"""FedRuntime on one device, counterpart of the JAX package's
``core/runtime.py FedRuntime`` (its ``_round_step``, and its split
round ``cohort``/``merge``/``commit`` for ``--async_agg``) without a
mesh or telemetry.

A round:

1. download accounting, before the update: each participant's count of
   coordinates changed since its last download; under ``--topk_down``
   each participant's stale weights advance by the top-k of their lag;
2. the clients, routed as the JAX package routes them: the fused sketch
   step (sketch mode with the fused encode, the default) streams every
   microbatch gradient of every client into the round's table; with a
   per-client table clip or ``--topk_down`` each client streams its
   microbatches and its own weight-decay term into its own table;
   every other case runs the client step once a client (local momentum,
   local error, the local top-k, clipping, DP, or FedAvg's local SGD)
   and sums the transmits, which the sketch mode then encodes once
   (deferred encode), or not at all under the dense server state. With
   an update-space adversary, a defense or the quarantine on, the round
   keeps each client's upload (W, ...) instead of their running sum and
   runs the JAX package's transmit tail on them: injection, then the
   quarantine's zeroing of nonfinite clients, then the per-client wire,
   then the robust (or plain) sum;
3. the sketch table crosses the wire (``--wire_dtype``): each client's
   table under the table clip, and the round's one table, rounded to
   bf16, or the round's one table (the per-client tables under the
   table clip) through the int8 wire's quantize and dequantize, its
   draws keyed by the round before it advances (so a resumed run draws
   them again);
4. the aggregate is divided by the round's datum count and
   ``server_update`` runs the mode's rule;
5. the weights move by the update, the participants' rows are written
   back, ``coord_last_update`` records the changed coordinates,
   ``nan_round`` the first round whose update, aggregate or client loss
   was not finite (under the quarantine: a round whose every live client
   went nonfinite), and the normclip ring takes the round's median norm.

The split round (``--async_agg``) runs steps 1-3 in ``cohort``, which
returns the unnormalized sum and its datum count; ``merge`` folds a
landed cohort into ``FedState.async_buffer`` at its staleness weight
(``merge_first`` swaps it in, no arithmetic) and ``commit`` runs steps 4-5
on the buffer. Both halves are the synchronous round's own code, so one
cohort merged first and committed at once is bitwise that round.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from commefficient_torch.config import FedConfig, auto_num_cols
from commefficient_torch.core import client as client_lib
from commefficient_torch.core.async_agg import validate_async_combo
from commefficient_torch.core.server import (nanmedian, robust_aggregate,
                                             server_update,
                                             validate_defense_combo,
                                             validate_mode_combo,
                                             validate_regimes)
from commefficient_torch.core.state import FedState
from commefficient_torch.data.scenarios import make_adversary
from commefficient_torch.ops.sketch import make_sketch_impl
from commefficient_torch.ops.wire import wire_round_trip

# keys DP noise apart from the data path's draws (seed ^ 0xDA7A)
NOISE_SALT = 0xD9
# the noise adversary's fold (the JAX package folds its client keys with
# this constant for the same draw)
ADV_FOLD = 0xAD5E


def noise_generator(seed: int, step: int, slot: int,
                    device, fold: int = 0) -> torch.Generator:
    """The generator of one round's DP noise: slot 0 is the server's,
    slot w + 1 the round's w-th client's. Keyed by (seed, global round,
    slot), so a resumed run draws the noise of the uninterrupted one;
    ``fold`` (``ADV_FOLD``: the noise adversary) keys another stream."""
    key = np.random.SeedSequence([seed, NOISE_SALT, step, slot]
                                 + ([fold] if fold else []))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key.generate_state(1, np.uint64)[0] >> 1))
    return gen


def download_coord_counts(coord_last_update: torch.Tensor,
                          thresholds: torch.Tensor) -> torch.Tensor:
    """``counts[w] = |{i : coord_last_update[i] >= thresholds[w]}|``: one
    compare-and-count pass over d a participant, summed in int32 over a
    uint8 view of the comparison (the fastest plain form measured on the
    card), with no atomics and no host read. A histogram of
    ``coord_last_update`` would take one pass, but it piles most
    coordinates into one bin (-1, never updated, in a sparse run; the
    last round in a dense one), and its atomic adds on that bin
    serialise."""
    return torch.stack([
        (coord_last_update >= t).view(torch.uint8).sum(dtype=torch.int32)
        for t in thresholds]).to(torch.int64)


class FedRuntime:
    """``model`` is a port model whose parameters are one flat vector
    (``model.flat``, the initial weights; ``model.num_params``);
    ``loss_fn(flat, batch, mask)`` follows the contract of losses.py, and
    ``loss_fn_val`` (default ``loss_fn``) is the one ``val`` runs. The
    per-client state has ``cfg.default_num_clients()`` rows. ``device``
    defaults to the card."""

    def __init__(self, cfg: FedConfig, model, loss_fn: Callable,
                 device="cuda", loss_fn_val: Optional[Callable] = None):
        self.device = torch.device(device)
        d = int(model.num_params)
        cfg = cfg.replace(grad_size=d)
        if (cfg.mode == "sketch" and cfg.sketch_impl == "circ"
                and not cfg.exact_num_cols):
            c = auto_num_cols(cfg.num_cols)
            if c != cfg.num_cols:
                print(f"auto-sized sketch num_cols {cfg.num_cols} -> {c} "
                      "(1024-aligned, as the JAX package sizes it; "
                      "--exact_num_cols pins the original)")
                cfg = cfg.replace(num_cols=c)
        validate_mode_combo(cfg)
        validate_regimes(cfg)
        validate_defense_combo(cfg)
        validate_async_combo(cfg)
        self.cfg = cfg
        self.num_clients = cfg.default_num_clients()
        # the robustness services: what acts on each client's upload, the
        # adversaries' assignment over the whole universe (the host's and
        # the round's view of one draw), the normclip ring
        self._per_client = client_lib.per_client_uploads(cfg)
        self._adv_inject = cfg.adversary in client_lib.INJECT_KINDS
        self._labelflip = cfg.adversary == "labelflip"
        self._quarantine = cfg.nonfinite_action == "quarantine"
        self._defense_ring = cfg.defense == "normclip"
        self._defense_stats = (cfg.defense != "none"
                               or cfg.adversary != "none"
                               or self._quarantine)
        self.adversary_plan = make_adversary(cfg)
        self._adv_universe = (
            torch.as_tensor(self.adversary_plan.universe_mask(
                self.num_clients), device=self.device)
            if self.adversary_plan is not None else None)
        self.batch_size = (cfg.local_batch_size if cfg.local_batch_size > 0
                           else cfg.max_client_batch)
        self.initial_weights = model.flat.detach().to(self.device,
                                                      torch.float32)
        # (path, shape) of the flat parameters, for checkpoint fingerprints
        self.layout = getattr(model, "layout", None)
        self.cs = None
        if cfg.mode == "sketch":
            self.cs = make_sketch_impl(cfg.sketch_impl, d, cfg.num_cols,
                                       cfg.num_rows, cfg.num_blocks,
                                       seed=cfg.sketch_seed,
                                       device=self.device,
                                       dtype=cfg.sketch_dtype,
                                       scan_rows=cfg.sketch_scan_rows)
        # the bf16 wire: tables travel rounded to bf16; the server's
        # arithmetic stays float32
        self._table_dtype = (getattr(torch, cfg.sketch_dtype)
                             if cfg.mode == "sketch" else torch.float32)
        # sum of the clients' sketches == sketch of the sum, so the round
        # encodes once, unless a per-client table clip intervenes
        self.defer_encode = cfg.mode == "sketch" and not cfg.table_clip
        # the dense server state: (d,) momentum and error pre-images,
        # always for the SRHT (a dense transform has no table cells)
        self.dense_preimage = self.defer_encode and (
            self.cs.dense_transform or cfg.sketch_server_state == "dense")
        if (cfg.mode == "sketch" and cfg.sketch_server_state == "dense"
                and not self.dense_preimage):
            raise ValueError(
                "--sketch_server_state dense requires deferred encode (no "
                "per-client table clip; use --sketch_dense_clip to clip)")
        problems = client_lib.fused_encode_blockers(cfg)
        if cfg.mode == "sketch":
            if self.dense_preimage:
                problems.append(
                    "the dense server state (--sketch_impl rht or "
                    "--sketch_server_state dense) consumes the dense "
                    "aggregate; there is no table to accumulate into")
            elif self.cs.dense_transform:
                problems.append(f"--sketch_impl {cfg.sketch_impl} has a "
                                "dense transform (no streaming encode)")
        fused_encode = (cfg.mode == "sketch"
                        and cfg.sketch_fused_encode != "off"
                        and not problems)
        if cfg.sketch_fused_encode == "on" and not fused_encode:
            raise ValueError(
                "--sketch_fused_encode on: the fused sketch encode is "
                "unsound for this configuration (use auto to fall back to "
                "the unfused round):\n  " + "\n  ".join(problems))
        # the int8 wire (ops/wire.py): an explicit request, so what it
        # cannot serve raises
        self._int8_wire, self._wire_block = False, 0
        if cfg.mode == "sketch" and cfg.wire_dtype == "int8":
            problems = []
            if self.dense_preimage:
                problems.append(
                    "the dense-preimage server state consumes the dense "
                    "aggregated gradient — no table crosses the wire")
            blk = min(cfg.wire_block, cfg.num_cols)
            if cfg.num_cols % blk:
                problems.append(
                    f"--wire_block {cfg.wire_block} does not tile the "
                    f"{cfg.num_cols} table columns: pick a --wire_block "
                    "dividing num_cols")
            if problems:
                raise ValueError(
                    "--wire_dtype int8 is unavailable for this "
                    "configuration:\n  " + "\n  ".join(problems))
            self._int8_wire, self._wire_block = True, blk
        self._upload_bytes = cfg.upload_wire_bytes(self._wire_block or None)
        self._fused_fn = self._client_fn = None
        if cfg.mode == "fedavg":
            self._client_fn = client_lib.make_fedavg_client(
                cfg, loss_fn, self.batch_size)
        elif (fused_encode and self.defer_encode and not cfg.do_topk_down
              and not self._per_client):
            # no per-client nonlinearity: every client into one table
            self._fused_fn = client_lib.make_fused_grad(cfg, loss_fn,
                                                        self.batch_size)
        else:
            self._client_fn = client_lib.make_client_step(
                cfg, loss_fn, self.batch_size, fused_encode)
        self._encode_sum = (self.defer_encode and not self.dense_preimage
                            and not fused_encode)
        # the per-client wire: each client's own table (the table clip)
        self._table_wire = (cfg.mode == "sketch" and not self.defer_encode
                            and (self._table_dtype != torch.float32
                                 or self._int8_wire))
        self._val_fn = client_lib.make_val_step(loss_fn_val or loss_fn)

    def state_shapes(self) -> Dict[str, Optional[Tuple[int, ...]]]:
        """The shape of each ``FedState`` field this run holds (None: a
        field it does not hold)."""
        cfg = self.cfg
        d, n = cfg.grad_size, self.num_clients
        server = (self.cs.table_shape
                  if cfg.mode == "sketch" and not self.dense_preimage
                  else (d,))
        track = cfg.track_bytes
        return {"ps_weights": (d,), "Vvelocity": server, "Verror": server,
                "step": (),
                "client_velocities": ((n, d) if cfg.needs_client_velocities
                                      else None),
                "client_errors": (n, d) if cfg.needs_client_errors else None,
                "client_weights": (n, d) if cfg.do_topk_down else None,
                "coord_last_update": (d,) if track else None,
                "client_last_round": (n,) if track else None,
                "nan_round": (),
                "async_buffer": server if cfg.async_agg else None,
                "async_buffer_n": () if cfg.async_agg else None,
                "defense_ref": ((cfg.defense_window,)
                                if self._defense_ring else None)}

    def init_state(self) -> FedState:
        dev, shapes = self.device, self.state_shapes()
        rows = sum(4 * shapes[name][0] * shapes[name][1]
                   for name in ("client_velocities", "client_errors",
                                "client_weights")
                   if shapes[name] is not None)
        if rows and dev.type == "cuda":
            free = torch.cuda.mem_get_info(dev)[0]
            if rows > free:
                raise ValueError(
                    f"the per-client rows of {self.num_clients} clients x d "
                    f"= {self.cfg.grad_size} take {rows} bytes "
                    f"({rows / 2**30:.2f} GiB), above the {free} bytes free "
                    f"on {dev}: lower --num_clients")

        def zeros(name: str, fill: float = 0.0, dtype=torch.float32):
            shape = shapes[name]
            return (torch.full(shape, fill, dtype=dtype, device=dev)
                    if shape is not None else None)

        return FedState(
            ps_weights=self.initial_weights.clone(),
            Vvelocity=zeros("Vvelocity"), Verror=zeros("Verror"), step=0,
            client_velocities=zeros("client_velocities"),
            client_errors=zeros("client_errors"),
            # every client starts from the initial weights
            client_weights=(self.initial_weights.expand(
                shapes["client_weights"]).clone()
                if shapes["client_weights"] is not None else None),
            coord_last_update=zeros("coord_last_update", -1, torch.int32),
            client_last_round=zeros("client_last_round", 0, torch.int32),
            nan_round=zeros("nan_round", -1, torch.int32),
            async_buffer=zeros("async_buffer"),
            async_buffer_n=zeros("async_buffer_n"),
            # NaN: a round not yet seen (nanmedian skips it)
            defense_ref=zeros("defense_ref", float("nan")))

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Every leaf onto the device: floating leaves as float32, integer
        leaves (labels, token ids, positions) as int64. A pinned host leaf
        is copied without blocking the host, in order on the current
        stream."""
        out = {}
        for key, val in batch.items():
            val = torch.as_tensor(val)
            dtype = (torch.float32 if val.is_floating_point()
                     else torch.int64)
            out[key] = val.to(self.device, dtype,
                              non_blocking=val.is_pinned())
        return out

    def _client_wire(self, tx: torch.Tensor, step: int, slot: int
                     ) -> torch.Tensor:
        """Client ``slot``'s own table over the wire (the table clip's
        per-client tables), or ``tx`` as it is."""
        if not self._table_wire:
            return tx
        if self._int8_wire:
            (tx,) = client_lib.int8_wire_uploads(
                self.cfg, [tx], step, self._wire_block, slot0=slot)
            return tx
        return tx.to(self._table_dtype).to(torch.float32)

    def _transmit_tail(self, state: FedState, ids: torch.Tensor,
                       tx: torch.Tensor, results: torch.Tensor,
                       n_valid: torch.Tensor):
        """The JAX package's ``_transmit_tail`` on the (W, ...) uploads:
        injection, then the quarantine's zeroing, then the per-client
        wire, then the robust (or plain) sum. Returns ``(agg, results,
        n_valid, client_finite or None, defense stats or None, cur_med or
        None)``."""
        cfg, W = self.cfg, tx.shape[0]
        client_finite = stats = cur_med = None
        if self._adv_inject:
            gens = ([noise_generator(cfg.seed, state.step, w + 1,
                                     self.device, fold=ADV_FOLD)
                     for w in range(W)]
                    if cfg.adversary == "noise" else None)
            tx = client_lib.inject_adversary(
                cfg, tx, self._adv_universe[ids], gens, n_valid)
        if self._quarantine:
            tx, n_valid, results, client_finite = \
                client_lib.quarantine_zero(tx, n_valid, results)
        if self._table_wire:
            tx = torch.stack([self._client_wire(t, state.step, w)
                              for w, t in enumerate(tx)])
        if cfg.defense != "none":
            ref = (nanmedian(state.defense_ref) if self._defense_ring
                   else None)
            agg, cur_med, stats = robust_aggregate(cfg, tx, n_valid, ref)
        else:
            agg = tx.sum(dim=0)
        return agg, results, n_valid, client_finite, stats, cur_med

    def _clients(self, state: FedState, ids: torch.Tensor, batch, mask,
                 mask_host: np.ndarray, lr: torch.Tensor,
                 used: Optional[torch.Tensor]) -> Dict:
        """The round's client work, up to the encode and the round's wire:
        ``agg`` (the sketch table in sketch mode, a (d,) vector under the
        dense server state and in the other modes), not yet divided by the
        round's datum count; ``results`` (W, 2), ``n_valid`` (W,), the new
        velocity and error rows (or None), ``client_finite`` (W,) bool
        under the quarantine, the defense ``stats`` and ``cur_med``.
        ``used`` holds each participant's weights under ``--topk_down``;
        otherwise every client reads the server's."""
        cfg, w = self.cfg, state.ps_weights
        if self._labelflip:
            batch = client_lib.flip_labels(batch, self._adv_universe[ids],
                                           cfg.num_classes)
        out = dict(vel=None, err=None, client_finite=None, stats=None,
                   cur_med=None)
        if self._fused_fn is not None:
            out["agg"], out["results"], out["n_valid"] = self._fused_fn(
                w, batch, mask, mask_host, self.cs)
            return self._round_wire(out, state.step)
        vel_rows = (state.client_velocities[ids]
                    if state.client_velocities is not None else None)
        err_rows = (state.client_errors[ids]
                    if state.client_errors is not None else None)
        W = mask.shape[0]
        agg, uploads, results, n_valid, vels, errs = None, None, [], [], \
            [], []
        for c in range(W):
            cb = {k: v[c] for k, v in batch.items()}
            wc = w if used is None else used[c]
            gen = (noise_generator(cfg.seed, state.step, c + 1, self.device)
                   if cfg.do_dp and cfg.dp_mode == "worker" else None)
            if cfg.mode == "fedavg":
                o = self._client_fn(wc, cb, mask[c], mask_host[c], lr, gen)
            else:
                o = self._client_fn(
                    wc, cb, mask[c],
                    None if vel_rows is None else vel_rows[c],
                    None if err_rows is None else err_rows[c], gen, self.cs)
            if self._per_client:
                # each client's upload, for the transmit tail
                if uploads is None:
                    uploads = o.transmit.new_empty(
                        (W,) + tuple(o.transmit.shape))
                uploads[c] = o.transmit
            else:
                tx = self._client_wire(o.transmit, state.step, c)
                agg = tx if agg is None else agg + tx
            results.append(o.results)
            n_valid.append(o.n_valid)
            vels.append(o.velocity)
            errs.append(o.error)
        results, n_valid = torch.stack(results), torch.stack(n_valid)
        if uploads is not None:
            agg, results, n_valid, out["client_finite"], out["stats"], \
                out["cur_med"] = self._transmit_tail(state, ids, uploads,
                                                     results, n_valid)
            del uploads
        if self._encode_sum:
            # sum of the clients' sketches == sketch of the sum: one encode
            agg = self.cs.encode(agg)
        if vel_rows is not None:
            out["vel"] = torch.stack(vels)
        if err_rows is not None:
            out["err"] = torch.stack(errs)
        fin = out["client_finite"]
        if fin is not None:
            # a struck client's rows keep their previous values
            for key, rows in (("vel", vel_rows), ("err", err_rows)):
                if out[key] is not None:
                    out[key] = torch.where(fin[:, None], out[key], rows)
        out.update(agg=agg, results=results, n_valid=n_valid)
        return self._round_wire(out, state.step)

    def _round_wire(self, out: Dict, step: int) -> Dict:
        """The round's one table over the wire: rounded to bf16, or the
        int8 wire's round trip with its draws keyed by the round before it
        advances (so a resumed run, and a cohort, draw them again)."""
        agg = out["agg"]
        if agg.ndim == 2 and not self.dense_preimage \
                and self._table_dtype != torch.float32:
            agg = agg.to(self._table_dtype).to(torch.float32)
        elif agg.ndim == 2 and self._int8_wire and self.defer_encode:
            agg = wire_round_trip(agg, self._wire_block, seed=self.cfg.seed,
                                  round_idx=step, salt=0)
        out["agg"] = agg
        return out

    def _inputs(self, client_ids, mask, lr):
        """``(ids, mask, mask_host, lr)`` on the device from the caller's
        numpy arrays or tensors; the mask is copied to the host once."""
        mask_host = np.asarray(torch.as_tensor(mask).cpu(), dtype=bool)
        mask = torch.as_tensor(mask_host, device=self.device)
        ids = torch.as_tensor(np.asarray(client_ids), dtype=torch.int64,
                              device=self.device)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=self.device)
        if lr.ndim and lr.shape != (self.cfg.grad_size,):
            raise ValueError(f"lr of shape {tuple(lr.shape)}: want a scalar "
                             f"or ({self.cfg.grad_size},)")
        return ids, mask, mask_host, lr

    def _client_half(self, state: FedState, ids: torch.Tensor, batch,
                     mask: torch.Tensor, mask_host: np.ndarray,
                     lr: torch.Tensor) -> Dict:
        """The round up to the server update (steps 1-3), shared by
        ``round`` and ``cohort``: the download accounting, the top-k
        download, the clients and their tail, the encode and the wire.
        Besides ``_clients``'s entries it returns the byte vectors, the
        new ``client_last_round`` and ``defense_ref``, the ``defense``
        scalars and ``bad``, whether the aggregate or (under the abort)
        a loss went nonfinite, or (under the quarantine) every live
        client did."""
        cfg, dev, step = self.cfg, self.device, state.step
        step_t = torch.tensor(step, dtype=torch.int32, device=dev)
        W = mask.shape[0]
        download_bytes = upload_bytes = None
        client_last_round = state.client_last_round
        if cfg.track_bytes:
            counts = download_coord_counts(state.coord_last_update,
                                           state.client_last_round[ids])
            download_bytes = torch.zeros(
                self.num_clients, dtype=torch.float32,
                device=dev).index_put_((ids,), 4.0 * counts.float())
            upload_bytes = torch.zeros(
                self.num_clients, dtype=torch.float32,
                device=dev).index_put_(
                    (ids,), torch.full((W,), self._upload_bytes,
                                       dtype=torch.float32, device=dev))
            client_last_round = state.client_last_round.index_put(
                (ids,), step_t)

        # each participant's stale weights advance by the top-k of their
        # lag (the download compression); it trains on those
        used = None
        if cfg.do_topk_down:
            used = client_lib.topk_down_weights(cfg, state.ps_weights,
                                                state.client_weights[ids])
            state.client_weights.index_copy_(0, ids, used)

        out = self._clients(state, ids, self.to_device(batch), mask,
                            mask_host, lr, used)
        fin = out["client_finite"]
        bad = ~torch.isfinite(out["agg"]).all()
        if fin is not None:
            # only a round whose every live client went nonfinite aborts
            # (n_valid is post-zeroing: > 0 iff live and finite)
            bad = bad | ((~fin).any() & ~(out["n_valid"] > 0).any())
        else:
            bad = bad | ~torch.isfinite(out["results"][:, 0]).all()
        defense_ref = state.defense_ref
        if self._defense_ring:
            # the round's median enters the ring after the round used the
            # past ones: an attack round cannot vouch for itself
            defense_ref = defense_ref.clone()
            defense_ref[step % cfg.defense_window] = out["cur_med"]
        defense = None
        if self._defense_stats:
            nan = torch.full((), float("nan"), device=dev)
            defense = (dict(out["stats"]) if out["stats"] is not None
                       else dict.fromkeys(("clip_frac", "clip_thresh",
                                           "clipped_mass", "trim_frac"),
                                          nan))
            defense["nonfinite_clients"] = (
                (~fin).sum().to(torch.float32) if fin is not None else nan)
        out.update(step_t=step_t, download_bytes=download_bytes,
                   upload_bytes=upload_bytes,
                   client_last_round=client_last_round,
                   defense_ref=defense_ref, defense=defense, bad=bad)
        return out

    def _server_tail(self, state: FedState, agg: torch.Tensor,
                     lr: torch.Tensor, step_t: torch.Tensor):
        """The round's server half on the normalized aggregate, shared by
        ``round`` and ``commit``: ``(update, Vvelocity, Verror,
        support mask, coord_last_update, bad)``."""
        cfg = self.cfg
        noise_gen = (noise_generator(cfg.seed, state.step, 0, self.device)
                     if cfg.do_dp and cfg.dp_mode == "server" else None)
        update, Vvel, Verr, sup_mask = server_update(
            cfg, agg, state.Vvelocity, state.Verror, lr, self.cs,
            noise_gen, self.dense_preimage)
        coord_last_update = state.coord_last_update
        if cfg.track_bytes:
            coord_last_update = torch.where(update != 0, step_t,
                                            coord_last_update)
        bad = ~torch.isfinite(update).all() | ~torch.isfinite(agg).all()
        return update, Vvel, Verr, sup_mask, coord_last_update, bad

    def round(self, state: FedState, client_ids, batch, mask, lr
              ) -> Tuple[FedState, Dict]:
        """One federated round. ``client_ids`` (W,) names the round's
        clients, ``batch`` leaves are (W, B, ...), ``mask`` is (W, B) and
        ``lr`` a scalar; numpy arrays or tensors. The participants' rows of
        ``state.client_velocities``, ``state.client_errors`` and
        ``state.client_weights`` are written in place (the JAX package
        donates the state likewise); the rest of the new state is new
        tensors. The metrics hold ``defense`` (the four defense scalars
        and ``nonfinite_clients``, NaN where not applicable) when a
        robustness flag is on, and ``client_finite`` (W,) under the
        quarantine."""
        cfg = self.cfg
        ids, mask, mask_host, lr = self._inputs(client_ids, mask, lr)
        half = self._client_half(state, ids, batch, mask, mask_host, lr)
        agg = half["agg"] / torch.clamp(half["n_valid"].sum(), min=1.0)
        update, Vvel, Verr, sup_mask, coord_last_update, bad = \
            self._server_tail(state, agg, lr, half["step_t"])
        vel_new, err_new = half["vel"], half["err"]
        if vel_new is not None:
            if cfg.mode == "true_topk":
                # momentum factor masking of the participants' rows
                vel_new = vel_new.masked_fill(sup_mask[None, :], 0.0)
            state.client_velocities.index_copy_(0, ids, vel_new)
        if err_new is not None:
            state.client_errors.index_copy_(0, ids, err_new)
        nan_round = torch.where(
            (state.nan_round < 0) & (bad | half["bad"]), half["step_t"],
            state.nan_round)
        new_state = state.replace(
            ps_weights=state.ps_weights - update, Vvelocity=Vvel,
            Verror=Verr, step=state.step + 1,
            coord_last_update=coord_last_update,
            client_last_round=half["client_last_round"],
            nan_round=nan_round, defense_ref=half["defense_ref"])
        results = half["results"]
        return new_state, {"results": (results[:, 0], results[:, 1]),
                           "n_valid": half["n_valid"],
                           "download_bytes": half["download_bytes"],
                           "upload_bytes": half["upload_bytes"],
                           "defense": half["defense"],
                           "client_finite": half["client_finite"]}

    # ------------------------------------------- the split round (async)

    def cohort(self, state: FedState, client_ids, batch, mask, lr
               ) -> Tuple[FedState, Dict]:
        """The client half of the round (``--async_agg``): advances only
        the dispatch-time state (``client_last_round``, ``nan_round``,
        the normclip ring) and returns the payload: ``sum`` (the
        unnormalized aggregate), ``n_total`` (its datum count), the
        round's per-client results, byte vectors and defense metrics."""
        if not self.cfg.async_agg:
            raise ValueError("cohort: the runtime was built without "
                             "--async_agg")
        ids, mask, mask_host, lr = self._inputs(client_ids, mask, lr)
        half = self._client_half(state, ids, batch, mask, mask_host, lr)
        nan_round = torch.where((state.nan_round < 0) & half["bad"],
                                half["step_t"], state.nan_round)
        new_state = state.replace(
            client_last_round=half["client_last_round"],
            nan_round=nan_round, defense_ref=half["defense_ref"])
        results = half["results"]
        return new_state, {"sum": half["agg"],
                           "n_total": half["n_valid"].sum(),
                           "results": (results[:, 0], results[:, 1]),
                           "n_valid": half["n_valid"],
                           "download_bytes": half["download_bytes"],
                           "upload_bytes": half["upload_bytes"],
                           "defense": half["defense"],
                           "client_finite": half["client_finite"]}

    def merge(self, state: FedState, cohort_sum: torch.Tensor, n_total,
              weight: float) -> FedState:
        """Fold a landed cohort into the buffer: ``buffer + weight x
        sum`` (the weight in float32, as the JAX package rounds it) and
        the raw datum count (the commit divides by the true total, so a
        stale cohort's contribution is attenuated by its weight)."""
        w = float(np.float32(weight))
        return state.replace(
            async_buffer=state.async_buffer + w * cohort_sum,
            async_buffer_n=state.async_buffer_n
            + torch.as_tensor(n_total, dtype=torch.float32,
                              device=self.device))

    def merge_first(self, state: FedState, cohort_sum: torch.Tensor,
                    n_total) -> FedState:
        """A weight-1 merge into an empty buffer: the cohort's arrays swap
        in, no arithmetic (0 + x would flip the sign of a -0 cell), the
        bitwise path of the synchronous round."""
        return state.replace(
            async_buffer=cohort_sum,
            async_buffer_n=torch.as_tensor(n_total, dtype=torch.float32,
                                           device=self.device))

    def commit(self, state: FedState, lr) -> Tuple[FedState, Dict]:
        """The server half on the buffer: normalized by its raw datum
        count, the mode's server update, the weights moved, the buffer
        emptied; ``step`` (the server version) advances here."""
        if not self.cfg.async_agg:
            raise ValueError("commit: the runtime was built without "
                             "--async_agg")
        lr = torch.as_tensor(lr, dtype=torch.float32, device=self.device)
        step_t = torch.tensor(state.step, dtype=torch.int32,
                              device=self.device)
        agg = state.async_buffer / torch.clamp(state.async_buffer_n,
                                               min=1.0)
        update, Vvel, Verr, _, coord_last_update, bad = self._server_tail(
            state, agg, lr, step_t)
        nan_round = torch.where((state.nan_round < 0) & bad, step_t,
                                state.nan_round)
        new_state = state.replace(
            ps_weights=state.ps_weights - update, Vvelocity=Vvel,
            Verror=Verr, step=state.step + 1,
            coord_last_update=coord_last_update, nan_round=nan_round,
            async_buffer=torch.zeros_like(state.async_buffer),
            async_buffer_n=torch.zeros_like(state.async_buffer_n))
        return new_state, {"update_norm": torch.linalg.norm(update),
                           "error_norm": torch.linalg.norm(Verr),
                           "velocity_norm": torch.linalg.norm(Vvel),
                           "buffer_n": state.async_buffer_n}

    def val(self, state: FedState, batch, mask):
        """Masked evaluation on the current weights: ``((loss, acc),
        n_valid)``."""
        return self._val_fn(state.ps_weights, self.to_device(batch),
                            torch.as_tensor(mask, device=self.device,
                                            dtype=torch.bool))
