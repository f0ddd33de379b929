"""FedRuntime on one device, counterpart of the JAX package's
``core/runtime.py FedRuntime`` (its ``_round_step``) without a mesh,
telemetry or the robustness subsystem.

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
   (deferred encode), or not at all under the dense server state;
3. the sketch table crosses the wire (``--wire_dtype``): each client's
   table under the table clip, and the round's one table, rounded to
   bf16, or the round's one table (the per-client tables under the
   table clip) through the int8 wire's quantize and dequantize, its
   draws keyed by the round before it advances (so a resumed run draws
   them again);
4. the aggregate is divided by the round's datum count and
   ``server_update`` runs the mode's rule;
5. the weights move by the update, the participants' rows are written
   back, ``coord_last_update`` records the changed coordinates, and
   ``nan_round`` the first round whose update, aggregate or client loss
   was not finite.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from commefficient_torch.config import FedConfig, auto_num_cols
from commefficient_torch.core import client as client_lib
from commefficient_torch.core.server import (server_update,
                                             validate_mode_combo,
                                             validate_regimes)
from commefficient_torch.core.state import FedState
from commefficient_torch.ops.sketch import make_sketch_impl
from commefficient_torch.ops.wire import wire_round_trip

# keys DP noise apart from the data path's draws (seed ^ 0xDA7A)
NOISE_SALT = 0xD9


def noise_generator(seed: int, step: int, slot: int,
                    device) -> torch.Generator:
    """The generator of one round's DP noise: slot 0 is the server's,
    slot w + 1 the round's w-th client's. Keyed by (seed, global round,
    slot), so a resumed run draws the noise of the uninterrupted one."""
    key = np.random.SeedSequence([seed, NOISE_SALT, step, slot])
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
        self.cfg = cfg
        self.num_clients = cfg.default_num_clients()
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
        elif fused_encode and self.defer_encode and not cfg.do_topk_down:
            # no per-client nonlinearity: every client into one table
            self._fused_fn = client_lib.make_fused_grad(cfg, loss_fn,
                                                        self.batch_size)
        else:
            self._client_fn = client_lib.make_client_step(
                cfg, loss_fn, self.batch_size, fused_encode)
        self._encode_sum = (self.defer_encode and not self.dense_preimage
                            and not fused_encode)
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
                "nan_round": ()}

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
            nan_round=zeros("nan_round", -1, torch.int32))

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

    def _clients(self, state: FedState, ids: torch.Tensor, batch, mask,
                 mask_host: np.ndarray, lr: torch.Tensor,
                 used: Optional[torch.Tensor]):
        """The round's client work: ``(aggregate, results (W, 2), n_valid
        (W,), new velocity rows or None, new error rows or None)``. The
        aggregate is the sketch table in sketch mode (a (d,) vector under
        the dense server state), else a (d,) vector, not yet divided by
        the round's datum count. ``used`` holds each participant's
        weights under ``--topk_down``; otherwise every client reads the
        server's."""
        cfg, w = self.cfg, state.ps_weights
        if self._fused_fn is not None:
            table, results, n_valid = self._fused_fn(w, batch, mask,
                                                     mask_host, self.cs)
            return table, results, n_valid, None, None
        vel_rows = (state.client_velocities[ids]
                    if state.client_velocities is not None else None)
        err_rows = (state.client_errors[ids]
                    if state.client_errors is not None else None)
        # the per-client wire: each client's own table (the table clip)
        table_wire = (cfg.mode == "sketch" and not self.defer_encode
                      and (self._table_dtype != torch.float32
                           or self._int8_wire))
        agg, results, n_valid, vels, errs = None, [], [], [], []
        for c in range(mask.shape[0]):
            cb = {k: v[c] for k, v in batch.items()}
            wc = w if used is None else used[c]
            gen = (noise_generator(cfg.seed, state.step, c + 1, self.device)
                   if cfg.do_dp and cfg.dp_mode == "worker" else None)
            if cfg.mode == "fedavg":
                out = self._client_fn(wc, cb, mask[c], mask_host[c], lr, gen)
            else:
                out = self._client_fn(
                    wc, cb, mask[c],
                    None if vel_rows is None else vel_rows[c],
                    None if err_rows is None else err_rows[c], gen, self.cs)
            tx = out.transmit
            if table_wire and self._int8_wire:
                (tx,) = client_lib.int8_wire_uploads(
                    cfg, [tx], state.step, self._wire_block, slot0=c)
            elif table_wire:
                tx = tx.to(self._table_dtype).to(torch.float32)
            agg = tx if agg is None else agg + tx
            results.append(out.results)
            n_valid.append(out.n_valid)
            vels.append(out.velocity)
            errs.append(out.error)
        if self._encode_sum:
            # sum of the clients' sketches == sketch of the sum: one encode
            agg = self.cs.encode(agg)
        return (agg, torch.stack(results), torch.stack(n_valid),
                None if vel_rows is None else torch.stack(vels),
                None if err_rows is None else torch.stack(errs))

    def round(self, state: FedState, client_ids, batch, mask, lr
              ) -> Tuple[FedState, Dict]:
        """One federated round. ``client_ids`` (W,) names the round's
        clients, ``batch`` leaves are (W, B, ...), ``mask`` is (W, B) and
        ``lr`` a scalar; numpy arrays or tensors. The participants' rows of
        ``state.client_velocities``, ``state.client_errors`` and
        ``state.client_weights`` are written in place (the JAX package
        donates the state likewise); the rest of the new state is new
        tensors."""
        cfg, dev, step = self.cfg, self.device, state.step
        mask_host = np.asarray(torch.as_tensor(mask).cpu(), dtype=bool)
        mask = torch.as_tensor(mask_host, device=dev)
        ids = torch.as_tensor(np.asarray(client_ids), dtype=torch.int64,
                              device=dev)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        if lr.ndim and lr.shape != (cfg.grad_size,):
            raise ValueError(f"lr of shape {tuple(lr.shape)}: want a scalar "
                             f"or ({cfg.grad_size},)")
        step_t = torch.tensor(step, dtype=torch.int32, device=dev)
        W = mask.shape[0]

        # download accounting, before this round's update
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

        agg, results, n_valid, vel_new, err_new = self._clients(
            state, ids, self.to_device(batch), mask, mask_host, lr, used)
        if agg.ndim == 2 and not self.dense_preimage \
                and self._table_dtype != torch.float32:
            agg = agg.to(self._table_dtype).to(torch.float32)
        elif agg.ndim == 2 and self._int8_wire and self.defer_encode:
            # the round's one table over the int8 wire, keyed by the round
            # before it advances
            agg = wire_round_trip(agg, self._wire_block, seed=cfg.seed,
                                  round_idx=step, salt=0)
        agg = agg / torch.clamp(n_valid.sum(), min=1.0)
        noise_gen = (noise_generator(cfg.seed, step, 0, dev)
                     if cfg.do_dp and cfg.dp_mode == "server" else None)
        update, Vvel, Verr, sup_mask = server_update(
            cfg, agg, state.Vvelocity, state.Verror, lr, self.cs,
            noise_gen, self.dense_preimage)

        if vel_new is not None:
            if cfg.mode == "true_topk":
                # momentum factor masking of the participants' rows
                vel_new = vel_new.masked_fill(sup_mask[None, :], 0.0)
            state.client_velocities.index_copy_(0, ids, vel_new)
        if err_new is not None:
            state.client_errors.index_copy_(0, ids, err_new)
        coord_last_update = state.coord_last_update
        if cfg.track_bytes:
            coord_last_update = torch.where(update != 0, step_t,
                                            coord_last_update)
        bad = (~torch.isfinite(update).all() | ~torch.isfinite(agg).all()
               | ~torch.isfinite(results[:, 0]).all())
        nan_round = torch.where((state.nan_round < 0) & bad, step_t,
                                state.nan_round)
        new_state = FedState(
            ps_weights=state.ps_weights - update, Vvelocity=Vvel,
            Verror=Verr, step=step + 1,
            client_velocities=state.client_velocities,
            client_errors=state.client_errors,
            client_weights=state.client_weights,
            coord_last_update=coord_last_update,
            client_last_round=client_last_round, nan_round=nan_round)
        return new_state, {"results": (results[:, 0], results[:, 1]),
                           "n_valid": n_valid,
                           "download_bytes": download_bytes,
                           "upload_bytes": upload_bytes}

    def val(self, state: FedState, batch, mask):
        """Masked evaluation on the current weights: ``((loss, acc),
        n_valid)``."""
        return self._val_fn(state.ps_weights, self.to_device(batch),
                            torch.as_tensor(mask, device=self.device,
                                            dtype=torch.bool))
