"""FedRuntime, counterpart of the JAX package's ``core/runtime.py
FedRuntime``: its ``_round_step``, its split round (``cohort`` with
``merge``/``commit`` for ``--async_agg``, with ``decode`` for
``--decode_overlap``), on one device or on a clients mesh
(``parallel/mesh.py``: one process a rank).

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
   went nonfinite), and the normclip ring takes the round's median norm;
6. under telemetry (the JAX package's gates, ``_signals`` and
   ``_client_stats``), the round's compression signals
   (telemetry/signals.py), its layer signals (telemetry/layer_signals.py)
   and its per-client quantiles (telemetry/clients.py) are reduced on
   the device into the metrics; nothing is read back here.

The split round runs steps 1-3 in ``cohort``, which returns the
unnormalized sum and its datum count. Under ``--async_agg`` ``merge``
folds a landed cohort into ``FedState.async_buffer`` at its staleness
weight (``merge_first`` swaps it in, no arithmetic) and ``commit`` runs
steps 4-5 on the buffer; under ``--decode_overlap`` ``decode`` runs them
on the cohort's sum (core/pipeline.py ``DecodeOverlapRound``). Both
halves are the synchronous round's own code, so one cohort merged first
and committed at once, or decoded, is bitwise that round.

On a mesh of n ranks (the JAX package's ``:146-190, 275-370, 972-1050,
1056-1420, 1620-1655``) each process holds its slices of the state
(``FedShardings``: the (d_pad,) vectors in d_pad/n blocks, the sketch
tables in column blocks under the sharded server tail and whole
otherwise, the dense client rows in column blocks) and runs the round's
positions ``[i W/n, (i+1) W/n)``, each client keyed by its global
position (DP and adversary noise draw what one device draws). The
weights cross in one all-gather a round; the dense aggregate is
reduce-scattered onto the d_pad/n blocks, the sketch table all-reduced
for the replicated tail or reduce-scattered over its columns for the
sharded tail (``core/server.py sharded_sketch_server_update``), every
float partial added in rank order (``Mesh.all_reduce``), so the two tails
are bitwise equal. Dense client rows move between their home column
blocks and the ranks computing them by one all_to_all each way. The
per-client results, datum counts, finite flags and gradient statistics
are gathered, so every rank's metrics are those of the single-device
round; the signals, on rounds that record them, read whole vectors
gathered for them. Under the int8 wire the sharded tail's reduce is
``ops/wire.py int8_reduce_scatter`` (in the round, the split round's
decode and the async cohort), its draws keyed by the round's step.

With a seq axis (the JAX package's ``:98-143, 1298-1317``) the ranks of
a clients index run the same clients, each on its S / n_seq tokens of
the leaves ``seq_spec`` names, with a seq-sharded loss
(``parallel/ring.py``, the seq fields of ``models/gpt2.py`` and
``losses.py``) whose collectives carry their own backward: each rank's
gradient is its tokens' share of its clients', and the reduce over every
rank sums them into the dense gradient (no over-count to probe). The
weight-decay term is added on seq index 0 alone; the per-client results
are gathered over the clients axis.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from commefficient_torch.config import FedConfig, auto_num_cols
from commefficient_torch.core import client as client_lib
from commefficient_torch.core.async_agg import (validate_async_combo,
                                                validate_overlap_combo)
from commefficient_torch.core.server import (nanmedian, robust_aggregate,
                                             server_update,
                                             sharded_sketch_server_update,
                                             sharded_topk_update,
                                             validate_defense_combo,
                                             validate_mode_combo,
                                             validate_regimes)
from commefficient_torch.core.state import FedState
from commefficient_torch.data.scenarios import make_adversary
from commefficient_torch.ops.sketch import make_sketch_impl
from commefficient_torch.ops.topk import (local_topk_candidates,
                                          merge_topk_candidates,
                                          scatter_winners)
from commefficient_torch.ops.wire import (int8_reduce_scatter,
                                          wire_round_trip)
from commefficient_torch.parallel.mesh import FedShardings
from commefficient_torch.telemetry.clients import (CLIENT_GRAD_KEYS,
                                                   summarize_per_client)
from commefficient_torch.telemetry.layer_signals import (
    layer_group_signals, make_group_spec)
from commefficient_torch.telemetry.signals import round_signals, shadow_step

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


def validate_seq_combo(cfg: FedConfig, seq_spec: Dict[str, int]) -> None:
    """The JAX package's refusals of a seq mesh axis (its
    ``runtime.py:112-139``): a client's gradient is the sum of its seq
    shards' partials, so only rules linear in it run, and nothing that
    needs its norm or its own state."""
    if not seq_spec:
        raise ValueError(
            "the mesh has a 'seq' axis but no seq_spec was given: "
            "without one the batch replicates over seq and every "
            "shard silently duplicates the full forward/backward. "
            "Pass seq_spec (and a seq-sharded loss/model, see "
            "gpt2_train.py), or drop the seq axis from mesh_axes.")
    if cfg.mode not in ("uncompressed", "true_topk", "sketch"):
        raise ValueError(
            f"mode={cfg.mode} is incompatible with a seq mesh axis "
            "(per-client nonlinear pipeline; use uncompressed/"
            "true_topk/sketch)")
    if (cfg.do_topk_down or cfg.do_dp or cfg.needs_client_velocities
            or cfg.needs_client_errors):
        raise ValueError(
            "topk_down / DP / local client state are not supported "
            "with a seq mesh axis")
    if cfg.max_grad_norm is not None:
        raise ValueError(
            "max_grad_norm is unsupported with a seq mesh axis: "
            "clipping needs the norm of the client's SUMMED "
            "gradient, which per-shard partial norms cannot "
            "provide (and the sketch table clip is per-client "
            "nonlinear)")


class FedRuntime:
    """``model`` is a port model whose parameters are one flat vector
    (``model.flat``, the initial weights; ``model.num_params``);
    ``loss_fn(flat, batch, mask)`` follows the contract of losses.py, and
    ``loss_fn_val`` (default ``loss_fn``) is the one ``val`` runs. The
    per-client state has ``cfg.default_num_clients()`` rows (on a mesh
    padded to a multiple of its size). ``device`` defaults to the card;
    ``mesh`` (``parallel.make_mesh``) runs this process's rank of a
    mesh on it. With a seq axis, ``seq_spec`` maps each batch leaf to the
    index of its sequence dimension (None: the leaf replicates over seq),
    and ``loss_fn`` runs the seq-sharded model (gpt2_train builds it)."""

    def __init__(self, cfg: FedConfig, model, loss_fn: Callable,
                 device="cuda", loss_fn_val: Optional[Callable] = None,
                 mesh=None, seq_spec: Optional[Dict[str, int]] = None):
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
        # the seq axis (a size-1 one is none): every rank of a clients
        # index runs its clients on S / n_seq of their tokens
        self.seq = mesh.seq if mesh is not None else None
        self.seq_spec = dict(seq_spec or {})
        if self.seq is not None:
            validate_seq_combo(cfg, self.seq_spec)
        validate_defense_combo(cfg, mesh=mesh,
                               seq_axis=None if self.seq is None else "seq")
        validate_async_combo(cfg)
        validate_overlap_combo(cfg)
        self.cfg = cfg
        self.mesh = mesh
        n = mesh.size if mesh is not None else 1
        # the clients axis: its size splits the round's positions
        self.clients = mesh.clients if mesh is not None else None
        n_c = self.clients.size if mesh is not None else 1
        if mesh is not None:
            if torch.device(mesh.device) != self.device:
                raise ValueError(f"the mesh computes on {mesh.device}, the "
                                 f"runtime on {self.device}")
            if cfg.num_workers % n_c:
                raise ValueError(
                    f"--num_workers {cfg.num_workers} must be divisible by "
                    f"the mesh axis size {n_c}")
        # the client rows and the dense federated vectors padded to mesh
        # multiples, so that both shard evenly (the JAX package's d_pad)
        self.num_clients = -(-cfg.default_num_clients() // n) * n
        self.d_pad = -(-d // n) * n
        self.shard_len = self.d_pad // n
        # rank i's coordinates of the vectors (every rank of the mesh),
        # and its clients index's positions of the round
        self.rank = mesh.rank if mesh is not None else 0
        self.n_shards = n
        self.client_rank = self.clients.rank if mesh is not None else 0
        self.n_client_shards = n_c
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
        # (one device only: on a mesh it would turn the table-sized
        # reduce back into a d-sized one)
        self.dense_preimage = self.defer_encode and mesh is None and (
            self.cs.dense_transform or cfg.sketch_server_state == "dense")
        if (cfg.mode == "sketch" and cfg.sketch_server_state == "dense"
                and not self.dense_preimage):
            raise ValueError(
                "--sketch_server_state dense requires a single device (no "
                "mesh) and deferred encode (no per-client table clip; use "
                "--sketch_dense_clip to clip)")
        # the telemetry's gates, as the JAX package sets them: signals and
        # client statistics only where a stream reads them, no signals
        # under the split rounds (a round's aggregate and its update are
        # decoupled there)
        self._signals = (cfg.signals and cfg.telemetry
                         and not cfg.async_agg and not cfg.decode_overlap)
        if cfg.signals and cfg.telemetry and cfg.async_agg:
            print("NOTE: --async_agg disables the per-round `signals` "
                  "diagnostics (they compare a round's aggregate against "
                  "the same round's server update, which buffered "
                  "aggregation decouples); commit-granularity EF norms "
                  "are emitted on the `async_round` events instead. Pass "
                  "--no_signals to silence this note.", file=sys.stderr)
        if cfg.signals and cfg.telemetry and cfg.decode_overlap:
            print("NOTE: --decode_overlap disables the per-round `signals` "
                  "diagnostics: the split round's client block finishes "
                  "before the server decode it would be compared against "
                  "(that early finish is the point of the split). Pass "
                  "--no_signals to silence this note.", file=sys.stderr)
        # the dense summed gradient before the deferred encode, kept for
        # grad_true_norm; with --signals_exact the table state's dense
        # shadow error pair rides in FedState (one device only: a mesh
        # never holds the dense aggregate)
        self._signals_dense_cap = (self._signals and cfg.mode == "sketch"
                                   and self.defer_encode
                                   and not self.dense_preimage
                                   and mesh is None)
        self._signals_shadow = self._signals_dense_cap and cfg.signals_exact
        self._client_stats = cfg.client_stats and cfg.telemetry
        # the JAX package's fused client loop (one scan into one buffer,
        # no per-client gradient): its gradient statistics are NaN there
        n_iters, mb = client_lib._num_microbatches(cfg, self.batch_size)
        jax_fused = (cfg.mode in ("sketch", "true_topk", "uncompressed")
                     and cfg.local_momentum == 0
                     and cfg.error_type != "local" and not cfg.do_dp
                     and cfg.max_grad_norm is None
                     and not cfg.do_topk_down and not self._per_client
                     and n_iters * mb == self.batch_size)
        # a seq shard holds a partial of each client's gradient, whose norm
        # is not the client's: no per-client gradient statistics there
        self._client_grad_stats = (self._client_stats and not jax_fused
                                   and self.seq is None)
        problems = client_lib.fused_encode_blockers(cfg,
                                                    signals=self._signals)
        if cfg.mode == "sketch":
            if self.dense_preimage:
                problems.append(
                    "the dense server state (--sketch_impl rht or "
                    "--sketch_server_state dense) consumes the dense "
                    "aggregate; there is no table to accumulate into")
            elif self.cs.dense_transform:
                problems.append(f"--sketch_impl {cfg.sketch_impl} has a "
                                "dense transform (no streaming encode)")
            if self._client_grad_stats:
                # the JAX package's default route: the per-client gradient
                # norms are measured on dense gradients
                problems.append(
                    "per-client grad-norm stats (telemetry/clients.py) "
                    "measure dense gradient norms on the per-client path; "
                    "pass --no_client_stats (or --no_telemetry)")
        fused_encode = (cfg.mode == "sketch"
                        and cfg.sketch_fused_encode != "off"
                        and not problems)
        if cfg.sketch_fused_encode == "on" and not fused_encode:
            raise ValueError(
                "--sketch_fused_encode on: the fused sketch encode is "
                "unsound for this configuration (use auto to fall back to "
                "the unfused round):\n  " + "\n  ".join(problems))
        if fused_encode and self._signals_dense_cap:
            print("NOTE: the fused sketch encode removes the dense "
                  "aggregated gradient the sketch-mode signals capture "
                  "(grad_true_norm and the collision-noise reference go "
                  "null). Pass --sketch_fused_encode off to keep them at "
                  "the cost of the dense (d,) materialization.",
                  file=sys.stderr)
            self._signals_dense_cap = False
        self.fused_encode = fused_encode
        # the layer signals: groups over the flat layout, reduced by
        # ranges (ops/segments.py); the dense gradient's per-group mass
        # only where the round holds a dense gradient
        self._layer_signals = (self._signals
                               and cfg.signal_groups != "off")
        self._layer_grad_mass = (self._layer_signals
                                 and (cfg.mode != "sketch"
                                      or self.dense_preimage
                                      or self._signals_dense_cap))
        self.group_spec = None
        if self._layer_signals:
            # a model without a layout is one leaf
            self.group_spec = make_group_spec(
                self.layout or [("params/params", (d,))], cfg.signal_groups)
            assert self.group_spec.d == d, (self.group_spec.d, d)
        # the sharded sketch server tail (core/server.py
        # sharded_sketch_server_update), decided once here as the JAX
        # package decides it: auto falls back to the replicated tail (the
        # same numbers), on raises with every blocker
        ss_problems = []
        if cfg.mode == "sketch":
            if mesh is None:
                ss_problems.append(
                    "no mesh: there is nothing to shard the server tail "
                    "over (the single-device round already holds the "
                    "whole table)")
            else:
                if self.seq is not None:
                    ss_problems.append(
                        "a seq mesh axis: the table's column shards "
                        "live on the clients axis only (the state's "
                        "sketch_table layout), which a seq-sharded "
                        "aggregation cannot feed without a reshard "
                        "every round")
                if self.cs.dense_transform \
                        or not hasattr(self.cs, "decode_range"):
                    ss_problems.append(
                        f"sketch_impl={cfg.sketch_impl} has a dense "
                        "transform (no cell-addressable table, no "
                        "range-restricted decode, and an estimate-space "
                        "EF rule); use circ or hash")
                if cfg.num_cols % n:
                    ss_problems.append(
                        f"num_cols={cfg.num_cols} is not divisible by the "
                        f"clients mesh axis ({n} ranks): the "
                        "reduce-scattered column shards must tile evenly "
                        "(pick --num_cols as a multiple of the rank count)")
        self.sharded_server = (cfg.mode == "sketch"
                               and cfg.sketch_sharded_server != "off"
                               and not ss_problems)
        if cfg.sketch_sharded_server == "on" and not self.sharded_server:
            raise ValueError(
                "--sketch_sharded_server on: the sharded server tail is "
                "unavailable for this configuration (use auto to fall "
                "back to the replicated tail instead):\n  "
                + "\n  ".join(ss_problems))
        # --decode_overlap with the sharded tail: the cohort ends at each
        # rank's local partial table and the decode runs the reduce
        self._reduce_in_decode = self.sharded_server and cfg.decode_overlap
        # which slice of each state field this rank holds
        self.shard_of = (FedShardings(mesh).for_state(
            cfg, self.full_state_shapes(),
            sharded_server=self.sharded_server)
            if mesh is not None else None)
        # the int8 wire (ops/wire.py): an explicit request, so what it
        # cannot serve raises
        self._int8_wire, self._wire_block = False, 0
        if cfg.mode == "sketch" and cfg.wire_dtype == "int8":
            problems = []
            if self.dense_preimage:
                problems.append(
                    "the dense-preimage server state consumes the dense "
                    "aggregated gradient — no table crosses the wire")
            if mesh is not None and not self.sharded_server:
                problems.append(
                    "a mesh without the sharded server tail: the "
                    "quantized reduce is an all_to_all of int8 COLUMN "
                    "SHARDS, which only the reduce-scattered tail "
                    "consumes (sharded-server blockers:\n    "
                    + "\n    ".join(ss_problems or ["(disabled by flag)"])
                    + ")")
            shard_c = cfg.num_cols // n_c
            blk = min(cfg.wire_block, shard_c)
            if shard_c == 0 or shard_c % max(blk, 1):
                problems.append(
                    f"--wire_block {cfg.wire_block} does not tile the "
                    f"per-device column shard ({shard_c} cols on "
                    f"{n_c} devices): pick a --wire_block dividing "
                    "num_cols / n_devices")
            if problems:
                raise ValueError(
                    "--wire_dtype int8 is unavailable for this "
                    "configuration:\n  " + "\n  ".join(problems))
            self._int8_wire, self._wire_block = True, blk
        self._upload_bytes = cfg.upload_wire_bytes(self._wire_block or None)
        self._fused_fn = self._client_fn = None
        # on a seq axis every shard's gradient is its tokens' share of the
        # client's, and the shards add up; the weight-decay term, which
        # no token carries, is added by seq index 0 alone
        client_cfg = cfg
        if self.seq is not None and self.seq.rank != 0:
            client_cfg = cfg.replace(weight_decay=0.0)
        if cfg.mode == "fedavg":
            self._client_fn = client_lib.make_fedavg_client(
                client_cfg, loss_fn, self.batch_size,
                with_stats=self._client_grad_stats)
        elif (fused_encode and self.defer_encode and not cfg.do_topk_down
              and not self._per_client):
            # no per-client nonlinearity: every client into one table
            self._fused_fn = client_lib.make_fused_grad(client_cfg, loss_fn,
                                                        self.batch_size)
        else:
            self._client_fn = client_lib.make_client_step(
                client_cfg, loss_fn, self.batch_size, fused_encode,
                with_stats=self._client_grad_stats)
        self._encode_sum = (self.defer_encode and not self.dense_preimage
                            and not fused_encode)
        # the per-client wire: each client's own table (the table clip)
        self._table_wire = (cfg.mode == "sketch" and not self.defer_encode
                            and (self._table_dtype != torch.float32
                                 or self._int8_wire))
        self._val_fn = client_lib.make_val_step(loss_fn_val or loss_fn)

    def full_state_shapes(self) -> Dict[str, Optional[Tuple[int, ...]]]:
        """The shape of each ``FedState`` field of the single-device round
        (None: a field the run does not hold): the whole state, as a
        checkpoint holds it."""
        cfg = self.cfg
        d, n = cfg.grad_size, cfg.default_num_clients()
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
                                if self._defense_ring else None),
                "sig_Vvelocity": (d,) if self._signals_shadow else None,
                "sig_Verror": (d,) if self._signals_shadow else None}

    def state_shapes(self) -> Dict[str, Optional[Tuple[int, ...]]]:
        """The shape of each ``FedState`` field this process holds: the
        whole state on one device, this rank's slices on a mesh."""
        shapes = self.full_state_shapes()
        if self.mesh is None:
            return shapes
        n, N = self.n_shards, self.num_clients
        out = {}
        for name, shape in shapes.items():
            kind = self.shard_of[name]
            if kind == "dense":
                shape = (self.shard_len,)
            elif kind == "cols":
                shape = ((N, self.shard_len) if len(shape) == 2
                         and name.startswith("client_")
                         else shape[:-1] + (shape[-1] // n,))
            elif name == "client_last_round":
                shape = (N,)
            out[name] = shape
        return out

    def _block(self, full: torch.Tensor, kind: Optional[str],
               fill: float = 0.0, rows: bool = False) -> torch.Tensor:
        """This rank's slice of a single-device field: a (d,) vector
        padded with ``fill`` to d_pad and cut to the rank's block; a
        table's column block; the column block of every client row, the
        rows padded to the mesh's client count."""
        if kind is None or kind == "replicated":
            return full
        lo, n = self.rank * self.shard_len, self.n_shards
        if kind == "dense":
            pad = self.d_pad - full.shape[0]
            full = torch.nn.functional.pad(full, (0, pad), value=fill)
            return full[lo:lo + self.shard_len].clone()
        if rows:
            padded = torch.nn.functional.pad(
                full, (0, self.d_pad - full.shape[1],
                       0, self.num_clients - full.shape[0]), value=fill)
            return padded[:, lo:lo + self.shard_len].clone()
        c = full.shape[-1] // n
        return full[..., self.rank * c:(self.rank + 1) * c].clone()

    def shard_state(self, full: FedState) -> FedState:
        """This rank's slices of a whole (single-device) state, such as a
        checkpoint restores; the state itself without a mesh."""
        if self.mesh is None:
            return full
        fields = {}
        for name, kind in self.shard_of.items():
            val = getattr(full, name)
            if val is None or name == "step":
                continue
            val = val.to(self.device)
            if name == "client_last_round":
                val = torch.nn.functional.pad(
                    val, (0, self.num_clients - val.shape[0]))
            fields[name] = self._block(
                val, kind, fill=-1 if name == "coord_last_update" else 0,
                rows=name.startswith("client_"))
        return full.replace(**fields)

    def gather_state(self, state: FedState) -> FedState:
        """The whole single-device state from the ranks' slices (a
        collective: every rank calls it and gets it); the state itself
        without a mesh."""
        if self.mesh is None:
            return state
        d, N = self.cfg.grad_size, self.cfg.default_num_clients()
        fields = {}
        for name, kind in self.shard_of.items():
            val = getattr(state, name)
            if val is None or name == "step":
                continue
            if kind == "dense":
                val = self.mesh.gather_rows(val)[:d]
            elif kind == "cols":
                val = self.mesh.gather_cols(val)
                if name.startswith("client_"):
                    val = val[:N, :d]
            elif name == "client_last_round":
                val = val[:N]
            fields[name] = val
        return state.replace(**fields)

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

        weights = self.initial_weights
        if self.mesh is not None:
            weights = self._block(weights, "dense")
        return FedState(
            ps_weights=weights.clone(),
            Vvelocity=zeros("Vvelocity"), Verror=zeros("Verror"), step=0,
            client_velocities=zeros("client_velocities"),
            client_errors=zeros("client_errors"),
            # every client starts from the initial weights
            client_weights=(weights.expand(
                shapes["client_weights"]).clone()
                if shapes["client_weights"] is not None else None),
            coord_last_update=zeros("coord_last_update", -1, torch.int32),
            client_last_round=zeros("client_last_round", 0, torch.int32),
            nan_round=zeros("nan_round", -1, torch.int32),
            async_buffer=zeros("async_buffer"),
            async_buffer_n=zeros("async_buffer_n"),
            # NaN: a round not yet seen (nanmedian skips it)
            defense_ref=zeros("defense_ref", float("nan")),
            sig_Vvelocity=zeros("sig_Vvelocity"),
            sig_Verror=zeros("sig_Verror"))

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
                       n_valid: torch.Tensor, slot0: int = 0):
        """The JAX package's ``_transmit_tail`` on the (W, ...) uploads
        (a rank's W/n, its first at round position ``slot0``):
        injection, then the quarantine's zeroing, then the per-client
        wire, then the robust (or plain) sum. Returns ``(agg, results,
        n_valid, client_finite or None, defense stats or None, cur_med or
        None)``."""
        cfg, W = self.cfg, tx.shape[0]
        client_finite = stats = cur_med = None
        if self._adv_inject:
            gens = ([noise_generator(cfg.seed, state.step, slot0 + w + 1,
                                     self.device, fold=ADV_FOLD)
                     for w in range(W)]
                    if cfg.adversary == "noise" else None)
            tx = client_lib.inject_adversary(
                cfg, tx, self._adv_universe[ids], gens, n_valid)
        if self._quarantine:
            tx, n_valid, results, client_finite = \
                client_lib.quarantine_zero(tx, n_valid, results)
        if self._table_wire:
            tx = torch.stack([self._client_wire(t, state.step, slot0 + w)
                              for w, t in enumerate(tx)])
        if cfg.defense != "none":
            ref = (nanmedian(state.defense_ref) if self._defense_ring
                   else None)
            agg, cur_med, stats = robust_aggregate(cfg, tx, n_valid, ref,
                                                   mesh=self.mesh)
        else:
            agg = tx.sum(dim=0)
        return agg, results, n_valid, client_finite, stats, cur_med

    def _clients(self, state: FedState, w: torch.Tensor, ids: torch.Tensor,
                 batch, mask, mask_host: np.ndarray, lr: torch.Tensor,
                 used: Optional[torch.Tensor], vel_rows, err_rows,
                 slot0: int = 0) -> Dict:
        """The round's client work (a rank's clients on a mesh, the first
        at round position ``slot0``), up to the encode and, on one
        device, the round's wire: ``agg`` (the sketch table in sketch
        mode, a (d,) vector under the dense server state and in the other
        modes), not yet divided by the round's datum count and, on a
        mesh, not yet reduced over the ranks; ``results`` (W, 2),
        ``n_valid`` (W,), the new velocity and error rows (or None),
        ``client_finite`` (W,) bool under the quarantine, the defense
        ``stats`` and ``cur_med``. ``w`` holds the server's weights;
        ``used`` each participant's under ``--topk_down``."""
        cfg = self.cfg
        if self._labelflip:
            batch = client_lib.flip_labels(batch, self._adv_universe[ids],
                                           cfg.num_classes)
        out = dict(vel=None, err=None, client_finite=None, stats=None,
                   cur_med=None, grad_stats=None, sig_dense=None)
        if self._fused_fn is not None:
            out["agg"], out["results"], out["n_valid"] = self._fused_fn(
                w, batch, mask, mask_host, self.cs)
            return self._round_wire(out, state.step)
        W = mask.shape[0]
        agg, uploads, results, n_valid, vels, errs = None, None, [], [], \
            [], []
        grad_stats = []
        for c in range(W):
            cb = {k: v[c] for k, v in batch.items()}
            wc = w if used is None else used[c]
            gen = (noise_generator(cfg.seed, state.step, slot0 + c + 1,
                                   self.device)
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
                tx = self._client_wire(o.transmit, state.step, slot0 + c)
                agg = tx if agg is None else agg + tx
            results.append(o.results)
            n_valid.append(o.n_valid)
            vels.append(o.velocity)
            errs.append(o.error)
            if o.stats is not None:
                grad_stats.append(o.stats)
        results, n_valid = torch.stack(results), torch.stack(n_valid)
        if grad_stats:
            out["grad_stats"] = {k: torch.stack([g[k] for g in grad_stats])
                                 for k in CLIENT_GRAD_KEYS}
        if uploads is not None:
            agg, results, n_valid, out["client_finite"], out["stats"], \
                out["cur_med"] = self._transmit_tail(state, ids, uploads,
                                                     results, n_valid,
                                                     slot0)
            del uploads
        if self._encode_sum:
            if self._signals_dense_cap:
                # the dense sum, kept for the signals' grad_true_norm
                out["sig_dense"] = agg
            # sum of the clients' sketches == sketch of the sum: one encode
            # (a rank's partial sum on a mesh)
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
        advances (so a resumed run, and a cohort, draw them again). On a
        mesh the bf16 wire is the reduce's own payload (``_reduce``)."""
        agg = out["agg"]
        if self.mesh is not None:
            return out
        if agg.ndim == 2 and not self.dense_preimage \
                and self._table_dtype != torch.float32:
            agg = agg.to(self._table_dtype).to(torch.float32)
        elif agg.ndim == 2 and self._int8_wire and self.defer_encode:
            agg = wire_round_trip(agg, self._wire_block, seed=self.cfg.seed,
                                  round_idx=step, salt=0)
        out["agg"] = agg
        return out

    def _reduce(self, agg: torch.Tensor, step: int) -> torch.Tensor:
        """The ranks' partial aggregates summed, in rank order
        (``Mesh.all_reduce``; every rank's, so a seq axis's partial
        gradients add up too): a dense vector padded to d_pad and
        reduce-scattered onto the rank's block; a table reduce-scattered
        over its columns under the sharded tail, else all-reduced whole.
        Under the bf16 wire the partials travel in bf16, add in float32
        and the sum is rounded to bf16 once, as the JAX package's bf16
        collective gives it on the CPU (one device rounds its one sum so
        too). Under the int8 wire the sharded tail's reduce is
        ``int8_reduce_scatter``, its draws keyed by round ``step``."""
        mesh = self.mesh
        if agg.ndim == 1:
            agg = torch.nn.functional.pad(agg, (0, self.d_pad - agg.shape[0]))
            return mesh.reduce_scatter(agg, dim=0)
        if self._int8_wire:
            return int8_reduce_scatter(agg, mesh, self._wire_block,
                                       seed=self.cfg.seed, round_idx=step)
        wire = self._table_dtype
        part = agg.to(wire) if wire != torch.float32 else agg
        red = (mesh.reduce_scatter(part, dim=1, dtype=torch.float32)
               if self.sharded_server
               else mesh.all_reduce(part, dtype=torch.float32))
        return red.to(wire).to(torch.float32)

    def _inputs(self, client_ids, mask, lr):
        """``(ids, mask, mask_host, lr)`` on the device from the caller's
        numpy arrays or tensors; the mask is copied to the host once."""
        mask_host = np.array(mask.cpu() if isinstance(mask, torch.Tensor)
                             else mask, dtype=bool)
        mask = torch.as_tensor(mask_host, device=self.device)
        ids = torch.as_tensor(np.asarray(client_ids), dtype=torch.int64,
                              device=self.device)
        lr = self._rate(lr)
        if lr.ndim and lr.shape != (self.cfg.grad_size,):
            raise ValueError(f"lr of shape {tuple(lr.shape)}: want a scalar "
                             f"or ({self.cfg.grad_size},)")
        return ids, mask, mask_host, lr

    def _scalar(self, value, dtype) -> torch.Tensor:
        """A 0-d tensor of a host number on the device, filled there:
        ``torch.tensor(x, device=cuda)`` copies from the host and waits
        for the copy (a host sync in the middle of a round)."""
        return torch.full((), value, dtype=dtype, device=self.device)

    def _rate(self, lr) -> torch.Tensor:
        """The rate on the device: a host scalar filled there, a vector
        or tensor moved there."""
        if not isinstance(lr, torch.Tensor) and np.ndim(lr) == 0:
            return self._scalar(float(lr), torch.float32)
        return torch.as_tensor(lr, dtype=torch.float32, device=self.device)

    def _positions(self, W: int) -> slice:
        """This rank's positions of a round of W clients (its clients
        index's)."""
        per = W // self.n_client_shards
        return slice(self.client_rank * per, (self.client_rank + 1) * per)

    def _seq_slice(self, batch: Dict) -> Dict:
        """The rank's S / n_seq tokens of each leaf ``seq_spec`` names
        (the others whole)."""
        if self.seq is None:
            return batch
        i, n = self.seq.rank, self.seq.size
        out = {}
        for key, val in batch.items():
            dim = self.seq_spec.get(key)
            if dim is not None:
                S = val.shape[dim]
                if S % n:
                    raise ValueError(
                        f"the seq mesh axis size ({n}) must divide the "
                        f"sequence length ({S}) of batch leaf {key!r}")
                cut = [slice(None)] * val.ndim
                cut[dim] = slice(i * (S // n), (i + 1) * (S // n))
                val = val[tuple(cut)]
            out[key] = val
        return out

    def _rows_to_compute(self, rows: torch.Tensor) -> torch.Tensor:
        """(W, d_pad/n) column blocks of the participants' rows (their
        home layout) -> (W/n, d) full rows of this rank's clients: one
        all_to_all."""
        n, W = self.n_shards, rows.shape[0]
        got = self.mesh.all_to_all(rows)                # (n W/n, d_pad/n)
        full = got.unflatten(0, (n, W // n)).permute(1, 0, 2)
        return full.reshape(W // n, self.d_pad)[:, :self.cfg.grad_size]

    def _rows_to_home(self, rows: torch.Tensor) -> torch.Tensor:
        """The inverse of ``_rows_to_compute``: (W/n, d) -> (W, d_pad/n)."""
        n = self.n_shards
        rows = torch.nn.functional.pad(rows,
                                       (0, self.d_pad - rows.shape[1]))
        blocks = rows.unflatten(1, (n, self.shard_len)).permute(1, 0, 2)
        return self.mesh.all_to_all(blocks).flatten(0, 1)

    def _mesh_topk_down(self, state: FedState, ids: torch.Tensor
                        ) -> torch.Tensor:
        """``topk_down_weights`` on the participants' column blocks: each
        row's top-k of its lag by the candidate merge (one (n, W, k_loc)
        all-gather of values and of indices). Writes the advanced blocks
        home and returns them."""
        stale = state.client_weights[ids]
        lag = state.ps_weights[None, :] - stale
        start = self.rank * self.shard_len
        vals, idx = local_topk_candidates(lag, self.cfg.k, start)
        win_v, win_i = merge_topk_candidates(self.mesh.all_gather(vals),
                                             self.mesh.all_gather(idx),
                                             self.cfg.k)
        used = stale + scatter_winners(win_v, win_i, start, self.shard_len)
        state.client_weights.index_copy_(0, ids, used)
        return used

    def _client_half(self, state: FedState, ids: torch.Tensor, batch,
                     mask: torch.Tensor, mask_host: np.ndarray,
                     lr: torch.Tensor, observe: bool = True,
                     reduce: bool = True) -> Dict:
        """The round up to the server update (steps 1-3), shared by
        ``round`` and ``cohort``: the download accounting, the top-k
        download, the clients and their tail, the encode and the wire,
        and on a mesh the reduce over the ranks (``reduce=False``: the
        rank's partial stays, for ``decode`` to reduce) and the gather of
        the per-client results. Besides ``_clients``'s entries it returns
        the byte vectors, the new ``client_last_round`` and
        ``defense_ref``, the ``defense`` scalars and ``bad``, whether the
        aggregate or (under the abort) a loss went nonfinite, or (under
        the quarantine) every live client did."""
        cfg, dev, step = self.cfg, self.device, state.step
        mesh = self.mesh
        step_t = self._scalar(step, torch.int32)
        W = mask.shape[0]
        download_bytes = upload_bytes = down_slot = up_slot = None
        client_last_round = state.client_last_round
        if cfg.track_bytes:
            counts = download_coord_counts(state.coord_last_update,
                                           state.client_last_round[ids])
            if mesh is not None:
                # each rank counts its own coordinates
                counts = mesh.all_reduce_int(counts)
            # each slot's bytes, kept for the client statistics
            down_slot = 4.0 * counts.float()
            up_slot = torch.full((W,), self._upload_bytes,
                                 dtype=torch.float32, device=dev)
            download_bytes = torch.zeros(
                self.num_clients, dtype=torch.float32,
                device=dev).index_put_((ids,), down_slot)
            upload_bytes = torch.zeros(
                self.num_clients, dtype=torch.float32,
                device=dev).index_put_((ids,), up_slot)
            client_last_round = state.client_last_round.index_put(
                (ids,), step_t)

        mine = self._positions(W)
        if mesh is not None:
            # only this rank's clients' data (and tokens) cross to its
            # device
            batch = self._seq_slice({k: v[mine] for k, v in batch.items()})
        batch = self.to_device(batch)
        w = state.ps_weights
        vel_rows = (state.client_velocities[ids]
                    if state.client_velocities is not None else None)
        err_rows = (state.client_errors[ids]
                    if state.client_errors is not None else None)
        # each participant's stale weights advance by the top-k of their
        # lag (the download compression); it trains on those
        used = None
        if mesh is None:
            if cfg.do_topk_down:
                used = client_lib.topk_down_weights(
                    cfg, state.ps_weights, state.client_weights[ids])
                state.client_weights.index_copy_(0, ids, used)
        else:
            # the round's weights cross once: every client reads them
            w = mesh.gather_rows(state.ps_weights)[:cfg.grad_size]
            if cfg.do_topk_down:
                used = self._rows_to_compute(self._mesh_topk_down(state,
                                                                  ids))
            if vel_rows is not None:
                vel_rows = self._rows_to_compute(vel_rows)
            if err_rows is not None:
                err_rows = self._rows_to_compute(err_rows)
            mask, mask_host = mask[mine], mask_host[mine]

        out = self._clients(state, w, ids[mine], batch, mask, mask_host, lr,
                            used, vel_rows, err_rows, slot0=mine.start)
        if mesh is not None:
            # every rank's metrics are the whole round's (the seq shards
            # of a clients index hold the same ones)
            rows = self.clients
            for key in ("results", "n_valid", "client_finite"):
                if out[key] is not None:
                    out[key] = rows.gather_rows(out[key])
            if out["grad_stats"] is not None:
                out["grad_stats"] = {k: rows.gather_rows(v) for k, v in
                                     out["grad_stats"].items()}
            if reduce:
                out["agg"] = self._reduce(out["agg"], step)
        fin = out["client_finite"]
        bad = ~torch.isfinite(out["agg"]).all()
        if mesh is not None:
            bad = mesh.any(bad)
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
        out["client_stats"] = (self._client_summary(out, down_slot, up_slot)
                               if observe else None)
        return out

    def _client_summary(self, half: Dict, down_slot, up_slot):
        """The round's per-client quantiles (telemetry/clients.py), or
        None: the loss, the gradient statistics (NaN where the JAX package
        keeps no per-client gradient) and the slots' bytes."""
        if not self._client_stats:
            return None
        W = half["results"].shape[0]
        per_client = {"loss": half["results"][:, 0]}
        if half["grad_stats"] is not None:
            per_client.update(half["grad_stats"])
        else:
            nan = torch.full((W,), float("nan"), device=self.device)
            per_client.update({k: nan for k in CLIENT_GRAD_KEYS})
        if self.cfg.track_bytes:
            per_client["upload_bytes"] = up_slot
            per_client["download_bytes"] = down_slot
        return summarize_per_client(per_client, half["n_valid"])

    def _lr_block(self, lr: torch.Tensor) -> torch.Tensor:
        """A (d,) rate vector as this rank's d_pad/n block (the padding's
        rate 1 multiplies an update that is 0 there); a scalar as is."""
        if not lr.ndim or self.mesh is None:
            return lr
        return self._block(lr, "dense", fill=1.0)

    def _server_tail(self, state: FedState, agg: torch.Tensor,
                     lr: torch.Tensor, step_t: torch.Tensor):
        """The round's server half on the normalized aggregate, shared by
        ``round``, ``commit`` and ``decode``: ``(update, Vvelocity,
        Verror, support mask, coord_last_update, bad)``; on a mesh the
        update, the dense vectors and the mask are the rank's blocks (the
        sharded tail's tables its columns) and ``bad`` holds on every
        rank if it holds on any."""
        cfg, mesh = self.cfg, self.mesh
        noise_gen = (noise_generator(cfg.seed, state.step, 0, self.device)
                     if cfg.do_dp and cfg.dp_mode == "server" else None)
        if mesh is None:
            update, Vvel, Verr, sup_mask = server_update(
                cfg, agg, state.Vvelocity, state.Verror, lr, self.cs,
                noise_gen, self.dense_preimage)
        elif self.sharded_server:
            update, Vvel, Verr = sharded_sketch_server_update(
                cfg, agg, state.Vvelocity, state.Verror,
                self._lr_block(lr), self.cs, mesh=mesh, d_pad=self.d_pad)
            sup_mask = None
        elif cfg.mode == "sketch":
            # the replicated tail: every rank runs the single-device rule
            # on the whole table and keeps its block of the update
            update, Vvel, Verr, sup_mask = server_update(
                cfg, agg, state.Vvelocity, state.Verror, lr, self.cs)
            update = self._block(update, "dense")
        elif cfg.mode == "true_topk":
            update, Vvel, Verr, sup_mask = sharded_topk_update(
                cfg, agg, state.Vvelocity, state.Verror, self._lr_block(lr),
                mesh=mesh, d_pad=self.d_pad)
        else:
            # elementwise rules on the blocks; server DP noise is the
            # single-device draw's block
            noise = (self._block(torch.randn(cfg.grad_size,
                                             generator=noise_gen,
                                             device=self.device), "dense")
                     if noise_gen is not None else None)
            update, Vvel, Verr, sup_mask = server_update(
                cfg, agg, state.Vvelocity, state.Verror, self._lr_block(lr),
                noise=noise)
        coord_last_update = state.coord_last_update
        if cfg.track_bytes:
            coord_last_update = torch.where(update != 0, step_t,
                                            coord_last_update)
        bad = ~torch.isfinite(update).all() | ~torch.isfinite(agg).all()
        if mesh is not None:
            bad = mesh.any(bad)
        return update, Vvel, Verr, sup_mask, coord_last_update, bad

    def _whole(self, x: Optional[torch.Tensor], kind: Optional[str]):
        """The single-device form of a rank's block: a dense block
        gathered and cut to d, a table's columns gathered (for the
        signals of a recorded round on a mesh)."""
        if x is None or self.mesh is None or kind in (None, "replicated"):
            return x
        if kind == "dense":
            return self.mesh.gather_rows(x)[:self.cfg.grad_size]
        return self.mesh.gather_cols(x)

    def round(self, state: FedState, client_ids, batch, mask, lr,
              observe: bool = True) -> Tuple[FedState, Dict]:
        """One federated round. ``client_ids`` (W,) names the round's
        clients, ``batch`` leaves are (W, B, ...), ``mask`` is (W, B) and
        ``lr`` a scalar; numpy arrays or tensors. The participants' rows of
        ``state.client_velocities``, ``state.client_errors`` and
        ``state.client_weights`` are written in place (the JAX package
        donates the state likewise); the rest of the new state is new
        tensors. The metrics hold ``defense`` (the four defense scalars
        and ``nonfinite_clients``, NaN where not applicable) when a
        robustness flag is on, and ``client_finite`` (W,) under the
        quarantine; under telemetry ``signals``, ``layer_signals`` and
        ``client_stats`` (None where off). ``observe=False`` (the driver's
        rounds between records, which nothing reads) skips those three;
        only the ``--signals_exact`` shadow pair advances. On a mesh every
        rank passes the whole round and gets the whole round's metrics."""
        cfg = self.cfg
        ids, mask, mask_host, lr = self._inputs(client_ids, mask, lr)
        half = self._client_half(state, ids, batch, mask, mask_host, lr,
                                 observe)
        total = torch.clamp(half["n_valid"].sum(), min=1.0)
        agg = half["agg"] / total
        update, Vvel, Verr, sup_mask, coord_last_update, bad = \
            self._server_tail(state, agg, lr, half["step_t"])
        sig_dense = (half["sig_dense"] / total
                     if half["sig_dense"] is not None else None)
        signals = layer_signals = None
        sig_vel, sig_err = state.sig_Vvelocity, state.sig_Verror
        if (self._signals or self._layer_signals) and observe:
            kind = self.shard_of["Vvelocity"] if self.mesh else None
            w = dict(agg=self._whole(agg, kind),
                     update=self._whole(update, "dense"),
                     Vvel_prev=self._whole(state.Vvelocity, kind),
                     Verr_prev=self._whole(state.Verror, kind),
                     Vvel_new=self._whole(Vvel, kind),
                     Verr_new=self._whole(Verr, kind))
        if self._signals and observe:
            signals, sig_vel, sig_err = round_signals(
                cfg, **w, cs=self.cs, dense_agg=sig_dense,
                sig_vel=state.sig_Vvelocity, sig_err=state.sig_Verror)
        elif self._signals_shadow:
            sig_vel, sig_err, _ = shadow_step(cfg, sig_dense, update,
                                              sig_vel, sig_err)
        if self._layer_signals and observe:
            layer_signals = self._layer_signals_of(
                state, w["agg"], w["update"], w["Verr_new"], sig_dense,
                sig_err, w["Vvel_prev"], w["Verr_prev"])
        vel_new, err_new = half["vel"], half["err"]
        if self.mesh is not None:
            if vel_new is not None:
                vel_new = self._rows_to_home(vel_new)
            if err_new is not None:
                err_new = self._rows_to_home(err_new)
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
            nan_round=nan_round, defense_ref=half["defense_ref"],
            sig_Vvelocity=sig_vel, sig_Verror=sig_err)
        results = half["results"]
        return new_state, {"results": (results[:, 0], results[:, 1]),
                           "n_valid": half["n_valid"],
                           "download_bytes": half["download_bytes"],
                           "upload_bytes": half["upload_bytes"],
                           "signals": signals,
                           "layer_signals": layer_signals,
                           "client_stats": half["client_stats"],
                           "defense": half["defense"],
                           "client_finite": half["client_finite"]}

    def _layer_signals_of(self, state: FedState, agg, update, Verr,
                          sig_dense, sig_err_new, Vvel_prev, Verr_prev
                          ) -> Dict:
        """The round's layer signals, from the same quantities as the
        scalar signals: the dense gradient and error where the round holds
        them, and under --signals_exact the dense pre-feedback error that
        ``topk_overlap`` ranks."""
        cfg = self.cfg
        dense = cfg.mode != "sketch" or self.dense_preimage
        grad_dense = (agg if dense
                      else sig_dense if self._layer_grad_mass else None)
        err_dense = Verr if dense else sig_err_new
        err_pre = None
        if cfg.signals_exact:
            rho = cfg.virtual_momentum
            if state.sig_Verror is not None and sig_dense is not None:
                err_pre = (state.sig_Verror + sig_dense
                           + rho * state.sig_Vvelocity)
            elif cfg.mode == "true_topk" or (cfg.mode == "sketch"
                                             and dense):
                err_pre = (Verr_prev + agg
                           + rho * Vvel_prev)[: cfg.grad_size]
        return layer_group_signals(cfg, spec=self.group_spec, update=update,
                                   grad_dense=grad_dense,
                                   err_dense=err_dense, err_pre=err_pre)

    # ------------------------------- the split round (async, overlap)

    def cohort(self, state: FedState, client_ids, batch, mask, lr,
               observe: bool = True) -> Tuple[FedState, Dict]:
        """The client half of the round (``--async_agg``,
        ``--decode_overlap``): advances only the dispatch-time state
        (``client_last_round``, ``nan_round``, the normclip ring) and
        returns the payload: ``sum`` (the unnormalized aggregate; on a
        mesh reduced over the ranks, except under the sharded tail with
        ``--decode_overlap``, where it is the rank's partial table and
        ``decode`` reduces it), ``n_total`` (its datum count), the
        round's per-client results, byte vectors and defense metrics;
        ``observe=False`` skips the client statistics, as in ``round``."""
        if not (self.cfg.async_agg or self.cfg.decode_overlap):
            raise ValueError("cohort: the runtime was built without "
                             "--async_agg or --decode_overlap")
        ids, mask, mask_host, lr = self._inputs(client_ids, mask, lr)
        half = self._client_half(state, ids, batch, mask, mask_host, lr,
                                 observe, reduce=not self._reduce_in_decode)
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
                           "client_stats": half["client_stats"],
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

    def _server_fields(self, state: FedState, agg: torch.Tensor, lr):
        """The split round's server half on the normalized aggregate, the
        synchronous round's own ``_server_tail``: the new state's fields
        and the update, velocity and error; ``step`` advances here."""
        lr = self._rate(lr)
        step_t = self._scalar(state.step, torch.int32)
        update, Vvel, Verr, _, coord_last_update, bad = self._server_tail(
            state, agg, lr, step_t)
        nan_round = torch.where((state.nan_round < 0) & bad, step_t,
                                state.nan_round)
        fields = dict(ps_weights=state.ps_weights - update, Vvelocity=Vvel,
                      Verror=Verr, step=state.step + 1,
                      coord_last_update=coord_last_update,
                      nan_round=nan_round)
        return fields, update, Vvel, Verr

    def commit(self, state: FedState, lr) -> Tuple[FedState, Dict]:
        """The server half on the buffer: normalized by its raw datum
        count, the mode's server update, the weights moved, the buffer
        emptied; ``step`` (the server version) advances here."""
        if not self.cfg.async_agg:
            raise ValueError("commit: the runtime was built without "
                             "--async_agg")
        agg = state.async_buffer / torch.clamp(state.async_buffer_n,
                                               min=1.0)
        fields, update, Vvel, Verr = self._server_fields(state, agg, lr)
        new_state = state.replace(
            async_buffer=torch.zeros_like(state.async_buffer),
            async_buffer_n=torch.zeros_like(state.async_buffer_n), **fields)
        mesh = self.mesh
        sq = torch.stack([(update * update).sum(), (Verr * Verr).sum(),
                          (Vvel * Vvel).sum()])
        if mesh is not None:
            # the blocks' squares summed over the ranks (a replicated
            # table counts once)
            table = self.shard_of["Vvelocity"] == "replicated"
            sq = torch.stack([mesh.all_reduce(sq[0]),
                              sq[1] if table else mesh.all_reduce(sq[1]),
                              sq[2] if table else mesh.all_reduce(sq[2])])
            norms = torch.sqrt(sq)
        else:
            norms = torch.stack([torch.linalg.norm(update),
                                 torch.linalg.norm(Verr),
                                 torch.linalg.norm(Vvel)])
        return new_state, {"update_norm": norms[0], "error_norm": norms[1],
                           "velocity_norm": norms[2],
                           "buffer_n": state.async_buffer_n}

    def decode(self, state: FedState, cohort_sum: torch.Tensor, n_total,
               lr) -> FedState:
        """The server half of the ``--decode_overlap`` split round (the
        JAX package's ``_decode_step``): the commit without the buffer, on
        the cohort's sum; with the sharded tail it first reduces the
        ranks' partial tables (the cohort left them), as the synchronous
        round does. Returns the new state."""
        if not self.cfg.decode_overlap:
            raise ValueError("decode: the runtime was built without "
                             "--decode_overlap")
        if self._reduce_in_decode:
            # the round's draws: step has not advanced since the cohort
            cohort_sum = self._reduce(cohort_sum, state.step)
        agg = cohort_sum / torch.clamp(
            torch.as_tensor(n_total, dtype=torch.float32,
                            device=self.device), min=1.0)
        fields, _, _, _ = self._server_fields(state, agg, lr)
        return state.replace(**fields)

    def val(self, state: FedState, batch, mask):
        """Masked evaluation on the current weights: ``((loss, acc),
        n_valid)``. On a mesh the items pad to a multiple of its size
        (the padding masked out), each rank evaluates its share with the
        whole weights, and the shares' means recombine weighted by their
        valid items, added in rank order (the JAX package's
        ``_val_step_sharded``)."""
        mask = torch.as_tensor(mask, device=self.device, dtype=torch.bool)
        batch = self.to_device(batch)
        if self.mesh is None:
            return self._val_fn(state.ps_weights, batch, mask)
        n, N = self.n_shards, mask.shape[0]
        per = -(-N // n)
        lo, hi = self.rank * per, min((self.rank + 1) * per, N)
        w = self.flat_weights(state)
        if hi > lo:
            (loss, acc), cnt = self._val_fn(
                w, {k: v[lo:hi] for k, v in batch.items()}, mask[lo:hi])
        else:
            loss = acc = cnt = torch.zeros((), device=self.device)
        part = torch.stack([loss * cnt, acc * cnt, cnt])
        num = self.mesh.all_reduce(part)
        safe = torch.clamp(num[2], min=1.0)
        return (num[0] / safe, num[1] / safe), num[2]

    def flat_weights(self, state: FedState) -> torch.Tensor:
        """The true-d flat weight vector (the mesh's blocks gathered and
        its padding cut off, on every rank)."""
        if self.mesh is None:
            return state.ps_weights
        return self.mesh.gather_rows(state.ps_weights)[:self.cfg.grad_size]
