"""Server update rules of the five federated modes, counterpart of the JAX
package's ``core/server.py``: ``validate_mode_combo``, the measured
divergence warnings (``check_regime_health``, ``validate_regimes``) and
``server_update``.

Every rule is ``(gradient, Vvelocity, Verror, lr) -> (update, Vvelocity',
Verror', support_mask_or_None)``: ``gradient`` is the round's aggregate,
already divided by the round's datum count; the update comes back
multiplied by ``lr`` (fedavg's by 1: its clients applied the rate). The
sketch rules keep momentum and error in (r, c) table space, or, under
the dense server state (``dense_preimage``: ``--sketch_server_state
dense``, and always for the SRHT on one device), as (d,) pre-images
that one encode-decode round trip a round passes through the sketch;
the SRHT's table-space rule subtracts in estimate space.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import torch

from commefficient_torch.config import CV_DATASETS, FedConfig
from commefficient_torch.ops.topk import (local_topk_candidates,
                                          merge_topk_candidates,
                                          scatter_winners, topk,
                                          topk_with_idx)

# The JAX package's measured divergence envelopes (its core/server.py):
# local_topk with local error learns only with the rate cut far below
# the dense-stable value, and the subtract rule diverged at every
# GPT-2-scale collision load d/c ~ 176 while d/c ~ 13 is its win.
LOCAL_TOPK_EF_STABLE_LR = 0.02
SUBTRACT_EF_STABLE_LOAD = 100.0
# class counts of the datasets (PersonaChat has none)
CLASSES = {name: n for name, (n, _) in CV_DATASETS.items()}


def check_regime_health(cfg: FedConfig) -> List[str]:
    """Warnings for legal configurations that the JAX package measured
    divergent; needs ``cfg.grad_size`` resolved (the collision load is
    d/c)."""
    warnings: List[str] = []
    if (cfg.mode == "local_topk" and cfg.error_type == "local"
            and cfg.lr_scale is not None
            and cfg.lr_scale > LOCAL_TOPK_EF_STABLE_LR):
        warnings.append(
            f"mode=local_topk with error_type=local at lr_scale="
            f"{cfg.lr_scale} is in the MEASURED divergent regime: local "
            "error feedback at real compression needs the lr cut to "
            f"~{LOCAL_TOPK_EF_STABLE_LR} or below. Cut --lr_scale, or use "
            "error_type=none")
    if (cfg.mode == "sketch" and cfg.sketch_ef == "subtract"
            and cfg.sketch_server_state != "dense" and cfg.grad_size
            and cfg.grad_size / cfg.num_cols >= SUBTRACT_EF_STABLE_LOAD):
        warnings.append(
            f"--sketch_ef subtract at collision load d/c = "
            f"{cfg.grad_size / cfg.num_cols:.0f} (d={cfg.grad_size}, "
            f"c={cfg.num_cols}) is in the MEASURED divergent regime "
            "(every GPT-2-scale arm at d/c ~ 176 diverged). Use d/c < "
            f"{SUBTRACT_EF_STABLE_LOAD:.0f} (raise --num_cols), or drop "
            "--sketch_ef subtract and use --sketch_server_state dense, or "
            "the default --sketch_ef zero")
    return warnings


def validate_regimes(cfg: FedConfig) -> None:
    """Print the measured-divergence warnings to stderr; raise under
    ``--strict_regimes``."""
    warnings = check_regime_health(cfg)
    if not warnings:
        return
    if cfg.strict_regimes:
        raise ValueError(
            "--strict_regimes: refusing measured-divergent config:\n  "
            + "\n  ".join(warnings))
    for w in warnings:
        print(f"WARNING: {w}", file=sys.stderr)


def validate_defense_combo(cfg: FedConfig, mesh=None,
                           seq_axis=None) -> None:
    """The JAX package's refusals of the robustness flags (its
    ``:112-140``): a seq axis refuses them all (a rank holds a partial of
    each client's upload); trim needs every client's whole upload on one
    device, so a mesh refuses it (normclip's cross-rank cost is one
    W-sized all-gather of norms); label flipping needs a classification
    dataset."""
    robust = (cfg.defense != "none" or cfg.adversary != "none"
              or cfg.nonfinite_action != "abort")
    if robust and seq_axis is not None:
        raise ValueError(
            "--adversary/--defense/--nonfinite_action quarantine are "
            "unsupported with a seq mesh axis: they act on PER-CLIENT "
            "transmitted quantities, and a seq-sharded round only ever "
            "holds per-shard partials of them")
    if robust and cfg.defense == "trim" and mesh is not None:
        raise ValueError(
            "--defense trim needs the per-coordinate cross-client sort, "
            "which requires every client's full transmitted vector on "
            "one device — unavailable on a mesh (the client axis is "
            "sharded). Use --defense normclip on a mesh (its cross-shard "
            "cost is one W-sized norm all-gather), or drop the mesh.")
    if cfg.adversary == "labelflip" and CLASSES.get(cfg.dataset_name,
                                                    0) < 2:
        n_cls = CLASSES.get(cfg.dataset_name, 0)
        raise ValueError(
            f"--adversary labelflip needs a classification dataset "
            f"with >= 2 classes; {cfg.dataset_name!r} has "
            f"{n_cls if n_cls > 0 else 'no fixed class count'} — use "
            "signflip/scale/noise/nan for update-space attacks "
            "instead")


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-d tensor, bit for bit: NaNs skipped, the
    mean of the two middle values of an even count (``torch.nanmedian``
    returns the lower one), NaN when every value is NaN. The sort is
    stable with -0 == +0, as ``jnp.sort`` orders them."""
    x = torch.where(torch.isnan(x), x.new_tensor(float("nan")), x)
    s = torch.sort(x, stable=True).values
    count = (~torch.isnan(s)).sum().to(torch.float32)
    q = 0.5 * (count - 1.0)
    last = count - 1.0
    low = torch.clamp(torch.minimum(torch.floor(q), last), min=0.0)
    high = torch.clamp(torch.minimum(torch.ceil(q), last), min=0.0)
    return (s[low.to(torch.int64)] + s[high.to(torch.int64)]) * 0.5


def robust_aggregate(cfg: FedConfig, tx: torch.Tensor,
                     n_valid: torch.Tensor,
                     ref_thresh: Optional[torch.Tensor] = None, mesh=None):
    """The JAX package's robust aggregation (``--defense``) of the (W, ...)
    uploads ``tx`` (each its client's upload times its datum count
    ``n_valid``); every statistic is over the per-datum update tx_i / n_i.
    Returns ``(agg, cur_med, stats)``: ``agg`` in place of
    ``tx.sum(0)``, ``cur_med`` the round's median per-datum norm (normclip
    alone, the ring's feed) and the four defense scalars.

    - normclip: each client's per-datum norm clipped to ``ref x
      defense_clip_mult``, ``ref`` the ring's median ``ref_thresh`` (NaN
      while the ring is cold: the round's own median).
    - trim: per coordinate, the live slots' values sorted (a zero-datum
      slot holds no vote: pushed to +inf, it sorts after every finite
      value, and a live NaN after it), ranks [t, V - t) averaged, t =
      floor(defense_trim_frac V) in float32, then times the round's
      datum count.

    On a ``mesh`` (normclip alone) ``tx`` and ``n_valid`` are the rank's
    W/n clients: their norms and datum counts cross in one W-sized
    all-gather, every rank computes the median, the factors and the
    scalars over all W as one device does, and ``agg`` is the rank's
    partial sum (the round's reduce adds the ranks)."""
    W = tx.shape[0]
    shape = (W,) + (1,) * (tx.ndim - 1)
    nan = tx.new_tensor(float("nan"))
    if cfg.defense == "trim":
        assert mesh is None, "trim is refused on a mesh"
        denom = torch.clamp(n_valid, min=1.0)
        valid = n_valid > 0
        V = valid.sum()
        t = torch.floor(torch.tensor(cfg.defense_trim_frac,
                                     dtype=torch.float32)
                        * V.to(torch.float32)).to(torch.int64)
        u = torch.where(valid.reshape(shape), tx / denom.reshape(shape),
                        tx.new_tensor(float("inf")))
        srt = torch.sort(u, dim=0, stable=True).values
        rank = torch.arange(W, device=tx.device).reshape(shape)
        keep = (rank >= t) & (rank < V - t)
        n_kept = torch.clamp(V - 2 * t, min=1)
        core_mean = torch.where(keep, srt, tx.new_zeros(())).sum(dim=0) \
            / n_kept
        agg = core_mean * n_valid.sum()
        stats = {"clip_frac": nan, "clip_thresh": nan, "clipped_mass": nan,
                 "trim_frac": (2.0 * t / torch.clamp(V, min=1)
                               ).to(torch.float32)}
        return agg, None, stats
    assert cfg.defense == "normclip", cfg.defense
    flat = tx.reshape(W, -1)
    raw, nv, lo = torch.sqrt((flat * flat).sum(dim=1)), n_valid, 0
    if mesh is not None:
        # all W norms and datum counts, in client order
        raw, nv = mesh.gather_cols(torch.stack([raw,
                                                n_valid.to(raw.dtype)]))
        lo = mesh.rank * W
    denom = torch.clamp(nv, min=1.0)
    norms = raw / denom
    usable = (nv > 0) & torch.isfinite(norms)
    cur_med = nanmedian(torch.where(usable, norms, nan))
    ref = cur_med if ref_thresh is None else torch.where(
        torch.isnan(ref_thresh), cur_med, ref_thresh)
    thresh = torch.tensor(cfg.defense_clip_mult, dtype=torch.float32,
                          device=tx.device) * ref
    factors = torch.minimum(tx.new_ones(()),
                            thresh / torch.clamp(norms, min=1e-12))
    factors = torch.where(usable, factors, tx.new_ones(()))
    agg = (tx * factors[lo:lo + W].reshape(shape)).sum(dim=0)
    n_clipped = ((factors < 1.0) & usable).sum().to(torch.float32)
    removed_sq = torch.where(usable, ((1.0 - factors) * norms * denom) ** 2,
                             tx.new_zeros(())).sum()
    n_part = usable.sum().to(torch.float32)
    stats = {"clip_frac": n_clipped / torch.clamp(n_part, min=1.0),
             "clip_thresh": thresh, "clipped_mass": torch.sqrt(removed_sq),
             "trim_frac": nan}
    return agg, cur_med, stats


def sharded_sketch_server_update(cfg: FedConfig, agg_shard: torch.Tensor,
                                 Vvel_shard: torch.Tensor,
                                 Verr_shard: torch.Tensor, lr, cs, *,
                                 mesh, d_pad: int):
    """The sketch server tail on rank ``mesh.rank``'s column shards, the
    counterpart of the JAX package's ``sharded_sketch_server_update``
    (its ``core/server.py:470-573``), step for step. ``agg_shard``,
    ``Vvel_shard`` and ``Verr_shard`` are the rank's (r, c/n) columns of
    the datum-normalized aggregate (reduce-scattered) and of the
    momentum and error tables:

    1. momentum and virtual error on the shards (column shards update
       independently);
    2. one table all-gather of the error (stacked with the velocity
       under the subtract rule, which also reads the velocity's
       estimates at the winners);
    3. ``decode_range`` of the rank's ``[i d_pad/n, (i+1) d_pad/n)``
       (K2's range form on the card; coordinates past d decode to 0):
       no rank holds the dense (d,) estimates;
    4. the local top-k candidates, an (n, k_loc) all-gather of values
       and indices and the order-stable merge: the global top-k, bitwise
       the unsharded selection;
    5. ``encode_vals_at`` of the k winners (O(k r)), of which the rank
       keeps its column slice, and the zero or subtract rule on it, then
       ``error_decay``.

    ``lr`` is a scalar or the rank's (d_pad/n,) block of the rate
    vector. Returns ``(update_shard (d_pad/n,), Vvel', Verr')``: the
    update in the dense-vector layout of ``ps_weights``."""
    rho = cfg.virtual_momentum
    Vvel = agg_shard + rho * Vvel_shard
    Verr = Verr_shard + Vvel
    if cfg.sketch_ef == "subtract":
        full = mesh.gather_cols(torch.stack([Verr, Vvel]))
        Verr_full, Vvel_full = full[0], full[1]
    else:
        Verr_full, Vvel_full = mesh.gather_cols(Verr), None
    i, n = mesh.rank, mesh.size
    blk = d_pad // n
    start = i * blk
    ests = cs.decode_range(Verr_full, start, blk)
    loc_vals, loc_idx = local_topk_candidates(ests, cfg.k, start)
    cand_v = mesh.all_gather(loc_vals)
    cand_i = mesh.all_gather(loc_idx)
    win_vals, win_idx = merge_topk_candidates(cand_v, cand_i, cfg.k)
    update = scatter_winners(win_vals, win_idx, start, blk)
    c_loc = Verr.shape[1]
    cols = slice(i * c_loc, (i + 1) * c_loc)
    sk_upd = cs.encode_vals_at(win_vals, win_idx)[:, cols]
    if cfg.sketch_ef == "subtract":
        vel_ests = cs.decode_at(Vvel_full, win_idx)
        Vvel = Vvel - cs.encode_vals_at(vel_ests, win_idx)[:, cols]
        Verr = Verr - sk_upd
    else:
        mask = sk_upd != 0
        Vvel = Vvel.masked_fill(mask, 0.0)
        Verr = Verr.masked_fill(mask, 0.0)
    if cfg.error_decay < 1.0:
        Verr = cfg.error_decay * Verr
    return update * lr, Vvel, Verr


def sharded_topk_update(cfg: FedConfig, agg_shard: torch.Tensor,
                        Vvel_shard: torch.Tensor, Verr_shard: torch.Tensor,
                        lr, *, mesh, d_pad: int):
    """true_topk's server rule on the rank's (d_pad/n,) blocks: the
    global top-k of the error by the candidate merge (an (n, k_loc)
    all-gather), error feedback and momentum masking at the rank's share
    of its support. Returns ``(update, Vvel', Verr', support mask)``,
    each the rank's block; bitwise ``server_update`` of the whole
    vectors, block by block."""
    rho = cfg.virtual_momentum
    Vvel = agg_shard + rho * Vvel_shard
    Verr = Verr_shard + Vvel
    blk = d_pad // mesh.size
    start = mesh.rank * blk
    loc_vals, loc_idx = local_topk_candidates(Verr, cfg.k, start)
    win_vals, win_idx = merge_topk_candidates(
        mesh.all_gather(loc_vals), mesh.all_gather(loc_idx), cfg.k)
    update = scatter_winners(win_vals, win_idx, start, blk)
    mask = update != 0
    Verr = Verr.masked_fill(mask, 0.0)
    Vvel = Vvel.masked_fill(mask, 0.0)
    if cfg.error_decay < 1.0:
        Verr = cfg.error_decay * Verr
    return update * lr, Vvel, Verr, mask


def validate_mode_combo(cfg: FedConfig) -> None:
    """Reject the illegal combinations of mode, error type and momentum
    (the reference's asserts, fed_worker.py:221-228 and
    fed_aggregator.py:484-486, 512, 545, 573-576)."""
    m, e = cfg.mode, cfg.error_type
    if m == "sketch":
        if (cfg.sketch_impl == "rht" and cfg.grad_size
                and cfg.num_rows * cfg.num_cols < cfg.grad_size):
            # the JAX package measured it: at r c < d the SRHT's top-k of
            # noisy estimates grows the error it should shrink
            msg = (f"--sketch_impl rht with r*c ({cfg.num_rows * cfg.num_cols}"
                   f") < grad_size ({cfg.grad_size}) diverges under error "
                   "feedback (measured by the JAX package); use --sketch_impl"
                   " circ or hash to compress: rht is safe only at r*c >= d")
            if not cfg.allow_divergent_rht:
                raise ValueError(msg + ". Pass --allow_divergent_rht to "
                                 "proceed anyway.")
            print(f"WARNING: {msg}", file=sys.stderr)
        if cfg.sketch_ef == "subtract" and (
                cfg.sketch_server_state == "dense"
                or cfg.sketch_impl == "rht"):
            which = ("--sketch_server_state dense"
                     if cfg.sketch_server_state == "dense"
                     else "--sketch_impl rht (its dense transform has no "
                          "table cells)")
            raise ValueError(
                f"--sketch_ef subtract has no effect with {which}: that "
                "server path applies its own error-feedback rule and would "
                "silently ignore the table-space subtract. Drop --sketch_ef "
                "subtract, or use --sketch_impl circ/hash with "
                "--sketch_server_state table")
        if e != "virtual":
            raise ValueError(
                "--mode sketch requires --error_type virtual (FetchSGD): "
                "none would unsketch an all-zero error table and never "
                "update; local error rows are what the reference's worker "
                "forbids for sketch (fed_worker.py:221-222)")
        if cfg.local_momentum > 0:
            raise ValueError("--mode sketch cannot use --local_momentum "
                             "(reference assert fed_worker.py:227-228)")
    elif m == "true_topk":
        if e != "virtual":
            raise ValueError("--mode true_topk requires --error_type "
                             "virtual (reference assert "
                             "fed_aggregator.py:512)")
    elif m == "local_topk":
        if e not in ("local", "none"):
            raise ValueError("--mode local_topk requires --error_type "
                             "local or none (reference assert "
                             "fed_aggregator.py:545)")
    elif m == "fedavg":
        if e != "none" or cfg.local_momentum != 0:
            raise ValueError("--mode fedavg requires --error_type none and "
                             "--local_momentum 0 (reference "
                             "utils.py:225-228)")
    elif m == "uncompressed":
        if e == "local":
            raise ValueError("--mode uncompressed cannot use --error_type "
                             "local (reference assert fed_worker.py:221-222)")


def server_update(cfg: FedConfig, gradient: torch.Tensor,
                  Vvelocity: torch.Tensor, Verror: torch.Tensor, lr,
                  cs=None, noise_gen: Optional[torch.Generator] = None,
                  dense_preimage: bool = False,
                  noise: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """One server step of ``cfg.mode`` (reference
    fed_aggregator.py:469-613). Returns ``(weight_update, Vvelocity',
    Verror', support_mask_or_None)``; the mask is the update's support in
    transmitted space (true_topk: coordinates; the sketch's zero rule:
    table cells). ``noise_gen`` draws the server's DP noise
    (``--dp --dp_mode server``, uncompressed), or ``noise`` is that
    noise already drawn (a mesh rank's block of it); ``dense_preimage``
    keeps the sketch's momentum and error as (d,) vectors."""
    rho = cfg.virtual_momentum
    Vvel = gradient + rho * Vvelocity
    if cfg.mode == "fedavg":
        # the clients applied the rate; the update is the (momentum of
        # the) averaged weight delta
        return Vvel, Vvel, Verror, None
    if cfg.mode == "uncompressed":
        grad = Vvel
        if cfg.do_dp and cfg.dp_mode == "server":
            if noise is None:
                noise = torch.randn(grad.shape, generator=noise_gen,
                                    device=grad.device)
            grad = grad + cfg.noise_multiplier * noise
        return grad * lr, Vvel, Verror, None
    if cfg.mode == "local_topk":
        # momentum accumulates onto the already sparse sum of the clients'
        # top-k; no virtual error, no masking
        return Vvel * lr, Vvel, Verror, None
    if cfg.mode == "true_topk":
        Verr = Verror + Vvel
        update = topk(Verr, cfg.k, approx=cfg.approx_topk)
        mask = update != 0
        # error feedback and momentum factor masking at the support
        Verr = Verr.masked_fill(mask, 0.0)
        Vvel = Vvel.masked_fill(mask, 0.0)
        if cfg.error_decay < 1.0:
            Verr = cfg.error_decay * Verr
        return update * lr, Vvel, Verr, mask
    if cfg.mode != "sketch":
        raise ValueError(f"unknown mode {cfg.mode}")
    if cs is None:
        raise ValueError("sketch mode needs the runtime's sketch")
    Verr = Verror + Vvel
    if dense_preimage:
        # the round trip through the sketch is what the server sees of the
        # error; the pre-images are exact, so error feedback and momentum
        # masking zero exactly the update's support (the true_topk rule
        # with the sketch inserted before the top-k)
        update, upd_idx = topk_with_idx(cs.decode(cs.encode(Verr)), cfg.k,
                                        approx=cfg.approx_topk)
        Verr = Verr.index_fill(0, upd_idx, 0.0)
        Vvel = Vvel.index_fill(0, upd_idx, 0.0)
        if cfg.error_decay < 1.0:
            Verr = cfg.error_decay * Verr
        return update * lr, Vvel, Verr, None
    if cs.dense_transform:
        # the SRHT of a k-sparse update is dense, so zeroing its cells
        # would wipe the table: subtract, in estimate space, the sketch of
        # what the reference zeroes (the update; the velocity's estimates
        # at the support)
        ests_err, ests_vel = cs.decode(torch.stack([Verr, Vvel]))
        update, upd_idx = topk_with_idx(ests_err, cfg.k,
                                        approx=cfg.approx_topk)
        vel_at_support = torch.zeros_like(ests_vel)
        vel_at_support[upd_idx] = ests_vel[upd_idx]
        enc_upd, enc_vel = cs.encode(torch.stack([update, vel_at_support]))
        Verr = Verr - enc_upd
        Vvel = Vvel - enc_vel
        if cfg.error_decay < 1.0:
            Verr = cfg.error_decay * Verr
        return update * lr, Vvel, Verr, None
    update, upd_idx = cs.unsketch_with_idx(Verr, k=cfg.k,
                                           approx=cfg.approx_topk)
    # the k-sparse update's sparse re-encode, O(k r)
    sketched_update = cs.encode_at(update, upd_idx)
    if cfg.sketch_ef == "subtract":
        # subtract the extracted estimates instead of zeroing whole cells,
        # so colliding coordinates keep their error; momentum masking
        # subtracts the velocity's estimates at the support
        Vvel = Vvel - cs.encode_vals_at(cs.decode_at(Vvel, upd_idx),
                                        upd_idx)
        Verr = Verr - sketched_update
        mask = None
    else:
        # the cells the update occupies (reference
        # fed_aggregator.py:593-611)
        mask = sketched_update != 0
        Vvel = Vvel.masked_fill(mask, 0.0)
        Verr = Verr.masked_fill(mask, 0.0)
    if cfg.error_decay < 1.0:
        Verr = cfg.error_decay * Verr
    return update * lr, Vvel, Verr, mask
