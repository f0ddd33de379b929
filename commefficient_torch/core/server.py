"""Server update rules of the five federated modes, counterpart of the JAX
package's ``core/server.py``: ``validate_mode_combo``, the measured
divergence warnings (``check_regime_health``, ``validate_regimes``) and
``server_update``.

Every rule is ``(gradient, Vvelocity, Verror, lr) -> (update, Vvelocity',
Verror', support_mask_or_None)``: ``gradient`` is the round's aggregate,
already divided by the round's datum count; the update comes back
multiplied by ``lr`` (fedavg's by 1: its clients applied the rate). The
sketch rules keep momentum and error in (r, c) table space; the
dense-preimage and SRHT branches of the JAX package are not ported.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import torch

from commefficient_torch.config import FedConfig
from commefficient_torch.ops.topk import topk

# The JAX package's measured divergence envelopes (its core/server.py):
# local_topk with local error learns only with the rate cut far below
# the dense-stable value, and the subtract rule diverged at every
# GPT-2-scale collision load d/c ~ 176 while d/c ~ 13 is its win.
LOCAL_TOPK_EF_STABLE_LR = 0.02
SUBTRACT_EF_STABLE_LOAD = 100.0


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
            and cfg.grad_size
            and cfg.grad_size / cfg.num_cols >= SUBTRACT_EF_STABLE_LOAD):
        warnings.append(
            f"--sketch_ef subtract at collision load d/c = "
            f"{cfg.grad_size / cfg.num_cols:.0f} (d={cfg.grad_size}, "
            f"c={cfg.num_cols}) is in the MEASURED divergent regime "
            "(every GPT-2-scale arm at d/c ~ 176 diverged). Use d/c < "
            f"{SUBTRACT_EF_STABLE_LOAD:.0f} (raise --num_cols), or the "
            "default --sketch_ef zero")
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


def validate_mode_combo(cfg: FedConfig) -> None:
    """Reject the illegal combinations of mode, error type and momentum
    (the reference's asserts, fed_worker.py:221-228 and
    fed_aggregator.py:484-486, 512, 545, 573-576)."""
    m, e = cfg.mode, cfg.error_type
    if m == "sketch":
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
                  cs=None) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, Optional[torch.Tensor]]:
    """One server step of ``cfg.mode`` (reference
    fed_aggregator.py:469-613). Returns ``(weight_update, Vvelocity',
    Verror', support_mask_or_None)``; the mask is the update's support in
    transmitted space (true_topk: coordinates; the sketch's zero rule:
    table cells)."""
    rho = cfg.virtual_momentum
    Vvel = gradient + rho * Vvelocity
    if cfg.mode == "fedavg":
        # the clients applied the rate; the update is the (momentum of
        # the) averaged weight delta
        return Vvel, Vvel, Verror, None
    if cfg.mode in ("uncompressed", "local_topk"):
        # local_topk: momentum accumulates onto the already sparse sum of
        # the clients' top-k; no virtual error, no masking
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
