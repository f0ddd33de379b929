"""Compression-signal health, computed on the device inside the round:
the port's counterpart of the JAX package's ``telemetry/signals.py``.

FetchSGD's claim lives inside the compressed channel (count-sketch
collision noise, error-feedback growth, heavy-hitter recovery), and those
quantities can diverge for rounds while the loss still prints finite
numbers. Everything here is a reduction on the device appended to the
round's metrics: nothing leaves the device until the driver's record
round, where the whole metrics tree crosses in one copy
(:func:`tree_to_host`).

The signal set (float32 scalars; NaN = not applicable here, serialised
as null):

- ``grad_norm``        : L2 of the aggregated transmitted quantity in
                         its own space (dense L2, or table Frobenius)
- ``grad_true_norm``   : L2 of the dense aggregated gradient where one
                         exists (dense modes, the sketch deferred
                         encode, the dense pre-image state)
- ``grad_l2estimate``  : sketch mode's ``cs.l2estimate`` of the
                         aggregated table (the median of the r row
                         norms): its gap to grad_true_norm is the
                         collision-noise proxy
- ``velocity_norm`` / ``error_norm``: L2 / Frobenius of the NEW server
                         velocity and error
- ``error_l2estimate`` : the table-space error's estimated norm
- ``update_norm``      : L2 of the applied update
- ``support_density``  : nnz(update) / d
- ``topk_overlap``     : |support(update) & exact top-k(dense error)| / k
                         under ``--signals_exact``: free where the server
                         holds a dense error (true_topk, the dense
                         pre-image sketch state); for the table state a
                         dense SHADOW error pair (``sig_Vvelocity``,
                         ``sig_Verror`` on FedState) is carried, on the
                         deferred-encode route only, where the dense
                         summed gradient exists.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from commefficient_torch.ops.topk import topk_with_idx

SIGNAL_KEYS = (
    "grad_norm", "grad_true_norm", "grad_l2estimate",
    "velocity_norm", "error_norm", "error_l2estimate",
    "update_norm", "support_density", "topk_overlap",
)


def _l2(x: torch.Tensor) -> torch.Tensor:
    """L2 (Frobenius for a table) in float32, one reduction."""
    return torch.linalg.vector_norm(x.to(torch.float32))


def _share(mask: torch.Tensor) -> torch.Tensor:
    """The share of True in ``mask``, as the JAX package's float32 mean
    rounds it: the count times the float32 reciprocal of the length."""
    return (torch.count_nonzero(mask).to(torch.float32)
            * np.float32(1.0 / mask.numel()))


def _topk_overlap(update: torch.Tensor, dense_err: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Share of the exact top-k coordinates of ``dense_err`` (by
    magnitude, ``lax.top_k``'s order: ops/topk.py) that the update's
    support recovered."""
    _, idx = topk_with_idx(dense_err, k)
    return _share(update[idx] != 0)


def round_signals(cfg, *, agg: torch.Tensor, update: torch.Tensor,
                  Vvel_prev: torch.Tensor, Verr_prev: torch.Tensor,
                  Vvel_new: torch.Tensor, Verr_new: torch.Tensor, cs=None,
                  dense_agg: Optional[torch.Tensor] = None,
                  sig_vel: Optional[torch.Tensor] = None,
                  sig_err: Optional[torch.Tensor] = None,
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """The round's signal dict. ``agg`` and ``update`` are the server
    update's input (normalised) and output; ``dense_agg`` is the dense
    aggregated gradient where one exists outside the transmitted space
    (the sketch deferred encode); ``sig_vel``/``sig_err`` the dense shadow
    pair (or None). Returns ``(signals, new sig_vel, new sig_err)``."""
    d = cfg.grad_size
    nan = torch.full((), float("nan"), device=update.device)
    upd = update[:d] if update.ndim == 1 else update
    sig: Dict[str, torch.Tensor] = {
        "update_norm": _l2(upd),
        "support_density": _share(upd != 0),
        "velocity_norm": _l2(Vvel_new),
        "error_norm": _l2(Verr_new),
        "grad_norm": _l2(agg),
    }
    if agg.ndim == 2:
        sig["grad_l2estimate"] = cs.l2estimate(agg).to(torch.float32)
        sig["error_l2estimate"] = cs.l2estimate(Verr_new).to(torch.float32)
        sig["grad_true_norm"] = (_l2(dense_agg) if dense_agg is not None
                                 else nan)
    else:
        sig["grad_l2estimate"] = nan
        sig["error_l2estimate"] = nan
        # the dense transmitted space: the aggregate is the gradient
        sig["grad_true_norm"] = sig["grad_norm"]
    overlap = nan
    new_vel, new_err = sig_vel, sig_err
    if getattr(cfg, "signals_exact", False):
        rho = cfg.virtual_momentum
        if sig_err is not None:
            new_vel, new_err, err_pre = shadow_step(cfg, dense_agg, upd,
                                                    sig_vel, sig_err)
            overlap = _topk_overlap(upd, err_pre, cfg.k)
        elif cfg.mode == "true_topk" or (cfg.mode == "sketch"
                                         and agg.ndim != 2):
            # the server's own error is dense: its pre-feedback value
            # from the previous state (the new one is post-zeroing)
            err_pre = (Verr_prev + agg + rho * Vvel_prev)[: upd.shape[0]]
            overlap = _topk_overlap(upd, err_pre, cfg.k)
    sig["topk_overlap"] = overlap
    return sig, new_vel, new_err


def shadow_step(cfg, dense_agg: torch.Tensor, update: torch.Tensor,
                sig_vel: torch.Tensor, sig_err: torch.Tensor):
    """One round of the table state's dense shadow (``--signals_exact``):
    the exact-state server's error feedback without the encode and
    decode, zeroed on the update's support. Returns ``(new sig_vel, new
    sig_err, the pre-feedback error)``; the last is ``topk_overlap``'s
    reference."""
    shadow_vel = dense_agg + cfg.virtual_momentum * sig_vel
    err_pre = sig_err + shadow_vel
    supp = update != 0
    new_err = err_pre.masked_fill(supp, 0.0)
    if cfg.error_decay < 1.0:
        new_err = cfg.error_decay * new_err
    return shadow_vel.masked_fill(supp, 0.0), new_err, err_pre


def tree_to_host(tree: Any) -> Any:
    """Every tensor of a metrics tree (dicts, lists, tuples; None kept) as
    numpy, in ONE device-to-host copy: the leaves are flattened into one
    float32 vector (their widest type here; the integer leaves are client
    slots, exact in it), copied, and cut back into their shapes and
    dtypes."""
    leaves = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves]
                     ).cpu().numpy()
    it = iter(leaves)
    pos = [0]

    def rebuild(x):
        if isinstance(x, torch.Tensor):
            t = next(it)
            n = t.numel()
            part = flat[pos[0]: pos[0] + n]
            pos[0] += n
            dtype = str(t.dtype).replace("torch.", "")
            if dtype == "bfloat16":
                dtype = "float32"
            return part.astype(dtype).reshape(tuple(t.shape))
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(v) for v in x)
        return x

    return rebuild(tree)


def signals_to_host(signals: Optional[Dict[str, Any]]) -> Dict[str, float]:
    """A signals dict as plain floats for the telemetry event (tensors
    are fetched in one copy, :func:`tree_to_host`)."""
    if not signals:
        return {}
    return {k: float(v) for k, v in tree_to_host(signals).items()}
