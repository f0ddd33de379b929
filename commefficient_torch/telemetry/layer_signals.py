"""Layer-wise compression attribution: per-parameter-group recovery
signals, the port's counterpart of the JAX package's
``telemetry/layer_signals.py``, computed on the device inside the round.

The model's flat vector is partitioned into named groups mapped to
ravel-order coordinate ranges: the port's flat layout
(``models/layers.py FlatModel.layout``, ``(path, shape)`` in the JAX
package's ravel order), so every coordinate lands in the group it has in
the JAX package. The round reduces its dense quantities per group
(ops/segments.py: each range through a view, then the ranges into their
groups in a fixed order):

- ``grad_mass``   : per-group squared L2 of the dense aggregated
                    gradient, where the round holds one (dense modes;
                    sketch only through the dense pre-image state or the
                    deferred-encode capture). Null, never zero, where it
                    does not exist (the fused encode).
- ``update_mass`` : per-group squared L2 of the applied update.
- ``topk_count``  : the update's support landing in the group.
- ``error_mass``  : per-group squared L2 of the new error accumulator,
                    where it is dense (dense modes, the dense pre-image
                    state, or the ``--signals_exact`` shadow pair).
- ``hh_overlap``  : of the exact top-k winners of the dense pre-feedback
                    error that land in the group, the share the update's
                    support recovered (``--signals_exact`` only); NaN for
                    a group that owns no winner this round.

Masses are energies, so the conservation laws are exact up to summation
order: the group masses sum to the whole vector's norm squared, the
support counts to nnz(update).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

LAYER_SIGNAL_KEYS = (
    "grad_mass", "update_mass", "topk_count", "error_mass", "hh_overlap",
)

SIGNAL_GROUP_MODES = ("coarse", "leaf", "off")

# group_starvation rule thresholds (telemetry/health.py + teleview
# layers share these): a group holding more than MASS_SHARE of the
# round's dense gradient energy while winning less than WIN_SHARE of
# the k top-k coordinates, for WINDOW consecutive observations, is
# starving — its gradient signal exists but never crosses the channel.
# WIN_SHARE is calibrated on the committed hard-v2 attribution arms
# (runs/BREAKDOWN_layers.md): at the 5% mass floor a group under 2% of
# k is >= 2.5x under-proportional (the measured starved head group sat
# at 10-50% mass for 1-3% of k); the flagship 2.6x arm flags head once
# late, the 10x arm flags it early and repeatedly — the dose response
# the adaptive controller keys on.
STARVATION_MASS_SHARE = 0.05
STARVATION_WIN_SHARE = 0.02
STARVATION_WINDOW = 4


def _comps(path: str) -> List[str]:
    """Path components of one layout entry, lowercased, with the Flax
    'params' wrapper stripped (the JAX package's ``_comps``)."""
    return [c.lower() for c in path.split("/") if c.lower() != "params"]


@dataclass(frozen=True)
class GroupSpec:
    """Named parameter groups over the ravel-order coordinate line.

    ``names``/``sizes`` are parallel (G,) tuples; ``ranges`` holds
    ``(start, end, group_index)`` half-open coordinate ranges in ravel
    order (a group may own several: the per-block splits of the stacked
    transformer leaves, interleaved norm and bias leaves). The ranges
    tile [0, d) exactly."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    ranges: Tuple[Tuple[int, int, int], ...]
    d: int

    @property
    def n_groups(self) -> int:
        return len(self.names)

    def gid(self, d_pad: Optional[int] = None):
        """The (d_pad,) int32 group-id map of the JAX package (padding
        coordinates map to ``n_groups``). The port's reductions do not
        use it; the tests compare with the JAX package through it."""
        import numpy as np
        d_pad = self.d if d_pad is None else int(d_pad)
        gid = np.full((d_pad,), self.n_groups, np.int32)
        for start, end, g in self.ranges:
            gid[start:end] = g
        return gid

    @functools.cached_property
    def plan(self):
        """The ranges' reduction plan (ops/segments.py SegmentPlan)."""
        from commefficient_torch.ops.segments import SegmentPlan
        return SegmentPlan(self.ranges, self.n_groups, self.d)


def _coarse_name(comps: List[str], ndim: int) -> str:
    """Coarse group of one NON-stacked leaf by path pattern: embeddings
    and heads by name, everything else stage-level (the first module
    component) with 1-D leaves (biases/norms/scales) split into the
    stage's norm-bias group — the small-mass tensors the starvation
    rule exists to watch."""
    last = comps[-1] if comps else ""
    for c in comps:
        if c in ("wte", "wpe") or "embed" in c:
            return "embed"
    for c in comps:
        if "head" in c or c in ("classifier", "score", "logits"):
            return "head"
    top = comps[0] if comps else "params"
    if ndim <= 1 or last in ("bias", "scale", "b", "g"):
        return f"{top}/norm-bias"
    return top


def _block_sub(comps: List[str]) -> str:
    """Sub-group of one scan-stacked transformer-block leaf:
    attn / mlp / norm-bias (models/gpt2.py's h/block layout)."""
    last = comps[-1]
    mods = comps[comps.index("block") + 1: -1] or [last]
    mod = mods[0]
    if mod.startswith("ln") or "norm" in mod or last in ("bias", "scale"):
        return "norm-bias"
    if "mlp" in mod or "fc" in mod:
        return "mlp"
    if "attn" in mod or mod == "c_proj":
        return "attn"
    return mod


def make_group_spec(layout: Sequence[Tuple[str, Sequence[int]]],
                    mode: str = "coarse") -> GroupSpec:
    """Partition a flat layout (``(path, shape)`` in ravel order) into
    named coordinate groups, as the JAX package partitions the parameter
    pytree.

    ``mode="coarse"``: path-pattern groups: embed / h<i>/attn / h<i>/mlp
    / h<i>/norm-bias / head for the GPT-2 layout (its stacked ``h/block``
    leaves split along their leading block dim into per-block ranges),
    stage-level (the top module, with a norm-bias split for 1-D leaves)
    for conv nets. ``mode="leaf"``: one group per leaf, named by its
    path."""
    if mode not in ("coarse", "leaf"):
        raise ValueError(f"signal_groups mode {mode!r} not in "
                         f"{SIGNAL_GROUP_MODES[:-1]}")
    names: List[str] = []
    index: Dict[str, int] = {}
    ranges: List[Tuple[int, int, int]] = []

    def gidx(name: str) -> int:
        if name not in index:
            index[name] = len(names)
            names.append(name)
        return index[name]

    off = 0
    for path, shape in layout:
        comps = _comps(path)
        n = 1
        for s in shape:
            n *= int(s)
        if mode == "leaf":
            ranges.append((off, off + n, gidx("/".join(comps) or "leaf")))
        elif "block" in comps and len(shape) >= 2:
            # stacked transformer blocks: block b owns the contiguous
            # sub-range [off + b chunk, off + (b + 1) chunk) of the leaf
            n_blocks = int(shape[0])
            chunk = n // n_blocks
            sub = _block_sub(comps)
            for b in range(n_blocks):
                ranges.append((off + b * chunk, off + (b + 1) * chunk,
                               gidx(f"h{b}/{sub}")))
        else:
            ranges.append((off, off + n,
                           gidx(_coarse_name(comps, len(shape)))))
        off += n
    sizes = [0] * len(names)
    for start, end, g in ranges:
        sizes[g] += end - start
    return GroupSpec(names=tuple(names), sizes=tuple(sizes),
                     ranges=tuple(ranges), d=off)


def layer_group_signals(cfg, *, spec: GroupSpec, update, grad_dense=None,
                        err_dense=None, err_pre=None) -> Dict[str, Any]:
    """The round's per-group signal dict, on the device. ``update`` is
    the applied update (d,); ``grad_dense``/``err_dense`` the dense
    aggregated gradient and new dense error accumulator where the round
    holds them (None: the field is null); ``err_pre`` the dense
    pre-feedback error of ``--signals_exact`` (the reference of
    ``topk_overlap``). Returns ``{key: (G,) float32 tensor or None}``."""
    import torch

    from commefficient_torch.ops.segments import (group_count,
                                                  group_sq_mass,
                                                  group_sum_at)
    from commefficient_torch.ops.topk import topk_with_idx

    plan = spec.plan
    out: Dict[str, Any] = {
        "grad_mass": (group_sq_mass(grad_dense, plan)
                      if grad_dense is not None else None),
        "update_mass": group_sq_mass(update, plan),
        "topk_count": group_count(update, plan),
        "error_mass": (group_sq_mass(err_dense, plan)
                       if err_dense is not None else None),
        "hh_overlap": None,
    }
    if err_pre is not None:
        # the exact top-k winners of the dense pre-feedback error, by
        # owning group: win = winners a group, rec = winners the update's
        # support recovered
        _, idx = topk_with_idx(err_pre, cfg.k)
        win = group_sum_at(torch.ones(idx.shape, device=idx.device), idx,
                           plan)
        rec = group_sum_at(update[idx] != 0, idx, plan)
        out["hh_overlap"] = torch.where(
            win > 0, rec / torch.clamp(win, min=1.0),
            torch.full_like(win, float("nan")))
    return out


def layer_signals_to_host(layer_signals: Optional[Dict[str, Any]]
                          ) -> Dict[str, Optional[List[float]]]:
    """A ``metrics['layer_signals']`` dict as per-group float lists for
    the telemetry event (tensors fetched in one copy). None fields stay
    None (null); NaN entries serialise as per-entry nulls."""
    from commefficient_torch.telemetry.signals import tree_to_host
    if not layer_signals:
        return {}
    return {k: ([float(x) for x in v.reshape(-1)] if v is not None
                else None)
            for k, v in tree_to_host(layer_signals).items()}


def starved_groups(groups: List[str], grad_mass, topk_count,
                   mass_share: float = STARVATION_MASS_SHARE,
                   win_share: float = STARVATION_WIN_SHARE
                   ) -> List[Tuple[str, float, float]]:
    """The starvation predicate over ONE emitted layer_signals event,
    dependency-free (health.py's rule and teleview both call it): the
    (name, mass_share, win_share) of every group holding more than
    ``mass_share`` of the round's dense gradient energy while winning
    less than ``win_share`` of the top-k coordinates. Empty when
    grad_mass is unavailable (null) — starvation is measured against
    gradient mass, never guessed."""
    if not grad_mass or not topk_count:
        return []
    gm = [v if isinstance(v, (int, float)) else 0.0 for v in grad_mass]
    tc = [v if isinstance(v, (int, float)) else 0.0 for v in topk_count]
    total_mass = sum(gm)
    total_k = sum(tc)
    if total_mass <= 0 or total_k <= 0:
        return []
    out = []
    for i, name in enumerate(groups):
        ms = gm[i] / total_mass
        ws = tc[i] / total_k
        if ms > mass_share and ws < win_share:
            out.append((str(name), ms, ws))
    return out
