"""Segment (per-group) reductions over the flat federated vector, the
port's counterpart of the JAX package's ``ops/segments.py``.

The layer-wise attribution (telemetry/layer_signals.py) reduces dense
(d,) round quantities (the aggregated gradient, the applied update, the
error accumulator) into one small (G,) vector per signal, G the number
of named parameter groups. The JAX package scatter-adds them through a
(d_pad,) int32 group-id map. On the card that is d float atomics onto
about ten addresses, which serialise and change their summation order
from run to run, and the map alone takes 368 MB at GPT-2's d.

Every group is a union of contiguous coordinate ranges (whole leaves,
or the per-block slices of the stacked GPT-2 leaves). So a
:class:`SegmentPlan` reduces each range through a view of the flat
vector (runs of equal-length neighbouring ranges as one (n, length)
view, a kernel each), then sums the ranges of each group in ascending
coordinate order with one gather and one row sum: no atomics, no d-sized
map, the same bits every run. A group id is kept only where
:func:`group_sum_at` needs it, for the k coordinates it is given.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


class SegmentPlan:
    """The reduction plan of ``ranges``, ``(start, end, group)``
    half-open coordinate ranges that tile ``[0, d)``: neighbouring ranges
    of one group are merged, and runs of contiguous ranges of equal
    length become ``pieces`` ``(start, count, length)``, each reduced as
    one (count, length) view."""

    def __init__(self, ranges: Sequence[Tuple[int, int, int]],
                 n_groups: int, d: int):
        merged: List[Tuple[int, int, int]] = []
        for start, end, g in sorted(ranges):
            if merged and merged[-1][2] == g and merged[-1][1] == start:
                merged[-1] = (merged[-1][0], end, g)
            else:
                merged.append((int(start), int(end), int(g)))
        pieces: List[Tuple[int, int, int]] = []
        for start, end, _ in merged:
            n = end - start
            if (pieces and pieces[-1][2] == n
                    and pieces[-1][0] + pieces[-1][1] * n == start):
                pieces[-1] = (pieces[-1][0], pieces[-1][1] + 1, n)
            else:
                pieces.append((start, 1, n))
        self.ranges = tuple(merged)
        self.pieces = tuple(pieces)
        self.n_groups = int(n_groups)
        self.d = int(d)
        members: List[List[int]] = [[] for _ in range(self.n_groups)]
        for i, (_, _, g) in enumerate(merged):
            members[g].append(i)
        width = max([len(m) for m in members] + [1])
        # row g lists group g's ranges, padded with the index of a zero
        self._gather = np.asarray(
            [m + [len(merged)] * (width - len(m)) for m in members],
            np.int64).reshape(self.n_groups, width)
        self._starts = np.asarray([s for s, _, _ in merged], np.int64)
        self._group_of = np.asarray([g for _, _, g in merged], np.int64)
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """The plan's index tensors on ``device`` (made once a device)."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {
                name: torch.as_tensor(arr, device=device)
                for name, arr in (("gather", self._gather),
                                  ("starts", self._starts),
                                  ("group_of", self._group_of))}
        return self._on[device]


def _range_values(x: torch.Tensor, plan: SegmentPlan,
                  reduce: Callable[[torch.Tensor], torch.Tensor]
                  ) -> torch.Tensor:
    """``reduce`` of each range of ``x`` (d,), in range order: one call a
    piece, on a (count, length) view, reducing along its rows."""
    if x.shape[0] != plan.d:
        raise ValueError(f"vector of length {x.shape[0]}; the groups tile "
                         f"{plan.d} coordinates")
    return torch.cat([reduce(x.narrow(0, s, c * n).reshape(c, n))
                      for s, c, n in plan.pieces])


def _to_groups(vals: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Sums the per-range ``vals`` (R,) or (R, C) into their groups: one
    gather of each group's ranges (ascending) and one row sum."""
    pad = vals.new_zeros((1,) + tuple(vals.shape[1:]))
    gather = plan.tensors(vals.device)["gather"]
    return torch.cat((vals, pad))[gather].sum(dim=1)


def group_sq_mass(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Per-group squared L2 mass, ``out[g] = sum of x^2 over group g``:
    each range's norm (no d-sized square is formed), squared. The masses
    sum to ``||x||^2`` up to summation order."""
    x = x.to(torch.float32)
    return _to_groups(_range_values(
        x, plan, lambda v: torch.linalg.vector_norm(v, dim=1).square()),
        plan)


def group_count(mask: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Per-group count of the nonzero (True) coordinates of ``mask``, as
    float32; the counts sum to nnz(mask)."""
    counts = _range_values(
        mask, plan,
        lambda v: v.ne(0).view(torch.uint8).sum(dim=1, dtype=torch.int32))
    return _to_groups(counts, plan).to(torch.float32)


def group_sum_cols(cols: Sequence[torch.Tensor],
                   plan: SegmentPlan) -> torch.Tensor:
    """Per-group sums of C columns, each a (d,) vector: (G, C), ``out[g,
    j] = sum of cols[j] over group g``."""
    vals = torch.stack([
        _range_values(c.to(torch.float32), plan, lambda v: v.sum(dim=1))
        for c in cols], dim=1)
    return _to_groups(vals, plan)


def group_sum_at(vals: torch.Tensor, idx: torch.Tensor,
                 plan: SegmentPlan) -> torch.Tensor:
    """Segment sum of ``vals`` over the groups owning the coordinates
    ``idx`` (the k top-k winners): ``out[g] = sum of vals[j] with idx[j]
    in group g``. The group of each winner comes from a search of the
    ranges' starts; the k values are added in one ``index_add_`` (whole
    numbers, as the callers pass, add up exactly in any order)."""
    t = plan.tensors(idx.device)
    r = torch.searchsorted(t["starts"], idx.to(torch.int64),
                           right=True) - 1
    out = torch.zeros(plan.n_groups, dtype=torch.float32, device=idx.device)
    return out.index_add_(0, t["group_of"][r], vals.to(torch.float32))
