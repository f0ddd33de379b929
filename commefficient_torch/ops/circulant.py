"""Circulant count sketch (d -> r x c).

Counterpart of the JAX package's ``ops/circulant.py``. The vector is padded
to m = ceil(d / c) blocks of length c; row j of the table is
``sum_b roll(sigma_j * v_b, s[j][b])``, with signs sigma from the murmur
mixer (ops/hashing.py) and per-(row, block) cyclic shifts drawn once from
the seed. The whole-vector and range encodes and the decode run the
hand-written CUDA kernels K1 and K2 (ops/circulant_kernels.py) on the
card, and so does the O(k r) sparse encode's ordered cell sum
(``ordered_cell_sum``); the O(k r) gather is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from commefficient_torch.ops import circulant_kernels as kernels
from commefficient_torch.ops import wire
from commefficient_torch.ops.hashing import MASK32, signs
from commefficient_torch.ops.topk import (clip_by_l2_norm, median_axis0,
                                          topk_with_idx)


@dataclasses.dataclass(frozen=True)
class CirculantSketch:
    """``shifts``: (r, m) int32 in [0, c); ``sign_keys``: (r,) int32 holding
    the bits of the odd uint32 sign keys. Both live on ``device``."""

    shifts: torch.Tensor
    sign_keys: torch.Tensor
    d: int
    c: int
    r: int

    # a k-sparse vector's table is k r-sparse: the cell rules apply
    dense_transform = False

    @property
    def m(self) -> int:
        return -(-self.d // self.c)

    @property
    def device(self) -> torch.device:
        return self.shifts.device

    @property
    def table_shape(self) -> Tuple[int, int]:
        return (self.r, self.c)

    def empty_table(self) -> torch.Tensor:
        return torch.zeros(self.table_shape, dtype=torch.float32,
                           device=self.device)

    def _key(self, row: int) -> torch.Tensor:
        return self.sign_keys[row].to(torch.int64) & MASK32

    def _sign_of(self, row: int, idx: torch.Tensor) -> torch.Tensor:
        """+-1 sign of global coordinates ``idx`` in ``row``: the one sign
        stream that encode, decode and the sparse forms share."""
        return signs(idx.to(torch.int64), self._key(row))

    def _buckets_of(self, row: int, idx: torch.Tensor) -> torch.Tensor:
        """Bucket of global coordinate i in ``row``:
        ``(i mod c + shifts[row][i // c]) mod c``."""
        idx = idx.to(torch.int64)
        s = self.shifts[row].to(torch.int64)[
            torch.div(idx, self.c, rounding_mode="floor")]
        return (idx % self.c + s) % self.c

    def _signs_and_buckets(self, idx: torch.Tensor):
        """``(signs (r, k), buckets (r, k))`` of global coordinates ``idx``
        in every row at once: ``_sign_of`` and ``_buckets_of`` for all r
        rows in one pass each."""
        idx = idx.to(torch.int64)
        keys = self.sign_keys.to(torch.int64) & MASK32
        sg = signs(idx[None, :], keys[:, None])
        block = torch.div(idx, self.c, rounding_mode="floor")
        s = self.shifts.to(torch.int64)[:, block]
        return sg, (idx % self.c + s) % self.c

    # -------------------------------------------------------------- ops

    def encode(self, vec: torch.Tensor) -> torch.Tensor:
        if vec.ndim != 1 or vec.shape[0] != self.d:
            raise ValueError(f"encode: shape {tuple(vec.shape)}, d={self.d}")
        return kernels.encode(vec.to(torch.float32).contiguous(),
                              self.shifts, self.sign_keys, self.c, self.r,
                              self.m)

    def encode_accum(self, table: torch.Tensor, vals: torch.Tensor,
                     start: int = 0, scale: Optional[float] = None
                     ) -> torch.Tensor:
        """``table + encode(scale * v)`` for the vector ``v`` holding
        ``vals`` at the coordinates ``[start, start + len(vals))`` and
        zeros elsewhere, written into ``table`` in place (one K1 launch on
        the card, over the range's blocks only) and returned: the
        streaming encode of the fused client step, a layer's gradient at
        its offset. ``start`` is any int with the range inside the m c
        coordinates, as in the JAX package."""
        if vals.ndim != 1:
            raise ValueError(f"encode_accum: vals of shape "
                             f"{tuple(vals.shape)}, want a vector")
        if tuple(table.shape) != self.table_shape:
            raise ValueError(f"table shape {tuple(table.shape)}")
        start = int(start)
        whole = start == 0 and vals.shape[0] == self.d
        return kernels.encode(vals.to(torch.float32).contiguous(),
                              self.shifts, self.sign_keys, self.c, self.r,
                              self.m, scale=scale, table=table,
                              start=None if whole else start)

    def encode_vals_at(self, vals: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
        """The table of the vector holding ``vals`` at ``idx`` and zero
        elsewhere, at O(k r) cost, each cell's addends summed in the order
        of ``idx`` (``ordered_cell_sum``)."""
        sg, buckets = self._signs_and_buckets(idx)
        return ordered_cell_sum(buckets, sg * vals.to(torch.float32), self.c)

    def encode_at(self, vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``encode(vec)`` for a ``vec`` that is zero outside ``idx``."""
        return self.encode_vals_at(vec[idx], idx)

    def decode(self, table: torch.Tensor) -> torch.Tensor:
        if tuple(table.shape) != self.table_shape:
            raise ValueError(f"table shape {tuple(table.shape)}")
        return kernels.decode(table.to(torch.float32).contiguous(),
                              self.shifts, self.sign_keys, self.c, self.r,
                              self.m, self.d)

    def decode_range(self, table: torch.Tensor, start: int,
                     length: int) -> torch.Tensor:
        """The estimates of the coordinates ``[start, start + length)``:
        ``decode(table)[start:start + length]`` below d, exactly 0 at and
        past d (mesh padding never wins a top-k). K2's range form on the
        card (one launch), the gather form on the CPU; bitwise the whole
        decode's slice either way."""
        if tuple(table.shape) != self.table_shape:
            raise ValueError(f"table shape {tuple(table.shape)}")
        return kernels.decode(table.to(torch.float32).contiguous(),
                              self.shifts, self.sign_keys, self.c, self.r,
                              self.m, self.d, start=start, n=length)

    def decode_at(self, table: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
        """``decode(table)[idx]`` at O(k r) gather cost."""
        sg, buckets = self._signs_and_buckets(idx)
        return median_axis0(sg * table.gather(1, buckets))

    def unsketch_with_idx(self, table: torch.Tensor, k: int,
                          approx: bool = False):
        return topk_with_idx(self.decode(table), k, approx=approx)

    def l2estimate(self, table: torch.Tensor) -> torch.Tensor:
        return median_axis0(torch.linalg.vector_norm(table, dim=1))

    def clip(self, table: torch.Tensor, clip: float) -> torch.Tensor:
        return clip_by_l2_norm(table, clip)

    # the int8 wire quantizes table cells, whatever the sketch
    def quantize_wire(self, table: torch.Tensor, block: int, *, seed: int,
                      round_idx: int, salt: int = 0):
        return wire.quantize_table(table, block, seed=seed,
                                   round_idx=round_idx, salt=salt)

    def dequantize_wire(self, q: torch.Tensor, scale: torch.Tensor,
                        block: int) -> torch.Tensor:
        return wire.dequantize_table(q, scale, block)


def ordered_cell_sum(buckets: torch.Tensor, addends: torch.Tensor,
                     c: int) -> torch.Tensor:
    """The (r, c) table whose cell (j, b) sums ``addends[j, t]`` over the
    t with ``buckets[j, t] == b``, in the order of t on every device, as
    the JAX package's ``segment_sum`` sums them on the CPU:
    ``index_add_``'s order on the card is not fixed, and the subtract
    rule and the zero rule's mask read the sums. The flat (row, bucket)
    cells are sorted stably, and ``circulant_kernels.cell_sum`` folds
    each run of equal cells in that order (its kernel on the card, which
    reads nothing back to the host)."""
    r = buckets.shape[0]
    rows = torch.arange(r, device=buckets.device)[:, None]
    cells = (buckets.to(torch.int64) + rows * c).reshape(-1)
    sorted_cells, order = torch.sort(cells, stable=True)
    table = kernels.cell_sum(sorted_cells, order,
                             addends.to(torch.float32).reshape(-1)
                             .contiguous(), r * c)
    return table.view(r, c)


def make_circulant_sketch(d: int, c: int, r: int, seed: int = 42,
                          device="cuda") -> CirculantSketch:
    """The same ``np.random.RandomState(seed)`` draws as the JAX package's
    ``make_circulant_sketch``, so shifts and sign keys match it bitwise:
    shifts are multiples of 1024 when ``c % 1024 == 0`` (the statistics
    note there applies), 1-granular otherwise; keys are forced odd. The
    sketch lives on the card unless ``device`` names another."""
    rng = np.random.RandomState(seed)
    m = -(-d // c)
    if c % 1024 == 0:
        shifts = np.stack([rng.randint(0, c // 1024, size=m) * 1024
                           for _ in range(r)])
    else:
        shifts = np.stack([rng.randint(0, c, size=m) for _ in range(r)])
    keys = rng.randint(0, 2**32, size=(r,),
                       dtype=np.uint64).astype(np.uint32) | 1
    return CirculantSketch(
        shifts=torch.as_tensor(shifts.astype(np.int32), device=device),
        sign_keys=torch.as_tensor(keys.view(np.int32), device=device),
        d=d, c=c, r=r)
