"""Circulant count sketch (d -> r x c).

Counterpart of the JAX package's ``ops/circulant.py``. The vector is padded
to m = ceil(d / c) blocks of length c; row j of the table is
``sum_b roll(sigma_j * v_b, s[j][b])``, with signs sigma from the murmur
mixer (ops/hashing.py) and per-(row, block) cyclic shifts drawn once from
the seed. The whole-vector encode and the decode run the hand-written
CUDA kernels K1 and K2 (ops/circulant_kernels.py) on the card; the O(k r)
sparse encode and gather are plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from commefficient_torch.ops import circulant_kernels as kernels
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
        """``table + encode(scale * vals)``, written into ``table`` in place
        (one K1 launch on the card) and returned. Only the whole-vector
        form is ported (``start == 0``, ``len(vals) == d``): it is the one
        the fused client step uses."""
        if int(start) != 0 or vals.ndim != 1 or vals.shape[0] != self.d:
            raise ValueError(
                "encode_accum: only the whole-vector form (start=0, d "
                f"values) is ported; got start={start}, shape "
                f"{tuple(vals.shape)}, d={self.d}")
        if tuple(table.shape) != self.table_shape:
            raise ValueError(f"table shape {tuple(table.shape)}")
        return kernels.encode(vals.to(torch.float32).contiguous(),
                              self.shifts, self.sign_keys, self.c, self.r,
                              self.m, scale=scale, table=table)

    def encode_vals_at(self, vals: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
        """The table of the vector holding ``vals`` at ``idx`` and zero
        elsewhere, at O(k r) cost. ``segment_sum`` becomes ``index_add_``,
        whose order of addition on the card is not fixed; the server's zero
        rule only reads which cells are non-zero, so that order does not
        change the main path (short of an exact cancellation to 0)."""
        rows = []
        for j in range(self.r):
            row = torch.zeros(self.c, dtype=torch.float32, device=vals.device)
            row.index_add_(0, self._buckets_of(j, idx),
                           self._sign_of(j, idx) * vals.to(torch.float32))
            rows.append(row)
        return torch.stack(rows)

    def encode_at(self, vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``encode(vec)`` for a ``vec`` that is zero outside ``idx``."""
        return self.encode_vals_at(vec[idx], idx)

    def decode(self, table: torch.Tensor) -> torch.Tensor:
        if tuple(table.shape) != self.table_shape:
            raise ValueError(f"table shape {tuple(table.shape)}")
        return kernels.decode(table.to(torch.float32).contiguous(),
                              self.shifts, self.sign_keys, self.c, self.r,
                              self.m, self.d)

    def decode_at(self, table: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
        """``decode(table)[idx]`` at O(k r) gather cost."""
        ests = torch.stack([self._sign_of(j, idx)
                            * table[j][self._buckets_of(j, idx)]
                            for j in range(self.r)])
        return median_axis0(ests)

    def unsketch_with_idx(self, table: torch.Tensor, k: int,
                          approx: bool = False):
        return topk_with_idx(self.decode(table), k, approx=approx)

    def l2estimate(self, table: torch.Tensor) -> torch.Tensor:
        return median_axis0(torch.linalg.vector_norm(table, dim=1))

    def clip(self, table: torch.Tensor, clip: float) -> torch.Tensor:
        return clip_by_l2_norm(table, clip)


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
