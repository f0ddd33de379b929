"""The hash Count Sketch (d -> r x c) and the factory over the port's
three sketches.

Counterpart of the JAX package's ``ops/sketch.py``: the CSVec semantics of
the published FetchSGD (``CSVec(d, c, r, numBlocks)``). Coordinate i
lands in row j's bucket ``mix32(i * bucket_key[j] + 0x9E3779B9) % c``
with sign ``1 - 2 * (mix32(i * sign_key[j] + 0x85EBCA77) >> 31)``, the
keys drawn by ``np.random.RandomState(seed)`` and forced odd, so buckets
and signs are the JAX package's bit for bit. The encode is a scatter-add
(``index_add_``) over ``num_blocks`` blocks of coordinates, so the
working set stays O(r d / num_blocks); its order of addition on the card
is not fixed, so a table agrees with the JAX package's to float32
rounding. The decode is a gather and the median over the rows, bitwise.
No Pallas kernel computes any of this in the JAX package: here it is
plain PyTorch on the card, apart from the sparse re-encode's ordered cell
sum (``ops/circulant.py ordered_cell_sum``), which runs a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from commefficient_torch.ops import wire
from commefficient_torch.ops.circulant import ordered_cell_sum
from commefficient_torch.ops.hashing import GOLDEN, MASK32, mix32, mul32
from commefficient_torch.ops.topk import (clip_by_l2_norm, median_axis0,
                                          topk_with_idx)

# the sign stream's additive constant (the bucket stream's is GOLDEN)
SIGN_SALT = 0x85EBCA77


@dataclasses.dataclass(frozen=True)
class CountSketch:
    """``bucket_keys`` and ``sign_keys``: (r,) int64 holding the odd
    uint32 keys, on ``device``; the (r, c) table is the caller's."""

    bucket_keys: torch.Tensor
    sign_keys: torch.Tensor
    d: int
    c: int
    r: int
    num_blocks: int

    # a k-sparse vector's table is k r-sparse, so the cell-zeroing rule
    # applies (the SRHT's dense transform has no such cells)
    dense_transform = False

    @property
    def block_len(self) -> int:
        return -(-self.d // self.num_blocks)

    @property
    def device(self) -> torch.device:
        return self.bucket_keys.device

    @property
    def table_shape(self) -> Tuple[int, int]:
        return (self.r, self.c)

    def empty_table(self) -> torch.Tensor:
        return torch.zeros(self.table_shape, dtype=torch.float32,
                           device=self.device)

    def buckets_signs(self, idx: torch.Tensor):
        """``(buckets (r, n) int64 in [0, c), signs (r, n) float32 +-1)``
        of global coordinates ``idx`` (< 2^32)."""
        idx = idx.to(torch.int64)[None, :]
        hb = mix32((mul32(idx, self.bucket_keys[:, None]) + GOLDEN) & MASK32)
        hs = mix32((mul32(idx, self.sign_keys[:, None]) + SIGN_SALT)
                   & MASK32)
        return hb % self.c, 1.0 - 2.0 * (hs >> 31).to(torch.float32)

    def _check_table(self, table: torch.Tensor) -> None:
        if tuple(table.shape) != self.table_shape:
            raise ValueError(f"table shape {tuple(table.shape)}, want "
                             f"{self.table_shape}")

    # -------------------------------------------------------------- ops

    def encode(self, vec: torch.Tensor) -> torch.Tensor:
        if vec.ndim != 1 or vec.shape[0] != self.d:
            raise ValueError(f"encode: shape {tuple(vec.shape)}, d={self.d}")
        return self.encode_accum(self.empty_table(), vec)

    def encode_accum(self, table: torch.Tensor, vals: torch.Tensor,
                     start: int = 0, scale: Optional[float] = None
                     ) -> torch.Tensor:
        """``table + encode(v)`` for ``v`` holding ``scale * vals`` at
        coordinates ``[start, start + len(vals))`` and zero elsewhere,
        added into ``table`` in place, a block of ``block_len``
        coordinates at a time, and returned."""
        self._check_table(table)
        vals = vals.to(torch.float32)
        if scale is not None:
            vals = vals * scale
        n, bl = vals.shape[0], self.block_len
        if start < 0 or start + n > self.d:
            raise ValueError(f"encode_accum: [{start}, {start + n}) outside "
                             f"[0, {self.d})")
        flat = table.view(-1)
        rows = torch.arange(self.r, device=table.device)[:, None] * self.c
        for lo in range(0, n, bl):
            hi = min(lo + bl, n)
            idx = torch.arange(start + lo, start + hi, device=table.device)
            buckets, sg = self.buckets_signs(idx)
            flat.index_add_(0, (buckets + rows).reshape(-1),
                            (sg * vals[lo:hi][None, :]).reshape(-1))
        return table

    def encode_vals_at(self, vals: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
        """The table of the vector holding ``vals`` at ``idx`` and zero
        elsewhere, at O(k r) cost, each cell's addends summed in the order
        of ``idx`` (``ordered_cell_sum``), as the JAX package's
        ``segment_sum`` sums them."""
        buckets, sg = self.buckets_signs(idx)
        return ordered_cell_sum(buckets, sg * vals.to(torch.float32), self.c)

    def encode_at(self, vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``encode(vec)`` for a ``vec`` that is zero outside ``idx``."""
        return self.encode_vals_at(vec[idx], idx)

    def decode_at(self, table: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
        """``decode(table)[idx]``: the median over the rows of the signed
        gathers at ``idx``."""
        buckets, sg = self.buckets_signs(idx)
        return median_axis0(sg * table.gather(1, buckets))

    def decode_range(self, table: torch.Tensor, start: int,
                     length: int) -> torch.Tensor:
        """The estimates of coordinates ``[start, start + length)``, a
        block at a time; exactly 0 at coordinates at or past d."""
        self._check_table(table)
        out = torch.zeros(length, dtype=torch.float32, device=table.device)
        n = max(0, min(length, self.d - start))
        for lo in range(0, n, self.block_len):
            hi = min(lo + self.block_len, n)
            idx = torch.arange(start + lo, start + hi, device=table.device)
            out[lo:hi] = self.decode_at(table, idx)
        return out

    def decode(self, table: torch.Tensor) -> torch.Tensor:
        """The (d,) median-of-r estimates of every coordinate."""
        return self.decode_range(table, 0, self.d)

    def unsketch_with_idx(self, table: torch.Tensor, k: int,
                          approx: bool = False):
        return topk_with_idx(self.decode(table), k, approx=approx)

    def l2estimate(self, table: torch.Tensor) -> torch.Tensor:
        """The vector norm's estimate: the median of the row norms."""
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


def make_sketch(d: int, c: int, r: int, num_blocks: int = 1, seed: int = 42,
                device="cuda") -> CountSketch:
    """The JAX package's ``make_sketch`` keys: bucket keys, then sign
    keys, each ``randint(0, 2^32)`` forced odd, from
    ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    bucket_keys = rng.randint(0, 2**32, size=(r,),
                              dtype=np.uint64).astype(np.uint32) | 1
    sign_keys = rng.randint(0, 2**32, size=(r,),
                            dtype=np.uint64).astype(np.uint32) | 1
    return CountSketch(
        bucket_keys=torch.as_tensor(bucket_keys.astype(np.int64),
                                    device=device),
        sign_keys=torch.as_tensor(sign_keys.astype(np.int64), device=device),
        d=d, c=c, r=r, num_blocks=num_blocks)


def make_sketch_impl(impl: str, d: int, c: int, r: int, num_blocks: int = 1,
                     seed: int = 42, device="cuda", dtype: str = "float32",
                     scan_rows: int = -1):
    """The sketch ``--sketch_impl`` names: ``circ`` (the circulant count
    sketch, K1/K2 on the card), ``hash`` (the Count Sketch above) or
    ``rht`` (the stratified SRHT, ops/rht.py, with its transform dtype
    ``dtype`` and ``scan_rows`` -1 automatic, 0 batched, 1 by rows)."""
    if impl == "circ":
        from commefficient_torch.ops.circulant import make_circulant_sketch
        return make_circulant_sketch(d, c, r, seed=seed, device=device)
    if impl == "hash":
        return make_sketch(d, c, r, num_blocks, seed=seed, device=device)
    if impl == "rht":
        from commefficient_torch.ops.rht import make_rht_sketch
        return make_rht_sketch(d, c, r, seed=seed, device=device,
                               dtype=dtype,
                               scan_rows=None if scan_rows < 0
                               else bool(scan_rows))
    raise ValueError(f"unknown sketch_impl {impl!r} (want 'circ', 'hash' or "
                     "'rht')")
