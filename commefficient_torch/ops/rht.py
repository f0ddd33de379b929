"""The stratified subsampled randomized Hadamard transform (SRHT) sketch,
counterpart of the JAX package's ``ops/rht.py``.

Row j of the (r, c) table is ``t_j = S_j H D_j pad(v)``: ``D_j`` are +-1
signs (drawn into an int8 table by ``np.random.RandomState(seed)`` when
r d' <= 2^30 entries, else derived from ``mix32``), ``H`` the orthonormal
Kronecker-Hadamard transform of the power-of-two length d' >= max(d, c),
applied as three last-axis matrix products, and ``S_j`` picks, for each
stratum s = {s, s + c, s + 2c, ...}, the member ``offsets[j][s]`` (a
one-hot selection over the (m, c) view, m = ceil(d' / c)). The decode is
the adjoint with each stratum scaled by its size, and the median over the
rows. At c >= d' every stratum has one member and the round trip is
exact up to float32 rounding.

The JAX package computes the transform with plain matrix products
outside any Pallas kernel; so does the port, with TF32 off (``_fp32``):
a TF32 product would lose the lossless round trip. ``dtype`` bfloat16
(``--sketch_dtype``, or a bf16 wire) runs the products on bf16 factors
and intermediates and returns float32. ``scan_rows``
(``--sketch_scan_rows``; on by default at d' >= 2^25) transforms one row
at a time in encode and decode, keeps the decode's per-row estimates in
the transform dtype and takes their median over axis 0 with no
transpose: the peak is a row's buffers, not r of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from commefficient_torch.ops.hashing import MASK32, signs
from commefficient_torch.ops.topk import median_axis0

# precompute the +-1 signs when the (r, d') table holds at most this many
# int8 entries (the JAX package's limit)
PRECOMPUTE_SIGN_LIMIT = 1 << 30
# d' from which the transforms run row by row unless asked otherwise
SCAN_ROWS_AUTO = 1 << 25


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def kron_dims(dp: int) -> Tuple[int, int, int]:
    """The power of two ``dp`` as three near-equal powers of two
    (2^23 -> 128 x 256 x 256)."""
    m = dp.bit_length() - 1
    a = m // 3
    b = (m - a) // 2
    return (1 << a, 1 << b, 1 << (m - a - b))


def hadamard(n: int) -> np.ndarray:
    """The Sylvester Hadamard matrix (+-1 entries) of order ``n``, a power
    of two."""
    h = np.array([[1.0]], np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@contextlib.contextmanager
def _fp32():
    """Matrix products in full float32 on the card (no TF32), restoring
    the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@dataclasses.dataclass(frozen=True)
class RHTSketch:
    sign_keys: torch.Tensor          # (r,) int64 holding uint32 keys
    signs_i8: Optional[torch.Tensor]  # (r, dp) int8 +-1, or None
    offsets: torch.Tensor            # (r, c) int64: the member of stratum s
    scales: torch.Tensor             # (c,) float32: the stratum's size
    hadamards: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    d: int
    c: int
    r: int
    dp: int                          # padded power-of-two length
    m: int                           # stratum width, ceil(dp / c)
    dtype: str = "float32"           # the transform's compute dtype
    scan_rows: bool = False          # transforms one row at a time

    # a k-sparse vector's transform is dense: the server keeps dense
    # pre-images, or subtracts in estimate space (core/server.py)
    dense_transform = True

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @property
    def table_shape(self) -> Tuple[int, int]:
        return (self.r, self.c)

    def _signs(self) -> torch.Tensor:
        """(r, dp) +-1 float32."""
        if self.signs_i8 is not None:
            return self.signs_i8.to(torch.float32)
        i = torch.arange(self.dp, dtype=torch.int64, device=self.device)
        return signs(i[None, :], (self.sign_keys & MASK32)[:, None])

    def _signs_row(self, j: int) -> torch.Tensor:
        """(dp,) +-1 float32 of row ``j``."""
        if self.signs_i8 is not None:
            return self.signs_i8[j].to(torch.float32)
        i = torch.arange(self.dp, dtype=torch.int64, device=self.device)
        return signs(i, self.sign_keys[j] & MASK32)

    def _onehot_row(self, j: int) -> torch.Tensor:
        """(m, c) float32 selection of row ``j``."""
        t = torch.arange(self.m, device=self.device)[:, None]
        return (t == self.offsets[j][None, :]).to(torch.float32)

    def _onehot(self) -> torch.Tensor:
        """(r, m, c) float32: [j, t, s] is 1 where transformed coordinate
        t c + s is row j's pick of stratum s."""
        t = torch.arange(self.m, device=self.device)[None, :, None]
        return (t == self.offsets[:, None, :]).to(torch.float32)

    def _transform(self, y: torch.Tensor) -> torch.Tensor:
        """The orthonormal Kronecker-Hadamard transform of each row of the
        (R, dp) ``y``: three last-axis products with the layout rotations
        of the JAX package's between them."""
        n1, n2, n3 = (h.shape[0] for h in self.hadamards)
        dt = getattr(torch, self.dtype)
        h1, h2, h3 = (h.to(dt) for h in self.hadamards)
        R = y.shape[0]
        with _fp32():
            x = y.to(dt).reshape(-1, n3) @ h3
            x = x.reshape(R, n1, n2, n3).transpose(2, 3)
            x = (x.reshape(-1, n2) @ h2).reshape(R, n1, n3, n2)
            x = x.permute(0, 3, 2, 1)
            x = (x.reshape(-1, n1) @ h1).reshape(R, n2, n3, n1)
            x = x.permute(0, 3, 1, 2)
        return x.reshape(R, self.dp).to(torch.float32) \
            * np.float32(1.0 / np.sqrt(self.dp))

    def encode(self, vec: torch.Tensor) -> torch.Tensor:
        """(d,) -> (r, c), or (B, d) -> (B, r, c)."""
        V = vec if vec.ndim == 2 else vec[None]
        if V.shape[1] != self.d:
            raise ValueError(f"encode: shape {tuple(vec.shape)}, d={self.d}")
        B = V.shape[0]
        v = torch.nn.functional.pad(V.to(torch.float32),
                                    (0, self.dp - self.d))
        pad = (0, self.c * self.m - self.dp)
        if self.scan_rows:
            t = torch.empty((B, self.r, self.c), dtype=torch.float32,
                            device=v.device)
            for j in range(self.r):
                z = torch.nn.functional.pad(
                    self._transform(self._signs_row(j)[None] * v), pad)
                t[:, j] = (z.reshape(B, self.m, self.c)
                           * self._onehot_row(j)[None]).sum(dim=1)
        else:
            y = (self._signs()[None] * v[:, None, :]).reshape(B * self.r,
                                                               self.dp)
            z = torch.nn.functional.pad(self._transform(y), pad)
            z = z.reshape(B, self.r, self.m, self.c)
            t = (z * self._onehot()[None]).sum(dim=2)
        return t if vec.ndim == 2 else t[0]

    def decode(self, table: torch.Tensor) -> torch.Tensor:
        """(r, c) -> the (d,) median-of-r estimates; (B, r, c) -> (B, d)."""
        T = table if table.ndim == 3 else table[None]
        if tuple(T.shape[1:]) != self.table_shape:
            raise ValueError(f"table shape {tuple(table.shape)}")
        B = T.shape[0]
        if self.scan_rows:
            # the per-row estimates in the transform dtype, stacked on
            # axis 0, where the median reads them: no transposed copy
            ys = torch.empty((self.r, B, self.dp),
                             dtype=getattr(torch, self.dtype),
                             device=T.device)
            for j in range(self.r):
                z = (T[:, j] * self.scales)[:, None, :] \
                    * self._onehot_row(j)[None]
                z = z.reshape(B, self.c * self.m)[:, :self.dp]
                ys[j] = self._signs_row(j)[None] * self._transform(z)
            est = median_axis0(ys.to(torch.float32))[:, :self.d]
        else:
            z = (T * self.scales)[:, :, None, :] * self._onehot()[None]
            z = z.reshape(B * self.r, self.c * self.m)[:, :self.dp]
            y = self._signs()[None] * self._transform(z).reshape(
                B, self.r, self.dp)
            est = median_axis0(y.transpose(0, 1))[:, :self.d]
        return est if table.ndim == 3 else est[0]

    def l2estimate(self, table: torch.Tensor) -> torch.Tensor:
        """The median row norm times sqrt(d' / c): E||t_j||^2 = (c / d')
        ||v||^2."""
        return median_axis0(torch.linalg.vector_norm(table, dim=1)) \
            * np.float32(np.sqrt(self.dp / self.c))

    def clip(self, table: torch.Tensor, clip: float) -> torch.Tensor:
        """Scale ``table`` so that its estimated vector norm is at most
        ``clip``."""
        l2 = self.l2estimate(table)
        scale = torch.where(l2 > clip, clip / torch.clamp(l2, min=1e-12),
                            torch.ones_like(l2))
        return table * scale


def make_rht_sketch(d: int, c: int, r: int, seed: int = 42,
                    device="cuda", dtype: str = "float32",
                    scan_rows: Optional[bool] = None) -> RHTSketch:
    """The JAX package's ``make_rht_sketch`` draws: sign keys (odd, from
    ``RandomState(seed)``), then the int8 sign table from the same stream
    when it is small enough, and the stratum offsets from
    ``RandomState(seed ^ 0x5EED5)``. ``scan_rows`` None: by rows once d'
    reaches 2^25, as the JAX package switches."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"rht transform dtype {dtype!r}: want float32 or "
                         "bfloat16")
    dp = max(next_pow2(d), next_pow2(c))
    if scan_rows is None:
        scan_rows = dp >= SCAN_ROWS_AUTO
    m = -(-dp // c)
    rng = np.random.RandomState(seed)
    sign_keys = rng.randint(1, 2**32, size=(r,),
                            dtype=np.uint64).astype(np.uint32) | 1
    signs_i8 = None
    if r * dp <= PRECOMPUTE_SIGN_LIMIT:
        signs_i8 = torch.as_tensor(
            rng.randint(0, 2, size=(r, dp), dtype=np.int8) * 2 - 1,
            device=device)
    rng_off = np.random.RandomState(seed ^ 0x5EED5)
    sizes = -(-(dp - np.arange(c)) // c)
    offsets = rng_off.randint(0, sizes[None, :], size=(r, c))
    return RHTSketch(
        sign_keys=torch.as_tensor(sign_keys.astype(np.int64), device=device),
        signs_i8=signs_i8,
        offsets=torch.as_tensor(offsets.astype(np.int64), device=device),
        scales=torch.as_tensor(sizes.astype(np.float32), device=device),
        hadamards=tuple(torch.as_tensor(hadamard(n), device=device)
                        for n in kron_dims(dp)),
        d=d, c=c, r=r, dp=dp, m=m, dtype=dtype, scan_rows=bool(scan_rows))
