"""The murmur3 fmix32 mixer and the circulant sketch's sign stream.

Counterpart of the JAX package's ``ops/sketch.py _mix32``. PyTorch on the
CPU has no right shift for uint32, so the plain version computes in int64
on values in [0, 2^32) and masks with ``& 0xFFFFFFFF`` after every step
that can leave that range. Products of two 32-bit values are formed from
16-bit halves, so no intermediate exceeds 2^49 and int64 never overflows.
The CUDA kernels (csrc/circulant.cu) compute the same function in native
uint32.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``(a * b) mod 2^32`` for int64 ``a`` in [0, 2^32) and ``b`` (an int
    or an int64 tensor) in [0, 2^32), without int64 overflow."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of int64 values in [0, 2^32); returns int64 in the
    same range."""
    h = h ^ (h >> 16)
    h = mul32(h, _M1)
    h = h ^ (h >> 13)
    h = mul32(h, _M2)
    return h ^ (h >> 16)


def signs(idx: torch.Tensor, key) -> torch.Tensor:
    """float32 +-1 sign of global coordinates ``idx`` (int64, < 2^32) for a
    row with sign key ``key`` (int or 0-d int64 tensor, in [0, 2^32)):
    ``1 - 2 * (mix32(idx * key + 0x9E3779B9) >> 31)``."""
    h = mix32((mul32(idx, key) + GOLDEN) & MASK32)
    return 1.0 - 2.0 * (h >> 31).to(torch.float32)
