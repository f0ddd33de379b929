"""Causal flash attention (K3): wrappers of the CUDA kernels, their plain
versions, and the ``torch.autograd.Function`` that binds them.

K3 replaces the library Pallas TPU kernel that the JAX package's
``models/gpt2.py flash_causal_attention`` calls: ``forward`` its forward
(``_flash_attention_impl``), ``backward`` its two backward kernels
(``_flash_attention_bwd_dq`` and ``_flash_attention_bwd_dkv``). The
kernels are in ``csrc/flash_attention.cu`` (design and bounds in its
header note).

Tensors are (N, S, H, D): N sequences, S positions, H heads, head width D,
the layout of the c_attn output's slices, which the kernels read through
their strides. The scale is 1/sqrt(D) and the mask causal.

Each wrapper takes the plain PyTorch version only for tensors that lie on
the CPU. For a CUDA tensor it launches the kernels on the current stream
or raises: the kernels take bf16 with D = 64 and S a multiple of 64, and
nothing falls back. ``launches`` counts, per kernel, the times a wrapper
launched it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from commefficient_torch.ops import _build

SOURCE = "flash_attention.cu"

# launches of each kernel since the last reset_launches()
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, p, f, p]
        lib.flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p,
                                     f, p]
        lib.flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p,
                                      f, p]
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv,
                   lib.flash_head_dim, lib.flash_tile):
            fn.restype = i
        lib.flash_head_dim.argtypes = []
        lib.flash_tile.argtypes = []
        lib._typed = True
    return lib


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def _check_cuda(name: str, ts, shape) -> None:
    """The kernels' contract for (N, S, H, D) operands on the card."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"{name}: a kernel runs on the card only, got "
                         f"{ts[0].device}")
    lib = _lib()
    N, S, H, D = shape
    if D != lib.flash_head_dim():
        raise ValueError(f"{name}: the kernels take head width D = "
                         f"{lib.flash_head_dim()}, got D = {D}")
    if S % lib.flash_tile():
        raise ValueError(f"{name}: the kernels take S a multiple of "
                         f"{lib.flash_tile()}, got S = {S}")
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise ValueError(
                f"{name}: the kernels take bfloat16, got {t.dtype} (float32 "
                "compute with K3 on the card, --compute_dtype float32, is "
                "not ported)")
        if tuple(t.shape) != tuple(shape) or t.device != ts[0].device:
            raise ValueError(f"{name}: operands of shape {tuple(t.shape)} on "
                             f"{t.device}, want {tuple(shape)} on "
                             f"{ts[0].device}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: each (N, S, H, D) operand needs a contiguous last "
                "dimension, 16-byte aligned rows and strides that are "
                f"multiples of 8 elements; got strides {t.stride()}")


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# --------------------------------------------------------- plain versions


def _causal_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """float32 (N, H, S, S) scores q k^T / sqrt(D), -inf above the
    diagonal."""
    S = q.shape[1]
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) \
        * _scale(q.shape[-1])
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel, in float32: ``(o, lse)``, o
    (N, S, H, D) in q's dtype and the float32 (N, H, S) log-sum-exp of the
    scaled, masked scores."""
    s = _causal_scores(q, k)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("nhqk,nkhd->nqhd", p, v.float())
    return o.to(q.dtype), lse


def backward_plain(q, k, v, o, lse, do
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels, in float32, by the
    explicit formulas from the saved log-sum-exp: ``(dq, dk, dv)`` in q's
    dtype."""
    scale = _scale(q.shape[-1])
    p = torch.exp(_causal_scores(q, k) - lse[..., None])
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)      # (N, H, S)
    dv = torch.einsum("nhqk,nqhd->nkhd", p, dof)
    dp = torch.einsum("nqhd,nkhd->nhqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k.float()) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- wrappers


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 forward: ``(o, lse)`` for (N, S, H, D) q, k, v; o is a
    contiguous (N, S, H, D) tensor, lse float32 (N, H, S)."""
    if q.device.type == "cpu":
        return forward_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    N, S, H, D = q.shape
    _check_cuda("flash_fwd", (q, k, v), (N, S, H, D))
    o = torch.empty((N, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((N, H, S), dtype=torch.float32, device=q.device)
    err = _lib().flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(), N, S, H, D,
                           _strides(q, k, v, o), _scale(D), _stream(q))
    _raise_on("flash_fwd", err)
    launches["flash_fwd"] += 1
    return o, lse


def backward_dq(q, k, v, o, lse, do
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel (card only): ``(dq, delta)``, dq a contiguous
    (N, S, H, D) tensor and delta = rowsum(dO o), float32 (N, H, S), which
    the kernel computes for its rows and ``backward_dkv`` reads."""
    N, S, H, D = q.shape
    _check_cuda("flash_bwd_dq", (q, k, v, o, do), (N, S, H, D))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (N, H, S) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_bwd_dq: lse must be contiguous float32 "
                         f"{(N, H, S)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dq = torch.empty((N, S, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((N, H, S), dtype=torch.float32, device=q.device)
    err = _lib().flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), N, S, H, D,
                              _strides(q, k, v, o, do, dq), _scale(D),
                              _stream(q))
    _raise_on("flash_bwd_dq", err)
    launches["flash_bwd_dq"] += 1
    return dq, delta


def backward_dkv(q, k, v, do, lse, delta
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel (card only): ``(dk, dv)``, contiguous (N, S, H,
    D), from the delta that ``backward_dq`` wrote."""
    N, S, H, D = q.shape
    _check_cuda("flash_bwd_dkv", (q, k, v, do), (N, S, H, D))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (N, H, S) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_bwd_dkv: {name} must be contiguous "
                             f"float32 {(N, H, S)} on {q.device}")
    dk, dv = (torch.empty((N, S, H, D), dtype=q.dtype, device=q.device)
              for _ in range(2))
    err = _lib().flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), N, S, H, D,
                               _strides(q, k, v, do, dk, dv), _scale(D),
                               _stream(q))
    _raise_on("flash_bwd_dkv", err)
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def backward(q, k, v, o, lse, do
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 backward: ``(dq, dk, dv)``, contiguous (N, S, H, D). On the card
    two launches on one stream: dq (which also writes delta), then dk/dv,
    which reads it."""
    if q.device.type == "cpu":
        return backward_plain(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    do = do.contiguous()
    dq, delta = backward_dq(q, k, v, o, lse, do)
    dk, dv = backward_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = causal attention of (N, S, H, D) q, k, v; the backward runs the
    backward kernels (or, on the CPU, their plain version) from the saved
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return backward(*ctx.saved_tensors, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Causal attention of (..., S, H, D) q, k, v through K3; the leading
    dimensions are folded into N as views (no copy for the slices of a
    c_attn output)."""
    lead, (S, H, D) = q.shape[:-3], q.shape[-3:]
    fold = lambda t: t.reshape((-1, S, H, D))
    o = FlashAttention.apply(fold(q), fold(k), fold(v))
    return o.reshape(lead + (S, H, D))
