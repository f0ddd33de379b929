"""Causal flash attention (K3): wrappers of the CUDA kernels, their plain
versions, the route table that picks a kernel by (dtype, D), and the
``torch.autograd.Function`` that binds them.

K3 replaces the library Pallas TPU kernel that the JAX package's
``models/gpt2.py flash_causal_attention`` calls: ``forward`` its forward
(``_flash_attention_impl``), ``backward`` its two backward kernels
(``_flash_attention_bwd_dq`` and ``_flash_attention_bwd_dkv``). Two
libraries hold the kernels (design and bounds in their header notes):
``csrc/flash_attention.cu``, warp-specialised wgmma kernels fed by TMA,
templates over D, for bf16 at head widths D = 32, 64 (GPT-2's width) and
128 (forward, dq and dk/dv) and the bf16 backward at D = 16 (dq and
dk/dv); ``csrc/flash_tiled.cu``, tiled kernels, for float32 at D = 16, 32,
64 and 128 (forward, dq and dk/dv in ``mma.sync`` on the TF32 tensor
cores, each product split into three, 3xTF32, for float32-level
accuracy) and the bf16 forward at D = 16 (``mma.sync``, K and V tiles
copied by ``cp.async``). ``route`` is the table, naming each kernel's
library; each
kernel's C entry point bears the name ``launches`` counts it under, and
all three of a kind take the same arguments.

Tensors are (N, S, H, D): N sequences, S positions, H heads, head width D,
the layout of the c_attn output's slices, which the kernels read through
their strides. The scale is 1/sqrt(D) and the mask causal.

Each wrapper takes the plain PyTorch version only for tensors that lie on
the CPU. For a CUDA tensor it launches the route's kernels on the current
stream or raises: a form outside the table (another dtype, D not in
``HEAD_DIMS``) or S not a multiple of ``TILE`` raises by name, and nothing
falls back. ``launches`` counts, per kernel of each route (the route's own
names: ``flash_fwd`` for bf16 at D = 64, ``flash_fwd_f32_d64``,
``flash_fwd_bf16_d16`` ...), the times a wrapper launched it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch

from commefficient_torch.ops import _build

SOURCE = "flash_attention.cu"           # wgmma and TMA
TILED_SOURCE = "flash_tiled.cu"         # mma.sync
HEAD_DIMS = (16, 32, 64, 128)
TILE = 64                               # S must be a multiple of this
# the dtypes the kernels take, by their names in the route names
DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


@dataclasses.dataclass(frozen=True)
class Route:
    """The kernels of one (dtype, D) form: their names, which are both
    their C entry points and what ``launches`` counts, and the library
    (``SOURCE`` or ``TILED_SOURCE``) of each."""

    fwd: str
    dq: str
    dkv: str
    sources: Tuple[str, str, str]       # the libraries of fwd, dq, dkv

    @property
    def names(self) -> Tuple[str, str, str]:
        return (self.fwd, self.dq, self.dkv)

    def source_of(self, name: str) -> str:
        return self.sources[self.names.index(name)]


def route(dtype: torch.dtype, D: int) -> Route:
    """The route of K3 on the card for operands of ``dtype`` and head
    width ``D``: bf16 at D = 32, 64 and 128 runs ``flash_attention.cu``;
    bf16 at D = 16 its forward in ``flash_tiled.cu`` and its backward in
    ``flash_attention.cu``; float32 at every D of ``HEAD_DIMS`` runs
    ``flash_tiled.cu``. Any other form raises, naming it."""
    if dtype not in DTYPES:
        raise ValueError(f"flash attention: no kernel for dtype {dtype} "
                         f"(the kernels take {', '.join(map(str, DTYPES))})")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention: no kernel for head width D = {D} "
                         f"(the kernels take D in {HEAD_DIMS})")
    if dtype == torch.bfloat16 and D == 64:
        return Route("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     (SOURCE, SOURCE, SOURCE))
    tag = DTYPES[dtype]
    if dtype == torch.float32:
        sources = (TILED_SOURCE,) * 3
    else:
        sources = (TILED_SOURCE if D == 16 else SOURCE, SOURCE, SOURCE)
    return Route(f"flash_fwd_{tag}_d{D}", f"flash_bwd_dq_{tag}_d{D}",
                 f"flash_bwd_dkv_{tag}_d{D}", sources)


ROUTES = {(dt, D): route(dt, D) for dt in DTYPES for D in HEAD_DIMS}

# launches of each kernel of each route since the last reset_launches()
launches = {name: 0 for r in ROUTES.values() for name in r.names}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib(source: str = SOURCE) -> ctypes.CDLL:
    """The library ``source``, its entry points typed on first load: each
    route kernel it exports (and, for ``SOURCE``, each one's
    ``<name>_smem_bytes``). A library of another tree may hold other
    kernels than the route table gives it (``scripts/k3_tiled_ab.py``)."""
    lib = _build.load(source)
    if getattr(lib, "_typed", False):
        return lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = [p, p, p, p, p, i, i, i, i, p, f, p]
    bwd = [p, p, p, p, p, p, p, p, i, i, i, i, p, f, p]
    for r in ROUTES.values():
        for name, args in zip(r.names, (fwd, bwd, bwd)):
            fn = getattr(lib, name, None)
            if fn is None:
                continue
            fn.argtypes, fn.restype = args, i
            smem = getattr(lib, f"{name}_smem_bytes", None)
            if smem is not None:
                smem.argtypes, smem.restype = [], i
    lib._typed = True
    return lib


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def _check_cuda(name: str, ts, shape) -> Route:
    """The kernels' contract for (N, S, H, D) operands on the card; returns
    the route of their form."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"{name}: a kernel runs on the card only, got "
                         f"{ts[0].device}")
    N, S, H, D = shape
    r = route(ts[0].dtype, D)
    if S % TILE:
        raise ValueError(f"{name}: the kernels take S a multiple of "
                         f"{TILE}, got S = {S}")
    for t in ts:
        if t.dtype != ts[0].dtype or tuple(t.shape) != tuple(shape) \
                or t.device != ts[0].device:
            raise ValueError(f"{name}: operands of {t.dtype} {tuple(t.shape)}"
                             f" on {t.device}, want {ts[0].dtype} "
                             f"{tuple(shape)} on {ts[0].device}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: each (N, S, H, D) operand needs a contiguous last "
                "dimension, 16-byte aligned rows and strides that are "
                f"multiples of 8 elements; got strides {t.stride()}")
    return r


def _check_stat(name: str, stat: str, t: torch.Tensor, shape, device
                ) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.device != device \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: {stat} must be contiguous, 16-byte "
                         f"aligned float32 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err == -1:
        raise RuntimeError(f"{name}: the driver refused an operand's tensor "
                           "map (cuTensorMapEncodeTiled)")
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
    contiguous (N, S, H, D) tensor in q's dtype, lse float32 (N, H, S)."""
    if q.device.type == "cpu":
        return forward_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    N, S, H, D = q.shape
    r = _check_cuda(f"flash attention forward ({q.dtype}, D = {D})",
                    (q, k, v), (N, S, H, D))
    o = torch.empty((N, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((N, H, S), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), N, S, H, D, _strides(q, k, v, o), _scale(D),
            _stream(q))
    _raise_on(r.fwd, getattr(_lib(r.source_of(r.fwd)), r.fwd)(*args))
    launches[r.fwd] += 1
    return o, lse


def backward_dq(q, k, v, o, lse, do
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel (card only): ``(dq, delta)``, dq a contiguous
    (N, S, H, D) tensor and delta = rowsum(dO o), float32 (N, H, S), which
    the kernel computes for its rows and ``backward_dkv`` reads."""
    N, S, H, D = q.shape
    name = f"flash attention dq ({q.dtype}, D = {D})"
    r = _check_cuda(name, (q, k, v, o, do), (N, S, H, D))
    _check_stat(name, "lse", lse, (N, H, S), q.device)
    dq = torch.empty((N, S, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((N, H, S), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            N, S, H, D, _strides(q, k, v, o, do, dq), _scale(D), _stream(q))
    _raise_on(r.dq, getattr(_lib(r.source_of(r.dq)), r.dq)(*args))
    launches[r.dq] += 1
    return dq, delta


def backward_dkv(q, k, v, do, lse, delta
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel (card only): ``(dk, dv)``, contiguous (N, S, H,
    D), from the delta that ``backward_dq`` wrote."""
    N, S, H, D = q.shape
    name = f"flash attention dk/dv ({q.dtype}, D = {D})"
    r = _check_cuda(name, (q, k, v, do), (N, S, H, D))
    _check_stat(name, "lse", lse, (N, H, S), q.device)
    _check_stat(name, "delta", delta, (N, H, S), q.device)
    dk, dv = (torch.empty((N, S, H, D), dtype=q.dtype, device=q.device)
              for _ in range(2))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            N, S, H, D, _strides(q, k, v, do, dk, dv), _scale(D), _stream(q))
    _raise_on(r.dkv, getattr(_lib(r.source_of(r.dkv)), r.dkv)(*args))
    launches[r.dkv] += 1
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
