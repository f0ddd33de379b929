#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together) and print the build time;
2. hold K1 (circulant encode) and K2 (circulant decode) against their
   plain PyTorch versions on the card at the ResNet-9 shapes
   (d = 6,568,640, c = 500,736, r = 5; seeded inputs; shifts from
   ``make_circulant_sketch``), at the unaligned c = 500,000, and at the
   GPT-2 shape (d = 92,138,496, c = 524,288, r = 5, m = 176); time kernel
   and plain version with CUDA events (median of 25 after warm-up)
   beside each kernel's bound;
3. hold K3 (causal flash attention: forward, dq, dk/dv) against its plain
   versions at (N, H, S, D) = (8, 12, 1024, 64) and (8, 12, 256, 64), q,
   k, v the slices of one c_attn-shaped buffer, each output row against
   its own norm (FLASH_ROW_RTOL), and show that this check rejects a
   planted fault in each kernel (one tile of its walk skipped); time the
   kernels, the plain versions and ``scaled_dot_product_attention``
   (forward, backward and both) beside each kernel's bound;
4. small-input checks: three rounds of a narrow ResNet-9 on the card
   (float32, TF32 off) against the same rounds on the CPU, whose wrappers
   take the plain versions; a narrow GPT-2 (2 layers, width 128, 2 heads
   of 64, S = 128, bf16, K3 on the card, full-length random tokens) on
   the card against the CPU: one client's c_attn q/k/v gradient and three
   rounds, within NARROW_LIMITS, and the same runs with a planted fault
   in each K3 kernel outside them;
5. the ResNet-9 main path: ``commefficient_torch.cv_train`` at full width
   (8 clients x 64 synthetic CIFAR10 images, k = 50,000, r = 5,
   c = 500,000 -> 500,736, bf16 compute), every launch count set to 0
   just before and read just after; requires 9 encode and 1 decode launch
   per round and finite losses; prints the median round time (of the
   rounds after the first), img/s and peak memory;
6. the GPT-2 main path: ``commefficient_torch.gpt2_train`` at GPT-2
   small's width (8 clients x 4 dialogues x 2 candidates x 1024 tokens,
   k = 50,000, r = 5, c = 524,288, bf16, K3), every launch count set to
   0 just before; requires per round exactly 9 K1, 1 K2, 96 K3 forward,
   96 dq and 96 dk/dv launches, 12 K3 forward launches in the validation
   after the rounds, and finite losses; prints the median round time (of
   the rounds after the first), tokens/s, the analytic model TFLOP/s and
   its share of 989 TFLOP/s, and peak memory;
7. print the ``{"kernels": [...]}`` line, the card's name and power limit,
   and last the ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device it fails at once.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12         # FP32 outside the tensor cores
H100_BF16_PER_S = 989e12        # dense bf16 tensor cores
ROUNDS = 6
FLAGSHIP = dict(d=6_568_640, c=500_736, r=5)
GPT2_SKETCH = dict(d=92_138_496, c=524_288, r=5)
GPT2_ROUNDS = 4
# K1: 8 clients + the weight-decay encode; K3: 12 layers x 8 clients
GPT2_PER_ROUND = {"circ_encode": 9, "circ_decode": 1, "flash_fwd": 96,
                  "flash_bwd_dq": 96, "flash_bwd_dkv": 96}
GPT2_VAL_FWD = 12               # one validation batch of 8 items, 12 layers
FLASH_SHAPES = ((8, 1024, 12, 64), (8, 256, 12, 64))   # (N, S, H, D)
FLASH_TILE = 64                 # the kernels' query and key tile
# K3 against its plain version, each (n, s, h) row of D held against its
# own size: |got - ref| <= 1.5e-2 |ref| (+ 1e-3 of the mean row norm, for
# rows near 0) for o, dq, dk and dv. The kernels round p and ds to bf16 as
# product operands and round their outputs to bf16: about 5e-3 at worst
# (an emulation of that rounding on the CPU; read on an H100: 4.6e-3 to
# 5.5e-3, and 1.0 to 1.6 with a planted fault). lse to 1e-4 absolute.
FLASH_ROW_RTOL = 1.5e-2
FLASH_LSE_ATOL = 1e-4
# narrow GPT-2, card against CPU (phase_gpt2_reference): largest relative
# L2 error of a c_attn q/k/v gradient block, largest relative loss
# difference over 3 rounds, least cosine of the rounds' weight update.
# Read on an H100: sound 1.6e-2, 1.8e-3, 0.934; a planted dq fault 0.83,
# 2.8e-2, 0.50; a planted dk/dv fault 0.80, 4.3e-3, 0.49 (the loss alone
# does not separate that one); a planted forward fault far outside.
NARROW_LIMITS = {"grad": 0.1, "dloss": 1e-2, "cos": 0.75}
LIBRARY_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, n: int = 25, warmup: int = 3, reps: int = 3) -> float:
    """Device time of one ``fn()``: CUDA events around ``n`` calls that
    run back to back on the card, median over ``reps`` such runs. The calls
    are enqueued behind a device-side sleep longer than it takes the host
    to enqueue them, so the wrappers' host overhead (checks, ctypes) does
    not enter the time unless it exceeds the device time. The sleep is
    sized from a timed enqueue of ``n`` calls after the warm-up (first
    calls pay one-time set-up) and capped at about a second."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # 2x the enqueue at the card's ~2 GHz clock
    cycles = int(min(2 * enqueue_s, 1.0) * 2e9) + 10_000_000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def reference_file(name: str) -> str:
    """Repository path of the TPU kernels' file ``name`` in the JAX
    package, found on disk (nothing of it is imported)."""
    import glob
    root = os.path.dirname(os.path.abspath(__file__))
    hits = sorted(os.path.relpath(h, root)
                  for h in glob.glob(os.path.join(root, "*", name)))
    hits = [h for h in hits if not h.startswith("commefficient_torch")]
    return hits[0] if hits else name


def phase_build():
    from commefficient_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    for source, log in logs.items():
        lines = [ln for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(f"[build] {source}:\n  " + "\n  ".join(lines))
    print(f"[build] {len(_build.SOURCES)} source(s) in {dt:.2f} s "
          f"({len(logs)} compiled now)", flush=True)


def bound(nbytes: float, ops: float, peak: float):
    """(least ms, "bytes" or "operations") on an H100 SXM."""
    tb, to = nbytes / H100_BYTES_PER_S, ops / peak
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def row_errors(got, ref):
    """Relative L2 error of each row (last dimension) of ``got`` against
    ``ref``: |got - ref| / (|ref| + 1e-3 of ref's mean row norm)."""
    diff = (got.float() - ref.float()).norm(dim=-1)
    norm = ref.float().norm(dim=-1)
    return diff / (norm + 1e-3 * norm.mean())


def planted_drops(S: int, device):
    """(S, S) masks of the (query, key) pairs that a faulty K3 kernel would
    skip: the forward and dq kernels skip key tile 0 for the rows of the
    second half; the dk/dv kernel skips the last query tile for the keys
    outside it."""
    import torch
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    T = FLASH_TILE
    tile0 = (i >= S // 2) & (j < T)
    return {"flash_fwd": tile0, "flash_bwd_dq": tile0,
            "flash_bwd_dkv": (i >= S - T) & (j < S - T)}


def plain_delta(o, do):
    """delta = rowsum(dO o), float32 (N, H, S)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def attention_skipping(q, k, v, drop, do=None, lse=None, delta=None):
    """Causal attention of (N, S, H, D) q, k, v in float32 that leaves out
    the (query, key) pairs of ``drop``: a planted fault. Without ``do``, the
    forward ``(o, lse)``; with ``do``, ``lse`` and ``delta``, the backward
    ``(dq, dk, dv)`` as the kernels compute it."""
    import torch
    S, D = q.shape[1], q.shape[-1]
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril() & ~drop
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) / math.sqrt(D)
    s = s.masked_fill(~keep, float("-inf"))
    if do is None:
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        o = torch.einsum("nhqk,nkhd->nqhd", p, v.float())
        return o.to(q.dtype).contiguous(), lse
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    ds = p * (torch.einsum("nqhd,nkhd->nhqk", dof, v.float())
              - delta[..., None])
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k.float()) / math.sqrt(D)
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q.float()) / math.sqrt(D)
    dv = torch.einsum("nhqk,nqhd->nkhd", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def phase_kernels(shape: dict, cols_list, scale: float, plain_n: int = 20):
    """K1 and K2 against their plain versions at (d, r) of ``shape`` and
    each c of ``cols_list``, and their timings at ``shape['c']``."""
    import numpy as np
    import torch
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops.circulant import make_circulant_sketch

    dev = torch.device("cuda")
    d, c, r = shape["d"], shape["c"], shape["r"]
    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.randn(d).astype(np.float32)).to(dev)
    t0 = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(dev)
    results = {}

    for cols in cols_list:
        cs = make_circulant_sketch(d, cols, r, device=dev)
        m = cs.m
        args = (cs.shifts, cs.sign_keys, cols, r, m)
        tab = t0 if cols == c else torch.from_numpy(
            rng.randn(r, cols).astype(np.float32)).to(dev)
        enc_k = K.encode(v, *args, scale=scale, table=tab.clone())
        enc_p = K.encode_plain(v, *args, scale=scale, table=tab)
        fresh_k = K.encode(v, *args)
        fresh_p = K.encode_plain(v, *args)
        dec_k = K.decode(tab, *args, d)
        dec_p = K.decode_plain(tab, *args, d)
        torch.cuda.synchronize()
        if not torch.isfinite(enc_k).all() or dec_k.shape != (d,):
            fail(f"c={cols}: kernel output not finite or misshapen")
        # K1 bound: bitwise, or |diff| <= 1e-6 * ||scale * v||_inf
        e1 = max(float((enc_k - enc_p).abs().max()),
                 float((fresh_k - fresh_p).abs().max()))
        e2 = float((dec_k - dec_p).abs().max())
        k1_bitwise = torch.equal(enc_k, enc_p) and torch.equal(fresh_k,
                                                               fresh_p)
        print(f"[kernels] c={cols} m={m}: K1 max|diff| {e1} "
              f"(bitwise {k1_bitwise}), K2 max|diff| {e2} "
              f"(bitwise {torch.equal(dec_k, dec_p)})", flush=True)
        if e1 > 1e-6 * scale * float(v.abs().max()):
            fail(f"K1 disagrees with its plain version at c={cols}: {e1}")
        if not torch.equal(dec_k, dec_p):
            fail(f"K2 is not bitwise equal to its plain version at "
                 f"c={cols}: {e2}")
        if cols == c:
            results["err"] = (e1, e2)
            results["args"] = args

    args = results.pop("args")
    m = args[4]
    acc = t0.clone()
    enc_ms = time_ms(lambda: K.encode(v, *args, scale=scale, table=acc))
    enc_plain_ms = time_ms(
        lambda: K.encode_plain(v, *args, scale=scale, table=acc),
        n=plain_n)
    dec_ms = time_ms(lambda: K.decode(t0, *args, d))
    dec_plain_ms = time_ms(lambda: K.decode_plain(t0, *args, d), n=plain_n)

    # least time for the same work on an H100 SXM: every input read once,
    # every output written once, over 3.35 TB/s; the float work over the
    # FP32 peak (K1: a scale multiply and an add per coordinate and row;
    # K2: r(r-1) min/max per coordinate). Integer hashing is not counted.
    k1_bytes = 4 * d + 2 * 4 * r * c
    k1_ops = 2 * r * d
    k2_bytes = 4 * r * c + 4 * d
    k2_ops = r * (r - 1) * d
    bounds = {}
    for name, nbytes, ops in (("circ_encode", k1_bytes, k1_ops),
                              ("circ_decode", k2_bytes, k2_ops)):
        bounds[name] = bound(nbytes, ops, H100_FP32_PER_S)
        print(f"[kernels] {name} (d={d}): {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e6:.1f} M fp32 ops -> bound "
              f"{bounds[name][0] * 1e3:.2f} us ({bounds[name][1]})")
    print(f"[kernels] circ_encode (accumulate, m={m}): kernel {enc_ms:.4f} "
          f"ms, plain {enc_plain_ms:.4f} ms, bound "
          f"{bounds['circ_encode'][0]:.4f} ms")
    print(f"[kernels] circ_decode (m={m}): kernel {dec_ms:.4f} ms, plain "
          f"{dec_plain_ms:.4f} ms, bound {bounds['circ_decode'][0]:.4f} ms",
          flush=True)
    e1, e2 = results["err"]
    return {
        "circ_encode": {"max_abs_err": e1, "ms": enc_ms, "kernel_ms": enc_ms,
                        "plain_ms": enc_plain_ms,
                        "bound_ms": bounds["circ_encode"][0],
                        "bound_by": bounds["circ_encode"][1],
                        "library_ms": None},
        "circ_decode": {"max_abs_err": e2, "ms": dec_ms, "kernel_ms": dec_ms,
                        "plain_ms": dec_plain_ms,
                        "bound_ms": bounds["circ_decode"][0],
                        "bound_by": bounds["circ_decode"][1],
                        "library_ms": None},
    }


def flash_inputs(N, S, H, D, seed=0):
    """q, k, v as the three (N, S, H, D) slices of one seeded (N, S, 3HD)
    bf16 buffer (the c_attn output's layout), and an output gradient."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(N, S, 3 * H * D).astype(
        np.float32)).to("cuda", torch.bfloat16)
    do = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    return q, k, v, do


def flash_bounds(N, S, H, D):
    """(bytes, FLOPs) each K3 kernel must move and do: every input read
    once, every output written once; 2 D FLOPs per causal (query, key)
    pair and product (forward: q k^T and p v; dq: q k^T, dO v^T, ds k;
    dk/dv: k q^T, p^T dO, v dO^T, ds^T q)."""
    pairs = N * H * S * (S + 1) // 2
    product = 2 * D * pairs
    t = 2 * N * S * H * D                      # one bf16 (N, S, H, D)
    stat = 4 * N * H * S                       # one float32 (N, H, S)
    return {"flash_fwd": (4 * t + stat, 2 * product),
            "flash_bwd_dq": (6 * t + 2 * stat, 3 * product),
            "flash_bwd_dkv": (6 * t + 2 * stat, 4 * product)}


def phase_flash():
    """K3 against its plain versions at the main path's shape and at
    S = 256, and timings of kernels, plain versions and SDPA."""
    import torch
    import torch.nn.functional as F
    from commefficient_torch.ops import flash_attention as FA

    out = {}
    for N, S, H, D in FLASH_SHAPES:
        q, k, v, do = flash_inputs(N, S, H, D)
        o, lse = FA.forward(q, k, v)
        dq, delta = FA.backward_dq(q, k, v, o, lse, do)
        dk, dv = FA.backward_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        o_ref, lse_ref = FA.forward_plain(q, k, v)
        refs = dict(zip(("dq", "dk", "dv"),
                        FA.backward_plain(q, k, v, o, lse_ref, do)))
        refs["o"] = o_ref

        def worst(outs):
            """Largest per-row relative error of each output in ``outs``,
            and max|diff| of lse when ``outs`` has it."""
            out = {name: float(row_errors(t, refs[name]).max())
                   for name, t in outs.items() if name != "lse"}
            if "lse" in outs:
                out["lse"] = float((outs["lse"] - lse_ref).abs().max())
            return out

        def passes(errs):
            return all(math.isfinite(e) and e <= (
                FLASH_LSE_ATOL if name == "lse" else FLASH_ROW_RTOL)
                for name, e in errs.items())

        errs = worst({"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv})
        abs_errs = {name: float((t.float() - refs[name].float()).abs().max())
                    for name, t in (("o", o), ("dq", dq), ("dk", dk),
                                    ("dv", dv))}
        print(f"[flash] (N, S, H, D) = {(N, S, H, D)}: worst row error "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (limits {FLASH_ROW_RTOL} of each row's norm, lse "
              f"{FLASH_LSE_ATOL}); max|diff| "
              + ", ".join(f"{n} {e:.3e}" for n, e in abs_errs.items()),
              flush=True)
        if not passes(errs):
            fail(f"K3 disagrees with its plain version at S={S}: {errs}")
        # the check must reject a kernel that skips one tile of its walk
        drops = planted_drops(S, q.device)
        fwd_f = attention_skipping(q, k, v, drops["flash_fwd"])
        delta_ref = plain_delta(o, do)
        dq_f = attention_skipping(q, k, v, drops["flash_bwd_dq"], do,
                                  lse_ref, delta_ref)[0]
        dk_f, dv_f = attention_skipping(q, k, v, drops["flash_bwd_dkv"], do,
                                        lse_ref, delta_ref)[1:]
        for name, outs in (("flash_fwd", {"o": fwd_f[0], "lse": fwd_f[1]}),
                           ("flash_bwd_dq", {"dq": dq_f}),
                           ("flash_bwd_dkv", {"dk": dk_f, "dv": dv_f})):
            planted = worst(outs)
            print(f"[flash] S={S}, planted fault in {name} (one tile "
                  f"skipped): worst row error {planted}", flush=True)
            if passes(planted):
                fail(f"the K3 check passed a planted fault in {name} at "
                     f"S={S}: {planted}")
        del fwd_f, dq_f, dk_f, dv_f, delta_ref
        if S != FLASH_SHAPES[0][1]:
            continue
        del o_ref, refs
        ms = {"flash_fwd": time_ms(lambda: FA.forward(q, k, v)),
              "flash_bwd_dq": time_ms(
                  lambda: FA.backward_dq(q, k, v, o, lse, do)),
              "flash_bwd_dkv": time_ms(
                  lambda: FA.backward_dkv(q, k, v, do, lse, delta))}
        plain_fwd = time_ms(lambda: FA.forward_plain(q, k, v), n=10)
        plain_bwd = time_ms(lambda: FA.backward_plain(q, k, v, o, lse, do),
                            n=10)
        # the library call, timed here only: SDPA on (N, H, S, D) views
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        sdpa_fwd = time_ms(lambda: sdpa().detach())
        o_s = sdpa()
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            o_s, (qt, kt, vt), dot, retain_graph=True))
        sdpa_both = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), dot))
        err_lib = float((o_s.detach().transpose(1, 2).float()
                         - o.float()).abs().max())
        print(f"[flash] S={S}: kernels fwd {ms['flash_fwd']:.4f} ms, dq "
              f"{ms['flash_bwd_dq']:.4f} ms, dk/dv "
              f"{ms['flash_bwd_dkv']:.4f} ms (fwd+bwd "
              f"{sum(ms.values()):.4f} ms); plain fwd {plain_fwd:.4f} ms, "
              f"bwd {plain_bwd:.4f} ms; SDPA fwd {sdpa_fwd:.4f} ms, bwd "
              f"{sdpa_bwd:.4f} ms, fwd+bwd {sdpa_both:.4f} ms (SDPA vs "
              f"kernel o: max|diff| {err_lib:.3e})", flush=True)
        library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                   "flash_bwd_dkv": sdpa_bwd}
        plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd,
                 "flash_bwd_dkv": plain_bwd}
        row_err = {"flash_fwd": errs["o"], "flash_bwd_dq": errs["dq"],
                   "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
        err = {"flash_fwd": abs_errs["o"], "flash_bwd_dq": abs_errs["dq"],
               "flash_bwd_dkv": max(abs_errs["dk"], abs_errs["dv"])}
        for name, (nbytes, flops) in flash_bounds(N, S, H, D).items():
            b_ms, b_by = bound(nbytes, flops, H100_BF16_PER_S)
            print(f"[flash] {name}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP -> bound {b_ms * 1e3:.2f} us "
                  f"({b_by}); kernel {ms[name] * 1e3:.2f} us = "
                  f"{flops / ms[name] / 1e9:.1f} TFLOP/s")
            out[name] = {"max_abs_err": err[name], "ms": ms[name],
                         "kernel_ms": ms[name], "plain_ms": plain[name],
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": library[name],
                         "max_row_err": row_err[name]}
    return out


def phase_small_reference():
    """Narrow ResNet-9 rounds: the card (kernels) against the CPU (plain
    versions). float32 with TF32 off on the card, so only summation order
    differs: losses to rtol 1e-4, weights to atol 1e-5."""
    import numpy as np
    import torch
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.resnet9 import ResNet9

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ch = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32}
    cfg = FedConfig(mode="sketch", error_type="virtual", local_momentum=0.0,
                    virtual_momentum=0.9, weight_decay=5e-4, k=200,
                    num_rows=5, num_cols=4096, num_workers=2,
                    local_batch_size=8, compute_dtype="float32")
    runs = {}
    for device in ("cpu", "cuda"):
        model = ResNet9(channels=ch,
                        generator=torch.Generator().manual_seed(0))
        rt = FedRuntime(cfg, model, make_cv_loss(model, "float32"),
                        device=device)
        st = rt.init_state()
        rng = np.random.RandomState(0)
        losses = []
        for rnd in range(3):
            batch = {"image": rng.randn(2, 8, 32, 32, 3).astype(np.float32),
                     "target": rng.randint(0, 10, (2, 8))}
            st, met = rt.round(st, np.arange(2), batch, np.ones((2, 8), bool),
                               0.1 * (rnd + 1))
            losses.append(met["results"][0].cpu().numpy())
        runs[device] = (np.stack(losses), st.ps_weights.cpu().numpy())
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    (l_cpu, w_cpu), (l_gpu, w_gpu) = runs["cpu"], runs["cuda"]
    dl = float(np.abs(l_gpu - l_cpu).max())
    dw = float(np.abs(w_gpu - w_cpu).max())
    print(f"[reference] narrow ResNet-9, 3 rounds, card vs CPU: max|dloss| "
          f"{dl:.3e}, max|dw| {dw:.3e}", flush=True)
    if not np.allclose(l_gpu, l_cpu, rtol=1e-4, atol=0) or dw > 1e-5:
        fail("the card's rounds disagree with the CPU's plain rounds")


def narrow_gpt2_batch(rng, W, B, C, S, vocab):
    """W clients x B items of C random token sequences that fill all S
    positions, every position with an LM label, so every attention row and
    tile enters the loss (a synthetic PersonaChat dialogue fills at most
    47 positions; the rest is padding that no loss reads)."""
    import numpy as np
    ids = rng.randint(0, vocab, (W, B, C, S))
    return {"input_ids": ids, "lm_labels": ids,
            "token_type_ids": vocab + 2 + rng.randint(0, 2, (W, B, C, S)),
            "mc_token_ids": np.full((W, B, C), S - 1),
            "mc_label": rng.randint(0, C, (W, B))}


def phase_gpt2_reference():
    """Narrow GPT-2 (2 layers, width 128, 2 heads of 64, S = 128, bf16):
    the card (K3, K1, K2) against the CPU (the plain versions), on
    full-length random token batches. Two readings, each with its limit
    (NARROW_LIMITS): (1) the gradient of one client's loss at the initial
    weights, in each layer's q, k and v column blocks of c_attn (what dq,
    dk and dv feed), as relative L2 errors; (2) three sketch rounds:
    relative loss differences and the cosine of the rounds' weight update
    (w - w0). The frameworks round bf16 at different places, so neither is
    exact. Then the card runs again with a planted fault in each K3 kernel
    (one tile of its walk skipped, ``planted_drops``), and the check must
    reject each."""
    import numpy as np
    import torch
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_gpt2_train_loss
    from commefficient_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
    from commefficient_torch.ops import flash_attention as FA

    S, W, B, C = 128, 2, 2, 2
    gcfg = GPT2Config(vocab_size=8192, n_positions=S, n_embd=128,
                      n_layer=2, n_head=2)
    cfg = FedConfig(model="GPT2", dataset_name="PERSONA", mode="sketch",
                    error_type="virtual", virtual_momentum=0.9,
                    weight_decay=5e-4, k=2000, num_rows=5, num_cols=65536,
                    num_workers=W, local_batch_size=B, attn_impl="flash",
                    max_seq_len=S)
    rng = np.random.RandomState(0)
    batches = [narrow_gpt2_batch(rng, W, B, C, S, gcfg.vocab_size)
               for _ in range(3)]
    E = gcfg.n_embd

    def run(device, fault=None):
        """(c_attn gradient blocks, (3, W) losses, update, K3 launches of
        the rounds) with ``fault`` planted in that K3 kernel."""
        saved = FA.forward, FA.backward_dq, FA.backward_dkv
        if fault is not None:
            drop = planted_drops(S, device)[fault]
        if fault == "flash_fwd":
            FA.forward = lambda q, k, v: attention_skipping(q, k, v, drop)
        elif fault == "flash_bwd_dq":
            FA.backward_dq = lambda q, k, v, o, lse, do: (
                attention_skipping(q, k, v, drop, do, lse,
                                   plain_delta(o, do))[0],
                plain_delta(o, do))
        elif fault == "flash_bwd_dkv":
            FA.backward_dkv = lambda q, k, v, do, lse, delta: \
                attention_skipping(q, k, v, drop, do, lse, delta)[1:]
        try:
            model = GPT2DoubleHeads(gcfg, attn_impl="flash",
                                    generator=torch.Generator().manual_seed(0))
            loss_fn = make_gpt2_train_loss(model)
            rt = FedRuntime(cfg, model, loss_fn, device=device)
            st = rt.init_state()
            w0 = st.ps_weights.clone()
            w = w0.clone().requires_grad_(True)
            loss, _ = loss_fn(w, {key: val[0] for key, val in
                                  rt._batch(batches[0]).items()},
                              torch.ones(B, dtype=torch.bool, device=device))
            (g,) = torch.autograd.grad(loss, w)
            g = model.views(g)["transformer/h/block/c_attn/kernel"]
            blocks = {f"layer {i} {name}": g[i, :, j * E:(j + 1) * E].cpu()
                      for i in range(gcfg.n_layer)
                      for j, name in enumerate("qkv")}
            FA.reset_launches()
            losses = []
            for rnd, batch in enumerate(batches):
                st, met = rt.round(st, np.arange(W), batch,
                                   np.ones((W, B), bool), 0.16)
                losses.append(met["results"][0].cpu().numpy())
            return (blocks, np.stack(losses),
                    (st.ps_weights - w0).cpu().numpy(), dict(FA.launches))
        finally:
            FA.forward, FA.backward_dq, FA.backward_dkv = saved

    g_cpu, l_cpu, u_cpu, n_cpu = run("cpu")

    def readings(result):
        g, l, u, _ = result
        grad = max(float((g[key].float() - ref.float()).norm()
                         / ref.float().norm()) for key, ref in g_cpu.items())
        cos = float(u @ u_cpu / (np.linalg.norm(u) * np.linalg.norm(u_cpu)))
        dloss = float(np.abs(l / l_cpu - 1).max())
        return {"grad": grad, "dloss": dloss, "cos": cos}

    def passes(r):
        lim = NARROW_LIMITS
        return (r["grad"] <= lim["grad"] and r["dloss"] <= lim["dloss"]
                and r["cos"] >= lim["cos"])

    sound = run("cuda")
    read = readings(sound)
    print(f"[reference] narrow GPT-2, card (bf16, K3) vs CPU (bf16, plain): "
          f"c_attn q/k/v gradient error {read['grad']:.3e}, 3 rounds: max "
          f"relative dloss {read['dloss']:.3e}, update cosine "
          f"{read['cos']:.6f} (limits {NARROW_LIMITS}); K3 launches of the "
          f"rounds on the card {sound[3]}", flush=True)
    faults = {}
    for fault in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        faults[fault] = readings(run("cuda", fault))
        print(f"[reference] narrow GPT-2 with a planted fault in {fault}: "
              f"{faults[fault]}", flush=True)
    if n_cpu != {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0} \
            or sound[3] != dict.fromkeys(n_cpu, 3 * W * gcfg.n_layer):
        fail(f"narrow GPT-2: unexpected K3 launches {n_cpu} / {sound[3]}")
    if not np.isfinite(sound[1]).all() or not passes(read):
        fail(f"the card's GPT-2 gradient or rounds disagree with the CPU's "
             f"plain ones: {read}")
    passed = [fault for fault, r in faults.items() if passes(r)]
    if passed:
        fail(f"the narrow GPT-2 check passed planted faults in {passed}")


def phase_main_path():
    """Full-width rounds through the user's entry point."""
    import numpy as np
    import torch
    from commefficient_torch import cv_train
    from commefficient_torch.ops import circulant_kernels as K

    argv = ["--dataset_name", "CIFAR10", "--model", "ResNet9",
            "--mode", "sketch", "--error_type", "virtual",
            "--virtual_momentum", "0.9", "--num_workers", "8",
            "--local_batch_size", "64", "--k", "50000", "--num_rows", "5",
            "--num_cols", "500000", "--num_rounds", str(ROUNDS)]
    print("[main] python -m commefficient_torch.cv_train " + " ".join(argv),
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    out = cv_train.main(argv)
    launches = dict(K.launches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if out["rounds"] != ROUNDS:
        fail(f"ran {out['rounds']} rounds, wanted {ROUNDS}")
    if not np.isfinite(out["losses"]).all() or \
            not math.isfinite(out["val_loss"]):
        fail(f"non-finite losses {out['losses']} / {out['val_loss']}")
    if launches["circ_encode"] != 9 * ROUNDS or \
            launches["circ_decode"] != ROUNDS:
        fail(f"launches {launches}: want 9 encode and 1 decode per round")
    rt = statistics.median(out["round_s"][1:])
    print(f"[main] {ROUNDS} rounds: median of rounds 2-{ROUNDS} (the first "
          f"pays one-time set-up) {rt * 1e3:.3f} ms "
          f"(all: {[round(t * 1e3, 3) for t in out['round_s']]}), "
          f"{8 * 64 / rt:.1f} img/s, peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}", flush=True)
    return launches


def phase_gpt2_main():
    """Four GPT-2 rounds at GPT-2 small's width through the user's entry
    point, then its validation."""
    import numpy as np
    import torch
    from commefficient_torch import gpt2_train
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops import flash_attention as FA

    argv = ["--mode", "sketch", "--error_type", "virtual",
            "--virtual_momentum", "0.9", "--num_workers", "8",
            "--local_batch_size", "4", "--num_candidates", "2",
            "--max_seq_len", "1024", "--k", "50000", "--num_rows", "5",
            "--num_cols", "524288", "--num_rounds", str(GPT2_ROUNDS)]
    print("[gpt2] python -m commefficient_torch.gpt2_train " + " ".join(argv),
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    FA.reset_launches()
    out = gpt2_train.main(argv)
    total = gpt2_train.kernel_launches()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rounds = out["launches_after_rounds"]
    val = {name: total[name] - rounds[name] for name in total}
    if out["rounds"] != GPT2_ROUNDS:
        fail(f"ran {out['rounds']} GPT-2 rounds, wanted {GPT2_ROUNDS}")
    if not np.isfinite(out["losses"]).all() or \
            not math.isfinite(out["val_loss"]):
        fail(f"non-finite GPT-2 losses {out['losses']} / {out['val_loss']}")
    want = {name: n * GPT2_ROUNDS for name, n in GPT2_PER_ROUND.items()}
    if rounds != want:
        fail(f"GPT-2 round launches {rounds}, want {want}")
    want_val = dict.fromkeys(total, 0)
    want_val["flash_fwd"] = GPT2_VAL_FWD
    if val != want_val:
        fail(f"GPT-2 validation launches {val}, want {want_val}")
    rt = statistics.median(out["round_s"][1:])
    tflops = out["model_flops_per_round"] / rt / 1e12
    print(f"[gpt2] {GPT2_ROUNDS} rounds: median of rounds 2-{GPT2_ROUNDS} "
          f"(the first pays one-time set-up) {rt * 1e3:.3f} ms "
          f"(all: {[round(t * 1e3, 3) for t in out['round_s']]}), "
          f"{out['tokens_per_round'] / rt:.1f} tokens/s, "
          f"{out['model_flops_per_round'] / 1e12:.3f} model TFLOP/round -> "
          f"{tflops:.2f} TFLOP/s = {100 * tflops * 1e12 / H100_BF16_PER_S:.2f}"
          f"% of 989 TFLOP/s, peak memory {peak / 2**30:.3f} GiB, "
          f"val nll {out['val_loss']:.4f}; launches: rounds {rounds}, "
          f"validation {val}", flush=True)
    return rounds, val


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs only on the card")
    try:
        import commefficient_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable here ({e}): run from the root "
             "of the repository")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        print(f"[time] {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    phase_build()
    done("build")
    # scale: a client's datum count, as the fused step passes it
    circ = phase_kernels(FLAGSHIP, (FLAGSHIP["c"], 500_000), scale=64.0)
    circ_gpt2 = phase_kernels(GPT2_SKETCH, (GPT2_SKETCH["c"],), scale=4.0,
                              plain_n=5)
    done("K1/K2")
    flash = phase_flash()
    done("K3")
    phase_small_reference()
    phase_gpt2_reference()
    done("card-vs-CPU rounds")
    cv_launches = phase_main_path()
    done("ResNet-9 main path")
    gpt2_rounds, gpt2_val = phase_gpt2_main()
    done("GPT-2 main path")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("JAX was imported: the port must run without it")

    pallas_file = reference_file("ops/circulant_pallas.py")
    gpt2_file = reference_file("models/gpt2.py")
    kernels = []
    for name, line in (("circ_encode", 144), ("circ_decode", 175)):
        by_path = {"cv_train": cv_launches[name],
                   "gpt2_train": gpt2_rounds[name] + gpt2_val[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "commefficient_torch/csrc/circulant.cu",
            "replaces": f"{pallas_file}:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **circ[name], "at_gpt2_shape": circ_gpt2[name]})
    for name, line in (("flash_fwd", 589), ("flash_bwd_dq", 1287),
                       ("flash_bwd_dkv", 941)):
        by_path = {"gpt2_train rounds": gpt2_rounds[name],
                   "gpt2_train validation": gpt2_val[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "commefficient_torch/csrc/flash_attention.cu",
            "replaces": f"{gpt2_file}:106 -> {LIBRARY_FLASH}:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **flash[name]})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
