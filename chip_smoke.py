#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together) and print the build time;
2. hold K1 (circulant encode) and K2 (circulant decode) against their
   plain PyTorch versions on the card at the flagship shapes
   (d = 6,568,640, c = 500,736, r = 5; seeded inputs; shifts from
   ``make_circulant_sketch``), and at the unaligned c = 500,000; time
   kernel and plain version with CUDA events (median of 25 after warm-up)
   beside each kernel's bound;
3. a small-input check: three rounds of a narrow ResNet-9 on the card
   (float32, TF32 off) against the same rounds on the CPU, whose wrappers
   take the plain versions;
4. the main path: ``commefficient_torch.cv_train`` at full width (8 clients
   x 64 synthetic CIFAR10 images, k = 50,000, r = 5, c = 500,000 -> 500,736,
   bf16 compute), with every launch count set to 0 just before and read
   just after; requires 9 encode and 1 decode launch per round, finite
   losses, and prints the median round time, img/s and peak memory;
5. print the ``{"kernels": [...]}`` line, the card's name and power limit,
   and last the ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the JAX package. Without a CUDA
device it fails at once.
"""

import json
import math
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12         # FP32 outside the tensor cores
ROUNDS = 6
FLAGSHIP = dict(d=6_568_640, c=500_736, r=5)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median of ``n`` CUDA-event timings of ``fn()``, after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def reference_file(name: str) -> str:
    """Repository path of the TPU kernels' file ``name`` in the JAX
    package, found on disk (nothing of it is imported)."""
    import glob
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    hits = sorted(glob.glob(os.path.join(root, "*", name)))
    return os.path.relpath(hits[0], root) if hits else name


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


def phase_kernels():
    """K1 and K2 against their plain versions, and their timings."""
    import numpy as np
    import torch
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops.circulant import make_circulant_sketch

    dev = torch.device("cuda")
    d, c, r = FLAGSHIP["d"], FLAGSHIP["c"], FLAGSHIP["r"]
    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.randn(d).astype(np.float32)).to(dev)
    t0 = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(dev)
    scale = 64.0   # a client's datum count, as the fused step passes it
    results = {}

    for cols in (c, 500_000):
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
        lambda: K.encode_plain(v, *args, scale=scale, table=acc), n=20)
    dec_ms = time_ms(lambda: K.decode(t0, *args, d))
    dec_plain_ms = time_ms(lambda: K.decode_plain(t0, *args, d), n=20)

    # least time for the same work on an H100 SXM: every input read once,
    # every output written once, over 3.35 TB/s; the float work over the
    # FP32 peak (K1: a scale multiply and an add per coordinate and row;
    # K2: r(r-1) min/max per coordinate). Integer hashing is not counted.
    k1_bytes = 4 * d + 2 * 4 * r * c
    k1_ops = 2 * r * d
    k2_bytes = 4 * r * c + 4 * d
    k2_ops = r * (r - 1) * d
    bound = {}
    for name, nbytes, ops in (("circ_encode", k1_bytes, k1_ops),
                              ("circ_decode", k2_bytes, k2_ops)):
        tb, to = nbytes / H100_BYTES_PER_S, ops / H100_FP32_PER_S
        bound[name] = (1e3 * max(tb, to), "bytes" if tb >= to else
                       "operations")
        print(f"[kernels] {name}: {nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} M "
              f"fp32 ops -> bound {bound[name][0] * 1e3:.2f} us "
              f"({bound[name][1]})")
    print(f"[kernels] circ_encode (accumulate, m={m}): kernel {enc_ms:.4f} "
          f"ms, plain {enc_plain_ms:.4f} ms, bound "
          f"{bound['circ_encode'][0]:.4f} ms")
    print(f"[kernels] circ_decode: kernel {dec_ms:.4f} ms, plain "
          f"{dec_plain_ms:.4f} ms, bound {bound['circ_decode'][0]:.4f} ms",
          flush=True)
    e1, e2 = results["err"]
    pallas_file = reference_file("ops/circulant_pallas.py")
    return [
        {"name": "circ_encode", "route": "cuda",
         "source": "commefficient_torch/csrc/circulant.cu",
         "replaces": f"{pallas_file}:144",
         "max_abs_err": e1, "ms": enc_ms, "kernel_ms": enc_ms,
         "plain_ms": enc_plain_ms, "bound_ms": bound["circ_encode"][0],
         "bound_by": bound["circ_encode"][1], "library_ms": None},
        {"name": "circ_decode", "route": "cuda",
         "source": "commefficient_torch/csrc/circulant.cu",
         "replaces": f"{pallas_file}:175",
         "max_abs_err": e2, "ms": dec_ms, "kernel_ms": dec_ms,
         "plain_ms": dec_plain_ms, "bound_ms": bound["circ_decode"][0],
         "bound_by": bound["circ_decode"][1], "library_ms": None},
    ]


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
    rt = statistics.median(out["round_s"])
    print(f"[main] {ROUNDS} rounds: median round {rt * 1e3:.3f} ms "
          f"(all: {[round(t * 1e3, 3) for t in out['round_s']]}), "
          f"{8 * 64 / rt:.1f} img/s, peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}", flush=True)
    return launches


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
    phase_build()
    kernels = phase_kernels()
    phase_small_reference()
    launches = phase_main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("JAX was imported: the port must run without it")
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
