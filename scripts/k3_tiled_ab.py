#!/usr/bin/env python3
"""K3's kernels of another tree against this tree's, on one NVIDIA card,
in one process. Both libraries of each tree are built
(``commefficient_torch/csrc/flash_attention.cu``, the wgmma/TMA kernels,
and ``flash_tiled.cu``, the ``mma.sync`` ones), and each tree runs each
form through its own routes: every entry point from whichever of its two
libraries exports it, so a form whose kernels moved between the files is
compared with the kernels that ran it before.

1. The SASS of each kernel of ``flash_attention.cu`` that both trees
   build (the same kernel and head width; the D = 64 forward, dq and
   dk/dv): instruction for instruction, from ``cuobjdump -sass``.
2. Every form of the route table (float32 at D = 16, 32, 64 and 128;
   bf16 at D = 16, 32, 64 and 128) at (8, 1024, 768 / D, D) and (8,
   256, 768 / D, D), bf16 D = 64 also at the bench paths' shapes
   (BENCH_SHAPES): both builds held to the plain
   version (``chip_smoke.flash_route_errors``: FLASH_F32_RTOL in float32,
   FLASH_ROW_RTOL in bf16) and timed in the order other, this, this,
   other, forward, dq and dk/dv, the forward's and the backward pair's
   share of their bounds printed beside SDPA's forward and backward
   timed in the same call.
3. ``GPT2DoubleHeads`` at GPT-2 small's width and depth (768 wide, 12
   layers) in bf16 with 6 heads of 128, 24 of 32 and 48 of 16, a
   training-loss forward and backward of (2, 2, 1024) tokens
   (``chip_smoke.model_route_steps``: exactly 12 of each of the form's
   kernels a step, a finite loss and gradient, the median of the steps
   after the first, and one step profiled: device busy, K3's kernels)
   under each build in the same order.

    git show <commit>:commefficient_torch/csrc/flash_tiled.cu > tiled.cu
    git show <commit>:commefficient_torch/csrc/flash_attention.cu > fa.cu
    python3 scripts/k3_tiled_ab.py --other tiled.cu --other_fa fa.cu

The other sources must export their entry points under the names and
signatures of ``ops/flash_attention.py route`` (every tree since the
route table has). Each line names a form and gives each build's forward,
dq and dk/dv times in ms.
"""

import argparse
import dataclasses
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

GPT2_FORMS = (16, 32, 128)    # bf16 head widths of the 12-layer steps
# (N, S, H) of bf16 D = 64 beside the main shapes: the bench paths' (the
# bare-model bench's microbatch and the long-context bench's)
BENCH_SHAPES = ((16, 1024, 12), (8, 2048, 12), (4, 4096, 12))
GPT2_LAYERS = 12
GPT2_STEPS = 8                # timed steps of each; the first warms up


def sass_functions(path: str) -> dict:
    """{(kernel, D): [instruction text, ...]} of the library at ``path``
    (``cuobjdump -sass``; a kernel without template argument is D = 64)."""
    from commefficient_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    funcs, key = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                          r"(?:ILi(\d+)E)?", line)
            key = (m.group(1), int(m.group(2) or 64)) if m else None
            if key is not None:
                funcs[key] = []
        elif key is not None and "/*" in line and ";" in line:
            funcs[key].append(line.split("*/", 1)[1].split(";")[0].strip())
    return funcs


def sass_identity(other: str, this: str) -> None:
    a, b = sass_functions(other), sass_functions(this)
    for key in sorted(set(a) & set(b)):
        x, y = a[key], b[key]
        diff = sum(p != q for p, q in zip(x, y)) + abs(len(x) - len(y))
        print(f"[k3_tiled_ab] SASS {key[0]} D={key[1]}: other "
              f"{len(x)} instructions, this {len(y)}; "
              + ("identical, instruction for instruction" if diff == 0
                 else f"{diff} differ"), flush=True)
    for key in sorted(set(b) - set(a)):
        print(f"[k3_tiled_ab] SASS {key[0]} D={key[1]}: this tree only "
              f"({len(b[key])} instructions)", flush=True)


def main(argv=None) -> int:
    import torch
    from commefficient_torch.ops import _build
    from commefficient_torch.ops import flash_attention as FA

    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True,
                   help="flash_tiled.cu of the tree to compare with")
    p.add_argument("--other_fa", required=True,
                   help="flash_attention.cu of the tree to compare with")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    sources = (FA.SOURCE, FA.TILED_SOURCE)
    _build.build_all(sources)
    paths = {"this": {s: _build.library_path(s) for s in sources},
             "other": {}}
    jobs = []
    for source, given in ((FA.SOURCE, args.other_fa),
                          (FA.TILED_SOURCE, args.other)):
        out = os.path.join(_build.BUILD_DIR, f"libother_"
                           f"{os.path.splitext(source)[0]}-{os.getpid()}.so")
        paths["other"][source] = out
        jobs.append(subprocess.Popen(
            [_build.find_nvcc(), *_build.nvcc_flags(source), "-o", out,
             given], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for job in jobs:
        log, _ = job.communicate()
        if job.returncode != 0:
            cs.fail(f"the other tree's build failed:\n{log}")
    sass_identity(paths["other"][FA.SOURCE], paths["this"][FA.SOURCE])

    this_route = FA.route

    def other_route(dtype, D):
        """The other tree's route: each kernel from the library of that
        tree that exports it."""
        r = this_route(dtype, D)
        return dataclasses.replace(r, sources=tuple(
            FA.SOURCE if hasattr(FA._lib(FA.SOURCE), name)
            else FA.TILED_SOURCE for name in r.names))

    def use(label):
        for source, path in paths[label].items():
            lib = _build.load_from(source, path)
            if FA._lib(source) is not lib:
                cs.fail(f"the wrappers do not run the {label} library")
        FA.route = other_route if label == "other" else this_route

    try:
        for dtype, D in FA.ROUTES:
            kernel_ab(use, FA, dtype, D)
        bf16_steps(use)
    finally:
        FA.route = this_route
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


def kernel_ab(use, FA, dtype, D) -> None:
    """One form at (8, 1024, 768 / D, D) and (8, 256, 768 / D, D), bf16 D
    = 64 also at BENCH_SHAPES: both builds against the plain version,
    then timed other, this, this, other, beside SDPA."""
    import torch
    import torch.nn.functional as F
    f32 = dtype == torch.float32
    shapes = [(8, 1024, 768 // D), (8, 256, 768 // D)]
    if (dtype, D) == (torch.bfloat16, 64):
        shapes += BENCH_SHAPES
    for N, S, H in shapes:
        q, k, v, do = cs.flash_inputs(N, S, H, D, dtype=dtype)
        line = []
        fwds, pairs = {"other": [], "this": []}, {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            use(label)
            o, lse = FA.forward(q, k, v)
            dq, delta = FA.backward_dq(q, k, v, o, lse, do)
            dk, dv = FA.backward_dkv(q, k, v, do, lse, delta)
            torch.cuda.synchronize()
            errs, ok = cs.flash_route_errors(
                q, k, v, do, {"o": o, "lse": lse, "dq": dq, "dk": dk,
                              "dv": dv})
            if not ok:
                cs.fail(f"{label} {FA.route(dtype, D).names} at "
                        f"{(N, S, H, D)}: {errs}")
            t = (cs.time_ms(lambda: FA.forward(q, k, v), n=10),
                 cs.time_ms(lambda: FA.backward_dq(q, k, v, o, lse, do),
                            n=10),
                 cs.time_ms(lambda: FA.backward_dkv(q, k, v, do, lse,
                                                    delta), n=10))
            fwds[label].append(t[0])
            pairs[label].append(t[1] + t[2])
            line.append(f"{label} {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} "
                        f"(error o {errs['o']:.1e}, worst "
                        f"{max(errs.values()):.1e})")
        use("this")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        sdpa_fwd = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True).detach(), n=10)
        o_s = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa_bwd = cs.time_ms(lambda: torch.autograd.grad(
            o_s, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
            n=10)
        bounds = cs.flash_bounds(N, S, H, D, elem=4 if f32 else 2)
        peak, mul = ((cs.H100_TF32_PER_S, 3) if f32
                     else (cs.H100_BF16_PER_S, 1))
        nb, fl = bounds["flash_fwd"]
        fwd_bound = cs.bound(nb, mul * fl, peak)[0]
        pair_bound = sum(cs.bound(nb, mul * fl, peak)[0]
                         for name, (nb, fl) in bounds.items()
                         if name != "flash_fwd")
        tag = FA.DTYPES[dtype]
        print(f"[k3_tiled_ab] {tag} {(N, S, H, D)} ms fwd / dq / dk-dv: "
              + "; ".join(line)
              + f"; SDPA fwd {sdpa_fwd:.4f}, bwd {sdpa_bwd:.4f}", flush=True)
        for part, b, times, sdpa in (("forward", fwd_bound, fwds, sdpa_fwd),
                                     ("backward pair", pair_bound, pairs,
                                      sdpa_bwd)):
            print(f"[k3_tiled_ab] {tag} {(N, S, H, D)} {part} (ms; bound "
                  f"{b:.4f}): "
                  + "; ".join(f"{k} " + ", ".join(
                      f"{t:.4f} ({100 * b / t:.1f}% of the bound)"
                      for t in v) for k, v in times.items())
                  + f"; SDPA {sdpa:.4f}", flush=True)
        del q, k, v, do, o, lse, dq, delta, dk, dv, qt, kt, vt, o_s
        torch.cuda.empty_cache()


def bf16_steps(use) -> None:
    """The 12-layer bf16 GPT2DoubleHeads step at each of GPT2_FORMS'
    head widths under each build, interleaved: GPT2_STEPS steps (the
    median of those after the first, host clock) and one more profiled
    (device busy, K3's kernels)."""
    import torch
    for D in GPT2_FORMS:
        ms = {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            use(label)
            tag, _, step_ms, peak, busy = cs.model_route_steps(
                torch.bfloat16, D, GPT2_LAYERS, steps=GPT2_STEPS,
                profile=True)
            ms[label].append((step_ms, busy["busy_ms"], busy["k3_ms"]))
            print(f"[k3_tiled_ab] {tag} under {label}: median step "
                  f"{step_ms:.3f} ms, peak {peak / 2**30:.3f} GiB",
                  flush=True)
        print(f"[k3_tiled_ab] bf16 D={D} {GPT2_LAYERS}-layer step (ms: "
              "host median / device busy / K3): "
              + "; ".join(f"{k} " + ", ".join(
                  f"{a:.3f} / {b:.3f} / {c:.3f}" for a, b, c in v)
                  for k, v in ms.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
