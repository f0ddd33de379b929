#!/usr/bin/env python3
"""K3's tiled kernels (``commefficient_torch/csrc/flash_tiled.cu``) of
another tree against this tree's, on one NVIDIA card, in one process:
every route of the file (float32 at D = 16, 32, 64 and 128: forward, dq
and dk/dv; bf16 at D = 16, 32 and 128: forward, dq and dk/dv) at (8, 1024,
768 / D, D) and (8, 256, 768 / D, D), both builds held to the plain
version (``chip_smoke.flash_route_errors``: FLASH_F32_RTOL in float32,
FLASH_ROW_RTOL in bf16) and timed in the order other, this, this, other,
with SDPA's forward and backward timed in the same call. Then
``gpt2_train --compute_dtype float32`` at GPT-2 small's width and S = 1024
(``chip_smoke.phase_gpt2_main``: GPT2_ROUNDS rounds, exact launches, the
median of the rounds after the first) under each build in the same
order, and ``profile_round`` of that run (two rounds after one of
warm-up, and one more with the operators' input shapes) under the other
build and this one: the float32 GPT-2 path is the one that runs these
kernels at full width.

    git show <commit>:commefficient_torch/csrc/flash_tiled.cu > other.cu
    python3 scripts/k3_tiled_ab.py --other other.cu

The other source must export the entry points under the names and
signatures of ``ops/flash_attention.py route`` (every tree since the route
table has). Each line names a form and gives each build's forward, dq and
dk/dv times in ms.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F
    from commefficient_torch.ops import _build
    from commefficient_torch.ops import flash_attention as FA

    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True,
                   help="flash_tiled.cu of the tree to compare with")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    source = FA.TILED_SOURCE
    _build.build_all((source,))
    other = os.path.join(_build.BUILD_DIR, f"libother_flash_tiled-"
                         f"{os.getpid()}.so")
    subprocess.run([_build.find_nvcc(), *_build.nvcc_flags(source), "-o",
                    other, args.other], check=True, capture_output=True)
    paths = {"other": other, "this": _build.library_path(source)}

    def use(label):
        lib = _build.load_from(source, paths[label])
        if FA._lib(source) is not lib:
            cs.fail(f"the wrappers do not run the {label} library")

    for (dtype, D), r in FA.ROUTES.items():
        if r.source != source:
            continue
        for N, S, H in ((8, 1024, 768 // D), (8, 256, 768 // D)):
            q, k, v, do = cs.flash_inputs(N, S, H, D, dtype=dtype)
            line = []
            for label in ("other", "this", "this", "other"):
                use(label)
                o, lse = FA.forward(q, k, v)
                dq, delta = FA.backward_dq(q, k, v, o, lse, do)
                dk, dv = FA.backward_dkv(q, k, v, do, lse, delta)
                torch.cuda.synchronize()
                errs, ok = cs.flash_route_errors(
                    q, k, v, do,
                    {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv})
                if not ok:
                    cs.fail(f"{label} {r.fwd} at {(N, S, H, D)}: {errs}")
                t = (cs.time_ms(lambda: FA.forward(q, k, v), n=10),
                     cs.time_ms(lambda: FA.backward_dq(q, k, v, o, lse, do),
                                n=10),
                     cs.time_ms(lambda: FA.backward_dkv(q, k, v, do, lse,
                                                        delta), n=10))
                line.append(f"{label} {t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} "
                            f"(error o {errs['o']:.1e}, worst "
                            f"{max(errs.values()):.1e})")
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            sdpa_fwd = cs.time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True).detach(), n=10)
            o_s = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            sdpa_bwd = cs.time_ms(lambda: torch.autograd.grad(
                o_s, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
                n=10)
            print(f"[k3_tiled_ab] {FA.DTYPES[dtype]} {(N, S, H, D)} ms "
                  f"fwd / dq / dk-dv: " + "; ".join(line)
                  + f"; SDPA fwd {sdpa_fwd:.4f}, bwd {sdpa_bwd:.4f}",
                  flush=True)
            del q, k, v, do, o, lse, dq, delta, dk, dv, qt, kt, vt, o_s
            torch.cuda.empty_cache()
    cs.DATA_ROOT["path"] = tempfile.mkdtemp(prefix="k3_tiled_ab_")
    try:
        gpt2_paths(use, FA)
    finally:
        shutil.rmtree(cs.DATA_ROOT["path"], ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


def gpt2_paths(use, FA) -> None:
    """The float32 GPT-2 round and its profile under each build."""
    import torch
    from commefficient_torch import profile_round

    names = FA.route(torch.float32, 64).names
    medians = {"other": [], "this": []}
    for label in ("other", "this", "this", "other"):
        use(label)
        _, _, ms, info = cs.phase_gpt2_main(
            ["--compute_dtype", "float32"], cs.GPT2_ROUNDS, k3=names)
        medians[label].append(ms)
        print(f"[k3_tiled_ab] gpt2_train --compute_dtype float32 under "
              f"{label}: median round {ms:.3f} ms, peak "
              f"{info['peak'] / 2**30:.3f} GiB", flush=True)
    print("[k3_tiled_ab] float32 GPT-2 round medians (ms): "
          + "; ".join(f"{k} " + ", ".join(f"{t:.3f}" for t in v)
                      for k, v in medians.items()), flush=True)
    for label in ("other", "this"):
        use(label)
        argv = [*cs.GPT2_ARGV, "--model", "GPT2", "--compute_dtype",
                "float32", "--warmup", "1", "--rounds", "2", "--shapes", "1",
                "--top", "25", *cs.logdir_flags(f"profile {label}")]
        print(f"[k3_tiled_ab] under {label}: python -m "
              "commefficient_torch.profile_round " + " ".join(argv),
              flush=True)
        profile_round.main(argv)


if __name__ == "__main__":
    sys.exit(main())
