#!/usr/bin/env python3
"""K3's float32 backward kernels (dq, dk/dv of
``commefficient_torch/csrc/flash_tiled.cu``) of another tree against this
tree's, on one NVIDIA card, in one process: at (8, 1024, 768 / D, D) and
(8, 256, 768 / D, D) for D = 16, 32, 64 and 128, both builds held to the
plain version (``chip_smoke.flash_route_errors``, FLASH_F32_RTOL) and
timed in the order other, this, this, other, with SDPA's float32
backward timed in the same call.

    git show <commit>:commefficient_torch/csrc/flash_tiled.cu > other.cu
    python3 scripts/k3_tiled_ab.py --other other.cu

The other source must export the float32 entry points under the names
and signatures of ``ops/flash_attention.py route`` (every tree since the
route table has).
"""

import argparse
import os
import subprocess
import sys

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

    for D in FA.HEAD_DIMS:
        for N, S, H in ((8, 1024, 768 // D), (8, 256, 768 // D)):
            q, k, v, do = cs.flash_inputs(N, S, H, D, dtype=torch.float32)
            use("this")
            o, lse = FA.forward(q, k, v)
            line = []
            for label in ("other", "this", "this", "other"):
                use(label)
                dq, delta = FA.backward_dq(q, k, v, o, lse, do)
                dk, dv = FA.backward_dkv(q, k, v, do, lse, delta)
                torch.cuda.synchronize()
                errs, ok = cs.flash_route_errors(
                    q, k, v, do, {"o": o, "dq": dq, "dk": dk, "dv": dv})
                if not ok:
                    cs.fail(f"{label} at {(N, S, H, D)}: {errs}")
                t_dq = cs.time_ms(
                    lambda: FA.backward_dq(q, k, v, o, lse, do), n=10)
                t_dkv = cs.time_ms(
                    lambda: FA.backward_dkv(q, k, v, do, lse, delta), n=10)
                line.append(f"{label} {t_dq:.4f} + {t_dkv:.4f} = "
                            f"{t_dq + t_dkv:.4f} (error "
                            f"{max(errs.values()):.1e})")
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            o_s = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            sdpa = cs.time_ms(lambda: torch.autograd.grad(
                o_s, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
                n=10)
            print(f"[k3_tiled_ab] {(N, S, H, D)} ms dq + dk/dv: "
                  + "; ".join(line) + f"; SDPA backward {sdpa:.4f}",
                  flush=True)
            del q, k, v, do, o, lse, dq, delta, dk, dv, qt, kt, vt, o_s
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
