#!/usr/bin/env python3
"""K1 (the circulant encode, ``commefficient_torch/csrc/circulant.cu``)
of another tree against this tree's, on one NVIDIA card, in one process:
the instructions a (row, coordinate) term of each r = 5 build issues in
its SASS, the bits of the whole-vector encode, and its time at the
ResNet-9, GPT-2 and StreamMLP shapes in the order other, this, this,
other.

    git show <commit>:commefficient_torch/csrc/circulant.cu > other.cu
    python3 scripts/k1_ab.py --other other.cu

The other source must have the C interface ``circ_encode(v, start, n,
shifts, keys, c, r, m, scale, accumulate, table, stream)``
(``csrc/circulant.cu`` since K1's range form); the whole vector is
``start = 0, n = d``.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def encode_kernel_sass(path: str, tool: str):
    lines = subprocess.run([tool, "-sass", path], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    out, keep = [], False
    for line in lines:
        if "Function :" in line:
            keep = "encode_kernelILi5E" in line
        elif keep:
            out.append(line)
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch
    from commefficient_torch.ops import _build
    from commefficient_torch.ops import circulant_kernels as K
    from commefficient_torch.ops.circulant import make_circulant_sketch

    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True,
                   help="circulant.cu of the tree to compare with")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    _build.build_all((K.SOURCE,))
    nvcc = _build.find_nvcc()
    lib_dir = tempfile.mkdtemp(prefix="k1_ab_")
    other = os.path.join(lib_dir, "libother_circulant.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", other, args.other],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(other)
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.circ_encode.argtypes = [ptr, ll, ll, ptr, ptr, i, i, i,
                                ctypes.c_float, i, ptr, ptr]
    lib.circ_encode.restype = i
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    for label, path in (("other", other),
                        ("this", _build.library_path(K.SOURCE))):
        per, hashes = cs.sass_per_term(encode_kernel_sass(path, tool))
        print(f"[k1_ab] {label}: SASS a term (r = 5, block of {hashes} "
              "hashes): " + ", ".join(f"{n:.2f} {k}" for k, n in per.items())
              + f" = {sum(per.values()):.2f}", flush=True)

    def other_encode(v, sk, scale, table):
        err = lib.circ_encode(v.data_ptr(), 0, v.shape[0],
                              sk.shifts.data_ptr(), sk.sign_keys.data_ptr(),
                              sk.c, sk.r, sk.m, scale, 1, table.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if err:
            cs.fail(f"the other circ_encode failed: CUDA error {err}")
        return table

    for shape in (cs.FLAGSHIP, cs.GPT2_SKETCH, cs.STREAM_SKETCH):
        d, c, r = shape["d"], shape["c"], shape["r"]
        sk = make_circulant_sketch(d, c, r, device="cuda")
        rng = np.random.RandomState(0)
        v = torch.from_numpy(rng.randn(d).astype(np.float32)).cuda()
        t0 = torch.from_numpy(rng.randn(r, c).astype(np.float32)).cuda()
        a = other_encode(v, sk, 64.0, t0.clone())
        b = K.encode(v, sk.shifts, sk.sign_keys, c, r, sk.m, scale=64.0,
                     table=t0.clone())
        torch.cuda.synchronize()
        if not cs.same_bits(a, b):
            cs.fail(f"m={sk.m}: the two K1 builds differ in bits")
        acc_o, acc_t = t0.clone(), t0.clone()
        times = []
        for label in ("other", "this", "this", "other"):
            if label == "other":
                ms = cs.time_ms(lambda: other_encode(v, sk, 64.0, acc_o))
            else:
                ms = cs.time_ms(lambda: K.encode(
                    v, sk.shifts, sk.sign_keys, c, r, sk.m, scale=64.0,
                    table=acc_t))
            times.append(f"{label} {ms:.4f}")
        print(f"[k1_ab] m={sk.m}: bitwise equal; ms " + ", ".join(times),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
