"""Where a round's time goes: ``torch.profiler`` over a few rounds of the
``cv_train`` run (or, with ``--model GPT2``, the ``gpt2_train`` run) that
the same flags describe.

    python -m commefficient_torch.profile_round --num_workers 8 \\
        --local_batch_size 64 --k 50000 --num_rows 5 --num_cols 500000 \\
        --virtual_momentum 0.9 --warmup 2 --profile_rounds 3
    python -m commefficient_torch.profile_round --model GPT2 \\
        --num_workers 8 --local_batch_size 4 --max_seq_len 1024 \\
        --k 50000 --num_cols 524288 --virtual_momentum 0.9 \\
        --warmup 1 --profile_rounds 2

Prints the device time by kernel group (the flash-attention kernels,
the circulant-sketch kernels, convolution and matmul, top-k and sorting,
other), the device's busy and idle share of the profiled window (busy =
the union of device kernel intervals), and the top kernels by device
time. Writes the Chrome trace to ``--trace`` when given. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from commefficient_torch import cv_train, gpt2_train
from commefficient_torch.config import parse_known
from commefficient_torch.core import driver
from commefficient_torch.utils.schedules import lr_schedule_for

GROUPS = (
    ("flash attention (K3)", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                              "flash_bwd_dkv_kernel")),
    ("sketch kernels (K1, K2)", ("encode_kernel", "decode_kernel")),
    ("convolution / matmul", ("conv", "cudnn", "gemm", "xmma", "sm90",
                              "wgrad", "dgrad", "implicit", "nvjet",
                              "cutlass")),
    ("top-k / sort / nonzero", ("topk", "sort", "radix", "select",
                                "nonzero", "scan", "gatherTopK")),
)


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return label
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--model", default="ResNet9")
    entry = (gpt2_train if pre.parse_known_args(argv)[0].model == "GPT2"
              else cv_train)
    p = entry.build_parser()
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--profile_rounds", type=int, default=3)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--trace", default="")
    ns = parse_known(p, argv)
    if not torch.cuda.is_available() or torch.device(ns.device).type != "cuda":
        raise SystemExit("profile_round measures the card: no CUDA device")
    runtime, state, train_ds = entry.setup(ns)[:3]
    schedule = (gpt2_train.make_gpt2_schedule(runtime.cfg)
                if entry is gpt2_train else lr_schedule_for(runtime.cfg))
    it = driver.rounds(runtime, train_ds, schedule)
    for _ in range(ns.warmup):
        _, lr, rnd = next(it)
        state, _ = runtime.round(state, rnd.client_ids,
                                 train_ds.gather(rnd.idx), rnd.mask, lr)
    torch.cuda.synchronize()
    batches = []
    for _ in range(ns.profile_rounds):
        _, lr, rnd = next(it)
        batches.append((rnd, lr, train_ds.gather(rnd.idx)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rnd, lr, batch in batches:
            state, _ = runtime.round(state, rnd.client_ids, batch, rnd.mask,
                                     lr)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device activity; time "
                         "with CUDA events instead")
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    span = [(e.time_range.start, e.time_range.end) for e in kernels]
    window_us = max(e for _, e in span) - min(s for s, _ in span)
    busy = _busy_us(span)
    n = ns.profile_rounds
    out = {
        "rounds": n,
        "wall_ms_per_round": wall_us / n / 1e3,
        "device_busy_ms_per_round": busy / n / 1e3,
        "device_idle_share_of_wall": 1.0 - busy / wall_us,
        "device_window_ms_per_round": window_us / n / 1e3,
        "kernel_ms_per_round_by_group": {
            k: v / n / 1e3 for k, v in sorted(by_group.items(),
                                               key=lambda kv: -kv[1])},
        "device_ops_per_round": len(kernels) / n,
        "device": torch.cuda.get_device_name(0),
    }
    print(f"{n} rounds: wall {out['wall_ms_per_round']:.3f} ms/round, "
          f"device busy {out['device_busy_ms_per_round']:.3f} ms/round, "
          f"idle share {out['device_idle_share_of_wall']:.3f}, "
          f"{out['device_ops_per_round']:.0f} device ops/round")
    for k, v in out["kernel_ms_per_round_by_group"].items():
        print(f"  {k:<28} {v:9.3f} ms/round")
    print(f"top {ns.top} kernels by device time (ms per round):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:ns.top]:
        print(f"  {us / n / 1e3:9.3f}  {name[:110]}")
    if ns.trace:
        prof.export_chrome_trace(ns.trace)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
