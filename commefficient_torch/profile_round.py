"""Where a round's time goes: ``torch.profiler`` over a few rounds of the
``cv_train`` run (or, with ``--model GPT2``, the ``gpt2_train`` run) that
the same flags describe.

    python -m commefficient_torch.profile_round --num_workers 8 \\
        --local_batch_size 64 --k 50000 --num_rows 5 --num_cols 500000 \\
        --error_type virtual --local_momentum 0 --virtual_momentum 0.9 \\
        --warmup 2 --rounds 3
    python -m commefficient_torch.profile_round --model GPT2 \\
        --num_workers 8 --local_batch_size 4 --max_seq_len 1024 \\
        --k 50000 --num_cols 524288 --error_type virtual \\
        --local_momentum 0 --virtual_momentum 0.9 \\
        --warmup 1 --rounds 2

Prints the device time by kernel group (the flash-attention kernels,
the circulant-sketch kernels, convolution and matmul, top-k and sorting,
other), the device's busy and idle share of the profiled window (busy =
the union of device kernel intervals), and the top kernels by device
time. The rounds take their batches as the run would, inside the
profiled window: from the device store when ``cv_train`` builds one
(index upload, gather and augmentation on the device), else the host
gather and its upload. The data path is then profiled alone over the
same rounds, and its device busy and wall a round are printed beside
the round's. Writes the Chrome trace to ``--trace`` when given. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
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


def _profiled(fn, device="cuda"):
    """``(profiler, device events, wall us)`` of ``fn()`` under
    ``torch.profiler``, synced at its end. On the CPU the "device events"
    are the leaf operators (those that call no other operator), which run
    one after another on the calling thread."""
    on_cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if on_cuda:
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if on_cuda:
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    else:
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and not e.cpu_children]
    if not kernels:
        raise SystemExit("the profiler recorded no device activity; time "
                         "with CUDA events instead")
    return prof, kernels, wall_us


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--model", default="ResNet9")
    entry = (gpt2_train if pre.parse_known_args(argv)[0].model == "GPT2"
              else cv_train)
    p = entry.build_parser()
    p.add_argument("--warmup", type=int, default=2)
    # the profiled rounds after the warm-up (the entry point's own
    # --profile_rounds is the telemetry's trace window)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--trace", default="")
    ns = parse_known(p, argv)
    if not torch.cuda.is_available() or torch.device(ns.device).type != "cuda":
        raise SystemExit("profile_round measures the card: no CUDA device")
    runtime, state, train_ds, val_ds = entry.setup(ns)[:4]
    store = lr_mult = None
    if entry is cv_train:
        store = cv_train.make_stores(runtime, train_ds, val_ds)[0]
        lr_mult = cv_train.lr_multiplier(runtime)

    def batch_of(rnd, i):
        return (store.round_batch(rnd.idx, i + 1) if store is not None
                else runtime.to_device(train_ds.gather(rnd.idx)))

    base = (gpt2_train.make_gpt2_schedule(runtime.cfg)
            if entry is gpt2_train else lr_schedule_for(runtime.cfg))

    def schedule(t):
        """The round's rate, times Fixup's (d,) multiplier as the driver
        applies it."""
        return base(t) if lr_mult is None else base(t) * lr_mult

    cfg = runtime.cfg
    spe = max(driver.epoch_sampler(cfg, train_ds, 0).epoch_rounds(), 1)
    it = enumerate(itertools.chain.from_iterable(
        driver.epoch_sampler(cfg, train_ds, epoch)
        for epoch in itertools.count()))
    for _ in range(ns.warmup):
        i, rnd = next(it)
        state, _ = runtime.round(state, rnd.client_ids, batch_of(rnd, i),
                                 rnd.mask, schedule((i + 1) / spe))
    torch.cuda.synchronize()
    rounds = [next(it) for _ in range(ns.rounds)]

    def run_rounds():
        nonlocal state
        for i, rnd in rounds:
            state, _ = runtime.round(state, rnd.client_ids, batch_of(rnd, i),
                                     rnd.mask, schedule((i + 1) / spe))

    prof, kernels, wall_us = _profiled(run_rounds)
    # the same rounds' data path alone (the store's draws are keyed by the
    # round, so it gathers the batches just trained on)
    _, data_kernels, data_wall_us = _profiled(
        lambda: [batch_of(rnd, i) for i, rnd in rounds])
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    span = [(e.time_range.start, e.time_range.end) for e in kernels]
    window_us = max(e for _, e in span) - min(s for s, _ in span)
    busy = _busy_us(span)
    n = ns.rounds
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
        "data_wall_ms_per_round": data_wall_us / n / 1e3,
        "data_device_busy_ms_per_round": _busy_us(
            [(e.time_range.start, e.time_range.end)
             for e in data_kernels]) / n / 1e3,
        "data_device_ops_per_round": len(data_kernels) / n,
        "device": torch.cuda.get_device_name(0),
    }
    print(f"{n} rounds with their data path: wall "
          f"{out['wall_ms_per_round']:.3f} ms/round, device busy "
          f"{out['device_busy_ms_per_round']:.3f} ms/round, idle share "
          f"{out['device_idle_share_of_wall']:.3f}, "
          f"{out['device_ops_per_round']:.0f} device ops/round; the data "
          f"path alone: wall {out['data_wall_ms_per_round']:.3f} ms/round, "
          f"device busy {out['data_device_busy_ms_per_round']:.3f} "
          f"ms/round, {out['data_device_ops_per_round']:.0f} device "
          "ops/round")
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
