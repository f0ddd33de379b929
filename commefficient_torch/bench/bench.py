"""Headline benchmark of the port: federated-round throughput of the
ResNet-9 FetchSGD round at CIFAR10's shape, its saturated point, and the
GPT-2 (124M) sketched round nested under ``"gpt2"``; the counterpart of
the JAX package's ``bench.py``.

    python -m commefficient_torch.bench.bench [--telemetry_dir D]
        [--profile_dir D --profile_rounds 2:4]
        [--wire_dtype float32|bfloat16|int8] [--device cuda|cpu]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "mfu",
..., "cifar_saturated": {...}, "gpt2": {...}}, the JAX bench's keys.

- The headline: 8 clients x 64 random CIFAR-shaped images a round, 20
  timed rounds after 2 of warmup, k = 50,000, a 5 x 500,000 (sized to
  500,736) circulant sketch, bf16 compute. ``value`` is images/s over
  the timed window; ``vs_baseline`` divides it by a NOMINAL 2,000 img/s
  (the JAX package's single-V100 anchor: not measured).
- The saturated point: the same round at 32 clients x 512 images
  (``round_images`` 16,384), 10 timed rounds.
- ``gpt2``: ``bench_gpt2.run``.

``mfu`` is the model's forward and backward FLOPs for the round's
images, counted by ``FlopCounterMode`` on the ``meta`` device
(``flops_source: "analytic"`` in the ``utilization`` event; the JAX
bench reads XLA's cost analysis of the bare ``value_and_grad``, which
the port does not have, so the two MFUs differ by the two counts'
ratio), over the timed seconds x the card's peak bf16 FLOP/s; null
where the peak table does not know the device. The sketch and server
work of the round is real work but not model FLOPs.

The line is printed even when a later stage dies (that stage then holds
``error``); the exit code is 0 only when the headline has a value. The
JAX flag ``--compile_cache`` is refused: the port runs eagerly and has
no compile step to cache (its kernels build once at first use, inside
``warmup_s``).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import traceback
from typing import Optional

import numpy as np
import torch

from commefficient_torch.bench.bench_common import (log, mfu_of,
                                                    model_flops,
                                                    peak_flops,
                                                    resolve_device,
                                                    timed_rounds)
from commefficient_torch.config import FedConfig, parse_known
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.losses import make_cv_loss
from commefficient_torch.models.resnet9 import ResNet9
from commefficient_torch.telemetry.utilization import (device_kind_of,
                                                       emit_from_totals)

NOMINAL_SINGLE_GPU_IMG_PER_SEC = 2000.0
CIFAR_SHAPE = (32, 32, 3)

COMPILE_CACHE_REFUSAL = (
    "--compile_cache: the PyTorch port runs eagerly and has no compile "
    "step to cache (its kernels build once at first use, inside "
    "warmup_s); the flag is not ported and no ROADMAP item queues it")


def cifar_config(W: int, B: int, wire_dtype: str = "float32") -> FedConfig:
    """The bench's FetchSGD round: the flagship sketch config at W
    clients x B images."""
    return FedConfig(
        mode="sketch", error_type="virtual", local_momentum=0.0,
        virtual_momentum=0.9, weight_decay=5e-4,
        num_workers=W, local_batch_size=B,
        k=50_000, num_rows=5, num_cols=500_000, num_blocks=20,
        num_clients=100, track_bytes=False, approx_topk=True,
        wire_dtype=wire_dtype)


def cifar_batch(W: int, B: int, device) -> dict:
    """The JAX bench's seeded random batch: (W, B, 32, 32, 3) float32
    images, (W, B) labels, on ``device``."""
    rng = np.random.RandomState(0)
    return {"image": torch.as_tensor(
                rng.randn(W, B, *CIFAR_SHAPE).astype(np.float32),
                device=device),
            "target": torch.as_tensor(rng.randint(0, 10, (W, B)),
                                      dtype=torch.int64, device=device)}


def cifar_flops(images: int) -> float:
    """Forward and backward FLOPs of ResNet-9 on ``images`` images."""
    return model_flops(functools.partial(ResNet9, num_classes=10),
                       CIFAR_SHAPE, images)


def run_cifar(result: dict, W: int = 8, B: int = 64, n_rounds: int = 20,
              telemetry=None, profiler=None, wire_dtype: str = "float32",
              device="cuda") -> None:
    """Fill ``result`` in place (so partial progress survives a crash)
    with the CIFAR round's throughput at W clients x B images."""
    dev = resolve_device(device)
    log("device:", device_kind_of(dev))
    cfg = cifar_config(W, B, wire_dtype)
    model = ResNet9(num_classes=10,
                    generator=torch.Generator().manual_seed(0))
    runtime = FedRuntime(cfg, model, make_cv_loss(model, "bfloat16"),
                         device=dev)
    if telemetry is not None:
        telemetry.memory_event(f"cifar_w{W}_b{B}_init")
    batch = cifar_batch(W, B, dev)
    args = (np.arange(W), batch, np.ones((W, B), bool), 0.1)
    dt, metrics, phases = timed_rounds(runtime, args, warmup=2,
                                       rounds=n_rounds, desc="cifar",
                                       profiler=profiler, device=dev)

    images = n_rounds * W * B
    ips = images / dt
    log(f"{n_rounds} rounds in {dt:.3f}s -> {ips:.1f} img/s")
    log(f"final mean client loss {float(metrics['results'][0].mean()):.4f}")
    result["value"] = round(ips, 1)
    result["vs_baseline"] = round(ips / NOMINAL_SINGLE_GPU_IMG_PER_SEC, 3)
    result["timed_rounds"] = n_rounds
    result["wire_dtype"] = runtime.cfg.wire_dtype
    # the bytes the round's tables take on the wire: W clients x the
    # runtime's own count (its sized table and effective int8 block)
    result["wire_bytes_per_round"] = W * runtime.cfg.upload_wire_bytes(
        runtime._wire_block or None)
    result["warmup_s"] = phases.pop("warmup_s", None)
    result["phase_split"] = phases
    result["input_wait_frac"] = round(phases["host_s"] / dt, 6)

    flops = cifar_flops(W * B)
    peak = peak_flops(dev)
    mfu = mfu_of(flops, n_rounds, dt, peak)
    log(f"model FLOPs/round {flops:.3e}, peak {peak}, MFU {mfu}")
    result["mfu"] = round(mfu, 4) if mfu is not None else None
    if telemetry is not None:
        ufields = emit_from_totals(
            telemetry, rnd=n_rounds, rounds=n_rounds, wall_s=dt,
            host_s=phases["host_s"], dispatch_s=phases["dispatch_s"],
            device_s=phases["device_wait_s"], flops_per_round=flops,
            flops_source="analytic", device_kind=device_kind_of(dev))
        result["roofline"] = {
            k: ufields[k] for k in ("bytes_per_round",
                                    "arithmetic_intensity", "bound",
                                    "bw_frac")}
        telemetry.bench_event(result["metric"], result,
                              wire_dtype=runtime.cfg.wire_dtype)


def make_bench_telemetry(args, run_type: str):
    """``--telemetry_dir`` opens the drivers' JSONL stream (schema v11)
    there; ``--profile_dir``/``--profile_rounds`` trace the timed
    rounds."""
    from commefficient_torch.telemetry import ProfilerWindow, RunTelemetry
    telemetry = None
    if args.telemetry_dir:
        telemetry = RunTelemetry(args.telemetry_dir, run_type,
                                 device=args.device)
        if telemetry.active:
            log(f"telemetry: {telemetry.path}")
        else:
            telemetry = None  # the constructor warned; no stream to feed
    profiler = (ProfilerWindow(args.profile_dir, args.profile_rounds,
                               log=log)
                if args.profile_dir else None)
    return telemetry, profiler


def add_bench_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--telemetry_dir", default="",
                    help="write a telemetry.jsonl event stream here "
                         "(the drivers' schema)")
    ap.add_argument("--profile_dir", default="",
                    help="write a torch.profiler trace of the timed rounds")
    ap.add_argument("--profile_rounds", default="2:4",
                    help="1-based inclusive timed-round window for the "
                         "trace, START:STOP")
    ap.add_argument("--compile_cache", default=None,
                    help="refused: the port has no compile step to cache")
    ap.add_argument("--wire_dtype",
                    choices=("float32", "bfloat16", "int8"),
                    default="float32",
                    help="sketch-table wire dtype of the benched round, "
                         "recorded in the JSON line")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu runs the "
                         "kernels' plain versions)")


def parse_bench_args(ap: argparse.ArgumentParser,
                     argv=None) -> argparse.Namespace:
    """Parse; a flag outside the parser, and ``--compile_cache``, raise
    ``ValueError`` naming it."""
    args = parse_known(ap, argv)
    if getattr(args, "compile_cache", None) is not None:
        raise ValueError(COMPILE_CACHE_REFUSAL)
    return args


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    add_bench_args(ap)
    args = parse_bench_args(ap, argv)
    telemetry, profiler = make_bench_telemetry(args, "bench")
    result = {
        "metric": "cifar10_sketch_round_throughput",
        "value": None,
        "unit": "images/sec",
        "vs_baseline": None,
        "mfu": None,
    }
    try:
        run_cifar(result, telemetry=telemetry, profiler=profiler,
                  wire_dtype=args.wire_dtype, device=args.device)
    except Exception as e:
        log(traceback.format_exc())
        result["error"] = f"{type(e).__name__}: {e}"
    log("headline:", json.dumps(result))
    # the same round at a size that feeds the card: 32 clients x 512
    try:
        sat = {"metric": "cifar10_sketch_round_throughput_saturated",
               "value": None, "unit": "images/sec", "vs_baseline": None,
               "mfu": None, "round_images": 32 * 512}
        run_cifar(sat, W=32, B=512, n_rounds=10, telemetry=telemetry,
                  wire_dtype=args.wire_dtype, device=args.device)
        result["cifar_saturated"] = sat
        log("saturated:", json.dumps(sat))
    except Exception as e:
        log(traceback.format_exc())
        log(f"WARNING: saturated CIFAR bench failed ({e})")
        result["cifar_saturated"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from commefficient_torch.bench import bench_gpt2
        result["gpt2"] = bench_gpt2.run(telemetry=telemetry,
                                        wire_dtype=args.wire_dtype,
                                        device=args.device)
    except Exception as e:
        log(traceback.format_exc())
        log(f"WARNING: GPT-2 bench failed ({e})")
        result["gpt2"] = {"error": f"{type(e).__name__}: {e}"}
    if telemetry is not None:
        n_rounds = sum(
            stage.get("timed_rounds", 0)
            for stage in (result, result.get("cifar_saturated") or {},
                          result.get("gpt2") or {}))
        telemetry.write_summary(aborted="error" in result,
                                n_rounds=n_rounds, final=result)
        telemetry.close()
    print(json.dumps(result))
    return 0 if result["value"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
