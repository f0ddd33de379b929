"""ImageNet-lineage round throughput of the port: FixupResNet50 at 224 x
224 with the reference's recipe (``scripts/imagenet.sh``: 7 iid clients
x local batch 64, uncompressed, virtual momentum); the counterpart of
the JAX package's ``scripts/bench_imagenet.py``. Prints one JSON line.

    python -m commefficient_torch.bench.bench_imagenet
        [--layout uint8_device|float_host] [--local_batch 64]
        [--rounds 10] [--telemetry_dir D] [--device cuda|cpu]

Each round's batch is staged inside the timed loop (``timed_rounds``'s
``round_args_fn``), so the staging is part of the measurement:

- ``uint8_device`` (default): the random uint8 images stay on the card
  in the port's ``data/device_store.py`` store, and each round gathers,
  flips and normalizes its batch there (``imagenet_train``);
- ``float_host``: a float32 host batch (270 MB at 7 x 64) is copied to
  the card every round.

``mfu`` is the model's forward and backward FLOPs a round, counted by
``FlopCounterMode`` on the ``meta`` device (10.886 TFLOP for 448
images), over the timed seconds x the card's peak bf16 FLOP/s. The JAX
script counts ``3 * 4.1e9`` an image, but 4.1e9 is ResNet-50's count of
multiply-adds, half its FLOPs (ROADMAP C13).
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Optional

import numpy as np
import torch

from commefficient_torch.bench.bench_common import (log, mfu_of,
                                                    model_flops,
                                                    peak_flops,
                                                    resolve_device,
                                                    timed_rounds)
from commefficient_torch.config import FedConfig
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data import transforms as T
from commefficient_torch.data.device_store import DeviceStore
from commefficient_torch.losses import make_cv_loss
from commefficient_torch.models.fixup_resnet import FixupResNet50
from commefficient_torch.telemetry.utilization import (device_kind_of,
                                                       emit_from_totals)

HW = 224
W = 7


def imagenet_config(W: int = W, B: int = 64) -> FedConfig:
    """The recipe's round: W iid clients of B images, uncompressed."""
    return FedConfig(mode="uncompressed", error_type="virtual",
                     local_momentum=0.0, virtual_momentum=0.9,
                     weight_decay=1e-4, num_workers=W, local_batch_size=B,
                     num_clients=7, do_iid=True, track_bytes=False)


def imagenet_flops(images: int) -> float:
    """Forward and backward FLOPs of FixupResNet50 on ``images`` images
    at 224 x 224."""
    return model_flops(functools.partial(FixupResNet50, num_classes=1000,
                                         input_shape=(HW, HW, 3)),
                       (HW, HW, 3), images)


def main(argv: Optional[list] = None) -> dict:
    from commefficient_torch.bench.bench import (add_bench_args,
                                                 make_bench_telemetry,
                                                 parse_bench_args)
    ap = argparse.ArgumentParser(description=__doc__)
    add_bench_args(ap)
    ap.add_argument("--layout", choices=("uint8_device", "float_host"),
                    default="uint8_device",
                    help="per-round batch staging: the uint8 device store "
                         "with on-card normalize (default), or a float32 "
                         "host batch copied to the card every round")
    ap.add_argument("--local_batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=10)
    args = parse_bench_args(ap, argv)
    dev = resolve_device(args.device)
    telemetry, profiler = make_bench_telemetry(args, "bench_imagenet")
    log("device:", device_kind_of(dev))
    B = args.local_batch
    cfg = imagenet_config(W, B)
    model = FixupResNet50(num_classes=1000, input_shape=(HW, HW, 3),
                          generator=torch.Generator().manual_seed(0))
    runtime = FedRuntime(cfg, model, make_cv_loss(model, "bfloat16"),
                         device=dev)
    log(f"grad size {runtime.cfg.grad_size}")
    if telemetry is not None:
        telemetry.memory_event("imagenet_init")

    rng = np.random.RandomState(0)
    targets = torch.as_tensor(rng.randint(0, 1000, (W, B)),
                              dtype=torch.int64, device=dev)
    mask = np.ones((W, B), bool)
    ids = np.arange(W)
    if args.layout == "uint8_device":
        # the driver's path: the uint8 images resident once, each round's
        # batch produced on the card (gather, flip, normalize)
        imgs_u8 = rng.randint(0, 255, (W * B, HW, HW, 3), dtype=np.uint8)
        store = DeviceStore({"image": imgs_u8}, dev,
                            augment="imagenet_train",
                            mean=T.IMAGENET_MEAN, std=T.IMAGENET_STD)
        log(f"uint8 device store: {store.nbytes / 2**20:.0f} MiB resident")
        idx = np.arange(W * B).reshape(W, B)

        def round_args_fn(i):
            got = store.round_batch(idx, round_index=i)
            return (ids, {"image": got["image"], "target": targets},
                    mask, 0.1)
    else:
        # the full float32 batch crosses host -> card every round
        host_imgs = torch.from_numpy(
            rng.randn(W, B, HW, HW, 3).astype(np.float32))

        def round_args_fn(i):
            return (ids, {"image": host_imgs.to(dev), "target": targets},
                    mask, 0.1)

    n_rounds = args.rounds
    t0 = time.perf_counter()
    dt, metrics, phases = timed_rounds(runtime, None, warmup=2,
                                       rounds=n_rounds, desc="imagenet",
                                       profiler=profiler,
                                       round_args_fn=round_args_fn,
                                       device=dev)
    warmup_s = phases.pop("warmup_s", None)
    ips = n_rounds * W * B / dt
    loss = float(metrics["results"][0].mean())
    log(f"{n_rounds} rounds in {dt:.3f}s -> {ips:.1f} img/s, loss {loss:.3f}")

    flops = imagenet_flops(W * B)
    peak = peak_flops(dev)
    mfu = mfu_of(flops, n_rounds, dt, peak)
    log(f"model FLOPs/round {flops:.3e}, MFU {mfu}")
    result = {"metric": "imagenet_fixupresnet50_round_throughput",
              "value": round(ips, 1), "unit": "images/sec",
              "mfu": round(mfu, 4) if mfu is not None else None,
              "round_images": W * B,
              "timed_rounds": n_rounds,
              "layout": args.layout,
              "warmup_s": warmup_s,
              "phase_split": phases,
              "input_wait_frac": round(phases["host_s"] / dt, 6),
              "total_s": round(time.perf_counter() - t0, 1)}
    if telemetry is not None:
        emit_from_totals(
            telemetry, rnd=n_rounds, rounds=n_rounds, wall_s=dt,
            host_s=phases["host_s"], dispatch_s=phases["dispatch_s"],
            device_s=phases["device_wait_s"],
            flops_per_round=flops, flops_source="analytic",
            device_kind=device_kind_of(dev))
        telemetry.bench_event(result["metric"], result)
        telemetry.write_summary(aborted=False, n_rounds=n_rounds,
                                final=result)
        telemetry.close()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
