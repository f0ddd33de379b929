"""Bare-model FixupResNet50 at 224 x 224, forward and backward: the PyTorch
port's counterpart of the JAX package's ``scripts/bench_imagenet_model.py``.
It isolates the model's step from the federated round, so the round's
time splits into the model's own and the round's overhead, and it names
the device operations the step spends its time in.

Usage: python -m commefficient_torch.scripts.bench_imagenet_model
           [--batch N] [--device cuda|cpu]

The step is the gradient of the JAX script's loss (``make_cv_loss(model,
"bfloat16")``: weights and images cast to bf16, float32 logits and
cross-entropy) with respect to the flat weight vector, on a seeded random
batch. One warm-up step, then 10 steps between two device syncs give the
ms a step and img/s. MFU is printed in two labelled forms: against the
FLOPs that ``FlopCounterMode`` counts (``bench_imagenet.imagenet_flops``,
about 24.3 GFLOP an image) and against the JAX script's ``3 * 4.1e9`` an
image, which counts ResNet-50's multiply-adds as FLOPs (ROADMAP C13).
Three more steps run under ``torch.profiler``; the top 25 device
operations a step print in the JAX script's line format, then the same
time by kernel group (``profile_round``'s groups) and by the operator
that launched it.

``--s2d`` is refused: the JAX script passes ``space_to_depth=`` to a
model that has no such field, so its arm cannot run (ROADMAP C16).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from commefficient_torch.bench.bench_common import peak_flops, resolve_device
from commefficient_torch.bench.bench_imagenet import HW, imagenet_flops
from commefficient_torch.losses import make_cv_loss
from commefficient_torch.models.fixup_resnet import FixupResNet50
from commefficient_torch.profile_round import _busy_us, _group, _profiled

TIMED_STEPS = 10
PROFILED_STEPS = 3
TOP = 25
# the JAX script's count: 3 x ResNet-50's 4.1e9 multiply-adds an image
SCRIPT_FLOPS_PER_IMAGE = 3 * 4.1e9
S2D_REFUSAL = (
    "--s2d: the JAX script passes space_to_depth= to models.FixupResNet50, "
    "whose ImageNet model has no such field, so its --s2d arm cannot run "
    "(ROADMAP C16); the port has nothing to port for it")


def _self_device_us(avg, on_cuda: bool) -> float:
    if not on_cuda:
        return avg.self_cpu_time_total
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, name):
            return getattr(avg, name)
    return 0.0


def run(model, batch: int, hw: int, device, flops_per_image: float,
        timed_steps: int = TIMED_STEPS,
        out: Callable[[str], None] = print) -> dict:
    """Times and profiles the gradient step of ``model`` (a port
    ``FlatModel`` on the CPU) on a seeded ``batch`` x ``hw`` x ``hw``
    batch on ``device``; prints the JAX script's lines through ``out``
    and returns what it printed as numbers."""
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    loss_fn = make_cv_loss(model, "bfloat16")
    flat = model.flat.detach().to(dev).requires_grad_(True)
    rng = np.random.RandomState(0)
    data = {"image": torch.as_tensor(
                rng.randn(batch, hw, hw, 3).astype(np.float32), device=dev),
            "target": torch.as_tensor(rng.randint(0, 1000, (batch,)) %
                                      model.num_classes, dtype=torch.int64,
                                      device=dev)}
    mask = torch.ones(batch, dtype=torch.bool, device=dev)

    def step():
        loss = loss_fn(flat, data, mask)[0]
        return torch.autograd.grad(loss, flat)[0], loss

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    out("compiling...")
    grad, loss = step()
    sync()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        grad, loss = step()
    sync()
    dt = (time.perf_counter() - t0) / timed_steps
    peak = peak_flops(dev) if on_cuda else None

    def mfu(per_image):
        return None if peak is None else per_image * batch / dt / peak

    mfu_counted, mfu_script = mfu(flops_per_image), mfu(
        SCRIPT_FLOPS_PER_IMAGE)

    def pct(v):
        return "n/a" if v is None else f"{v:.1%}"

    out(f"batch {batch}: {dt * 1e3:.1f} ms/step, {batch / dt:.0f} img/s, "
        f"MFU {pct(mfu_counted)} (FlopCounterMode, "
        f"{flops_per_image / 1e9:.2f} GFLOP/img), MFU {pct(mfu_script)} "
        f"(the JAX script's 3 x 4.1e9 FLOP/img, C13)")

    def profiled():
        for _ in range(PROFILED_STEPS):
            step()

    prof, kernels, wall_us = _profiled(profiled, dev)
    by_name, by_group = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + us
    busy_us = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
    n = PROFILED_STEPS
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    out(f"span {busy_us / 1e3 / n:.1f} ms/step; top {TOP} ops (ms/step):")
    for name, us in ops[:TOP]:
        out(f"  {us / 1e3 / n:8.2f}  {name[:110]}")
    groups = sorted(by_group.items(), key=lambda kv: -kv[1])
    out("by kernel group (ms/step):")
    for name, us in groups:
        out(f"  {us / 1e3 / n:8.2f}  {name}")
    # the operators (host-side events) with the device time of the
    # kernels each launched itself
    operators = sorted(
        ((a.key, _self_device_us(a, on_cuda))
         for a in prof.key_averages()
         if a.device_type == torch.autograd.DeviceType.CPU
         and _self_device_us(a, on_cuda) > 0),
        key=lambda kv: -kv[1])
    out(f"by operator, self device time (ms/step), top {TOP}:")
    for name, us in operators[:TOP]:
        out(f"  {us / 1e3 / n:8.2f}  {name[:110]}")
    return {"batch": batch, "ms_per_step": dt * 1e3,
            "img_per_s": batch / dt, "loss": float(loss.detach()),
            "flops_per_image": flops_per_image,
            "mfu_flopcounter": mfu_counted, "mfu_script_count": mfu_script,
            "busy_ms_per_step": busy_us / 1e3 / n,
            "profiled_wall_ms_per_step": wall_us / 1e3 / n,
            "device_ops_per_step": len(kernels) / n,
            "ops_ms_per_step": [(k, v / 1e3 / n) for k, v in ops],
            "groups_ms_per_step": {k: v / 1e3 / n for k, v in groups},
            "operators_ms_per_step": [(k, v / 1e3 / n)
                                      for k, v in operators],
            "grad_finite": bool(torch.isfinite(grad).all())}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        usage="python -m commefficient_torch.scripts.bench_imagenet_model "
              "[--batch N] [--device cuda|cpu]")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--s2d", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.s2d:
        ap.error(S2D_REFUSAL)
    dev = resolve_device(args.device)
    model = FixupResNet50(num_classes=1000, input_shape=(HW, HW, 3),
                          generator=torch.Generator().manual_seed(0))
    return run(model, args.batch, HW, dev, imagenet_flops(1))


if __name__ == "__main__":
    main()
