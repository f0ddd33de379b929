"""Round-shape grid of the CIFAR FetchSGD round: throughput and MFU over
clients a round W in {8, 16, 32} x local batch B in {64, 256, 512}, with
``bench``'s machinery; the counterpart of the JAX package's
``scripts/round_shape_grid.py``. Prints a table and one JSON line.

    python -m commefficient_torch.bench.round_shape_grid [--rounds 10]
        [--device cuda|cpu]

``flops_per_image`` is ResNet-9's forward and backward FLOPs of one
image, counted by ``FlopCounterMode`` on the ``meta`` device (the JAX
script reads XLA's cost analysis). A cell that fails records its error
and the grid goes on.
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Optional

import numpy as np
import torch

from commefficient_torch.bench.bench import cifar_batch, cifar_flops
from commefficient_torch.bench.bench_common import (peak_flops,
                                                    resolve_device,
                                                    timed_rounds)
from commefficient_torch.config import FedConfig, parse_known
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.losses import make_cv_loss
from commefficient_torch.models.resnet9 import ResNet9

GRID_W = (8, 16, 32)
GRID_B = (64, 256, 512)


def grid_config(W: int, B: int) -> FedConfig:
    """The JAX script's round: the flagship sketch config at W x B, with
    at least W clients."""
    return FedConfig(
        mode="sketch", error_type="virtual", local_momentum=0.0,
        virtual_momentum=0.9, weight_decay=5e-4,
        num_workers=W, local_batch_size=B,
        k=50_000, num_rows=5, num_cols=500_000, num_blocks=20,
        num_clients=max(100, W), track_bytes=False, approx_topk=True)


def measure(W: int, B: int, n_rounds: int = 10, device="cuda"):
    """Images/s of ``n_rounds`` timed rounds at W x B, the peak FLOP/s of
    ``device`` (None where unknown) and the runtime."""
    dev = resolve_device(device)
    model = ResNet9(num_classes=10,
                    generator=torch.Generator().manual_seed(0))
    runtime = FedRuntime(grid_config(W, B), model,
                         make_cv_loss(model, "bfloat16"), device=dev)
    args = (np.arange(W), cifar_batch(W, B, dev), np.ones((W, B), bool), 0.1)
    dt, _, _ = timed_rounds(runtime, args, warmup=2, rounds=n_rounds,
                            desc=f"W{W}xB{B}", device=dev)
    return n_rounds * W * B / dt, peak_flops(dev), runtime


def flops_per_image() -> float:
    return cifar_flops(1)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=10,
                    help="timed rounds a cell")
    ap.add_argument("--device", default="cuda")
    args = parse_known(ap, argv)
    fpi = flops_per_image()
    print(f"model FLOPs/image {fpi:.3e}", flush=True)
    rows = []
    for W, B in itertools.product(GRID_W, GRID_B):
        try:
            ips, peak, _ = measure(W, B, args.rounds, args.device)
        except Exception as e:
            print(f"W={W:3d} B={B:4d}: FAILED ({type(e).__name__}: {e})",
                  flush=True)
            rows.append({"W": W, "B": B, "error": type(e).__name__})
            continue
        mfu = ips * fpi / peak if peak else None
        print(f"W={W:3d} B={B:4d} round={W * B:6d} img: {ips:9.0f} img/s  "
              f"MFU {'null' if mfu is None else f'{mfu:6.1%}'}", flush=True)
        rows.append({"W": W, "B": B, "img_per_s": round(ips),
                     "mfu": round(mfu, 4) if mfu is not None else None})
    out = {"metric": "cifar_round_shape_grid", "rows": rows,
           "flops_per_image": fpi}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
