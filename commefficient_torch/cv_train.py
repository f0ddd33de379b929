"""Federated CV training entry point of the PyTorch port (sketch-mode
ResNet-9 on CIFAR10).

    python -m commefficient_torch.cv_train --dataset_name CIFAR10 \\
        --model ResNet9 --mode sketch --error_type virtual \\
        --virtual_momentum 0.9 --num_workers 8 --local_batch_size 64 \\
        --k 50000 --num_rows 5 --num_cols 500000 --num_rounds 5

Runs on the card unless ``--device cpu`` is given. Prints one row per
round (loss, accuracy, round time) and a validation row at the end. The
data is the synthetic CIFAR10 set of data/fed_cifar.py.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from commefficient_torch.config import add_args, config_from_args, parse_known
from commefficient_torch.core.driver import train, validate
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data.fed_cifar import FedCIFAR10
from commefficient_torch.data.transforms import CifarEval, CifarTrain
from commefficient_torch.losses import make_cv_loss
from commefficient_torch.models.resnet9 import ResNet9
from commefficient_torch.utils.schedules import lr_schedule_for


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(p)
    p.add_argument("--num_rounds", type=int, default=0,
                   help="stop after this many rounds (0 = run num_epochs)")
    p.add_argument("--device", default="cuda")
    return p


def setup(ns: argparse.Namespace):
    """Data, model and runtime for the parsed flags ``ns``: returns
    ``(runtime, state, train_ds, val_ds)``."""
    cfg = config_from_args(ns)
    if cfg.model != "ResNet9":
        raise ValueError(f"--model {cfg.model}: cv_train runs ResNet9 "
                         "(GPT-2 runs through commefficient_torch.gpt2_train)")
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    torch.manual_seed(cfg.seed)
    np.random.seed(cfg.seed)
    train_ds = FedCIFAR10(train=True,
                          synthetic_per_class=cfg.synthetic_per_class,
                          num_clients=cfg.num_clients,
                          transform=CifarTrain(seed=cfg.seed))
    val_ds = FedCIFAR10(train=False,
                        synthetic_per_class=cfg.synthetic_per_class,
                        transform=CifarEval())
    gen = torch.Generator().manual_seed(cfg.seed)
    model = ResNet9(do_batchnorm=cfg.do_batchnorm, num_classes=10,
                    generator=gen)
    loss_fn = make_cv_loss(model, cfg.compute_dtype)
    runtime = FedRuntime(cfg, model, loss_fn, device=device)
    cfg = runtime.cfg
    print(f"d={cfg.grad_size} c={cfg.num_cols} r={cfg.num_rows} k={cfg.k} "
          f"W={cfg.num_workers} B={cfg.local_batch_size} device={device}")
    return runtime, runtime.init_state(), train_ds, val_ds


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ns = parse_known(build_parser(), argv)
    runtime, state, train_ds, val_ds = setup(ns)
    state, times, losses = train(runtime, state, train_ds,
                                 lr_schedule_for(runtime.cfg), ns.num_rounds)
    val_loss, val_acc = validate(runtime, state, val_ds,
                                 runtime.cfg.valid_batch_size)
    print(f"val loss {val_loss:.5f} acc {val_acc:.4f}")
    return {"losses": losses, "round_s": times, "val_loss": val_loss,
            "val_acc": val_acc, "rounds": len(losses)}


if __name__ == "__main__":
    main()
