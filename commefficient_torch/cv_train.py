"""Federated CV training entry point of the PyTorch port (ResNet-9 on
CIFAR10, every mode of the JAX package's single-device round).

    python -m commefficient_torch.cv_train --dataset_name CIFAR10 \\
        --model ResNet9 --mode sketch --error_type virtual \\
        --virtual_momentum 0.9 --num_workers 8 --local_batch_size 64 \\
        --k 50000 --num_rows 5 --num_cols 500000 --num_rounds 5

``--mode`` takes sketch, true_topk, local_topk, fedavg or uncompressed
(fedavg with ``--local_batch_size -1 --error_type none``). Runs on the
card unless ``--device cpu`` is given. At each epoch's end it prints the
epoch's rounds (loss, accuracy, round time), validates, and prints the
reference's epoch row (train and test loss and accuracy, download and
upload MiB); at the end the run's byte totals and the TSV record. The
data is the synthetic CIFAR10 set of data/fed_cifar.py.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from commefficient_torch.config import add_args, config_from_args, parse_known
from commefficient_torch.core.driver import train
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data.fed_cifar import FedCIFAR10
from commefficient_torch.data.transforms import CifarEval, CifarTrain
from commefficient_torch.losses import make_cv_loss
from commefficient_torch.models.resnet9 import ResNet9
from commefficient_torch.utils.logging import TableLogger, Timer, TSVLogger
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
    cfg = cfg.replace(num_clients=train_ds.num_clients)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = ResNet9(do_batchnorm=cfg.do_batchnorm, num_classes=10,
                    generator=gen)
    loss_fn = make_cv_loss(model, cfg.compute_dtype)
    runtime = FedRuntime(cfg, model, loss_fn, device=device)
    cfg = runtime.cfg
    print(f"mode={cfg.mode} d={cfg.grad_size} c={cfg.num_cols} "
          f"r={cfg.num_rows} k={cfg.k} W={cfg.num_workers} "
          f"B={runtime.batch_size} clients={runtime.num_clients} "
          f"device={device}")
    return runtime, runtime.init_state(), train_ds, val_ds


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the flags ``argv``; returns the run's per-round losses and
    host-clock round times, the last epoch row (``summary``, None after a
    divergence abort), the final state and the run's byte totals."""
    timer = Timer()
    ns = parse_known(build_parser(), argv)
    runtime, state, train_ds, val_ds = setup(ns)
    tsv = TSVLogger()
    state, summary, log = train(runtime, state, train_ds, val_ds,
                                lr_schedule_for(runtime.cfg), ns.num_rounds,
                                loggers=(TableLogger(), tsv), timer=timer)
    print(tsv)
    return {"losses": log.losses, "round_s": log.round_s,
            "rounds": len(log.losses), "summary": summary, "state": state,
            "val_loss": summary["test_loss"] if summary else float("nan"),
            "val_acc": summary["test_acc"] if summary else float("nan"),
            "total_download_mib": log.total_download_mib,
            "total_upload_mib": log.total_upload_mib,
            "runtime": runtime}


if __name__ == "__main__":
    main()
