"""Federated CV training entry point of the PyTorch port (ResNet-9 on
CIFAR10 or CIFAR100, every mode of the JAX package's single-device
round).

    python -m commefficient_torch.cv_train --dataset_name CIFAR10 \\
        --dataset_dir ./dataset --model ResNet9 --mode sketch \\
        --error_type virtual --local_momentum 0 --virtual_momentum 0.9 \\
        --num_workers 8 --local_batch_size 64 --k 50000 --num_rows 5 \\
        --num_cols 500000 --checkpoint_every 1

``--mode`` takes sketch, true_topk, local_topk, fedavg or uncompressed
(fedavg with ``--local_batch_size -1 --error_type none --local_momentum
0``); ``--sketch_impl`` circ, hash or rht; ``--max_grad_norm``,
``--sketch_dense_clip``, ``--dp``, ``--topk_down`` and
``--sketch_server_state dense`` as in the JAX package. Runs on the
card unless ``--device cpu`` is given. At each epoch's end it prints the
epoch's rounds (loss, accuracy, round time), validates, and prints the
reference's epoch row (train and test loss and accuracy, download and
upload MiB); at the end the run's byte totals and the TSV record.

The data is read from the CIFAR python pickles under ``--dataset_dir``
(``cifar-10-batches-py`` or ``cifar-100-python``), prepared there once
(data/fed_cifar.py); without them a synthetic set is generated there,
with a ``WARNING:``. ``--iid`` deals a fixed permutation of the train set
to ``--num_clients`` clients. When the set fits (2 GiB), its arrays live
on the device and every round is gathered and augmented there
(data/device_store.py; ``--no_augment``: normalised only); the run says
which path feeds it. ``--checkpoint_every N`` writes the whole state
every N epochs under ``--checkpoint_path``, ``--resume`` continues from
the newest intact checkpoint, and ``--checkpoint`` writes the final
weights to ``<checkpoint_path>/ResNet9.npz`` (checkpoint.py).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from commefficient_torch.checkpoint import setup_checkpointing
from commefficient_torch.config import add_args, config_from_args, parse_known
from commefficient_torch.core.driver import train
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data.device_store import (DATA_KEY,
                                                   make_device_store)
from commefficient_torch.data.fed_cifar import DATASETS
from commefficient_torch.data.transforms import transforms_for
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
    p.add_argument("--checkpoint", action="store_true",
                   dest="do_checkpoint",
                   help="write the final weights to "
                        "<checkpoint_path>/<model>.npz")
    return p


def build_model(cfg, num_classes: int) -> ResNet9:
    """ResNet-9 with weights drawn from a generator seeded by ``--seed``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    return ResNet9(do_batchnorm=cfg.do_batchnorm, num_classes=num_classes,
                   generator=gen)


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
    ds_cls = DATASETS[cfg.dataset_name]
    # no host transform yet: make_stores installs one where no store
    # feeds the split
    train_ds = ds_cls(cfg.dataset_dir, train=True, do_iid=cfg.do_iid,
                      num_clients=cfg.num_clients,
                      synthetic_per_class=cfg.synthetic_per_class)
    val_ds = ds_cls(cfg.dataset_dir, train=False,
                    synthetic_per_class=cfg.synthetic_per_class)
    cfg = cfg.replace(num_clients=train_ds.num_clients)
    model = build_model(cfg, cfg.num_classes)
    loss_fn = make_cv_loss(model, cfg.compute_dtype)
    runtime = FedRuntime(cfg, model, loss_fn, device=device)
    cfg = runtime.cfg
    print(f"mode={cfg.mode} d={cfg.grad_size} c={cfg.num_cols} "
          f"r={cfg.num_rows} k={cfg.k} W={cfg.num_workers} "
          f"B={runtime.batch_size} clients={runtime.num_clients} "
          f"{cfg.dataset_name}{' iid' if cfg.do_iid else ''} "
          f"device={device}")
    return runtime, runtime.init_state(), train_ds, val_ds


def make_stores(runtime: FedRuntime, train_ds, val_ds):
    """The train and validation ``DeviceStore``s, or None for the host
    path, whose dataset then gets its host transform; prints which path
    feeds the rounds."""
    cfg = runtime.cfg
    train_store = make_device_store(train_ds, cfg.dataset_name, True,
                                    runtime.device,
                                    no_augment=cfg.no_augment,
                                    seed=cfg.seed)
    val_store = make_device_store(val_ds, cfg.dataset_name, False,
                                  runtime.device)
    if val_store is None:
        val_ds.transform = transforms_for(cfg.dataset_name, False)
    if train_store is None:
        train_ds.transform = transforms_for(cfg.dataset_name,
                                            not cfg.no_augment,
                                            seed=cfg.seed)
        print("data: host path (the round's batch is gathered and "
              "augmented on the host)")
    else:
        print(f"data: device store on {runtime.device}: train "
              f"{train_store.nbytes / 2**20:.1f} MiB "
              f"({train_store.augment}, draws keyed by seed ^ "
              f"{DATA_KEY:#x} and the round)"
              + (f", val {val_store.nbytes / 2**20:.1f} MiB"
                 if val_store is not None else ""))
    return train_store, val_store


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the flags ``argv``; returns the run's per-round losses,
    host-clock round times and data-path times, the last epoch row
    (``summary``, None after a divergence abort), the final state and the
    run's byte totals."""
    timer = Timer()
    ns = parse_known(build_parser(), argv)
    runtime, state, train_ds, val_ds = setup(ns)
    cfg = runtime.cfg
    train_store, val_store = make_stores(runtime, train_ds, val_ds)
    ckpt_mgr, start_epoch, restored, global_round = setup_checkpointing(
        cfg, runtime, cfg.model)
    if restored is not None:
        state = restored
    tsv = TSVLogger()
    state, summary, log = train(runtime, state, train_ds, val_ds,
                                lr_schedule_for(cfg), ns.num_rounds,
                                loggers=(TableLogger(), tsv), timer=timer,
                                train_store=train_store,
                                val_store=val_store, ckpt_mgr=ckpt_mgr,
                                checkpoint_every=cfg.checkpoint_every,
                                start_epoch=start_epoch,
                                global_round=global_round)
    print(tsv)
    if cfg.do_checkpoint and summary is not None:
        os.makedirs(cfg.checkpoint_path, exist_ok=True)
        path = os.path.join(cfg.checkpoint_path, cfg.model + ".npz")
        np.savez(path, ps_weights=state.ps_weights.cpu().numpy())
        print(f"saved checkpoint to {path}")
    return {"losses": log.losses, "round_s": log.round_s,
            "data_s": log.data_s, "epochs": log.epochs,
            "rounds": len(log.losses), "summary": summary, "state": state,
            "val_loss": summary["test_loss"] if summary else float("nan"),
            "val_acc": summary["test_acc"] if summary else float("nan"),
            "total_download_mib": log.total_download_mib,
            "total_upload_mib": log.total_upload_mib,
            "runtime": runtime, "train_store": train_store}


if __name__ == "__main__":
    main()
