"""The epoch loop and validation shared by the port's entry points
(``cv_train`` and ``gpt2_train``), counterpart of the JAX package's
``cv_train.train`` and ``run_validation`` without checkpoints,
telemetry, pipelining or asynchronous aggregation.

Each round's ``[loss * n, acc * n, n, download bytes, upload bytes]``
stays on the device; the epoch's rows are fetched once, at its end. There
the loop reads the device-side divergence flag and aborts on it (``TRAINING
DIVERGED``, no validation after it), validates, and appends the epoch
row to the loggers. Round times are taken on the host clock around work
that ends in a device sync.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data.fed_sampler import FedSampler, ValSampler
from commefficient_torch.utils.logging import Timer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class RunLog:
    """What a run measured, for the entry points' callers."""

    round_s: List[float] = dataclasses.field(default_factory=list)
    losses: List[float] = dataclasses.field(default_factory=list)
    epochs: List[dict] = dataclasses.field(default_factory=list)
    val_batches: int = 0          # validation batches run, all epochs
    total_download_mib: float = 0.0
    total_upload_mib: float = 0.0


def validate(runtime: FedRuntime, state, val_ds, batch_size: int,
             max_batches: Optional[int] = None):
    """Masked means of the validation loss and accuracy over the set, in
    chunks of ``batch_size`` (the first ``max_batches`` chunks only, when
    given). The sums stay on the device and are fetched once. Returns
    ``(loss, acc, batches)``."""
    sums, batches = None, 0
    for idx, mask in ValSampler(len(val_ds), batch_size):
        if max_batches is not None and batches >= max_batches:
            break
        (loss, acc), n = runtime.val(state, val_ds.gather(idx), mask)
        contrib = torch.stack((loss * n, acc * n, n))
        sums = contrib if sums is None else sums + contrib
        batches += 1
    host = sums.cpu().numpy() if sums is not None else np.zeros(3)
    total = max(float(host[2]), 1.0)
    return float(host[0]) / total, float(host[1]) / total, batches


def epoch_sampler(cfg, train_ds, epoch: int) -> FedSampler:
    """The rounds of ``epoch``: the sampler seeded by (seed, epoch), as the
    JAX package's driver seeds it."""
    return FedSampler(train_ds.data_per_client, cfg.num_workers,
                      cfg.local_batch_size,
                      max_client_batch=cfg.max_client_batch,
                      seed=cfg.seed + 7919 * epoch)


def train(runtime: FedRuntime, state, train_ds, val_ds, schedule: Callable,
          num_rounds: int = 0, max_per_epoch: Optional[int] = None,
          val_max_batches: Optional[int] = None, loggers: Sequence = (),
          timer: Optional[Timer] = None):
    """The run's epochs: one sampler an epoch, seeded by (seed, epoch), at
    most ``ceil(rounds per epoch x the epoch's fraction)`` rounds of it
    (and ``max_per_epoch``), round t (from 1) at the rate ``schedule(t /
    rounds per epoch)``.
    Stops after ``num_rounds`` rounds when that is positive; the epoch in
    which it stops still ends as any epoch does. Returns ``(state,
    summary, log)``: ``summary`` is the last epoch row, or None after a
    divergence abort."""
    cfg, device = runtime.cfg, runtime.device
    timer = timer or Timer()
    spe = max(epoch_sampler(cfg, train_ds, 0).epoch_rounds(), 1)
    log, summary, global_round = RunLog(), None, 0
    n_epochs = math.ceil(cfg.num_epochs)
    for epoch in range(n_epochs):
        if num_rounds and global_round >= num_rounds:
            break
        fraction = (cfg.num_epochs - epoch if epoch == n_epochs - 1
                    else 1.0)
        max_rounds = int(math.ceil(spe * fraction))
        if max_per_epoch is not None:
            max_rounds = min(max_rounds, max_per_epoch)
        rows, lrs, first = [], [], global_round
        for rnd in epoch_sampler(cfg, train_ds, epoch):
            if len(rows) >= max_rounds or (num_rounds
                                           and global_round >= num_rounds):
                break
            # the JAX package keys the schedule by the 1-based round
            lr = schedule((global_round + 1) / spe)
            batch = train_ds.gather(rnd.idx)
            _sync(device)
            t0 = time.perf_counter()
            state, metrics = runtime.round(state, rnd.client_ids, batch,
                                           rnd.mask, lr)
            _sync(device)
            log.round_s.append(time.perf_counter() - t0)
            w = metrics["n_valid"]
            zero = torch.zeros((), device=w.device)
            rows.append(torch.stack((
                (metrics["results"][0] * w).sum(),
                (metrics["results"][1] * w).sum(), w.sum(),
                metrics["download_bytes"].sum() if cfg.track_bytes
                else zero,
                metrics["upload_bytes"].sum() if cfg.track_bytes
                else zero)))
            lrs.append(lr)
            global_round += 1
        if not rows:
            break
        per_round = torch.stack(rows).cpu().numpy().astype(np.float64)
        sums = per_round.sum(axis=0)
        train_time = timer()
        print(f"{'round':>6} {'lr':>8} {'loss':>9} {'acc':>7} "
              f"{'round_s':>9}")
        for i, row in enumerate(per_round):
            n = max(row[2], 1.0)
            log.losses.append(row[0] / n)
            print(f"{first + i + 1:>6} {lrs[i]:>8.5f} {row[0] / n:>9.5f} "
                  f"{row[1] / n:>7.4f} {log.round_s[first + i]:>9.4f}")
        # the divergence abort, at the epoch boundary: the flag names the
        # first round whose update, aggregate or loss was not finite
        nan_round = int(state.nan_round)
        if nan_round >= 0 or np.isnan(sums[0]):
            which = (f"first non-finite update at round {nan_round}"
                     if nan_round >= 0 else f"epoch loss {sums[0]} is NaN")
            print(f"TRAINING DIVERGED ({which}), TERMINATING", flush=True)
            return state, None, log
        total = max(sums[2], 1.0)
        download_mib = sums[3] / 2**20
        upload_mib = sums[4] / 2**20
        log.total_download_mib += download_mib
        log.total_upload_mib += upload_mib
        test_loss, test_acc, batches = validate(
            runtime, state, val_ds, cfg.valid_batch_size, val_max_batches)
        log.val_batches += batches
        timer()
        summary = {
            "epoch": epoch + 1,
            "lr": schedule(global_round / spe),
            "train_time": train_time,
            "train_loss": sums[0] / total,
            "train_acc": sums[1] / total,
            "test_loss": test_loss,
            "test_acc": test_acc,
            "down (MiB)": round(download_mib),
            "up (MiB)": round(upload_mib),
            "total_time": timer.total_time,
        }
        log.epochs.append(summary)
        for logger in loggers:
            logger.append(summary)
    n_clients = len(train_ds.data_per_client)
    print(f"Total Download (MiB): {log.total_download_mib:0.2f}")
    print(f"Total Upload (MiB): {log.total_upload_mib:0.2f}")
    print(f"Avg Download Per Client: "
          f"{log.total_download_mib / n_clients:0.2f}")
    print(f"Avg Upload Per Client: {log.total_upload_mib / n_clients:0.2f}",
          flush=True)
    return state, summary, log
