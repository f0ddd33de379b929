"""The epoch loop and validation shared by the port's entry points
(``cv_train`` and ``gpt2_train``), counterpart of the JAX package's
``cv_train.train`` and ``run_validation`` without telemetry or
asynchronous aggregation.

A round's batch comes from the train ``DeviceStore`` when there is one
(gathered and augmented on the device, keyed by the global round) and
from the host gather otherwise, fetched by the round input pipeline
(``core/pipeline.py``). The host gather runs on a worker thread,
``cfg.prefetch_depth`` rounds ahead, or inline under ``--no_pipeline``;
the store's fetch, a few kernels, runs inline (a worker thread hides
nothing there: PERF.md, ``chip_smoke.py phase_pipeline_ab``). The rounds
are the same either way. Each round's ``[loss * n, acc * n, n,
download bytes, upload bytes]`` stays on the device; the epoch's rows
are fetched once, at its end. There the loop reads the device-side
divergence flag and aborts on it (``TRAINING DIVERGED``, no validation
and no checkpoint after it), validates, appends the epoch row to the
loggers and, every ``checkpoint_every`` epochs, writes the whole state.
A resumed run starts at its checkpoint's epoch and global round, so the
rate schedule, the epoch samplers and the store's draws continue as if
never interrupted. Round times are taken on the host clock around
``runtime.round`` alone, between device syncs. Beside them the loop
keeps what the round waited for its batch (``data_s``: inline the whole
fetch, pipelined the queue wait) and what the fetch took on its own
thread (``fetch_s``, synced): the host gather and its upload, or the
store's index upload and its gather and augmentation on the device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from commefficient_torch.core.pipeline import RoundPipeline
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
    data_s: List[float] = dataclasses.field(default_factory=list)
    fetch_s: List[float] = dataclasses.field(default_factory=list)
    losses: List[float] = dataclasses.field(default_factory=list)
    epochs: List[dict] = dataclasses.field(default_factory=list)
    val_batches: int = 0          # validation batches run, all epochs
    total_download_mib: float = 0.0
    total_upload_mib: float = 0.0


def validate(runtime: FedRuntime, state, val_ds, batch_size: int,
             max_batches: Optional[int] = None, val_store=None):
    """Masked means of the validation loss and accuracy over the set, in
    chunks of ``batch_size`` (the first ``max_batches`` chunks only, when
    given), from ``val_store`` when there is one. The sums stay on the
    device and are fetched once. Returns ``(loss, acc, batches)``."""
    sums, batches = None, 0
    for idx, mask in ValSampler(len(val_ds), batch_size):
        if max_batches is not None and batches >= max_batches:
            break
        batch = (val_store.round_batch(idx) if val_store is not None
                 else val_ds.gather(idx))
        (loss, acc), n = runtime.val(state, batch, mask)
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


def make_fetch(runtime: FedRuntime, train_ds, train_store=None):
    """``fetch(rnd, global_round)``: the round's batch on the device, from
    ``train_store`` (drawn for the global round) or the host gather and
    its upload. On the card the host batch is uploaded from pinned
    memory, so that on the pipeline's side stream the copy does not hold
    the host."""
    pin = runtime.device.type == "cuda"

    def fetch(rnd, global_round: int):
        if train_store is not None:
            return train_store.round_batch(rnd.idx, global_round)
        batch = train_ds.gather(rnd.idx)
        if pin:
            batch = {k: torch.as_tensor(v).pin_memory()
                     for k, v in batch.items()}
        return runtime.to_device(batch)
    return fetch


def _round_row(cfg, metrics) -> torch.Tensor:
    """The round's ``[loss * n, acc * n, n, download bytes, upload
    bytes]``, on the device."""
    w = metrics["n_valid"]
    zero = torch.zeros((), device=w.device)
    return torch.stack((
        (metrics["results"][0] * w).sum(), (metrics["results"][1] * w).sum(),
        w.sum(),
        metrics["download_bytes"].sum() if cfg.track_bytes else zero,
        metrics["upload_bytes"].sum() if cfg.track_bytes else zero))


def train(runtime: FedRuntime, state, train_ds, val_ds, schedule: Callable,
          num_rounds: int = 0, max_per_epoch: Optional[int] = None,
          val_max_batches: Optional[int] = None, loggers: Sequence = (),
          timer: Optional[Timer] = None, train_store=None, val_store=None,
          ckpt_mgr=None, checkpoint_every: int = 0, start_epoch: int = 0,
          global_round: int = 0, lr_mult: Optional[torch.Tensor] = None,
          eval_before_start: bool = False):
    """The run's epochs from ``start_epoch``: one sampler an epoch, seeded
    by (seed, epoch), at most ``ceil(rounds per epoch x the epoch's
    fraction)`` rounds of it (and ``max_per_epoch``), round t (from 1,
    counted over the whole run from ``global_round`` rounds already taken)
    at the rate ``schedule(t / rounds per epoch)`` (times the (d,)
    ``lr_mult`` when given: the round takes the vector, the rows print
    the scalar), its batch fetched by a ``RoundPipeline`` from
    ``train_store`` (drawn for round t) or the host gather
    (``make_fetch``): the host gather ``cfg.prefetch_depth`` ahead, or
    inline when ``cfg.pipeline`` is False; the store's inline. ``eval_before_start`` validates once
    before the first round. Stops after
    ``num_rounds`` rounds of the whole run when that is positive; the
    epoch in which it stops still ends as any epoch does, but is
    checkpointed only when it ran to its end. Every ``checkpoint_every``
    epochs ``ckpt_mgr`` saves the state with the epoch row and the global
    round. Returns ``(state, summary, log)``: ``summary`` is the last
    epoch row, or None after a divergence abort."""
    cfg, device = runtime.cfg, runtime.device
    timer = timer or Timer()
    spe = max(epoch_sampler(cfg, train_ds, 0).epoch_rounds(), 1)
    log, summary = RunLog(), None
    fetch = make_fetch(runtime, train_ds, train_store)
    if eval_before_start:
        _, test_acc, _ = validate(runtime, state, val_ds,
                                  cfg.valid_batch_size, val_max_batches,
                                  val_store)
        print(f"Test acc at epoch 0: {test_acc:0.4f}")
    n_epochs = math.ceil(cfg.num_epochs)
    for epoch in range(start_epoch, n_epochs):
        if num_rounds and global_round >= num_rounds:
            break
        fraction = (cfg.num_epochs - epoch if epoch == n_epochs - 1
                    else 1.0)
        max_rounds = int(math.ceil(spe * fraction))
        if max_per_epoch is not None:
            max_rounds = min(max_rounds, max_per_epoch)
        cut = False
        if num_rounds and num_rounds - global_round < max_rounds:
            # the run ends inside this epoch's cap: it cuts the epoch
            # short where the sampler has a round more (a copy of the
            # sampler counts them, so no batch is fetched for it)
            max_rounds = num_rounds - global_round
            cut = any(True for _ in itertools.islice(
                epoch_sampler(cfg, train_ds, epoch), max_rounds, None))
        rows, lrs, first = [], [], len(log.round_s)
        # the JAX package keys the schedule and the store's draws by the
        # 1-based round
        pipe = RoundPipeline(epoch_sampler(cfg, train_ds, epoch), fetch,
                             start_round=global_round, max_rounds=max_rounds,
                             depth=cfg.prefetch_depth,
                             enabled=cfg.pipeline and train_store is None,
                             device=device)
        with pipe:
            for item in pipe:
                rnd = item.rnd
                lr = schedule(item.global_round / spe)
                log.data_s.append(item.wait_s)
                log.fetch_s.append(item.fetch_s)
                t0 = time.perf_counter()
                state, metrics = runtime.round(
                    state, rnd.client_ids, item.batch, rnd.mask,
                    lr if lr_mult is None else lr * lr_mult)
                _sync(device)
                log.round_s.append(time.perf_counter() - t0)
                rows.append(_round_row(cfg, metrics))
                lrs.append(lr)
                global_round = item.global_round
        if not rows:
            break
        per_round = torch.stack(rows).cpu().numpy().astype(np.float64)
        sums = per_round.sum(axis=0)
        train_time = timer()
        print(f"{'round':>6} {'lr':>8} {'loss':>9} {'acc':>7} "
              f"{'round_s':>9} {'data_ms':>8} {'fetch_ms':>8}")
        for i, row in enumerate(per_round):
            n = max(row[2], 1.0)
            log.losses.append(row[0] / n)
            print(f"{global_round - len(rows) + i + 1:>6} {lrs[i]:>8.5f} "
                  f"{row[0] / n:>9.5f} {row[1] / n:>7.4f} "
                  f"{log.round_s[first + i]:>9.4f} "
                  f"{log.data_s[first + i] * 1e3:>8.3f} "
                  f"{log.fetch_s[first + i] * 1e3:>8.3f}")
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
            runtime, state, val_ds, cfg.valid_batch_size, val_max_batches,
            val_store)
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
        if (ckpt_mgr is not None and checkpoint_every and not cut
                and (epoch + 1) % checkpoint_every == 0):
            ckpt_mgr.save(state, epoch + 1,
                          meta={"summary": summary,
                                "global_round": int(global_round)})
    n_clients = len(train_ds.data_per_client)
    print(f"Total Download (MiB): {log.total_download_mib:0.2f}")
    print(f"Total Upload (MiB): {log.total_upload_mib:0.2f}")
    print(f"Avg Download Per Client: "
          f"{log.total_download_mib / n_clients:0.2f}")
    print(f"Avg Upload Per Client: {log.total_upload_mib / n_clients:0.2f}",
          flush=True)
    return state, summary, log
