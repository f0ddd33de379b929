"""The round loop and validation shared by the port's entry points
(``cv_train`` and ``gpt2_train``), counterpart of the shared loop of the
JAX package's ``cv_train.train`` without checkpointing, telemetry or
pipelining."""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data.fed_sampler import FedSampler, ValSampler


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def validate(runtime: FedRuntime, state, val_ds, batch_size: int,
             max_batches: Optional[int] = None):
    """Masked means of the validation loss and accuracy over the set, in
    chunks of ``batch_size`` (the first ``max_batches`` chunks only, when
    given)."""
    tot = np.zeros(3)
    for i, (idx, mask) in enumerate(ValSampler(len(val_ds), batch_size)):
        if max_batches is not None and i >= max_batches:
            break
        (loss, acc), n = runtime.val(state, val_ds.gather(idx), mask)
        n = float(n)
        tot += (float(loss) * n, float(acc) * n, n)
    return tot[0] / max(tot[2], 1), tot[1] / max(tot[2], 1)


def rounds(runtime: FedRuntime, train_ds, schedule: Callable,
           max_per_epoch: Optional[int] = None):
    """``(global_round, lr, Round)`` over the run's epochs: one sampler per
    epoch, seeded by (seed, epoch), at most ``max_per_epoch`` rounds of
    each, and the learning rate ``schedule(epoch fraction)``."""
    cfg = runtime.cfg

    def epoch_sampler(epoch: int) -> FedSampler:
        return FedSampler(train_ds.data_per_client, cfg.num_workers,
                          cfg.local_batch_size, seed=cfg.seed + 7919 * epoch)

    spe = max(epoch_sampler(0).epoch_rounds(), 1)
    global_round = 0
    for epoch in range(math.ceil(cfg.num_epochs)):
        for i, rnd in enumerate(epoch_sampler(epoch)):
            if max_per_epoch is not None and i >= max_per_epoch:
                break
            yield global_round, schedule(global_round / spe), rnd
            global_round += 1


def train(runtime: FedRuntime, state, train_ds, schedule: Callable,
          num_rounds: int = 0, max_per_epoch: Optional[int] = None):
    """One printed row per round (lr, loss, accuracy, round time on the
    host clock around work that ends in a device sync). Stops after
    ``num_rounds`` rounds when that is positive. Returns ``(state,
    round_s, losses)``."""
    device = runtime.device
    print(f"{'round':>6} {'lr':>8} {'loss':>9} {'acc':>7} {'round_s':>9}")
    times, losses = [], []
    for global_round, lr, rnd in rounds(runtime, train_ds, schedule,
                                        max_per_epoch):
        if num_rounds and global_round >= num_rounds:
            break
        batch = train_ds.gather(rnd.idx)
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = runtime.round(state, rnd.client_ids, batch,
                                       rnd.mask, lr)
        _sync(device)
        dt = time.perf_counter() - t0
        n = metrics["n_valid"]
        tot = torch.clamp(n.sum(), min=1.0)
        loss = float((metrics["results"][0] * n).sum() / tot)
        acc = float((metrics["results"][1] * n).sum() / tot)
        times.append(dt)
        losses.append(loss)
        print(f"{global_round + 1:>6} {lr:>8.5f} {loss:>9.5f} {acc:>7.4f} "
              f"{dt:>9.4f}", flush=True)
    return state, times, losses
