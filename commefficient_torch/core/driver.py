"""The epoch loop and validation shared by the port's entry points
(``cv_train`` and ``gpt2_train``), counterpart of the JAX package's
``cv_train.train`` and ``run_validation`` without telemetry. ``cv_train``
also runs the host half of the runtime services (``Services``: the async
pool, the quarantine ledger, the preemption drain and the watchdog), as
the JAX package's CV driver does; its GPT-2 loop has none.

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
import os
import sys
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from commefficient_torch.checkpoint import save_postmortem
from commefficient_torch.core.async_agg import AsyncAggregator
from commefficient_torch.core.pipeline import RoundPipeline
from commefficient_torch.core.preempt import (PreemptGuard, RoundWatchdog,
                                              collect_ledger_state,
                                              restore_ledger_state,
                                              with_retries)
from commefficient_torch.core.quarantine import QuarantineLedger
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data.fed_sampler import (FedSampler, ValSampler,
                                                  mask_blocked)
from commefficient_torch.data.scenarios import make_scenario
from commefficient_torch.faults import maybe_fault
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
    # each round's defense scalars (DEFENSE_KEYS), when the round has them
    defense: List[dict] = dataclasses.field(default_factory=list)
    # the host services of the run (Services), and whether it drained
    services: Any = None
    preempted: bool = False


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


DEFENSE_KEYS = ("clip_frac", "clip_thresh", "clipped_mass", "trim_frac",
                "nonfinite_clients")


def _round_row(cfg, metrics) -> torch.Tensor:
    """The round's ``[loss * n, acc * n, n, download bytes, upload
    bytes]``, on the device, then the defense scalars (``DEFENSE_KEYS``)
    when the round returns them."""
    w = metrics["n_valid"]
    zero = torch.zeros((), device=w.device)
    cols = [(metrics["results"][0] * w).sum(),
            (metrics["results"][1] * w).sum(), w.sum(),
            metrics["download_bytes"].sum() if cfg.track_bytes else zero,
            metrics["upload_bytes"].sum() if cfg.track_bytes else zero]
    if metrics.get("defense") is not None:
        cols += [metrics["defense"][k] for k in DEFENSE_KEYS]
    return torch.stack(cols)


class Services:
    """The host half of the runtime services (``cv_train``; the JAX
    package's GPT-2 loop has none): the async pool (core/async_agg.py)
    with its scenario, the quarantine ledger, the preemption guard and
    the watchdog (core/preempt.py). ``ledgers`` is a resumed
    checkpoint's sidecar."""

    def __init__(self, runtime: FedRuntime, num_clients: int,
                 ledgers=None):
        cfg = self.cfg = runtime.cfg
        self.num_clients = num_clients
        self.async_agg = None
        if cfg.async_agg:
            self.async_agg = AsyncAggregator(runtime,
                                             scenario=make_scenario(cfg))
            print(f"async aggregation: K={self.async_agg.max_inflight} in "
                  f"flight, commit every M={self.async_agg.buffer_goal} "
                  f"cohorts, {self.async_agg.discount} staleness discount"
                  + ("" if self.async_agg.scenario is None
                     else f", scenario={cfg.scenario}"))
        self.qledger = None
        if cfg.nonfinite_action == "quarantine":
            self.qledger = QuarantineLedger(
                backoff=cfg.quarantine_backoff,
                strikes=cfg.quarantine_strikes)
            restore_ledger_state(ledgers, qledger=self.qledger)
        plan = runtime.adversary_plan
        if plan is not None:
            n_adv = int(plan.universe_mask(num_clients).sum())
            print(f"adversary injection: {cfg.adversary} on {n_adv}/"
                  f"{num_clients} clients (frac {cfg.adversary_frac}), "
                  f"defense={cfg.defense}, "
                  f"nonfinite_action={cfg.nonfinite_action}")
        self.guard = PreemptGuard(cfg.preempt_grace)
        self.watchdog = None
        self.commits: List[dict] = []

    def start(self) -> None:
        """Installs the guard and starts the watchdog: call just before
        the ``try`` whose ``finally`` calls ``stop``."""
        self.guard.install()
        if self.cfg.watchdog:
            self.watchdog = RoundWatchdog(self._on_stall,
                                          mult=self.cfg.watchdog_mult)

    def stop(self) -> None:
        self.guard.uninstall()
        if self.watchdog is not None:
            self.watchdog.close()

    @staticmethod
    def _on_stall(rnd: int, elapsed: float, deadline: float) -> None:
        print(f"WATCHDOG: round {rnd} exceeded its stall deadline: "
              f"{elapsed:.1f}s > {deadline:.1f}s", file=sys.stderr,
              flush=True)

    def retrying(self, fetch: Callable) -> Callable:
        """Under ``--watchdog`` the round's input fetch gets bounded
        exponential-backoff retries."""
        if not self.cfg.watchdog:
            return fetch
        return lambda rnd, g: with_retries(
            lambda: fetch(rnd, g), attempts=3,
            desc=f"round {g} input fetch")

    def observe_quarantine(self, global_round: int, client_ids,
                           metrics) -> bool:
        """Feeds the round's per-slot finite flags (one copy) to the
        ledger and prints each strike; True when every client is
        ejected."""
        if self.qledger is None or metrics is None \
                or metrics.get("client_finite") is None:
            return False
        fin = metrics["client_finite"].cpu().numpy()
        q = self.qledger
        for cid in q.observe(global_round, np.asarray(client_ids), fin):
            what = ("EJECTED (strikes exhausted)" if cid in q.ejected
                    else f"benched {self.cfg.quarantine_backoff} rounds "
                    f"(strike {q.strikes[cid]}/{q.max_strikes})")
            print(f"QUARANTINE: client {cid} uploaded a nonfinite update "
                  f"at round {global_round}; {what}", file=sys.stderr)
        return len(q.ejected) >= self.num_clients

    def flush(self, state, lr):
        """The epoch's (and the drain's) flush of the async pool: every
        in-flight cohort lands and a partial buffer commits, so no open
        buffer reaches a checkpoint."""
        if self.async_agg is None:
            return state
        state, commits = self.async_agg.flush(state, lr)
        self.commits.extend(commits)
        return state


def train(runtime: FedRuntime, state, train_ds, val_ds, schedule: Callable,
          num_rounds: int = 0, max_per_epoch: Optional[int] = None,
          val_max_batches: Optional[int] = None, loggers: Sequence = (),
          timer: Optional[Timer] = None, train_store=None, val_store=None,
          ckpt_mgr=None, checkpoint_every: int = 0, start_epoch: int = 0,
          global_round: int = 0, lr_mult: Optional[torch.Tensor] = None,
          eval_before_start: bool = False, services: bool = False):
    """The run's epochs from ``start_epoch``: one sampler an epoch, seeded
    by (seed, epoch), at most ``ceil(rounds per epoch x the epoch's
    fraction)`` rounds of it (and ``max_per_epoch``), round t (from 1,
    counted over the whole run from ``global_round`` rounds already taken)
    at the rate ``schedule(t / rounds per epoch)`` (times the (d,)
    ``lr_mult`` when given: the round takes the vector, the rows print
    the scalar), its batch fetched by a ``RoundPipeline`` from
    ``train_store`` (drawn for round t) or the host gather
    (``make_fetch``): the host gather ``cfg.prefetch_depth`` ahead, or
    inline when ``cfg.pipeline`` is False; the store's inline.
    ``eval_before_start`` validates once before the first round. A
    resume inside an epoch (``ckpt_mgr.resume``'s ``round_in_epoch``, a
    preempt generation's) skips the rounds that epoch already trained.
    Stops after ``num_rounds`` rounds of the whole run when that is
    positive; the epoch in which it stops still ends as any epoch does,
    but is checkpointed only when it ran to its end. Every
    ``checkpoint_every`` epochs ``ckpt_mgr`` saves the state with the
    epoch row, the global round and the host ledgers.

    ``services`` (``cv_train``) runs the host half of the runtime
    services: under ``--async_agg`` each round is a tick of the
    ``AsyncAggregator`` (a dropped cohort trains nothing and prints no
    row) and every epoch's end flushes it; under the quarantine each
    round's slots of benched clients are masked out and its finite flags
    strike the ledger (every client ejected: a postmortem beside the
    checkpoints, and the run ends); a first SIGTERM/SIGINT drains at the
    next round boundary (pipeline closed, pool flushed, a
    ``preempt``-tagged checkpoint written) and the run ends without a
    summary; ``--watchdog`` deadlines each round and retries its fetch.
    Returns ``(state, summary, log)``: ``summary`` is the last epoch row,
    or None after a divergence abort, a quarantine abort or a drain."""
    cfg, device = runtime.cfg, runtime.device
    timer = timer or Timer()
    spe = max(epoch_sampler(cfg, train_ds, 0).epoch_rounds(), 1)
    log, summary = RunLog(), None
    resume = ckpt_mgr.resume if ckpt_mgr is not None else {}
    start_round = int(resume.get("round_in_epoch", 0))
    svc = (Services(runtime, len(train_ds.data_per_client),
                    resume.get("ledgers")) if services else None)
    log.services = svc
    fetch = make_fetch(runtime, train_ds, train_store)
    if svc is not None:
        fetch = svc.retrying(fetch)
    if eval_before_start:
        _, test_acc, _ = validate(runtime, state, val_ds,
                                  cfg.valid_batch_size, val_max_batches,
                                  val_store)
        print(f"Test acc at epoch 0: {test_acc:0.4f}")

    def lr_at(g: int):
        lr = schedule(g / spe)
        return lr, (lr if lr_mult is None else lr * lr_mult)

    def drain(state, epoch: int, in_epoch: int, pipe, existing=None):
        """The preemption drain, within what is left of the grace budget
        (a drain that wedges is force-exited)."""
        guard = svc.guard
        remaining = max(cfg.preempt_grace - (guard.grace_used_s() or 0.0),
                        1.0)
        force = guard.force_exit_after(remaining)
        try:
            if pipe is not None:
                pipe.close()
            state = svc.flush(state, lr_at(global_round)[1])
            ck = existing
            if ck is None and ckpt_mgr is not None:
                ck = ckpt_mgr.save(
                    state, epoch,
                    meta={"global_round": int(global_round),
                          "ledgers": collect_ledger_state(svc.qledger)},
                    round_in_epoch=in_epoch, tag="preempt")
            elif ck is None:
                print("PREEMPT WARNING: no checkpoint manager configured — "
                      "draining WITHOUT a checkpoint; progress since the "
                      "last save is lost on restart", file=sys.stderr)
            grace = guard.grace_used_s()
            print(f"PREEMPT: drained at epoch {epoch} + {in_epoch} "
                  f"round(s) (global round {global_round})"
                  + (f"; checkpoint {ck}" if ck else "")
                  + (f"; grace used {grace:.1f}s of "
                     f"{cfg.preempt_grace:.0f}s" if grace is not None
                     else ""), flush=True)
        finally:
            force.cancel()
        log.preempted = True
        return state

    n_epochs = math.ceil(cfg.num_epochs)
    pipe = None
    if svc is not None:
        svc.start()
    try:
        for epoch in range(start_epoch, n_epochs):
            if num_rounds and global_round >= num_rounds:
                break
            skip = start_round if epoch == start_epoch else 0
            fraction = (cfg.num_epochs - epoch if epoch == n_epochs - 1
                        else 1.0)
            max_rounds = int(math.ceil(spe * fraction))
            if max_per_epoch is not None:
                max_rounds = min(max_rounds, max_per_epoch)
            cut = False
            if num_rounds and num_rounds - global_round < max_rounds - skip:
                # the run ends inside this epoch's cap: it cuts the epoch
                # short where the sampler has a round more (a copy of the
                # sampler counts them, so no batch is fetched for it)
                max_rounds = skip + num_rounds - global_round
                cut = any(True for _ in itertools.islice(
                    epoch_sampler(cfg, train_ds, epoch), max_rounds, None))
            rows, lrs, first = [], [], len(log.round_s)
            in_epoch, consumed = skip, 0
            # the JAX package keys the schedule and the store's draws by
            # the 1-based round
            pipe = RoundPipeline(epoch_sampler(cfg, train_ds, epoch), fetch,
                                 start_round=global_round - skip,
                                 max_rounds=max_rounds,
                                 depth=cfg.prefetch_depth,
                                 enabled=cfg.pipeline and train_store is None,
                                 device=device, skip=skip)
            for item in pipe:
                if svc is not None and svc.guard.requested:
                    # the fetched round has not trained: the preempt
                    # checkpoint's round count covers the consumed ones
                    state = drain(state, epoch, in_epoch, pipe)
                    return state, None, log
                rnd, g = item.rnd, item.global_round
                in_epoch += 1
                consumed += 1
                maybe_fault("pre_round", g)
                if svc is not None and svc.qledger is not None:
                    rnd = mask_blocked(rnd, svc.qledger.blocked(g))
                lr, lr_arr = lr_at(g)
                watchdog = svc.watchdog if svc is not None else None
                if watchdog is not None:
                    watchdog.arm(g)
                t0 = time.perf_counter()
                if svc is not None and svc.async_agg is not None:
                    state, metrics, commits = svc.async_agg.step(
                        state, rnd, g, item.batch, lr_arr)
                    svc.commits.extend(commits)
                else:
                    state, metrics = runtime.round(
                        state, rnd.client_ids, item.batch, rnd.mask, lr_arr)
                maybe_fault("mid_round", g)
                _sync(device)
                round_s = time.perf_counter() - t0
                if watchdog is not None:
                    watchdog.disarm()
                global_round = g
                if svc is not None and svc.observe_quarantine(
                        g, rnd.client_ids, metrics):
                    print(f"QUARANTINE ABORT: all {svc.num_clients} "
                          "clients are permanently ejected (nonfinite "
                          "strikes exhausted) — no data remains, "
                          "TERMINATING", flush=True)
                    if ckpt_mgr is not None:
                        path = save_postmortem(
                            os.path.join(ckpt_mgr.directory,
                                         f"postmortem_r{g:06d}"), state,
                            {"rule": "quarantine_exhausted", "round": g,
                             "ejected": len(svc.qledger.ejected),
                             "ledgers": collect_ledger_state(svc.qledger)})
                        print(f"postmortem: {path}", flush=True)
                    return state, None, log
                if metrics is None:
                    # a scenario-dropped cohort: nothing trained
                    continue
                log.data_s.append(item.wait_s)
                log.fetch_s.append(item.fetch_s)
                log.round_s.append(round_s)
                rows.append(_round_row(cfg, metrics))
                lrs.append(lr)
            pipe.close()
            if svc is not None:
                state = svc.flush(state, lr_at(global_round)[1])
            if not consumed:
                break
            if rows:
                per_round = torch.stack(rows).cpu().numpy().astype(
                    np.float64)
            else:
                per_round = np.zeros((0, 5))
            sums = per_round.sum(axis=0) if rows else np.zeros(5)
            train_time = timer()
            _print_rows(log, per_round, lrs, first, global_round)
            # the divergence abort, at the epoch boundary: the flag names
            # the first round whose update, aggregate or loss was not
            # finite
            nan_round = int(state.nan_round)
            if nan_round >= 0 or np.isnan(sums[0]):
                which = (f"first non-finite update at round {nan_round}"
                         if nan_round >= 0
                         else f"epoch loss {sums[0]} is NaN")
                print(f"TRAINING DIVERGED ({which}), TERMINATING",
                      flush=True)
                return state, None, log
            total = max(sums[2], 1.0)
            download_mib = sums[3] / 2**20
            upload_mib = sums[4] / 2**20
            log.total_download_mib += download_mib
            log.total_upload_mib += upload_mib
            test_loss, test_acc, batches = validate(
                runtime, state, val_ds, cfg.valid_batch_size,
                val_max_batches, val_store)
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
            ck = None
            if (ckpt_mgr is not None and checkpoint_every and not cut
                    and (epoch + 1) % checkpoint_every == 0):
                ck = ckpt_mgr.save(
                    state, epoch + 1,
                    meta={"summary": summary,
                          "global_round": int(global_round),
                          "ledgers": collect_ledger_state(
                              svc.qledger if svc is not None else None)})
            if svc is not None and svc.guard.requested:
                state = drain(state, epoch + 1, 0, None, existing=ck)
                return state, None, log
    finally:
        if pipe is not None:
            pipe.close()
        if svc is not None:
            svc.stop()
    n_clients = len(train_ds.data_per_client)
    print(f"Total Download (MiB): {log.total_download_mib:0.2f}")
    print(f"Total Upload (MiB): {log.total_upload_mib:0.2f}")
    print(f"Avg Download Per Client: "
          f"{log.total_download_mib / n_clients:0.2f}")
    print(f"Avg Upload Per Client: {log.total_upload_mib / n_clients:0.2f}",
          flush=True)
    return state, summary, log


def _print_rows(log: RunLog, per_round: np.ndarray, lrs, first: int,
                global_round: int) -> None:
    """The epoch's rounds, one row each (the defense scalars after the
    times when the rounds carry them); appends the losses and the
    defense rows to ``log``."""
    defense = per_round.shape[1] > 5
    print(f"{'round':>6} {'lr':>8} {'loss':>9} {'acc':>7} "
          f"{'round_s':>9} {'data_ms':>8} {'fetch_ms':>8}"
          + "".join(f" {k:>12}" for k in DEFENSE_KEYS if defense))
    n_rows = len(per_round)
    for i, row in enumerate(per_round):
        n = max(row[2], 1.0)
        log.losses.append(row[0] / n)
        if defense:
            log.defense.append(dict(zip(DEFENSE_KEYS, row[5:].tolist())))
        print(f"{global_round - n_rows + i + 1:>6} {lrs[i]:>8.5f} "
              f"{row[0] / n:>9.5f} {row[1] / n:>7.4f} "
              f"{log.round_s[first + i]:>9.4f} "
              f"{log.data_s[first + i] * 1e3:>8.3f} "
              f"{log.fetch_s[first + i] * 1e3:>8.3f}"
              + "".join(f" {v:>12.5g}" for v in row[5:]))
