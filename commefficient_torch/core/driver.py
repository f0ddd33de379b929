"""The epoch loop and validation shared by the port's entry points
(``cv_train`` and ``gpt2_train``), counterpart of the JAX package's
``cv_train.train`` and ``run_validation``. ``cv_train`` also runs the
host half of the runtime services (``Services``: the async pool, the
quarantine ledger, the preemption drain and the watchdog), as the JAX
package's CV driver does; its GPT-2 loop has none.

With a telemetry stream (telemetry/run.py, the default) the loop writes
the JAX package's events: a ``round`` record (with ``host_s``, the wait
for the batch, ``dispatch_s``, the host's dispatch of the round, and
``device_s``, the wait at the driver's sync), ``signals``,
``layer_signals``, ``client_stats``, ``population`` and ``defense`` every
``telemetry_round_every`` rounds, the metrics crossing to the host in
one copy at that round and never between; ``utilization`` and ``span``
events, ``memory`` snapshots (init, round 1, each epoch's rounds,
validation and checkpoint) and the first round's measured
``memory_ledger``; ``async_round``, ``fault`` and ``resume`` lineage;
``epoch``; ``nan_abort``; and a ``summary`` footer on every exit. The
``AnomalyMonitor`` watches the stream, and under ``--alert_action
checkpoint|abort`` the ``FlightRecorder`` writes its bundle. On a mesh
the first round runs under the collectives ledger and rank 0 writes its
``collectives`` event; rank 0's monitor verdict (the abort) and a
preemption drain request of any rank reach every rank through one
``Mesh.any`` at each round's end and at the epoch's, so all ranks abort
or drain at the same round.

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
from commefficient_torch.core.async_agg import AsyncAggregator, commit_loss
from commefficient_torch.core.pipeline import (DecodeOverlapRound,
                                               RoundPipeline)
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
from commefficient_torch.telemetry import maybe_create as make_telemetry
from commefficient_torch.telemetry import tracing
from commefficient_torch.telemetry.collectives import recording
from commefficient_torch.telemetry.clients import (client_stats_to_host,
                                                   make_ledger)
from commefficient_torch.telemetry.health import (AnomalyMonitor,
                                                  FlightRecorder)
from commefficient_torch.telemetry.layer_signals import \
    layer_signals_to_host
from commefficient_torch.telemetry.memory_ledger import measure_round
from commefficient_torch.telemetry.profiling import ProfilerWindow
from commefficient_torch.telemetry.signals import (signals_to_host,
                                                   tree_to_host)
from commefficient_torch.telemetry.utilization import UtilizationTracker
from commefficient_torch.utils.logging import Timer, make_logdir


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
    # the run's telemetry: the participation ledger, the anomaly monitor
    # and the flight recorder (None without a stream)
    ledger: Any = None
    monitor: Any = None
    recorder: Any = None


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
    checkpoint's sidecar. ``obs`` (a :class:`Observers`) takes the
    watchdog's stall, the fetch's retries and the quarantine's
    strikes."""

    def __init__(self, runtime: FedRuntime, num_clients: int,
                 ledgers=None, obs: Optional["Observers"] = None):
        cfg = self.cfg = runtime.cfg
        self.num_clients = num_clients
        self.obs = obs
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

    def _on_stall(self, rnd: int, elapsed: float, deadline: float) -> None:
        msg = (f"round {rnd} exceeded its stall deadline: "
               f"{elapsed:.1f}s > {deadline:.1f}s")
        print(f"WATCHDOG: {msg}", file=sys.stderr, flush=True)
        if self.obs is not None:
            self.obs.stall(rnd, elapsed, deadline, msg)

    def retrying(self, fetch: Callable) -> Callable:
        """Under ``--watchdog`` the round's input fetch gets bounded
        exponential-backoff retries, each a ``fault`` event."""
        if not self.cfg.watchdog:
            return fetch
        obs = self.obs

        def fetch_retrying(rnd, g):
            def note(attempt, err):
                if obs is not None and obs.tel is not None:
                    obs.tel.fault_event(rnd=g, kind="fetch_retry",
                                        detail=f"attempt {attempt}: {err}")
            return with_retries(lambda: fetch(rnd, g), attempts=3,
                                desc=f"round {g} input fetch",
                                on_retry=note)
        return fetch_retrying

    def observe_quarantine(self, global_round: int, client_ids,
                           metrics) -> bool:
        """Feeds the round's per-slot finite flags (one copy) to the
        ledger, prints each strike and passes them to the participation
        ledger; True when every client is ejected."""
        if self.qledger is None or metrics is None \
                or metrics.get("client_finite") is None:
            return False
        fin = metrics["client_finite"].cpu().numpy()
        q = self.qledger
        struck = q.observe(global_round, np.asarray(client_ids), fin)
        if struck and self.obs is not None and self.obs.ledger is not None:
            self.obs.ledger.observe_strikes(struck)
        for cid in struck:
            what = ("EJECTED (strikes exhausted)" if cid in q.ejected
                    else f"benched {self.cfg.quarantine_backoff} rounds "
                    f"(strike {q.strikes[cid]}/{q.max_strikes})")
            print(f"QUARANTINE: client {cid} uploaded a nonfinite update "
                  f"at round {global_round}; {what}", file=sys.stderr)
        return len(q.ejected) >= self.num_clients

    def flush(self, state, lr):
        """The epoch's (and the drain's) flush of the async pool: every
        in-flight cohort lands and a partial buffer commits, so no open
        buffer reaches a checkpoint. Returns ``(state, commits)``."""
        if self.async_agg is None:
            return state, []
        state, commits = self.async_agg.flush(state, lr)
        self.commits.extend(commits)
        return state, commits


class Observers:
    """The telemetry of one run, around the stream ``tel`` (None: every
    method is a no-op and nothing is installed): the span tracer, the
    utilization window, the anomaly monitor, the flight recorder, the
    participation ledger and the profiler window."""

    def __init__(self, runtime: FedRuntime, tel, num_clients: int,
                 flops_per_round: Optional[float] = None, ledgers=None):
        cfg = self.cfg = runtime.cfg
        self.tel = tel
        self.device = runtime.device
        self.prof = ProfilerWindow(cfg.profile_dir, cfg.profile_rounds)
        self.tracer = self.util = self.monitor = self.recorder = None
        self.ledger = None
        if tel is None:
            return
        self.tracer = tracing.install()
        kind = (torch.cuda.get_device_name(runtime.device)
                if runtime.device.type == "cuda" else "cpu")
        self.util = UtilizationTracker(
            tel, device_kind=kind, peak_flops=cfg.peak_flops,
            peak_hbm_gbps=cfg.peak_hbm_gbps, n_devices=1)
        if flops_per_round:
            self.util.set_flops_per_round(flops_per_round)
        self.monitor = AnomalyMonitor(tel, action=cfg.alert_action,
                                      window=cfg.alert_window,
                                      z_thresh=cfg.alert_zscore)
        tel.set_monitor(self.monitor)
        if cfg.alert_action in ("checkpoint", "abort"):
            self.recorder = FlightRecorder(tel.logdir, tel)
        if cfg.client_stats:
            self.ledger = make_ledger(num_clients, cfg.population_sketch)
        restore_ledger_state(ledgers, participation=self.ledger,
                             monitor=self.monitor)

    def close(self) -> None:
        if self.tracer is not None:
            tracing.uninstall()

    def stall(self, rnd: int, elapsed: float, deadline: float,
              msg: str) -> None:
        """The watchdog's stall: a ``round_stall`` alert through the
        monitor, a ``fault`` event and an events-only bundle (fetching
        the state is what may hang)."""
        if self.monitor is not None:
            self.monitor.external_alert(rnd=rnd, rule="round_stall",
                                        metric="round.wall_s",
                                        value=float(elapsed))
        if self.tel is not None:
            self.tel.fault_event(rnd=rnd, kind="round_stall", detail=msg)
            self.tel.fsync()
        if self.recorder is not None:
            self.recorder.record(None, {"rule": "round_stall",
                                        "round": int(rnd),
                                        "elapsed_s": float(elapsed),
                                        "deadline_s": float(deadline)})

    def sidecar(self, qledger=None) -> dict:
        """The checkpoint's host-ledger sidecar."""
        return collect_ledger_state(qledger=qledger,
                                    participation=self.ledger,
                                    monitor=self.monitor, telemetry=self.tel)

    def sync(self) -> None:
        _sync(self.device)

    def act_on_alerts(self, state) -> bool:
        """The monitor's side effects that need the state: the flight
        recorder's snapshot, and True when ``--alert_action abort`` asks
        the run to stop."""
        if self.recorder is not None:
            req = self.monitor.pop_snapshot_request()
            if req is not None:
                self.recorder.record(state, req)
        if self.monitor is not None and self.monitor.abort_requested:
            last = self.monitor.alerts[-1]
            print(f"ALERT ABORT (--alert_action abort): rule "
                  f"{last['rule']} on {last['metric']} at round "
                  f"{last['round']}, TERMINATING", flush=True)
            return True
        return False

    def footer(self, log: "RunLog", aborted: bool, n_rounds: int) -> None:
        """The stream's last events on any exit: the spans since the last
        drain and the ``summary``, forced to disk."""
        self.prof.finalize(self.sync)
        if self.tel is None:
            return
        self.tel.span_event(self.tracer)
        self.tel.write_summary(aborted=aborted, n_rounds=n_rounds,
                               total_download_mib=log.total_download_mib,
                               total_upload_mib=log.total_upload_mib,
                               final=self.tel.last_epoch)
        self.tel.fsync()

    def commits(self, commits, lr: float, with_device: bool) -> None:
        """One ``async_round`` event a commit; the device fields (and the
        loss) only when ``with_device`` (a record round, or a flush)."""
        if self.tel is None:
            return
        for c in commits:
            self.tel.async_round_event(
                rec=c, lr=float(lr),
                loss=commit_loss(c) if with_device else None,
                with_device=with_device)


def open_telemetry(cfg, runtime: FedRuntime, run_type: str, ckpt_mgr=None):
    """The run's logdir (``--logdir``, else ``make_logdir``'s; one for the
    stream and the TensorBoard writer) and its telemetry stream (None
    under ``--no_telemetry``), opened on the runtime's resolved config
    with the resume's lineage, its ``manifest`` and ``memory("init")``
    written. Returns ``(logdir or None, telemetry or None)``; on a mesh
    only rank 0 writes (the others get ``(None, None)``)."""
    mesh = getattr(runtime, "mesh", None)
    if mesh is not None and mesh.rank != 0:
        return None, None
    logdir = (cfg.logdir or make_logdir(cfg)
              if cfg.telemetry or cfg.use_tensorboard else None)
    resume = ckpt_mgr.resume if ckpt_mgr is not None else {}
    telemetry = make_telemetry(
        cfg, run_type, logdir=logdir, device=runtime.device,
        resume_info=({"round": resume["global_round"],
                      "epoch": resume["epoch"],
                      "checkpoint": resume["checkpoint"]}
                     if resume.get("checkpoint") else None))
    if telemetry is not None:
        telemetry.memory_event("init")
    return logdir, telemetry


def make_writer(cfg, logdir: Optional[str] = None):
    """A TensorBoard writer under ``--tensorboard`` (the reference's
    scalars), sharing the run's logdir; the JAX package's warning when
    ``torch.utils.tensorboard`` is missing."""
    if not cfg.use_tensorboard:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        print("WARNING: --tensorboard set but SummaryWriter unavailable")
        return None
    return SummaryWriter(log_dir=logdir or make_logdir(cfg))


def train(runtime: FedRuntime, state, train_ds, val_ds, schedule: Callable,
          num_rounds: int = 0, max_per_epoch: Optional[int] = None,
          val_max_batches: Optional[int] = None, loggers: Sequence = (),
          timer: Optional[Timer] = None, train_store=None, val_store=None,
          ckpt_mgr=None, checkpoint_every: int = 0, start_epoch: int = 0,
          global_round: int = 0, lr_mult: Optional[torch.Tensor] = None,
          eval_before_start: bool = False, services: bool = False,
          telemetry=None, model_flops_per_round: Optional[float] = None,
          writer=None):
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

    ``telemetry`` (a ``RunTelemetry``) gets the run's events (the module
    docstring), ``model_flops_per_round`` is the MFU's numerator and
    ``writer`` a TensorBoard writer for the epoch scalars. Returns
    ``(state, summary, log)``: ``summary`` is the last epoch row, or None
    after a divergence abort, a quarantine or alert abort, or a drain."""
    cfg, device = runtime.cfg, runtime.device
    timer = timer or Timer()
    spe = max(epoch_sampler(cfg, train_ds, 0).epoch_rounds(), 1)
    log, summary = RunLog(), None
    resume = ckpt_mgr.resume if ckpt_mgr is not None else {}
    start_round = int(resume.get("round_in_epoch", 0))
    n_clients = len(train_ds.data_per_client)
    obs = Observers(runtime, telemetry, n_clients, model_flops_per_round,
                    resume.get("ledgers"))
    log.ledger, log.monitor, log.recorder = (obs.ledger, obs.monitor,
                                             obs.recorder)
    tel = telemetry
    if tel is not None:
        for fb in resume.get("fallbacks") or ():
            tel.fault_event(rnd=-1, kind="corrupt_checkpoint",
                            detail=fb.get("error"),
                            checkpoint=fb.get("path"))
    svc = (Services(runtime, n_clients, resume.get("ledgers"), obs)
           if services else None)
    log.services = svc
    fetch = make_fetch(runtime, train_ds, train_store)
    # --decode_overlap: each round as its client and decode halves; the
    # loop waits for the client half alone
    overlap = None
    if cfg.decode_overlap:
        overlap = DecodeOverlapRound(runtime)
        print("decode overlap: round split into cohort + decode halves "
              "(the server decode can run under round t+1's staging)")
    if svc is not None:
        fetch = svc.retrying(fetch)
    plan = runtime.adversary_plan if svc is not None else None
    defense_on = (cfg.defense != "none" or cfg.adversary != "none"
                  or cfg.nonfinite_action == "quarantine")
    every = cfg.telemetry_round_every
    # which rounds compute the record's device metrics: on a mesh every
    # rank computes them (their gathers are collectives), rank 0 alone
    # writes them
    mesh = getattr(runtime, "mesh", None)
    watch = cfg.telemetry if mesh is not None else tel is not None
    # a drain every rank has agreed on (a mesh; one process reads its own
    # guard)
    agreed_drain = False

    def agree(abort: bool) -> bool:
        """On a mesh: whether any rank asks to abort (rank 0's monitor)
        or to drain (a guard), one ``Mesh.any`` for both; the drain is
        kept for the next boundary. Returns the abort."""
        nonlocal agreed_drain
        if mesh is None:
            return abort
        want = torch.tensor([abort, svc is not None and svc.guard.requested])
        got = mesh.any(want.to(mesh.device)).tolist()
        agreed_drain = agreed_drain or got[1]
        return got[0]

    def drain_requested() -> bool:
        if svc is None:
            return False
        return agreed_drain if mesh is not None else svc.guard.requested
    if eval_before_start:
        _, test_acc, _ = validate(runtime, state, val_ds,
                                  cfg.valid_batch_size, val_max_batches,
                                  val_store)
        print(f"Test acc at epoch 0: {test_acc:0.4f}")

    def lr_at(g: int):
        lr = schedule(g / spe)
        return lr, (lr if lr_mult is None else lr * lr_mult)

    def flush(state):
        if svc is None:
            return state
        lr, lr_arr = lr_at(global_round)
        state, commits = svc.flush(state, lr_arr)
        obs.commits(commits, lr, with_device=True)
        return state

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
            state = flush(state)
            ck = existing
            if ck is None and ckpt_mgr is not None:
                ck = ckpt_mgr.save(
                    state, epoch,
                    meta={"global_round": int(global_round),
                          "ledgers": obs.sidecar(svc.qledger)},
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
            if tel is not None:
                tel.fault_event(rnd=global_round, kind="preempt",
                                signal=guard.signal_name, grace_s=grace,
                                checkpoint=ck)
            obs.footer(log, True, rounds_run)
        finally:
            force.cancel()
        log.preempted = True
        return state

    n_epochs = math.ceil(cfg.num_epochs)
    pipe = None
    rounds_run = 0
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
                if drain_requested():
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
                obs.prof.maybe_start(g)
                # the first round's peak above its resident bytes: the
                # measured round_step ledger
                measure = (measure_round(device, tel.residency)
                           if tel is not None and rounds_run == 0 else None)
                if measure is not None:
                    measure.__enter__()
                # the first round's collectives, on a mesh
                ledger = (recording() if mesh is not None
                          and rounds_run == 0 and cfg.telemetry else None)
                entries = ledger.__enter__() if ledger is not None else None
                t0 = time.perf_counter()
                commits = ()
                if svc is not None and svc.async_agg is not None:
                    state, metrics, commits = svc.async_agg.step(
                        state, rnd, g, item.batch, lr_arr)
                    svc.commits.extend(commits)
                else:
                    # the telemetry's device metrics only where a record
                    # reads them
                    state, metrics = (overlap or runtime).round(
                        state, rnd.client_ids, item.batch, rnd.mask, lr_arr,
                        observe=bool(watch and every and g % every == 0))
                t_dispatch = time.perf_counter()
                if ledger is not None:
                    ledger.__exit__(None, None, None)
                    if tel is not None:
                        tel.collectives_event("round_step", entries)
                maybe_fault("mid_round", g)
                with tracing.span("device_wait"):
                    if overlap is not None:
                        overlap.wait_cohort()
                    else:
                        _sync(device)
                t_device = time.perf_counter()
                round_s = t_device - t0
                obs.prof.maybe_stop(g, obs.sync)
                if watchdog is not None:
                    watchdog.disarm()
                global_round = g
                record = bool(tel is not None and every and g % every == 0
                              and metrics is not None)
                if obs.util is not None and metrics is not None:
                    obs.util.observe_round(host_s=item.wait_s,
                                           dispatch_s=t_dispatch - t0,
                                           device_s=t_device - t_dispatch)
                if obs.ledger is not None and metrics is not None:
                    if svc is not None and svc.async_agg is not None:
                        obs_ids, obs_n = metrics["participation"]
                    else:
                        obs_ids = rnd.client_ids
                        obs_n = np.asarray(rnd.mask).sum(axis=1)
                    obs.ledger.observe(g, obs_ids, obs_n)
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
                             "ledgers": obs.sidecar(svc.qledger)})
                        print(f"postmortem: {path}", flush=True)
                    if tel is not None:
                        tel.alert_event(rnd=g, rule="quarantine_exhausted",
                                        severity="critical",
                                        metric="defense.ejected",
                                        value=float(len(svc.qledger.ejected)),
                                        action=cfg.alert_action)
                        tel.memory_event("quarantine_exhausted")
                        if obs.recorder is not None:
                            obs.recorder.record(state, {
                                "rule": "quarantine_exhausted",
                                "round": int(g),
                                "ejected": len(svc.qledger.ejected)})
                    obs.footer(log, True, rounds_run + 1)
                    return state, None, log
                if record:
                    with tracing.span("telemetry_emit"):
                        _emit_record(tel, obs, cfg, runtime, metrics, rnd,
                                     g, epoch, lr, item.wait_s,
                                     t_dispatch - t0, t_device - t_dispatch,
                                     svc, plan, defense_on)
                    tel.span_event(obs.tracer)
                if commits:
                    obs.commits(commits, lr, with_device=record)
                if agree(bool((record or commits)
                              and obs.act_on_alerts(state))):
                    obs.footer(log, True, rounds_run + 1)
                    return state, None, log
                if metrics is None:
                    # a scenario-dropped cohort: nothing trained
                    continue
                rounds_run += 1
                if measure is not None:
                    tel.memory_ledger_event("round_step", measure.ledger(),
                                            source="measured")
                if tel is not None and rounds_run == 1:
                    tel.memory_event("round_1")
                log.data_s.append(item.wait_s)
                log.fetch_s.append(item.fetch_s)
                log.round_s.append(round_s)
                rows.append(_round_row(cfg, metrics))
                lrs.append(lr)
            pipe.close()
            state = flush(state)
            if not consumed:
                break
            if obs.util is not None:
                # the round window ends here: validation stays out of it
                obs.util.emit(global_round)
            if tel is not None:
                tel.memory_event(f"rounds_{epoch + 1}")
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
                if tel is not None:
                    tel.alert_event(
                        rnd=nan_round if nan_round >= 0 else global_round,
                        rule="nonfinite_abort", severity="critical",
                        metric="loss", action=cfg.alert_action)
                    tel.memory_event("nan_abort")
                    if obs.recorder is not None:
                        obs.recorder.record(state, {
                            "rule": "nonfinite_abort", "reason": which,
                            "round": int(nan_round)})
                    tel.nan_abort(nan_round=nan_round, reason=which,
                                  cfg=cfg)
                obs.footer(log, True, rounds_run)
                return state, None, log
            total = max(sums[2], 1.0)
            download_mib = sums[3] / 2**20
            upload_mib = sums[4] / 2**20
            log.total_download_mib += download_mib
            log.total_upload_mib += upload_mib
            with tracing.span("validation"):
                test_loss, test_acc, batches = validate(
                    runtime, state, val_ds, cfg.valid_batch_size,
                    val_max_batches, val_store)
            log.val_batches += batches
            test_time = timer()
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
            abort = False
            if tel is not None:
                tel.epoch_event(summary, test_time=test_time)
                tel.memory_event(f"epoch_{epoch + 1}")
                tel.span_event(obs.tracer)
                abort = obs.act_on_alerts(state)
            if agree(abort):
                obs.footer(log, True, rounds_run)
                return state, None, log
            if writer is not None:
                # the reference's scalars
                for tag, val in (("Loss/train", summary["train_loss"]),
                                 ("Loss/test", test_loss),
                                 ("Acc/train", summary["train_acc"]),
                                 ("Acc/test", test_acc),
                                 ("Time/train", train_time),
                                 ("Time/test", test_time),
                                 ("Time/total", timer.total_time),
                                 ("Lr", summary["lr"])):
                    writer.add_scalar(tag, val, epoch)
            ck = None
            if (ckpt_mgr is not None and checkpoint_every and not cut
                    and (epoch + 1) % checkpoint_every == 0):
                ck = ckpt_mgr.save(
                    state, epoch + 1,
                    meta={"summary": summary,
                          "global_round": int(global_round),
                          "ledgers": obs.sidecar(
                              svc.qledger if svc is not None else None)})
                if tel is not None:
                    tel.memory_event(f"checkpoint_{epoch + 1}")
            if drain_requested():
                state = drain(state, epoch + 1, 0, None, existing=ck)
                return state, None, log
    except BaseException:
        # a crash inside the profiler window still closes the trace
        obs.prof.abort()
        raise
    finally:
        if pipe is not None:
            pipe.close()
        if svc is not None:
            svc.stop()
        obs.close()
    print(f"Total Download (MiB): {log.total_download_mib:0.2f}")
    print(f"Total Upload (MiB): {log.total_upload_mib:0.2f}")
    print(f"Avg Download Per Client: "
          f"{log.total_download_mib / n_clients:0.2f}")
    print(f"Avg Upload Per Client: {log.total_upload_mib / n_clients:0.2f}",
          flush=True)
    obs.footer(log, False, rounds_run)
    return state, summary, log


def _emit_record(tel, obs: Observers, cfg, runtime, metrics, rnd, g: int,
                 epoch: int, lr: float, host_s: float, dispatch_s: float,
                 device_s: float, svc, plan, defense_on: bool) -> None:
    """One record round's events: the metrics tree crosses to the host in
    one copy, then ``round``, ``signals``, ``layer_signals``,
    ``client_stats``, ``population``, ``defense`` and ``utilization``."""
    keys = ("results", "n_valid", "download_bytes", "upload_bytes",
            "signals", "layer_signals", "client_stats", "defense")
    m = tree_to_host({k: metrics.get(k) for k in keys})
    res = [np.asarray(r, np.float64) for r in m["results"]]
    nv = np.asarray(m["n_valid"], np.float64)
    tot = max(float(nv.sum()), 1.0)
    down_total = up_total = down_clients = up_clients = None
    ids = np.asarray(rnd.client_ids)
    if cfg.track_bytes:
        down_all, up_all = m["download_bytes"], m["upload_bytes"]
        down_total, up_total = float(down_all.sum()), float(up_all.sum())
        down_clients = [float(x) for x in down_all[ids]]
        up_clients = [float(x) for x in up_all[ids]]
    tel.round_event(rnd=g, epoch=epoch + 1, lr=float(lr),
                    loss=float((res[0] * nv).sum() / tot),
                    acc=float((res[1] * nv).sum() / tot),
                    n_valid=float(nv.sum()), download_bytes=down_total,
                    upload_bytes=up_total, host_s=host_s,
                    dispatch_s=dispatch_s, device_s=device_s)
    if m["signals"]:
        tel.signals_event(rnd=g, mode=cfg.mode,
                          signals=signals_to_host(m["signals"]),
                          download_bytes=down_total, upload_bytes=up_total,
                          client_download_bytes=down_clients,
                          client_upload_bytes=up_clients)
    if m["layer_signals"]:
        tel.layer_signals_event(rnd=g, mode=cfg.mode,
                                signal_groups=cfg.signal_groups,
                                groups=runtime.group_spec.names,
                                sizes=runtime.group_spec.sizes,
                                values=layer_signals_to_host(
                                    m["layer_signals"]))
    is_async = svc is not None and svc.async_agg is not None
    ledger = obs.ledger
    if m["client_stats"] is not None and ledger is not None:
        n_part = (int((np.asarray(metrics["participation"][1]) > 0).sum())
                  if is_async else len(ids))
        quantiles = client_stats_to_host(m["client_stats"], ids)
        ledger.observe_loss_argmax(
            (quantiles.get("loss") or {}).get("argmax_client"))
        tel.client_stats_event(rnd=g, n_participants=n_part,
                               quantiles=quantiles,
                               participation=ledger.snapshot(g))
    if ledger is not None:
        tel.population_event(snapshot=ledger.population_snapshot(g))
    if defense_on:
        inj = None
        if plan is not None:
            # a slot injects only when it carries data
            if is_async:
                ids_a, n_a = metrics["participation"]
                slots = metrics.get("adversary_slots")
                if slots is None:
                    slots = plan.slot_mask(np.asarray(ids_a))
                live = np.asarray(n_a) > 0
            else:
                slots = plan.slot_mask(ids)
                live = np.asarray(rnd.mask).any(axis=1)
            inj = {cfg.adversary: int((np.asarray(slots) & live).sum())}
        qledger = svc.qledger if svc is not None else None
        tel.defense_event(rnd=g, defense=cfg.defense,
                          adversary=cfg.adversary,
                          nonfinite_action=cfg.nonfinite_action,
                          device=(signals_to_host(m["defense"])
                                  if m["defense"] else {}),
                          quarantine=(qledger.snapshot(g)
                                      if qledger is not None else None),
                          injected=inj)
    obs.util.emit(g)


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
