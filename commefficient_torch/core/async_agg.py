"""Asynchronous buffered aggregation (FedBuff; Nguyen et al. 2022,
"Federated Learning with Buffered Asynchronous Aggregation"), a port of
the JAX package's ``core/async_agg.py``.

:class:`AsyncAggregator` is the host-side controller over the split
round of ``core/runtime.py``:

- ``dispatch`` (every driver tick): one cohort (a sampler round of
  ``num_workers`` clients) is computed against the current weights by
  ``FedRuntime.cohort``, the client half of the synchronous round. The
  payload (the unnormalized transmitted-space sum and its datum count)
  stays on the device; up to ``max_inflight`` (K) payloads are held.
- ``land`` (in the simulated arrival order of data/scenarios.py): the
  cohort's sum merges into ``FedState.async_buffer`` at the weight
  ``staleness_weight(discount, s, alpha)``, s the commits between its
  dispatch and its merge. A scalar times a linear sketch is the sketch
  of the scaled gradient, so the discount commutes with the decode.
- ``commit`` (every ``buffer_goal`` (M) merged cohorts, or at the
  epoch's flush): ``FedRuntime.commit`` divides the buffer by its raw
  datum count, runs the mode's unchanged server step and empties the
  buffer. ``FedState.step`` counts commits (the server version).

With K = 1, M = 1 and no scenario latency every cohort lands and
commits in its own tick at staleness 0 (weight exactly 1.0), the first
merge swaps the cohort's sum into the empty buffer with no arithmetic,
and cohort, merge_first, commit is bitwise the synchronous round (the
int8 wire's draws key off ``state.step``, which the two share). The
port's DP noise is keyed by (seed, round, slot) in both, so this holds
with DP too; the JAX package's does not (its split advances its PRNG
key differently).

Buffered merging is sound only when the server reads the uploads through
their weighted sum: per-client momentum or error rows and the top-k
download's weight rows are refused (:func:`validate_async_combo`).
"""

from __future__ import annotations

import bisect
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from commefficient_torch.config import DISCOUNT_RULES, FedConfig
from commefficient_torch.faults import maybe_fault


def staleness_weight(rule: str, staleness: float, alpha: float = 0.5
                     ) -> float:
    """Merge weight of a cohort ``staleness`` commits old.

    - ``none``: 1 (plain FedBuff averaging);
    - ``poly``: (1+s)^-alpha — alpha 0.5 is FedBuff's 1/sqrt(1+s);
    - ``exp``: exp(-alpha*s).

    Every rule returns EXACTLY 1.0 at s=0 (the sync-equivalence
    contract) and decreases monotonically in s.
    """
    s = float(staleness)
    if s < 0:
        raise ValueError(f"staleness must be >= 0, got {s}")
    if rule == "none":
        return 1.0
    if rule == "poly":
        return float((1.0 + s) ** (-float(alpha)))
    if rule == "exp":
        return float(math.exp(-float(alpha) * s))
    raise ValueError(f"unknown staleness discount {rule!r}; "
                     f"choices: {DISCOUNT_RULES}")


def _split_round_problems(cfg: FedConfig) -> List[str]:
    """Why a configuration cannot run its round as separate client/server
    executables (the cohort step carries no per-client persistent-row or
    topk_down plumbing — shared by --async_agg and --decode_overlap)."""
    problems: List[str] = []
    if cfg.needs_client_velocities:
        problems.append(
            "local_momentum > 0 keeps per-client velocity rows that the "
            "synchronous round masks with the SAME round's server support "
            "(momentum factor masking) — the split client block finishes "
            "before that support exists, so the masking semantics cannot "
            "be reproduced. Use local_momentum 0 (rely on "
            "--virtual_momentum, which lives in server state and splits "
            "soundly)")
    if cfg.needs_client_errors:
        problems.append(
            "error_type=local keeps per-client error rows written at "
            "dispatch; the split round's client block has no row "
            "plumbing (and under buffering the rows would accumulate "
            "against interleaved server versions the synchronous rule "
            "never sees). Use error_type none (local_topk) or virtual "
            "(sketch/true_topk — virtual EF lives in server state and "
            "splits soundly)")
    if cfg.do_topk_down:
        problems.append(
            "--topk_down keeps per-client stale weight vectors updated "
            "at dispatch from the current server weights — the split "
            "client block has no weight-row plumbing (and under "
            "buffering a client's record diverges from what it actually "
            "downloaded). Drop --topk_down")
    return problems


def validate_async_combo(cfg: FedConfig) -> None:
    """Reject mode combinations where buffered merge is unsound.

    The buffer consumes cohort uploads only through their weighted sum;
    any per-client persistent state written at dispatch from commit-time
    information cannot be reproduced out of order. Mirrors the fail-fast
    contract of core/server.validate_mode_combo."""
    if not cfg.async_agg:
        return
    problems = _split_round_problems(cfg)
    if problems:
        raise ValueError(
            "--async_agg: buffered merge is unsound for this "
            "configuration:\n  " + "\n  ".join(problems))


def validate_overlap_combo(cfg: FedConfig) -> None:
    """--decode_overlap's fail-fast twin of :func:`validate_async_combo`:
    the split round shares the cohort step, so the same per-client
    persistent-state combinations are out (``FedConfig`` already rejects
    --decode_overlap together with --async_agg)."""
    if not cfg.decode_overlap:
        return
    problems = _split_round_problems(cfg)
    if problems:
        raise ValueError(
            "--decode_overlap: splitting the round into client and "
            "server-decode executables is unsound for this "
            "configuration:\n  " + "\n  ".join(problems))


def reconcile_resumed_state(state, runtime) -> Tuple[Any, List[str]]:
    """A restored FedState made consistent with this runtime's async
    configuration. Returns (state, messages to print).

    - an async run resuming a checkpoint without buffer fields (or one
      of another shape): the buffer starts empty; nothing double-counts;
    - an async run resuming a non-empty buffer (a mid-epoch postmortem):
      the buffer is restarted, loudly. The epoch replays from the
      checkpoint's round, so keeping it would double-count its cohorts;
    - a synchronous run resuming an async checkpoint: the buffer fields
      are dropped (with a warning when non-empty).
    """
    import torch

    msgs: List[str] = []
    if runtime.cfg.async_agg:
        shape = runtime.state_shapes()["async_buffer"]
        dev = runtime.device
        if state.async_buffer is None \
                or tuple(state.async_buffer.shape) != tuple(shape):
            state = state.replace(
                async_buffer=torch.zeros(shape, device=dev),
                async_buffer_n=torch.zeros((), device=dev))
            msgs.append(
                "async buffer initialized EMPTY: the checkpoint predates "
                "async buffered aggregation (no buffer state to restore; "
                "nothing double-counts)")
        else:
            n = float(state.async_buffer_n)
            if n > 0:
                state = state.replace(
                    async_buffer=torch.zeros_like(state.async_buffer),
                    async_buffer_n=torch.zeros_like(state.async_buffer_n))
                msgs.append(
                    f"resume mid-buffer: RESTARTING the partial async "
                    f"buffer ({n:.0f} buffered datums discarded). The "
                    "epoch replays from its checkpoint, so keeping the "
                    "buffer would double-count its cohorts")
    elif state.async_buffer is not None:
        n = (float(state.async_buffer_n)
             if state.async_buffer_n is not None else 0.0)
        if n > 0:
            msgs.append(
                f"discarding a non-empty async buffer ({n:.0f} datums) "
                "from an async-mode checkpoint resumed synchronously")
        state = state.replace(async_buffer=None, async_buffer_n=None)
    return state, msgs


class _InFlight:
    """One dispatched-but-unlanded cohort: device payload + bookkeeping."""

    __slots__ = ("cohort", "version", "arrival", "sum", "n_total",
                 "results", "n_valid")

    def __init__(self, cohort, version, arrival, payload):
        self.cohort = int(cohort)
        self.version = int(version)       # server commits at dispatch
        self.arrival = float(arrival)     # simulated arrival tick
        self.sum = payload["sum"]         # device array, dropped at merge
        self.n_total = payload["n_total"]
        self.results = payload["results"]
        self.n_valid = payload["n_valid"]

    def __lt__(self, other):              # bisect.insort ordering
        return (self.arrival, self.cohort) < (other.arrival, other.cohort)


def commit_loss(rec: Dict[str, Any]) -> Optional[float]:
    """Datum-weighted mean dispatch loss of a commit's merged cohorts.
    Copies the cohorts' results to the host: one read a commit."""
    num = den = 0.0
    for res0, n_valid in rec.get("loss_refs", ()):
        r = np.asarray(res0.cpu(), np.float64)
        n = np.asarray(n_valid.cpu(), np.float64)
        num += float((r * n).sum())
        den += float(n.sum())
    if den <= 0:
        return None
    v = num / den
    return v if math.isfinite(v) else None


class AsyncAggregator:
    """Bounded in-flight pool + staleness-weighted buffer over a
    FedRuntime built with ``cfg.async_agg``.

    Driver contract (core/driver.train): one :meth:`step` per sampler
    round; at the epoch boundary one :meth:`flush` (land everything,
    commit any partial buffer) so epochs, and therefore checkpoints,
    never straddle an open buffer. ``step``/``flush`` return the list of
    commit records produced, each carrying the merged cohorts' measured
    staleness and discounts and the commit's device scalars.
    """

    def __init__(self, runtime, scenario=None, *,
                 max_inflight: Optional[int] = None,
                 buffer_goal: Optional[int] = None,
                 discount: Optional[str] = None,
                 alpha: Optional[float] = None):
        cfg = runtime.cfg
        if not cfg.async_agg:
            raise ValueError("AsyncAggregator needs a runtime built with "
                             "cfg.async_agg=True")
        validate_async_combo(cfg)
        sc_plan = getattr(scenario, "adversary", None)
        rt_plan = getattr(runtime, "adversary_plan", None)
        if sc_plan is not None and rt_plan is not None:
            # the scenario's per-cohort adversary annotation
            # (CohortFate.adversary) and the universe mask the round
            # applies are two AdversaryPlan instances that must describe
            # the SAME assignment: a seed/frac mismatch would make the
            # host's view silently diverge from the injected reality
            a = (sc_plan.kind, sc_plan.frac, sc_plan.seed, sc_plan.scale)
            b = (rt_plan.kind, rt_plan.frac, rt_plan.seed, rt_plan.scale)
            if a != b:
                raise ValueError(
                    f"scenario adversary plan {a} disagrees with the "
                    f"runtime's {b}: build both from the same FedConfig "
                    "(make_scenario/make_adversary with matching seeds)")
        self.runtime = runtime
        self.scenario = scenario
        self.max_inflight = int(max_inflight if max_inflight is not None
                                else cfg.max_inflight)
        self.buffer_goal = int(buffer_goal if buffer_goal is not None
                               else cfg.buffer_goal)
        self.discount = (discount if discount is not None
                         else cfg.staleness_discount)
        self.alpha = float(alpha if alpha is not None
                           else cfg.staleness_alpha)
        assert self.max_inflight >= 1 and self.buffer_goal >= 1
        self._inflight: List[_InFlight] = []      # sorted by (arrival, id)
        self._pending: List[Dict[str, Any]] = []  # merged, uncommitted
        self.commits = 0          # host mirror of the server version delta
        self.dispatched = 0
        self.dropped = 0
        self.merged = 0
        self.staleness_max_seen = 0
        self._staleness_sum = 0.0

    # ------------------------------------------------------------- observers

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def staleness_mean_seen(self) -> float:
        return self._staleness_sum / max(self.merged, 1)

    # ----------------------------------------------------------------- steps

    def step(self, state, rnd, global_round: int, batch, lr
             ) -> Tuple[Any, Optional[Dict[str, Any]],
                        List[Dict[str, Any]]]:
        """One driver tick: land overdue cohorts, free a pool slot if
        full, apply the scenario fate, dispatch this tick's cohort, and
        land zero-latency arrivals. Returns ``(state, cohort_metrics,
        commit_records)``; ``cohort_metrics`` is None for a dropped
        cohort (no compute happened)."""
        commits: List[Dict[str, Any]] = []
        tick = int(global_round)
        state = self._land_due(state, tick, lr, commits)
        mask_np = np.asarray(rnd.mask)
        fate = (self.scenario.fate(tick, mask_np,
                                   client_ids=rnd.client_ids)
                if self.scenario is not None else None)
        if fate is not None and fate.dropped:
            # decided BEFORE the pool-full wait: a dropped cohort never
            # needs a slot, so it must not force an in-flight cohort to
            # land early (that would skew the measured staleness)
            self.dropped += 1
            return state, None, commits
        while len(self._inflight) >= self.max_inflight:
            # the pool is full: the simulated dispatch waits for the
            # earliest in-flight cohort, exactly like a real bounded
            # upload queue
            state = self._land_earliest(state, lr, commits)
        eff_mask = fate.mask if fate is not None else mask_np
        state, payload = self.runtime.cohort(
            state, rnd.client_ids, batch, eff_mask, lr)
        # crash-matrix kill-point: the pool holds in-flight cohorts and
        # this tick's dispatch just happened — a death here must resume
        # bit-identically (the epoch replays; the buffer was never
        # checkpointed open, see reconcile_resumed_state)
        maybe_fault("async_pool", tick)
        self.dispatched += 1
        latency = float(fate.latency) if fate is not None else 0.0
        bisect.insort(self._inflight,
                      _InFlight(tick, self.commits, tick + latency,
                                payload))
        state = self._land_due(state, tick, lr, commits)
        metrics = {
            "results": payload["results"],
            "n_valid": payload["n_valid"],
            "download_bytes": payload["download_bytes"],
            "upload_bytes": payload["upload_bytes"],
            # the cohort's per-client quantiles (telemetry/clients.py)
            "client_stats": payload["client_stats"],
            # robustness channel (FedRuntime.cohort): the defense scalars
            # and the quarantine ledger's per-client finite flags ride
            # the cohort payload, as they ride the synchronous round's
            "defense": payload["defense"],
            "client_finite": payload["client_finite"],
            # host-resident effective participation for the ledger (the
            # scenario may have masked slots out of this cohort)
            "participation": (np.asarray(rnd.client_ids),
                              eff_mask.sum(axis=1)),
            # the scenario's per-slot adversary annotation
            # (CohortFate.adversary): the driver's defense event counts
            # injections from the SAME draw the dispatch saw instead of
            # re-deriving it against the ledger's view of the round
            "adversary_slots": (fate.adversary if fate is not None
                                else None),
        }
        return state, metrics, commits

    def flush(self, state, lr) -> Tuple[Any, List[Dict[str, Any]]]:
        """Epoch-boundary drain: land every in-flight cohort (in arrival
        order) and commit whatever the buffer holds — a partial commit
        below ``buffer_goal`` is flagged ``partial`` in its record, so
        no open buffer ever crosses an epoch (or reaches a checkpoint)."""
        commits: List[Dict[str, Any]] = []
        while self._inflight:
            state = self._land_earliest(state, lr, commits)
        if self._pending:
            state, rec = self._commit(state, lr, partial=True)
            commits.append(rec)
        return state, commits

    # -------------------------------------------------------------- internals

    def _land_due(self, state, tick: int, lr, commits) -> Any:
        while self._inflight and self._inflight[0].arrival <= tick:
            state = self._land_earliest(state, lr, commits)
        return state

    def _land_earliest(self, state, lr, commits) -> Any:
        item = self._inflight.pop(0)
        staleness = self.commits - item.version
        weight = staleness_weight(self.discount, staleness, self.alpha)
        if not self._pending and weight == 1.0:
            # empty buffer, weight 1: swap the cohort sum in directly —
            # no arithmetic, the bitwise sync-equivalence path
            state = self.runtime.merge_first(state, item.sum, item.n_total)
        else:
            state = self.runtime.merge(state, item.sum, item.n_total,
                                       weight)
        # the buffer owns these device arrays now: drop the pool's refs
        # so a merged sum's memory goes with the buffer's
        item.sum = item.n_total = None
        self.merged += 1
        self._staleness_sum += staleness
        self.staleness_max_seen = max(self.staleness_max_seen, staleness)
        self._pending.append({
            "cohort": item.cohort,
            "staleness": int(staleness),
            "weight": float(weight),
            "loss_ref": (item.results[0], item.n_valid),
        })
        if len(self._pending) >= self.buffer_goal:
            state, rec = self._commit(state, lr, partial=False)
            commits.append(rec)
        return state

    def _commit(self, state, lr, partial: bool
                ) -> Tuple[Any, Dict[str, Any]]:
        state, m = self.runtime.commit(state, lr)
        self.commits += 1
        pend, self._pending = self._pending, []
        st = [p["staleness"] for p in pend]
        ws = [p["weight"] for p in pend]
        rec = {
            "round": self.commits,
            "n_cohorts": len(pend),
            "cohorts": [p["cohort"] for p in pend],
            "staleness_mean": float(np.mean(st)),
            "staleness_max": int(max(st)),
            "discount_mean": float(np.mean(ws)),
            "discount_min": float(min(ws)),
            "partial": bool(partial),
            "buffer_n": m["buffer_n"],        # device scalar refs: sync
            "update_norm": m["update_norm"],  # only at the record cadence
            "error_norm": m["error_norm"],
            "velocity_norm": m["velocity_norm"],
            "loss_refs": [p["loss_ref"] for p in pend],
        }
        return state, rec
