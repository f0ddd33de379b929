"""Online anomaly detection over the telemetry streams, and the flight
recorder that snapshots state before a run dies.

PRs 1-3 RECORD everything — round losses, compression-signal norms, MFU,
and now per-client population quantiles — but nothing WATCHES the
recordings: round 5's measured-divergent regimes (the subtract-EF arms,
the local_topk leak) drifted for dozens of rounds with their error norms
growing in plain sight, and the device-side ``nan_round`` flag only
fires *after* the state is poisoned. :class:`AnomalyMonitor` closes the
loop: it keeps a rolling median/MAD history of a small set of watched
stream fields and raises a schema-v3 ``alert`` event when a robust
z-score leaves the envelope — loss spikes, EF-accumulator blowups,
heavy-hitter recovery collapse, MFU cliffs, client-population loss
spread — plus nonfinite-precursor rules (a watched metric that WAS
numeric turning null is the last observable event before the abort).

Median/MAD (not mean/std) on purpose: the history will CONTAIN the
anomalies it is trying to flag, and a single spike must not drag the
envelope after it. The MAD is floored at 2% of |median| so quantized
metrics (rounded MFU) cannot fire on noise.

``--alert_action`` escalates what a fired rule does:

- ``log``        — the alert event only (always written);
- ``warn``       — + one stderr line;
- ``checkpoint`` — + the :class:`FlightRecorder` writes a ONE-SHOT
  postmortem bundle on the first firing: the live ``FedState`` through
  the existing checkpoint layer, the last-N telemetry events, and the
  alert context — so the round that *precedes* a NaN is preserved for
  replay instead of dying with the process;
- ``abort``      — + the driver stops training (summary records
  ``aborted=True``), mirroring the NaN abort.

Feeding is wired through ``RunTelemetry.set_monitor``: every monitored
event the stream writes is forwarded here after serialization, so the
monitor sees exactly what a postmortem reader will see (NaN already
null). Dependency-free (no jax/numpy in the detection path) — the same
rules run identically under ``teleview alerts --replay`` on a machine
without jax.

The PyTorch port's copy of the JAX package's ``telemetry/health.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import math
import os
import sys
from collections import deque
from typing import Any, Dict, List, Optional

SEVERITIES = ("info", "warn", "critical")
# event kinds RunTelemetry forwards to an attached monitor
MONITORED_KINDS = ("round", "signals", "utilization", "client_stats",
                   "async_round", "defense", "memory", "layer_signals",
                   "population")

# coverage_stall: consecutive population events with no distinct-
# participant growth (while rounds advance and the universe is not yet
# covered) before the rule fires — shared with `teleview diff
# --coverage_stall`
COVERAGE_STALL_WINDOW = 5

# The rule table: each rule watches ONE field of ONE event kind.
# kind="z" fires on a robust z-score breach of the rolling history
# (direction high/low); kind="nonfinite" fires when a field that has
# numeric history arrives null (the nonfinite-precursor counter —
# fields that are null because they are N/A for the mode never fire,
# since they never build numeric history).
RULES = (
    dict(name="loss_spike", event="round", field="loss",
         kind="z", direction="high", severity="warn"),
    dict(name="loss_nonfinite", event="round", field="loss",
         kind="nonfinite", severity="critical"),
    dict(name="grad_norm_spike", event="signals", field="grad_norm",
         kind="z", direction="high", severity="warn"),
    dict(name="error_norm_blowup", event="signals", field="error_norm",
         kind="z", direction="high", severity="critical"),
    dict(name="velocity_norm_blowup", event="signals",
         field="velocity_norm", kind="z", direction="high",
         severity="critical"),
    dict(name="update_nonfinite", event="signals", field="update_norm",
         kind="nonfinite", severity="critical"),
    dict(name="topk_overlap_collapse", event="signals",
         field="topk_overlap", kind="z", direction="low", severity="warn"),
    dict(name="mfu_cliff", event="utilization", field="mfu",
         kind="z", direction="low", severity="warn"),
    dict(name="input_starvation", event="utilization",
         field="input_wait_frac", kind="z", direction="high",
         severity="info"),
    dict(name="client_loss_spread", event="client_stats",
         field="loss_spread", kind="z", direction="high", severity="warn"),
    # async buffered aggregation (core/async_agg.py, schema v4): the
    # staleness-induced EF-divergence precursor — stale discounted
    # cohorts leaking into the virtual error accumulator show up as
    # error_norm growth at COMMIT granularity rounds before the loss
    # goes non-finite (the same failure shape as the sync EF blowups,
    # observed on the async_round stream instead of signals)
    dict(name="async_ef_blowup", event="async_round", field="error_norm",
         kind="z", direction="high", severity="critical"),
    dict(name="async_loss_spike", event="async_round", field="loss",
         kind="z", direction="high", severity="warn"),
    dict(name="staleness_spike", event="async_round",
         field="staleness_max", kind="z", direction="high",
         severity="info", mad_floor_abs=0.5),
    # robustness subsystem (schema v5, core/runtime.py defense events +
    # the client_stats tx_norm quantiles): a client whose transmitted
    # update norm leaves the population envelope is the boosted/scale-
    # attack signature BEFORE any defense decision; quarantine count
    # growth is the broken-fleet signature. The count-like quarantined
    # metric sits at a constant zero on healthy runs, so it carries the
    # absolute MAD floor (see robust_z): a single benched client above
    # an all-zero history is the system WORKING, not an anomaly — a
    # multi-client jump still fires. tx_norm_max is scale-dependent
    # (model/lr set its magnitude), so no fixed absolute floor fits;
    # its healthy history has a nonzero median and the 2%-of-median
    # relative floor does the quieting instead.
    dict(name="update_norm_outlier", event="client_stats",
         field="tx_norm_max", kind="z", direction="high",
         severity="warn"),
    dict(name="quarantine_growth", event="defense", field="quarantined",
         kind="z", direction="high", severity="warn",
         mad_floor_abs=0.5),
    # HBM pressure (schema v6 memory events, telemetry/memory_ledger
    # .py): the allocator high-water peak leaving its rolling envelope
    # is the near-OOM precursor — a leak (an accidentally retained
    # state copy, a growing host->device staging buffer) shows up as
    # anomalous peak growth SNAPSHOTS before the allocator dies, which
    # is when a flight-recorder bundle can still be written. A healthy
    # run's peak is a near-constant after warm-up, so the relative MAD
    # floor would be 2% of multi-GB = tens of MB of tolerated jitter
    # already; the absolute floor (16 MiB) only guards tiny-model runs
    # whose whole peak is smaller than allocator rounding.
    dict(name="hbm_pressure", event="memory", field="peak_bytes",
         kind="z", direction="high", severity="warn",
         mad_floor_abs=16 * 2**20),
    # layer-wise compression attribution (schema v10, telemetry/
    # layer_signals.py): the STARVATION signature — a parameter group
    # holding a material share of the round's dense gradient energy
    # while winning (almost) none of the k top-k coordinates, for a
    # window of consecutive observations. This is the FetchSGD-lineage
    # per-layer failure mode at high compression: small-mass layers
    # lose the global top-k race and their signal rots in error
    # feedback. kind="starvation" is evaluated per GROUP (not a scalar
    # z-score) with the thresholds/window shared with teleview layers
    # (layer_signals.STARVATION_*); silent when grad_mass is null
    # (fused-encode / mesh sketch rounds) — starvation is measured
    # against gradient mass, never guessed from the update side.
    dict(name="group_starvation", event="layer_signals", field="topk_count",
         kind="starvation", severity="warn"),
    # population-scale observability (schema v11, telemetry/
    # population.py): coverage_stall — distinct-participant growth
    # flatlining across COVERAGE_STALL_WINDOW consecutive population
    # events while rounds advance and the universe is not yet covered
    # (a stuck sampler shard at 10^6 clients looks exactly like healthy
    # training on every OTHER stream); hh_churn — the most-sampled
    # heavy-hitter set turning over anomalously fast (robust z on the
    # Jaccard turnover between consecutive top_sampled sets — a churn
    # burst is the drifted-sampler / hijacked-cohort signature). The
    # absolute MAD floor keeps single-slot rotation in an otherwise
    # stable set (turnover ~0.1 over a 10-entry list) from firing on a
    # constant-zero history.
    dict(name="coverage_stall", event="population", field="distinct",
         kind="coverage_stall", severity="warn"),
    dict(name="hh_churn", event="population", field="top_sampled",
         kind="hh_churn", severity="warn", mad_floor_abs=0.05),
)


def _extract(rule: Dict[str, Any], fields: Dict[str, Any]) -> Any:
    """Pull the watched value out of one event's fields. Derived metric:
    ``client_stats.loss_spread`` = p95 - p5 of the per-client loss
    quantiles (the population-divergence signal)."""
    if rule["event"] == "client_stats" and rule["field"] == "loss_spread":
        q = (fields.get("quantiles") or {}).get("loss") or {}
        hi, lo = q.get("p95"), q.get("p5")
        if isinstance(hi, (int, float)) and isinstance(lo, (int, float)):
            return float(hi) - float(lo)
        return None
    if rule["event"] == "client_stats" and rule["field"] == "tx_norm_max":
        # the update_norm_outlier feed: the round's largest per-client
        # transmitted-update norm (the boosted-client signature)
        q = (fields.get("quantiles") or {}).get("tx_norm") or {}
        v = q.get("max")
        return float(v) if isinstance(v, (int, float)) else None
    return fields.get(rule["field"])


def robust_z(value: float, history: List[float],
             mad_floor_frac: float = 0.02,
             mad_floor_abs: float = 0.0) -> Dict[str, float]:
    """Median/MAD z-score of ``value`` against ``history`` (the standard
    0.6745 normal-consistency factor, so z compares to sigma units).

    The MAD is floored at ``mad_floor_frac * |median|`` so a constant or
    quantized history cannot make every deviation infinite — but that
    relative floor is itself ZERO when the rolling median is zero (e.g.
    staleness on a no-latency run, quarantine counts on a healthy
    fleet), and the old 1e-12 backstop made the FIRST nonzero tick fire
    with an astronomical z. ``mad_floor_abs`` is the fix: an absolute
    epsilon floor, supplied per rule for metrics whose healthy state is
    a constant zero in natural units of ~1 (a floor of 0.5 keeps a
    single-unit tick below z = 1.35 while a jump of several units still
    breaches the default threshold 6). It defaults to 0 so continuous
    metrics with real scatter (loss, mfu) keep their full sensitivity.
    Regression-tested on a constant-zero-then-tick history in
    tests/test_health.py."""
    xs = sorted(history)
    n = len(xs)
    med = (xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2]))
    dev = sorted(abs(x - med) for x in xs)
    mad = (dev[n // 2] if n % 2 else 0.5 * (dev[n // 2 - 1] + dev[n // 2]))
    mad = max(mad, mad_floor_frac * abs(med), mad_floor_abs, 1e-12)
    return {"zscore": 0.6745 * (value - med) / mad, "median": med,
            "mad": mad}


class AnomalyMonitor:
    """Watches the monitored event kinds and fires rule alerts.

    ``observe(kind, fields)`` is the single entry point (RunTelemetry
    forwards through it); it returns the list of alerts fired by that
    event, after writing each as an ``alert`` telemetry event and
    applying the configured action's side effects (stderr warn, snapshot
    request, abort request). A fired rule goes quiet for ``cooldown``
    observations of its metric — a spike fires once, not once per
    follow-up read while the history catches up.
    """

    def __init__(self, telemetry=None, *, action: str = "log",
                 window: int = 32, z_thresh: float = 6.0,
                 min_points: int = 8, cooldown: Optional[int] = None,
                 rules=RULES):
        assert action in ("log", "warn", "checkpoint", "abort"), action
        self._telemetry = telemetry
        self.action = action
        self.window = int(window)
        self.z_thresh = float(z_thresh)
        # a window smaller than min_points would otherwise gate every
        # statistical rule off forever (the deque can never hold enough
        # history) — tightening --alert_window must tighten, not disarm
        self.min_points = min(int(min_points), self.window)
        self.cooldown = int(cooldown if cooldown is not None else window)
        self.rules = tuple(rules)
        self._hist: Dict[str, deque] = {}
        self._quiet: Dict[str, int] = {}      # rule name -> obs remaining
        # group_starvation streaks: group name -> consecutive
        # observations the starvation predicate held (layer_signals.py
        # starved_groups); a clean observation breaks the streak
        self._starve: Dict[str, int] = {}
        # coverage_stall state: the last population event's distinct/
        # round and the current no-growth streak
        self._cov: Dict[str, Any] = {}
        # hh_churn state: the previous population event's top_sampled
        # id set (None until one has been seen)
        self._prev_hh: Optional[set] = None
        self.alerts: List[Dict[str, Any]] = []
        self.nonfinite_counts: Dict[str, int] = {}
        self.n_observed = 0
        self.abort_requested = False
        self._snapshot_request: Optional[Dict[str, Any]] = None

    @property
    def armed(self) -> bool:
        """The dryrun predicate: the monitor exists, has rules, and is
        attached to a stream it can write alerts into."""
        return bool(self.rules) and self._telemetry is not None

    def pop_snapshot_request(self) -> Optional[Dict[str, Any]]:
        """The first checkpoint/abort-worthy alert's context, once —
        the driver hands it to the FlightRecorder with the live state
        (the monitor never holds device arrays itself)."""
        req, self._snapshot_request = self._snapshot_request, None
        return req

    # ------------------------------------------------------------- observing

    def observe(self, kind: str, fields: Dict[str, Any]
                ) -> List[Dict[str, Any]]:
        if kind not in MONITORED_KINDS:
            return []
        self.n_observed += 1
        rnd = fields.get("round", -1)
        rnd = rnd if isinstance(rnd, int) else -1
        fired: List[Dict[str, Any]] = []
        appended: set = set()
        for rule in self.rules:
            if rule["event"] != kind:
                continue
            name = rule["name"]
            metric = f"{kind}.{rule['field']}"
            value = _extract(rule, fields)
            numeric = (isinstance(value, (int, float))
                       and not isinstance(value, bool)
                       and math.isfinite(value))
            hist = self._hist.setdefault(metric, deque(maxlen=self.window))
            quiet = self._quiet.get(name, 0)
            if quiet > 0:
                self._quiet[name] = quiet - 1
            alert = None
            if rule["kind"] == "starvation":
                # per-GROUP predicate over the layer_signals event (no
                # scalar history): a group above the mass-share floor
                # winning under the k-share floor for
                # STARVATION_WINDOW consecutive observations starves.
                # Dependency-free on purpose (layer_signals's helpers
                # import nothing at module level) — `teleview alerts`
                # replays identically on a machine without jax.
                from commefficient_torch.telemetry.layer_signals import (
                    STARVATION_WINDOW, starved_groups)
                starved = starved_groups(fields.get("groups") or [],
                                         fields.get("grad_mass"),
                                         fields.get("topk_count"))
                now = {g for g, _, _ in starved}
                for g in [g for g in self._starve if g not in now]:
                    del self._starve[g]          # streak broken
                ripe = []
                for g, mass_share, win_share in starved:
                    streak = self._starve.get(g, 0) + 1
                    self._starve[g] = streak
                    if streak >= STARVATION_WINDOW:
                        ripe.append((g, mass_share, win_share))
                if ripe and quiet <= 0:
                    # one alert per firing, naming the hungriest group
                    # (largest starved mass share); the full list rides
                    # as an extra field for postmortems
                    g, mass_share, win_share = max(ripe,
                                                   key=lambda t: t[1])
                    alert = dict(
                        round=rnd, rule=name, severity=rule["severity"],
                        metric=f"layer_signals.starvation[{g}]",
                        value=round(win_share, 6), zscore=None,
                        median=round(mass_share, 6), mad=None,
                        window=STARVATION_WINDOW, action=self.action,
                        starved=[list(r) for r in ripe])
            elif rule["kind"] == "coverage_stall":
                # distinct-participant growth flatlining while rounds
                # advance and coverage has headroom: the sampler has
                # stopped reaching new clients. Streak state persists
                # across restarts (state_dict), like the starvation
                # streaks — a stall straddling a resume keeps counting.
                cov = fields.get("coverage")
                covered = (isinstance(cov, (int, float))
                           and not isinstance(cov, bool)
                           and float(cov) >= 0.999)
                st = self._cov
                if numeric:
                    grew = (st.get("distinct") is None
                            or float(value) > float(st["distinct"]))
                    advanced = rnd > st.get("round", -1)
                    if covered or grew or not advanced:
                        st["streak"] = 0
                    else:
                        st["streak"] = int(st.get("streak", 0)) + 1
                    st["distinct"] = float(value)
                    st["round"] = rnd
                    if (st["streak"] >= COVERAGE_STALL_WINDOW
                            and quiet <= 0):
                        alert = dict(
                            round=rnd, rule=name,
                            severity=rule["severity"],
                            metric="population.coverage_stall",
                            value=(float(cov)
                                   if isinstance(cov, (int, float))
                                   and not isinstance(cov, bool)
                                   else None),
                            zscore=None, median=None, mad=None,
                            window=COVERAGE_STALL_WINDOW,
                            action=self.action)
                        st["streak"] = 0
            elif rule["kind"] == "hh_churn":
                # Jaccard turnover between consecutive top_sampled
                # heavy-hitter sets, z-scored against its own rolling
                # history (the churn value — not the raw list — is the
                # monitored scalar; it builds history under its own
                # metric name, entered AFTER detection like every
                # other history)
                top = fields.get("top_sampled") or []
                ids = {e[0] for e in top
                       if isinstance(e, (list, tuple)) and e}
                if ids:
                    cmetric = "population.hh_turnover"
                    chist = self._hist.setdefault(
                        cmetric, deque(maxlen=self.window))
                    if self._prev_hh:
                        union = len(ids | self._prev_hh)
                        turnover = (1.0 - len(ids & self._prev_hh) / union
                                    if union else 0.0)
                        if len(chist) >= self.min_points and quiet <= 0:
                            stats = robust_z(
                                turnover, list(chist),
                                mad_floor_abs=rule.get("mad_floor_abs",
                                                       0.0))
                            if stats["zscore"] > self.z_thresh:
                                alert = dict(
                                    round=rnd, rule=name,
                                    severity=rule["severity"],
                                    metric=cmetric,
                                    value=round(turnover, 6),
                                    zscore=round(stats["zscore"], 4),
                                    median=stats["median"],
                                    mad=stats["mad"],
                                    window=len(chist),
                                    action=self.action)
                        chist.append(turnover)
                    self._prev_hh = ids
            elif rule["kind"] == "nonfinite":
                # only a metric that WAS numeric turning null is a
                # precursor; an always-null field is merely N/A
                if not numeric and value is None and len(hist) > 0:
                    self.nonfinite_counts[metric] = (
                        self.nonfinite_counts.get(metric, 0) + 1)
                    if quiet <= 0:
                        alert = dict(round=rnd, rule=name,
                                     severity=rule["severity"],
                                     metric=metric, value=None, zscore=None,
                                     median=None, mad=None,
                                     window=len(hist), action=self.action)
            elif numeric and len(hist) >= self.min_points and quiet <= 0:
                stats = robust_z(float(value), list(hist),
                                 mad_floor_abs=rule.get("mad_floor_abs",
                                                        0.0))
                z = stats["zscore"]
                breach = (z > self.z_thresh
                          if rule.get("direction") == "high"
                          else z < -self.z_thresh)
                if breach:
                    alert = dict(round=rnd, rule=name,
                                 severity=rule["severity"], metric=metric,
                                 value=float(value),
                                 zscore=round(z, 4),
                                 median=stats["median"],
                                 mad=stats["mad"],
                                 window=len(hist), action=self.action)
            # the observed value enters the history AFTER detection, so
            # the spike itself cannot vouch for its own normality —
            # and only ONCE per event, even when several rules watch
            # the same metric (loss_spike + loss_nonfinite would
            # otherwise double-append and halve the effective window)
            if numeric and metric not in appended:
                hist.append(float(value))
                appended.add(metric)
            if alert is not None:
                self._quiet[name] = self.cooldown
                fired.append(alert)
        for alert in fired:
            self._fire(alert)
        return fired

    # ----------------------------------------------------------- persistence

    def state_dict(self) -> Dict[str, Any]:
        """JSON-serializable rolling state for checkpoint meta: the
        per-metric median/MAD histories, cooldowns and nonfinite
        counters. Without this a resumed monitor restarts COLD — its
        statistical rules are disarmed for min_points observations and
        a divergence straddling the restart goes unflagged."""
        return {
            "hist": {m: list(h) for m, h in self._hist.items()},
            "quiet": dict(self._quiet),
            "nonfinite_counts": dict(self.nonfinite_counts),
            "n_observed": self.n_observed,
            # group_starvation streaks: a starvation window straddling
            # a restart must keep counting, not restart cold
            "starve": dict(self._starve),
            # population rules: the coverage_stall streak and the
            # previous heavy-hitter set (same straddle-the-restart
            # argument; pre-v11 sidecars legitimately lack both)
            "cov": dict(self._cov),
            "prev_hh": (sorted(self._prev_hh)
                        if self._prev_hh is not None else None),
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self._hist = {m: deque((float(x) for x in h),
                               maxlen=self.window)
                      for m, h in (d.get("hist") or {}).items()}
        self._quiet = {r: int(q)
                       for r, q in (d.get("quiet") or {}).items()}
        self.nonfinite_counts = {m: int(n) for m, n in
                                 (d.get("nonfinite_counts") or {}).items()}
        self.n_observed = int(d.get("n_observed", 0))
        self._starve = {g: int(n)
                        for g, n in (d.get("starve") or {}).items()}
        self._cov = dict(d.get("cov") or {})
        prev = d.get("prev_hh")
        self._prev_hh = set(prev) if prev is not None else None

    # --------------------------------------------------------------- actions

    def external_alert(self, *, rnd: int, rule: str, metric: str,
                       value: Optional[float] = None,
                       severity: str = "critical") -> Dict[str, Any]:
        """Fire a non-statistical alert THROUGH the monitor (the hang
        watchdog's round_stall path): the alert event is written, the
        configured action's side effects (stderr, snapshot request,
        abort request) apply, exactly as if a rule had fired."""
        alert = dict(round=int(rnd), rule=rule, severity=severity,
                     metric=metric, value=value, zscore=None, median=None,
                     mad=None, window=0, action=self.action)
        self._fire(alert)
        return alert

    def _fire(self, alert: Dict[str, Any]) -> None:
        self.alerts.append(alert)
        if self._telemetry is not None:
            self._telemetry.event("alert", **alert)
        if self.action != "log":
            z = alert.get("zscore")
            print(f"ALERT [{alert['severity']}] {alert['rule']}: "
                  f"{alert['metric']}={alert.get('value')}"
                  + (f" (robust z {z:+.1f})" if z is not None else "")
                  + f" at round {alert['round']}", file=sys.stderr)
        if self.action in ("checkpoint", "abort"):
            if self._snapshot_request is None:
                self._snapshot_request = dict(alert)
        if self.action == "abort":
            self.abort_requested = True


class FlightRecorder:
    """One-shot postmortem bundle writer (``--alert_action checkpoint``).

    ``record(state, context)`` writes, into ``<logdir>/postmortem/``:

    - ``state.npz`` + ``state.meta.json`` — the live ``FedState``
      through the existing checkpoint layer
      (:func:`commefficient_torch.checkpoint.save_postmortem`; a state too
      large for the single-host guard degrades to weights-only, never
      fails the run);
    - ``events.jsonl`` — the stream's last-N events (the RunTelemetry
      ring buffer), so the bundle replays without the full stream;
    - ``alert.json`` — the firing alert's context;
    - ``memory.json`` — the residency timeline (the stream's last-N
      ``memory`` snapshots, separately ring-buffered so round/span
      traffic cannot rotate them out) plus the per-executable memory
      ledgers of the watched compiled functions — an OOM postmortem
      ships WHERE the bytes went, not just the weights.

    One-shot: the FIRST alert owns the bundle (the interesting state is
    the earliest anomalous one — later alerts describe decay of a run
    the bundle already captured). Best-effort like all telemetry: a
    failed write warns and disables, never raises into the round loop.
    """

    def __init__(self, logdir: str, telemetry=None,
                 subdir: str = "postmortem"):
        self.path = os.path.join(logdir, subdir)
        self._telemetry = telemetry
        self.written: Optional[str] = None
        # whether the bundle on disk carries state.npz: an events-only
        # stall bundle must not consume the one-shot slot for state —
        # see record()
        self._state_written = False

    def record(self, state, context: Dict[str, Any]) -> Optional[str]:
        """``state=None`` writes an events-only bundle (no ``state.npz``)
        — the hang-watchdog path, where fetching device state is exactly
        the operation that may be hung. One-shot applies to the EVENTS
        side; a later state-carrying alert (NaN abort after a stall
        alert already claimed the bundle) UPGRADES the bundle with
        ``state.npz`` instead of being swallowed — the recorder exists
        for exactly that snapshot."""
        if self.written is not None:
            if state is None or self._state_written:
                return self.written
            # upgrade path: add the state snapshot to the existing
            # events-only bundle; the first firing's events/alert.json
            # (the earliest anomalous window) stay as written
            try:
                from commefficient_torch.checkpoint import save_postmortem
                save_postmortem(os.path.join(self.path, "state"), state,
                                meta={"alert": context})
                self._state_written = True
                print(f"flight recorder: state.npz added to the "
                      f"events-only bundle at {self.path}",
                      file=sys.stderr)
            except Exception as e:  # noqa: BLE001
                print(f"WARNING: flight recorder state upgrade failed "
                      f"({e})", file=sys.stderr)
            return self.written
        try:
            os.makedirs(self.path, exist_ok=True)
            if state is not None:
                from commefficient_torch.checkpoint import save_postmortem
                save_postmortem(os.path.join(self.path, "state"), state,
                                meta={"alert": context})
                self._state_written = True
            if self._telemetry is not None:
                with open(os.path.join(self.path, "events.jsonl"),
                          "w") as f:
                    # snapshot: the watchdog thread records bundles while
                    # the round loop keeps appending to the ring —
                    # iterating the live deque would raise mutated-
                    # during-iteration and lose the bundle
                    for ev in list(self._telemetry.recent):
                        f.write(json.dumps(ev) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                # memory.json: residency timeline + per-executable
                # ledgers (see class docstring). getattr-guarded — a
                # minimal telemetry stand-in without the v6 memory
                # machinery still gets the rest of the bundle.
                watcher = getattr(self._telemetry, "_watcher", None)
                mem = {
                    "residency": list(getattr(self._telemetry,
                                              "recent_memory", ())),
                    "ledgers": dict(getattr(watcher, "memory", {})
                                    if watcher is not None else {}),
                }
                if mem["residency"] or mem["ledgers"]:
                    with open(os.path.join(self.path, "memory.json"),
                              "w") as f:
                        json.dump(mem, f, indent=1)
                        f.flush()
                        os.fsync(f.fileno())
                # the stream itself must survive whatever comes next
                self._telemetry.fsync()
            with open(os.path.join(self.path, "alert.json"), "w") as f:
                json.dump(context, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
        except Exception as e:  # noqa: BLE001 - observability never kills
            print(f"WARNING: flight recorder failed ({e})", file=sys.stderr)
            return None
        self.written = self.path
        print(f"flight recorder: postmortem bundle at {self.path}",
              file=sys.stderr)
        return self.written
