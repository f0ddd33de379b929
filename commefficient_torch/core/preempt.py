"""Preemption-safe rounds: the host-side fault-tolerance layer, a port of
the JAX package's ``core/preempt.py``.

- :class:`PreemptGuard`: an installable SIGTERM/SIGINT handler. The
  first signal only sets a flag: the round loop notices it at the next
  round boundary and drains within the ``--preempt_grace`` budget
  (close the RoundPipeline, flush the AsyncAggregator through the
  epoch-flush path, write an out-of-cadence ``preempt``-tagged
  checkpoint with round-granular meta, exit 0). A second signal
  force-exits at once.
- :class:`RoundWatchdog`: a host thread that deadlines each round's
  dispatch and sync at ``--watchdog_mult`` times the rolling median round
  time (with a MAD envelope, so scheduler jitter cannot fire it). On
  expiry it calls back once a round; the driver prints the JAX
  package's ``WATCHDOG:`` line, writes a ``fault`` event and fires a
  ``round_stall`` alert through the anomaly monitor, and the flight
  recorder (``--alert_action checkpoint|abort``) writes an events-only
  bundle.
- :func:`with_retries`: bounded exponential-backoff retries of the
  retryable host phases (the round's input fetch).
- :func:`collect_ledger_state` / :func:`restore_ledger_state`: the
  host ledgers a checkpoint carries in its meta (the quarantine ledger,
  the participation ledger, the anomaly monitor and the stream's ring
  vintage), in the JAX package's layout.

Everything here is host-only, standard library alone.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from commefficient_torch.telemetry.health import robust_z


# signals a preemption can arrive on (SIGKILL is uncatchable by design)
PREEMPT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptGuard:
    """First signal: request a graceful drain. Second signal: force-exit.

    Installs only from the MAIN thread (CPython restricts
    ``signal.signal`` to it); elsewhere the guard stays inert —
    ``requested`` is simply never set, which degrades to today's
    behavior (the default handler kills the process).
    """

    def __init__(self, grace_s: float = 30.0, *, _exit=os._exit):
        if grace_s <= 0:
            raise ValueError(f"grace_s must be > 0, got {grace_s}")
        self.grace_s = float(grace_s)
        self.requested = False
        self.signal_name: Optional[str] = None
        self.t_signal: Optional[float] = None
        self.installed = False
        self._old: Dict[int, Any] = {}
        self._exit = _exit

    def install(self) -> "PreemptGuard":
        if threading.current_thread() is not threading.main_thread():
            return self          # inert off the main thread (see class doc)
        for sig in PREEMPT_SIGNALS:
            try:
                self._old[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):  # pragma: no cover - exotic host
                continue
        self.installed = bool(self._old)
        return self

    def uninstall(self) -> None:
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._old = {}
        self.installed = False

    def grace_used_s(self) -> Optional[float]:
        if self.t_signal is None:
            return None
        return time.monotonic() - self.t_signal

    def request(self, signame: str = "manual") -> None:
        """Programmatic preemption request (tests; also what the signal
        handler does)."""
        self.requested = True
        if self.t_signal is None:
            self.t_signal = time.monotonic()
            self.signal_name = signame

    def force_exit_after(self, delay_s: float) -> threading.Timer:
        """Arm the grace ENFORCEMENT: a daemon timer that force-exits
        the process if the drain itself wedges past the remaining
        budget (a checkpoint save blocked on a hung device, a flush
        stuck in a dead collective — the exact states a preemption
        tends to arrive in). The drain cancels it on success; on expiry
        the process exits 1 — a drain that overran its grace did NOT
        complete, and the fleet's hard kill was coming anyway."""
        def _expire():
            sys.stderr.write(
                f"PREEMPT: drain exceeded the {self.grace_s:.0f}s grace "
                "budget — force exit (resume falls back to the last "
                "durable checkpoint)\n")
            sys.stderr.flush()
            self._exit(1)

        t = threading.Timer(max(float(delay_s), 0.0), _expire)
        t.daemon = True
        t.start()
        return t

    def _handle(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        if self.requested:
            # the drain is already running (or wedged): force out NOW,
            # skipping every finally — the operator asked twice
            sys.stderr.write(
                f"PREEMPT: second signal ({name}) — force exit\n")
            sys.stderr.flush()
            self._exit(128 + int(signum))
            return               # only reachable with a stubbed _exit
        sys.stderr.write(
            f"PREEMPT: {name} received — draining within "
            f"{self.grace_s:.0f}s grace (signal again to force exit)\n")
        sys.stderr.flush()
        self.request(name)

    def __enter__(self) -> "PreemptGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def stall_deadline_s(history, mult: float, *, floor_s: float = 2.0,
                     z: float = 6.0) -> Optional[float]:
    """Deadline for "this round has hung": ``mult x median + z x MAD``
    over the rolling round-time history, with the MAD floored exactly
    like the health.py rules (2% of the median relatively, plus an
    absolute 50 ms so micro-rounds cannot arm a zero-width envelope),
    and the whole deadline floored at ``floor_s``. None until the
    history has enough points to be meaningful (min 4)."""
    hist = [float(h) for h in history]
    if len(hist) < 4:
        return None
    stats = robust_z(0.0, hist, mad_floor_abs=0.05)
    return max(mult * stats["median"] + z * stats["mad"], floor_s)


class RoundWatchdog:
    """Host watchdog thread deadlining each round's dispatch+sync.

    Driver contract::

        wd = RoundWatchdog(on_stall, mult=cfg.watchdog_mult)
        for each round:
            wd.arm(global_round)
            ... dispatch + sync ...
            wd.disarm()          # feeds the measured duration
        wd.close()

    ``on_stall(round, elapsed_s, deadline_s)`` runs on the watchdog
    thread, at most once per armed round; the round itself is never
    interrupted — a stall alert is evidence, the kill decision belongs
    to the operator (or the preemption layer).
    """

    def __init__(self, on_stall: Callable[[int, float, float], None],
                 mult: float = 10.0, *, window: int = 32,
                 floor_s: float = 2.0, poll_s: float = 0.05):
        if mult < 1:
            raise ValueError(f"watchdog mult must be >= 1, got {mult}")
        self.on_stall = on_stall
        self.mult = float(mult)
        self.floor_s = float(floor_s)
        self.history: deque = deque(maxlen=int(window))
        self.stalls = 0
        self._poll_s = float(poll_s)
        self._cond = threading.Condition()
        self._armed: Optional[tuple] = None   # (round, t0, deadline)
        self._fired_round: Optional[int] = None
        self._closing = False
        self._thread = threading.Thread(target=self._worker,
                                        name="round-watchdog", daemon=True)
        self._thread.start()

    def deadline_s(self) -> Optional[float]:
        return stall_deadline_s(self.history, self.mult,
                                floor_s=self.floor_s)

    def arm(self, rnd: int) -> None:
        deadline = self.deadline_s()
        with self._cond:
            self._armed = (int(rnd), time.monotonic(), deadline)
            self._cond.notify_all()

    def disarm(self, observe: bool = True) -> None:
        """``observe=False`` clears the deadline without feeding the
        duration into the rolling history: for a round that never synced
        the device (a dispatch-only duration would drag the median, and
        the deadline, down onto the floor)."""
        with self._cond:
            if self._armed is None:
                return
            rnd, t0, _ = self._armed
            if observe:
                self.history.append(time.monotonic() - t0)
            self._armed = None
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)

    def _worker(self) -> None:
        while True:
            with self._cond:
                if self._closing:
                    return
                armed = self._armed
                if armed is None or armed[2] is None \
                        or self._fired_round == armed[0]:
                    self._cond.wait(timeout=self._poll_s)
                    continue
                rnd, t0, deadline = armed
                now = time.monotonic()
                if now - t0 < deadline:
                    self._cond.wait(timeout=min(
                        deadline - (now - t0), self._poll_s * 4))
                    continue
                self._fired_round = rnd
                self.stalls += 1
                elapsed = now - t0
            try:
                self.on_stall(rnd, elapsed, deadline)
            except Exception as e:  # noqa: BLE001 — observability only
                print(f"WARNING: watchdog stall callback failed ({e})",
                      file=sys.stderr)


def with_retries(fn: Callable[[], Any], *, attempts: int = 3,
                 base_s: float = 0.1, max_s: float = 2.0,
                 desc: str = "host phase",
                 on_retry: Optional[Callable[[int, Exception], None]]
                 = None) -> Any:
    """Bounded exponential-backoff retry for retryable HOST-side phases
    (device_put, gather dispatch). The final failure propagates — after
    ``attempts`` tries the round is declared dead and the driver's
    existing abort paths own what happens next."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delay = float(base_s)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — re-raised on exhaustion
            if attempt >= attempts:
                raise
            print(f"WARNING: {desc} failed (attempt {attempt}/"
                  f"{attempts}: {e}); retrying in {delay:.2f}s",
                  file=sys.stderr)
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)
            delay = min(delay * 2, float(max_s))


# ------------------------------------------------------- ledger persistence


# the cap on the participation ledger's serialized sidecar (it rides the
# checkpoint's meta.json, read whole at every resume): the JAX package's,
# with its environment override
LEDGER_SIDECAR_MAX_BYTES = int(os.environ.get(
    "COMMEFF_LEDGER_SIDECAR_MAX_BYTES", 8 * 1024 * 1024))


def collect_ledger_state(qledger=None, participation=None, monitor=None,
                         telemetry=None) -> Dict[str, Any]:
    """The host-ledger sidecar a checkpoint carries in its meta, in the
    JAX package's layout: ``quarantine`` (strikes, benches, ejections),
    ``participation`` (the participation ledger's state), ``monitor``
    (the anomaly monitor's rolling histories) and ``ring`` (how far the
    stream's flight-recorder ring had advanced). JSON; restored by
    :func:`restore_ledger_state`. Raises when the participation state
    passes :data:`LEDGER_SIDECAR_MAX_BYTES` (the exact ledger at
    population scale), naming ``--population_sketch on``."""
    out: Dict[str, Any] = {}
    if qledger is not None:
        out["quarantine"] = qledger.state_dict()
    if participation is not None:
        part = participation.state_dict()
        nbytes = len(json.dumps(part).encode())
        if nbytes > LEDGER_SIDECAR_MAX_BYTES:
            raise ValueError(
                f"participation-ledger checkpoint sidecar is "
                f"{nbytes / 2**20:.1f} MiB (> "
                f"{LEDGER_SIDECAR_MAX_BYTES / 2**20:.1f} MiB cap): the "
                f"exact per-client ledger does not scale to this "
                f"universe ({getattr(participation, 'num_clients', '?')} "
                f"registered clients). Pass --population_sketch on (or "
                f"auto) for the bounded-memory sketch ledger, or raise "
                f"COMMEFF_LEDGER_SIDECAR_MAX_BYTES to keep exact state.")
        out["participation"] = part
    if monitor is not None:
        out["monitor"] = monitor.state_dict()
    if telemetry is not None:
        out["ring"] = {"seq": getattr(telemetry, "_seq", 0),
                       "recent": len(getattr(telemetry, "recent", ()))}
    return out


def restore_ledger_state(ledgers: Optional[Dict[str, Any]], *,
                         qledger=None, participation=None,
                         monitor=None) -> None:
    """Applies a saved sidecar to this run's fresh host ledgers, each
    only where both the saved state and the live object exist (a run
    that turned quarantine off drops that state)."""
    if not ledgers:
        return
    if qledger is not None and ledgers.get("quarantine"):
        qledger.load_state_dict(ledgers["quarantine"])
    if participation is not None and ledgers.get("participation"):
        participation.load_state_dict(ledgers["participation"])
    if monitor is not None and ledgers.get("monitor"):
        monitor.load_state_dict(ledgers["monitor"])
