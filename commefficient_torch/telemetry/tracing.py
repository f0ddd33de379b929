"""Lightweight span tracer: where does a round's wall time actually go?

The ``round`` telemetry event carries a whole-round host/dispatch/device
split, but nothing below that granularity — when the host phase grows,
nothing says whether the data gather, the sampler, or the JSONL flush
grew. ``span("data_fetch")`` / ``span("dispatch")`` / ``span("device_wait")``
context managers mark the phases that own wall time; completed spans
buffer in memory (two ``perf_counter`` calls + one list append each) and
are drained into batched ``span`` telemetry events at the round-record
cadence, which ``scripts/teleview.py timeline`` renders into a
perfetto/chrome-tracing ``trace.json``.

Dependency-free on purpose (``threading`` + ``time`` only): the data
layer (``data/fed_dataset.py``) and the offline tooling must be able to
reason about spans without jax in the room.

Zero overhead when telemetry is off: the module-level :func:`span`
delegates to a process-global tracer that defaults to a
:class:`NullTracer`, whose ``span()`` returns one shared no-op context
manager — no allocation, no clock reads, no lock. The drivers
:func:`install` a real :class:`SpanTracer` only when a telemetry stream
exists, and :func:`uninstall` it on the way out.

Thread-safety: spans may open/close on any thread (nesting depth is
tracked per thread); the completed-span buffer is lock-protected, and
``drain()`` swaps the buffer atomically.

The PyTorch port's copy of the JAX package's ``telemetry/tracing.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager — the entire cost of a span when
    tracing is off is one attribute lookup and one call returning this
    singleton."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """The installed-by-default tracer: spans are no-ops, drains are
    empty. Keeps every instrumentation site unconditional — no
    ``if telemetry`` branches in the hot paths."""

    enabled = False
    t0_wall = 0.0
    dropped = 0

    def span(self, name: str) -> _NullSpan:
        return NULL_SPAN

    def drain(self) -> List[Dict[str, Any]]:
        return []

    def pop_dropped(self) -> int:
        return 0


class _Span:
    """One live span (context manager). Records on exit only — an
    exception inside the span still produces the span, with the time it
    actually took."""

    __slots__ = ("_tracer", "_name", "_t0", "_depth")

    def __init__(self, tracer: "SpanTracer", name: str):
        self._tracer = tracer
        self._name = name

    def __enter__(self) -> "_Span":
        self._depth = self._tracer._enter_depth()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._tracer._record(self._name, self._t0, t1 - self._t0,
                             self._depth)
        return False


class SpanTracer:
    """Buffers completed spans for periodic drain into the telemetry
    stream.

    Spans carry ``ts`` (seconds since the tracer's epoch, measured on
    the monotonic ``perf_counter`` clock — NTP steps cannot reorder
    them), ``dur_s``, ``tid`` (a small per-tracer thread ordinal) and
    ``depth`` (nesting level within the thread). ``t0_wall`` anchors the
    monotonic epoch to unix time once, so offline tools can align spans
    with the events' absolute ``t`` fields.

    ``max_spans`` bounds the buffer: a run that never drains (telemetry
    record cadence 0) drops further spans and counts them in
    ``dropped`` instead of growing without limit. ``pop_dropped()``
    returns-and-resets that counter, so each ``span`` event reports the
    drops of ITS window — per-event counts sum to the true total.
    """

    enabled = True

    def __init__(self, max_spans: int = 100_000):
        self.t0_wall = time.time()
        self.t0 = time.perf_counter()
        self.max_spans = max_spans
        self.dropped = 0
        self._buf: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}

    # ------------------------------------------------------------- recording

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def _enter_depth(self) -> int:
        d = getattr(self._local, "depth", 0)
        self._local.depth = d + 1
        return d

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _record(self, name: str, t0: float, dur: float, depth: int) -> None:
        self._local.depth = depth  # restore: this span closed
        rec = {"name": name, "ts": round(t0 - self.t0, 6),
               "dur_s": round(dur, 6), "tid": self._tid(), "depth": depth}
        with self._lock:
            if len(self._buf) >= self.max_spans:
                self.dropped += 1
                return
            self._buf.append(rec)

    # --------------------------------------------------------------- reading

    def drain(self) -> List[Dict[str, Any]]:
        """Return and clear the completed-span buffer (open spans land in
        a later drain)."""
        with self._lock:
            out, self._buf = self._buf, []
            return out

    def pop_dropped(self) -> int:
        """Drops since the last pop (atomically reset)."""
        with self._lock:
            d, self.dropped = self.dropped, 0
            return d


# process-global tracer: instrumentation sites call tracing.span(name)
# unconditionally; only a driver that owns a telemetry stream installs a
# recording tracer.
_TRACER: Any = NullTracer()


def current():
    return _TRACER


def install(tracer: Optional[SpanTracer] = None) -> SpanTracer:
    """Make ``tracer`` (or a fresh SpanTracer) the process-global tracer;
    returns it. Pair with :func:`uninstall` in a finally block."""
    global _TRACER
    if tracer is None:
        tracer = SpanTracer()
    _TRACER = tracer
    return tracer


def uninstall() -> None:
    global _TRACER
    _TRACER = NullTracer()


def span(name: str):
    """Open a span on the current tracer (a shared no-op when tracing is
    off). Usage: ``with tracing.span("data_fetch"): ...``"""
    return _TRACER.span(name)
