"""Deterministic crash and kill points for the crash harness, a copy of
the JAX package's ``faults.py`` with the same ``COMMEFFICIENT_FAULT``
grammar and the same points.

The preemption layer (checkpoint fallback, the graceful SIGTERM drain,
the round-granular resume) only earns trust if the process actually
DIES at the awkward moments (mid-checkpoint-write, inside the async
in-flight pool) and the resumed run is then proven bit-identical.
Timing-based kills are unreproducible, so the kill-points are injected:
hot-path sites call :func:`maybe_fault` with a point name (and
optionally the current round), and when the ``COMMEFFICIENT_FAULT``
environment variable names that point the process dies *right there*
via ``os._exit``: no ``finally`` blocks, no atexit, no flushes.

Spec grammar (one fault per process)::

    COMMEFFICIENT_FAULT=<action>:<point>[:<n>]

- ``action``: ``kill`` (``os._exit(137)``, the SIGKILL-alike) or
  ``sigterm`` (``os.kill(getpid(), SIGTERM)``: exercises the graceful
  drain instead of dying; the handler decides what happens next).
- ``point``: one of :data:`FAULT_POINTS`. ``mid_telemetry_flush``'s
  site is the stream's writer (telemetry/run.py), whose counter is the
  event's ``seq``: half the line reaches the file, then the action.
- ``n`` (optional): only trigger when the site's counter argument
  equals ``n`` (e.g. global round 5). A point without ``n`` triggers on
  the site's first visit.

Cost when unset: module import parses the env var once; every
``maybe_fault`` call is then a single ``is None`` check. ``sigterm``
fires at most once per process.
"""

from __future__ import annotations

import os
import signal
import sys
from typing import Optional, Tuple

FAULT_POINTS = (
    "pre_round",            # driver loop, before the round dispatches
    "mid_round",            # after dispatch, before telemetry/accounting
    "mid_checkpoint_write",  # tmp file written, BEFORE os.replace
    "mid_telemetry_flush",  # half a JSONL line written, stream unflushed
    "async_pool",           # inside AsyncAggregator.step, pool populated
)
_ACTIONS = ("kill", "sigterm")
_ENV = "COMMEFFICIENT_FAULT"
KILL_EXIT_CODE = 137        # the 128+SIGKILL convention


def _parse(spec: Optional[str]
           ) -> Optional[Tuple[str, str, Optional[int]]]:
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"{_ENV}={spec!r}: expected <action>:<point>[:<n>]")
    action, point = parts[0], parts[1]
    if action not in _ACTIONS:
        raise ValueError(f"{_ENV}={spec!r}: action {action!r} not in "
                         f"{_ACTIONS}")
    if point not in FAULT_POINTS:
        raise ValueError(f"{_ENV}={spec!r}: point {point!r} not in "
                         f"{FAULT_POINTS}")
    n = int(parts[2]) if len(parts) == 3 else None
    return action, point, n


_SPEC = _parse(os.environ.get(_ENV))
_FIRED = False


def faults_enabled() -> bool:
    return _SPEC is not None


def set_fault(spec: Optional[str]) -> None:
    """Test hook: (re)arm the module from a spec string (None disarms).
    The env-var path calls the same parser at import."""
    global _SPEC, _FIRED
    _SPEC = _parse(spec)
    _FIRED = False


def fault_matches(point: str, n=None) -> bool:
    """Whether the armed fault targets this site visit (no side
    effects) — for sites that need to corrupt something BEFORE dying
    (the mid-telemetry partial-line write)."""
    if _SPEC is None or _FIRED:
        return False
    action, p, want = _SPEC
    if p != point:
        return False
    return want is None or (n is not None and int(n) == want)


def trigger(point: str) -> None:
    """Execute the armed fault's action at ``point`` (the caller has
    already matched via :func:`fault_matches` and staged any
    corruption). ``kill`` never returns."""
    global _FIRED
    action = _SPEC[0]
    _FIRED = True
    sys.stderr.write(f"FAULT INJECTED: {action} at {point}\n")
    sys.stderr.flush()
    if action == "kill":
        os._exit(KILL_EXIT_CODE)
    os.kill(os.getpid(), signal.SIGTERM)


def maybe_fault(point: str, n=None) -> None:
    """The one-line site hook: die (or self-SIGTERM) here when the armed
    fault names this point/visit."""
    if _SPEC is None:
        return
    if fault_matches(point, n):
        trigger(point)
