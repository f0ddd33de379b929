"""Profiler window management: ``--profile_rounds START:STOP``, the
port's counterpart of the JAX package's ``telemetry/profiling.py``.

Every driver places a ``torch.profiler`` trace (CPU and, on the card,
CUDA activity) over a round range of the run and writes it as a chrome
trace into ``--profile_dir``. Rounds are 1-based and the window is
inclusive: the default "2:4" captures rounds 2, 3 and 4 (round 1, with
its one-time set-up and kernel builds, stays out).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple


def parse_profile_rounds(spec: str) -> Tuple[int, int]:
    """Parse "START:STOP" (inclusive, 1-based). A bare "N" profiles the
    single round N. Raises ValueError with an actionable message."""
    s = spec.strip()
    try:
        if ":" in s:
            a, b = s.split(":", 1)
            start, stop = int(a), int(b)
        else:
            start = stop = int(s)
    except ValueError:
        raise ValueError(
            f"--profile_rounds {spec!r} is not START:STOP (two integers, "
            "e.g. '2:4') or a single round number") from None
    if start < 1 or stop < start:
        raise ValueError(
            f"--profile_rounds {spec!r}: need 1 <= START <= STOP")
    return start, stop


class ProfilerWindow:
    """Start/stop a ``torch.profiler`` trace over a round window.

    ``maybe_start(rnd)`` goes before the round's dispatch and
    ``maybe_stop(rnd, sync)`` after it; ``sync`` is called before
    stopping so the trace holds the round's finished device work. The
    trace goes to ``<outdir>/trace_rounds_<start>-<stop>.json``.
    ``abort()`` closes a live trace on an error path."""

    def __init__(self, outdir: str, rounds: str = "2:4",
                 log: Callable[[str], None] = print):
        self.outdir = outdir
        self.start, self.stop = (parse_profile_rounds(rounds) if outdir
                                 else (0, 0))
        self._log = log
        self._prof = None
        self.active = False
        self.done = False
        self.path: Optional[str] = None

    @property
    def enabled(self) -> bool:
        return bool(self.outdir)

    def maybe_start(self, rnd: int) -> None:
        if (self.enabled and not self.done and not self.active
                and self.start <= rnd <= self.stop):
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self.active = True

    def _close(self, sync, note: str = "") -> None:
        if sync is not None:
            sync()
        self._prof.__exit__(None, None, None)
        self.active = False
        self.done = True
        os.makedirs(self.outdir, exist_ok=True)
        self.path = os.path.join(
            self.outdir, f"trace_rounds_{self.start}-{self.stop}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self._log(f"profiler trace written to {self.path}{note}")

    def maybe_stop(self, rnd: int,
                   sync: Optional[Callable[[], None]] = None) -> None:
        if self.active and rnd >= self.stop:
            self._close(sync)

    def finalize(self, sync: Optional[Callable[[], None]] = None) -> None:
        """Close a window the run ended inside of (STOP beyond the last
        round, an abort): the rounds captured so far still become a
        trace. No-op when the window closed already or never opened."""
        if self.active:
            self._close(sync, " (window closed early: run ended before "
                        f"round {self.stop})")

    def abort(self) -> None:
        if self.active:
            self.active = False
            self.done = True
            try:
                self._prof.__exit__(None, None, None)
            except Exception:
                pass
            self._prof = None
