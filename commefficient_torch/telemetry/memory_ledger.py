"""Device memory of a run: the per-phase residency of the ``memory``
events and the measured ``memory_ledger`` of a round, the port's
counterpart of the JAX package's ``telemetry/memory_ledger.py``.

**Residency**: per-phase snapshots of the caching allocator
(``torch.cuda.memory_stats``, ``torch.cuda.mem_get_info``): live bytes,
the high-water peak, the peak's growth since the previous snapshot
(which phase grew it: rounds, validation, checkpoint), fragmentation
(peak - live) and the headroom against the card's memory. On the CPU
every derived field is null, never zero, with a one-time note.

**Ledger**: the JAX package reads XLA's static memory analysis of each
compiled executable, which has no counterpart in an eager run. Here the
``round_step`` ledger is measured instead: ``temp_bytes`` is the peak a
round allocates above the bytes resident when it starts
(:func:`measure_round`), marked ``source: "measured"``;
:func:`check_dense_grad_floor` reads it against d x 4 bytes.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

# byte fields of one ``memory_ledger`` event (beyond the executable
# name), the JAX package's (scripts/teleview.py reads them); a measured
# ledger fills temp, argument (resident) and total bytes
MEMORY_LEDGER_KEYS = ("temp_bytes", "argument_bytes", "output_bytes",
                      "alias_bytes", "generated_code_bytes", "total_bytes")

# derived residency fields of the (schema v6) ``memory`` event; every
# one is null where there are no allocator statistics
MEMORY_KEYS = ("live_bytes", "peak_bytes", "delta_peak_bytes",
               "fragmentation_bytes", "limit_bytes", "headroom_frac")


def ledger_from_round(temp_bytes: Optional[int],
                      resident_bytes: Optional[int]) -> Dict[str, Any]:
    """The measured ``round_step`` ledger: ``temp_bytes`` the round's peak
    above what was resident when it started, ``argument_bytes`` that
    resident set; the fields an eager run cannot know are null."""
    out: Dict[str, Any] = {k: None for k in MEMORY_LEDGER_KEYS}
    out["temp_bytes"] = temp_bytes
    out["argument_bytes"] = resident_bytes
    if temp_bytes is not None and resident_bytes is not None:
        out["total_bytes"] = int(temp_bytes + resident_bytes)
    return out


def check_dense_grad_floor(ledger: Optional[Dict[str, Any]], d: int,
                           fused: bool = True) -> List[str]:
    """The sketch round's dense-gradient gate: ``fused``, the round's
    temporary bytes must stay under the dense (d,) float32 gradient (d
    x 4); unfused, they must hold it. Returns the problems, empty when
    the round is in the expected regime."""
    if ledger is None or ledger.get("temp_bytes") is None:
        return ["temp_bytes is null (cannot check the dense-gradient "
                "floor)"]
    temp, floor = int(ledger["temp_bytes"]), int(d) * 4
    if not fused and temp < floor:
        return [f"temp_bytes {temp} < d*4 = {floor}: the dense gradient "
                "no longer materializes"]
    if fused and temp >= floor:
        return [f"temp_bytes {temp} >= d*4 = {floor}: the round "
                "materializes a dense-gradient-sized temporary"]
    return []


def residency_fields(device_stats: List[Optional[Dict[str, Any]]],
                     prev_peak: Optional[float] = None) -> Dict[str, Any]:
    """Derive the MEMORY_KEYS residency fields from a list of per-device
    ``memory_stats()`` dicts (None / empty for devices that report
    nothing). Aggregation is worst-device over reporting devices — the
    binding constraint on a replicated-state mesh is the worst device —
    and the DERIVED fields (fragmentation, headroom) are computed
    per-device BEFORE aggregating, so they always describe a real
    device: max live/peak paired with an independently-maxed limit
    would overstate the headroom of a small-limit device about to OOM.
    Every field is null when no device reports — never a fake zero."""
    def _num(s, key):
        v = s.get(key) if isinstance(s, dict) else None
        return v if isinstance(v, (int, float)) else None

    lives, peaks, limits, frags, headrooms = [], [], [], [], []
    for s in device_stats:
        live, peak, limit = (_num(s, "bytes_in_use"),
                             _num(s, "peak_bytes_in_use"),
                             _num(s, "bytes_limit"))
        if live is not None:
            lives.append(live)
        if peak is not None:
            peaks.append(peak)
        if limit is not None:
            limits.append(limit)
        if peak is not None and live is not None:
            frags.append(peak - live)
        if limit and peak is not None:
            headrooms.append((limit - peak) / limit)
    peak = max(peaks) if peaks else None
    out: Dict[str, Any] = {
        "live_bytes": max(lives) if lives else None,
        "peak_bytes": peak,
        "delta_peak_bytes": (peak - prev_peak
                             if peak is not None and prev_peak is not None
                             else None),
        "fragmentation_bytes": max(frags) if frags else None,
        "limit_bytes": max(limits) if limits else None,
        "headroom_frac": (round(min(headrooms), 6)
                          if headrooms else None),
    }
    return out


def device_stats(device) -> Optional[Dict[str, Any]]:
    """The allocator's numbers for a CUDA ``device`` under the JAX
    package's ``memory_stats`` keys (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``: the card's memory), plus the
    caching allocator's reserved bytes; None off the card."""
    import torch
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    s = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(s.get("reserved_bytes.all.peak", 0)),
            "bytes_free": int(free),
            "num_alloc_retries": int(s.get("num_alloc_retries", 0)),
            "num_ooms": int(s.get("num_ooms", 0))}


class ResidencyTracker:
    """The snapshot-to-snapshot state of the residency fields (the last
    peak, for the delta) and the one-time note where there are no
    allocator numbers. ``snapshot(devices)`` returns ``(records,
    derived)``: per-device ``{id, kind, stats}`` (stats null off the
    card) and the MEMORY_KEYS fields. ``fold_peak`` carries the
    allocator's peak over a ``torch.cuda.reset_peak_memory_stats`` (the
    measured round ledger resets it), so the stream's peak never falls."""

    def __init__(self):
        self._prev_peak: Optional[float] = None
        self._floor = 0
        self._warned = False

    def fold_peak(self, device) -> None:
        s = device_stats(device)
        if s is not None:
            self._floor = max(self._floor, s["peak_bytes_in_use"])

    def snapshot(self, devices) -> tuple:
        import torch
        records, stats_list = [], []
        for d in devices:
            d = torch.device(d)
            try:
                stats = device_stats(d)
            except Exception:
                stats = None
            if stats is not None:
                stats["peak_bytes_in_use"] = max(
                    stats["peak_bytes_in_use"], self._floor)
            records.append({
                "id": int(d.index or 0) if d.type == "cuda" else 0,
                "kind": (torch.cuda.get_device_name(d)
                         if d.type == "cuda" else "cpu"),
                "stats": stats})
            stats_list.append(stats)
        derived = residency_fields(stats_list, self._prev_peak)
        if derived["peak_bytes"] is not None:
            self._prev_peak = derived["peak_bytes"]
        if (not self._warned and devices
                and all(derived[k] is None for k in MEMORY_KEYS)):
            self._warned = True
            print("NOTE: no allocator statistics on this device (CPU); "
                  "memory-event residency fields (live/peak/fragmentation/"
                  "headroom) will be null — null means 'not measurable "
                  "here', never zero", file=sys.stderr)
        return records, derived


class measure_round:
    """Context manager around one round on ``device``: resets the
    allocator's peak (after ``tracker.fold_peak`` keeps the old one) and
    records the bytes resident at the start; ``ledger()`` after the
    round (synced) gives the measured ``round_step`` ledger. Off the card
    its fields are null."""

    def __init__(self, device, tracker: Optional[ResidencyTracker] = None):
        import torch
        self.device = torch.device(device)
        self.tracker = tracker
        self.start: Optional[int] = None

    def __enter__(self) -> "measure_round":
        import torch
        if device_stats(self.device) is not None:
            if self.tracker is not None:
                self.tracker.fold_peak(self.device)
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self.start = int(torch.cuda.memory_allocated(self.device))
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def ledger(self) -> Dict[str, Any]:
        import torch
        if self.start is None:
            return ledger_from_round(None, None)
        peak = int(torch.cuda.max_memory_allocated(self.device))
        return ledger_from_round(peak - self.start, self.start)
