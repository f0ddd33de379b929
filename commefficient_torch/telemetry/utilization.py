"""Utilization accounting: achieved FLOP/s, MFU, and starvation
fractions; the port's counterpart of the JAX package's
``telemetry/utilization.py``.

Joins the per-round wall-time phases the driver measures (the wait for
the round's batch, the host's dispatch of the round, the wait for the
card at the driver's sync), an analytic FLOP count a round where the
entry point has one (GPT-2's ``gpt2_model_flops``) and a per-device
peak table keyed by the card's full name (``--peak_flops`` and
``--peak_hbm_gbps`` override it), and emits ``utilization`` events. The
port has no compiler cost analysis: without an analytic count ``mfu``
and the roofline fields are null, never a guess; an unknown card gives
null peaks the same way.

- **MFU** is FLOPs a round x rounds / (wall s x peak), over the full
  window including host time.
- ``input_wait_frac`` / ``dispatch_frac`` / ``device_wait_frac`` are
  fractions of the window's wall time; the remainder is the untimed
  loop tail (the telemetry writes among it).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional, Tuple

# peak bf16 FLOP/s by device kind (public data sheets), matched by
# device_kind prefix: the JAX package's table and the H100
PEAK_FLOPS_BY_KIND = {
    # the card's full name: a prefix "NVIDIA H100" would also match the
    # PCIe and NVL cards, whose peaks differ (dense bf16, data sheet)
    "NVIDIA H100 80GB HBM3": 989e12,
    "TPU v5 lite": 197e12,   # v5e
    "TPU v5e": 197e12,
    "TPU v5": 459e12,        # v5p
    "TPU v4": 275e12,
    "TPU v6 lite": 918e12,   # v6e / Trillium
    "TPU v3": 123e12,
    "TPU v2": 45e12,
}

# peak HBM bandwidth in GB/s by generation (public spec sheets), same
# prefix matching and same single-source rule as the FLOPs table — the
# roofline's second axis. An unknown chip yields null bandwidth fields
# (--peak_hbm_gbps overrides), never a guess.
PEAK_HBM_GBPS_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "TPU v5 lite": 819.0,    # v5e
    "TPU v5e": 819.0,
    "TPU v5": 2765.0,        # v5p
    "TPU v4": 1228.0,
    "TPU v6 lite": 1640.0,   # v6e / Trillium
    "TPU v3": 900.0,
    "TPU v2": 700.0,
}

# roofline attribution fields of the ``utilization`` event (schema v6),
# computed by roofline_fields below
ROOFLINE_KEYS = ("peak_hbm_gbps", "bytes_per_round", "bytes_source",
                 "arithmetic_intensity", "ridge_intensity", "bound",
                 "achieved_gbps", "bw_frac", "expected_round_s")


def _peak_lookup(table, device_kind: str,
                 override: float = 0.0) -> Optional[float]:
    if override:
        return float(override)
    for name, peak in table.items():
        if device_kind.startswith(name):
            return peak
    return None


def peak_flops_for(device_kind: str,
                   override: float = 0.0) -> Optional[float]:
    """Peak FLOP/s for a device kind: the ``--peak_flops`` override when
    given, else the table (prefix match), else None — an unknown chip
    yields null MFU rather than a number computed against a guess."""
    return _peak_lookup(PEAK_FLOPS_BY_KIND, device_kind, override)


def peak_hbm_for(device_kind: str,
                 override: float = 0.0) -> Optional[float]:
    """Peak HBM bandwidth (GB/s): the ``--peak_hbm_gbps`` override when
    given, else the table (prefix match), else None — same
    null-never-fake-zero contract as peak_flops_for."""
    return _peak_lookup(PEAK_HBM_GBPS_BY_KIND, device_kind, override)


def roofline_fields(*, rounds: int, wall_s: float,
                    flops_per_round: Optional[float],
                    bytes_per_round: Optional[float],
                    bytes_source: Optional[str],
                    peak_flops: Optional[float],
                    peak_hbm_gbps: Optional[float]) -> Dict[str, Any]:
    """Roofline attribution for one executable over one timed window:

    - ``arithmetic_intensity`` = FLOPs / bytes accessed (FLOP/byte);
    - ``ridge_intensity`` = peak FLOP/s / peak bytes/s — the intensity
      where the roofline's two ceilings meet on THIS chip;
    - ``bound``: ``compute`` when the intensity sits at/right of the
      ridge (the FLOP ceiling binds), ``bandwidth`` left of it (the HBM
      ceiling binds), null when either coordinate is unknown;
    - ``achieved_gbps`` / ``bw_frac``: measured byte throughput and its
      fraction of peak — the bandwidth analog of achieved_flops / mfu;
    - ``expected_round_s``: the two-term time model
      max(flops/peak_flops, bytes/peak_bw) — the executable's floor
      under perfect overlap; wall clock above it is overhead
      (dispatch, serialization, under-utilized units), below it means
      the byte or FLOP count under-describes the executable.

    Every field is null when an input it needs is unknown — a roofline
    verdict computed against a guessed peak would be exactly the
    back-of-envelope arithmetic this module exists to replace."""
    peak_bw = peak_hbm_gbps * 1e9 if peak_hbm_gbps else None
    ai = (flops_per_round / bytes_per_round
          if flops_per_round and bytes_per_round else None)
    ridge = (peak_flops / peak_bw if peak_flops and peak_bw else None)
    bound = None
    if ai is not None and ridge is not None:
        bound = "compute" if ai >= ridge else "bandwidth"
    achieved_bps = (bytes_per_round * rounds / wall_s
                    if bytes_per_round and wall_s > 0 else None)
    t_flops = (flops_per_round / peak_flops
               if flops_per_round and peak_flops else None)
    t_bytes = (bytes_per_round / peak_bw
               if bytes_per_round and peak_bw else None)
    expected = (max(t_flops, t_bytes)
                if t_flops is not None and t_bytes is not None else None)

    def sig(v, figs=6):
        # significant figures like mfu: tiny true values must not
        # round to a dishonest 0.0
        return float(f"{v:.{figs}g}") if v is not None else None

    return {
        "peak_hbm_gbps": peak_hbm_gbps,
        "bytes_per_round": bytes_per_round,
        "bytes_source": bytes_source if bytes_per_round else None,
        "arithmetic_intensity": sig(ai),
        "ridge_intensity": sig(ridge),
        "bound": bound,
        "achieved_gbps": sig(achieved_bps / 1e9
                             if achieved_bps is not None else None),
        "bw_frac": sig(achieved_bps / peak_bw
                       if achieved_bps is not None and peak_bw else None),
        "expected_round_s": sig(expected),
    }


def device_kind_of(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def _device_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _frac(part: float, whole: float) -> Optional[float]:
    return round(part / whole, 6) if whole > 0 else None


def utilization_fields(*, rounds: int, wall_s: float,
                       host_s: float, dispatch_s: float, device_s: float,
                       flops_per_round: Optional[float],
                       flops_source: Optional[str],
                       device_kind: str,
                       peak_flops: Optional[float],
                       spread: Optional[float] = None,
                       bytes_per_round: Optional[float] = None,
                       bytes_source: Optional[str] = None,
                       peak_hbm_gbps: Optional[float] = None,
                       n_devices: Optional[int] = None,
                       mesh_shape: Optional[List[int]] = None
                       ) -> Dict[str, Any]:
    """The pure MFU/starvation math, separated from event emission so
    tests can drive it with synthetic cost dicts and fake peak tables.
    Schema v6: joins the roofline attribution (roofline_fields) when a
    byte count / bandwidth peak is supplied — null fields otherwise.
    Schema v7: carries the window's mesh topology (``n_devices`` /
    ``mesh_shape``) so per-chip throughput — the weak-scaling contract
    scripts/scaling_curves.py gates — is computable from the stream
    alone; null when the caller knows neither, never a fake 1."""
    achieved = mfu = None
    if flops_per_round and wall_s > 0:
        achieved = flops_per_round * rounds / wall_s
        if peak_flops:
            mfu = achieved / peak_flops
    return {
        "n_devices": int(n_devices) if n_devices else None,
        "mesh_shape": (list(int(x) for x in mesh_shape)
                       if mesh_shape is not None else None),
        "rounds": int(rounds),
        "wall_s": round(wall_s, 6),
        "device_kind": device_kind,
        "peak_flops": peak_flops,
        "flops_per_round": flops_per_round,
        "flops_source": flops_source if flops_per_round else None,
        "achieved_flops": achieved,
        # significant figures, not decimal places: a smoke-model mfu of
        # 2e-8 must not round to a (dishonest) 0.0
        "mfu": (float(f"{mfu:.6g}") if mfu is not None else None),
        "input_wait_frac": _frac(host_s, wall_s),
        "dispatch_frac": _frac(dispatch_s, wall_s),
        "device_wait_frac": _frac(device_s, wall_s),
        "straggler_spread": spread,
        **roofline_fields(rounds=rounds, wall_s=wall_s,
                          flops_per_round=flops_per_round,
                          bytes_per_round=bytes_per_round,
                          bytes_source=bytes_source,
                          peak_flops=peak_flops,
                          peak_hbm_gbps=peak_hbm_gbps),
    }


def emit_from_totals(telemetry, *, rnd: int, rounds: int, wall_s: float,
                     host_s: float = 0.0, dispatch_s: float = 0.0,
                     device_s: float = 0.0,
                     flops_per_round: Optional[float] = None,
                     flops_source: Optional[str] = None,
                     device_kind: str = "unknown") -> Dict[str, Any]:
    """One ``utilization`` event from a timed stage's totals (the bench
    path: one event a stage); returns the fields so the caller can fold
    them into its JSON line. ``n_devices`` is the cards this process sees
    (1 on the CPU); the peaks come from the tables (null for an unknown
    kind). One device, so no straggler spread."""
    fields = utilization_fields(
        rounds=rounds, wall_s=wall_s, host_s=host_s, dispatch_s=dispatch_s,
        device_s=device_s, flops_per_round=flops_per_round,
        flops_source=flops_source, device_kind=device_kind,
        peak_flops=peak_flops_for(device_kind),
        bytes_per_round=None, bytes_source=None,
        peak_hbm_gbps=peak_hbm_for(device_kind),
        n_devices=_device_count(), mesh_shape=None)
    if telemetry is not None:
        telemetry.event("utilization", round=int(rnd), **fields)
    return fields


class UtilizationTracker:
    """Windowed utilization accounting for a driver's round loop.

    ``observe_round`` is called every round with the measured phase
    times (``device_s=None`` on rounds that did not sync); ``emit`` —
    called at the telemetry record cadence, outside the timed region —
    joins the window's phase sums with the analytic FLOPs a round (when
    the entry point set one) and writes one ``utilization`` event, then
    resets the window. The window wall clock runs from the first
    observed round (monotonic ``perf_counter``), so untimed loop tail
    (telemetry emission itself) is included in the denominator — MFU is
    honest about everything the loop spends.
    """

    def __init__(self, telemetry, *, device_kind: Optional[str] = None,
                 peak_flops: float = 0.0,
                 peak_hbm_gbps: float = 0.0,
                 n_devices: Optional[int] = None,
                 mesh_shape: Optional[List[int]] = None):
        self._telemetry = telemetry
        if device_kind is None:
            device_kind = device_kind_of()
        if n_devices is None:
            n_devices = _device_count()
        self.n_devices = n_devices
        self.mesh_shape = mesh_shape
        self.device_kind = device_kind
        self.peak_flops = peak_flops_for(device_kind, peak_flops)
        if self.peak_flops is None:
            print(f"WARNING: no peak-FLOPs entry for device kind "
                  f"{device_kind!r}; utilization events will carry null "
                  "mfu (set --peak_flops to override)", file=sys.stderr)
        self.peak_hbm_gbps = peak_hbm_for(device_kind, peak_hbm_gbps)
        if self.peak_hbm_gbps is None:
            print(f"WARNING: no peak-HBM-bandwidth entry for device kind "
                  f"{device_kind!r}; utilization events will carry null "
                  "roofline fields (set --peak_hbm_gbps to override)",
                  file=sys.stderr)
        self._flops: Optional[float] = None
        self._flops_source: Optional[str] = None
        self._reset()

    def _reset(self) -> None:
        self._win_t0: Optional[float] = None
        self._rounds = 0
        self._host_s = self._dispatch_s = self._device_s = 0.0

    def set_flops_per_round(self, flops: Optional[float],
                            source: str = "analytic") -> None:
        """Pin the MFU numerator (e.g. an analytic count where XLA's
        cost analysis under-reports scanned rounds)."""
        self._flops = flops
        self._flops_source = source if flops else None

    def _flops_per_round(self) -> Tuple[Optional[float], Optional[str]]:
        return self._flops, self._flops_source

    def observe_round(self, *, host_s: float, dispatch_s: float,
                      device_s: Optional[float] = None) -> None:
        if self._win_t0 is None:
            # anchor at the observed round's start, not at emit time
            self._win_t0 = time.perf_counter() - (
                host_s + dispatch_s + (device_s or 0.0))
        self._rounds += 1
        self._host_s += host_s
        self._dispatch_s += dispatch_s
        if device_s is not None:
            self._device_s += device_s

    def emit(self, rnd: int) -> Optional[Dict[str, Any]]:
        """Emit one ``utilization`` event over the window since the last
        emit; no-op (returns None) on an empty window."""
        if self._rounds == 0 or self._telemetry is None:
            return None
        wall = time.perf_counter() - self._win_t0
        flops, source = self._flops_per_round()
        nbytes, bsource = None, None
        fields = utilization_fields(
            rounds=self._rounds, wall_s=wall, host_s=self._host_s,
            dispatch_s=self._dispatch_s, device_s=self._device_s,
            flops_per_round=flops, flops_source=source,
            device_kind=self.device_kind, peak_flops=self.peak_flops,
            bytes_per_round=nbytes, bytes_source=bsource,
            peak_hbm_gbps=self.peak_hbm_gbps,
            n_devices=self.n_devices, mesh_shape=self.mesh_shape)
        self._telemetry.event("utilization", round=int(rnd), **fields)
        self._reset()
        return fields
