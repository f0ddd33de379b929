"""Per-client population statistics, the port's counterpart of the JAX
package's ``telemetry/clients.py``: what each of the round's W clients
did, without a per-client vector leaving the device.

- **Device side** (:func:`summarize_per_client`, called in
  ``FedRuntime``'s round): per-client scalars (loss, gradient norm before
  and after the clip, clip saturation, upload norm, exact bytes) reduced
  along the client axis to quantile summaries (p5/p25/p50/p75/p95/max/
  mean and the argmax slot). Computed only when a telemetry stream exists
  to read them (``FedRuntime._client_stats``); they cross to the host
  with the round's other metrics, in one copy, at the record cadence.
- **Host side** (:class:`ParticipationLedger`): per-client sample
  counts, coverage and staleness from the sampler's host-resident ids
  every round, snapshotted into the same ``client_stats`` event.

NaN means "not applicable on this path" (the per-client gradient norms
of the fused route, where no per-client gradient exists) and serialises
as null, never as zero.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

# per-client scalars the CLIENT step can produce (core/client.py); the
# round adds "loss" (results[0] is already per-client) and, under
# --track_bytes, the exact per-slot byte costs
CLIENT_GRAD_KEYS = ("grad_norm_pre", "grad_norm_post", "clip_frac",
                    "tx_norm")
CLIENT_STAT_KEYS = ("loss",) + CLIENT_GRAD_KEYS + ("upload_bytes",
                                                   "download_bytes")
QUANTILE_PCTS = (5.0, 25.0, 50.0, 75.0, 95.0)
QUANTILE_FIELDS = ("p5", "p25", "p50", "p75", "p95", "max", "mean")


def _nanpercentile(masked, pcts):
    """``jnp.nanpercentile(masked, pcts, axis=1)`` (linear) on a (K, W)
    float32 tensor, step for step in float32: NaNs sort last, each row's
    count of the rest sets the positions, and the result is ``low * (1 -
    w) + high * w``, so a row that is all NaN gives NaN, and an inf that
    meets a zero weight gives NaN, as the JAX package's does. Returns
    (P, K)."""
    import torch
    a = torch.sort(masked, dim=1).values
    counts = (~torch.isnan(a)).sum(dim=1).to(torch.float32)      # (K,)
    q = (torch.as_tensor(pcts, dtype=torch.float32, device=a.device)
         / np.float32(100.0))
    pos = q[:, None] * (counts - 1.0)[None, :]                    # (P, K)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    top = (counts - 1.0)[None, :]
    low = torch.clamp(torch.minimum(low, top), min=0.0).to(torch.int64)
    high = torch.clamp(torch.minimum(high, top), min=0.0).to(torch.int64)
    lo_v = torch.gather(a, 1, low.T).T
    hi_v = torch.gather(a, 1, high.T).T
    return lo_v * lw + hi_v * hw


def summarize_per_client(per_client: Dict[str, Any], n_valid: Any
                         ) -> Dict[str, Dict[str, Any]]:
    """Quantile reduction of per-client (W,) stat tensors, on the device.

    Slots that processed no valid datum are masked to NaN; stats that
    arrive as NaN (not applicable) stay NaN through the quantiles. Every
    stat is stacked into one (K, W) matrix. Returns ``{key: {"q": (5,),
    "max": (), "mean": (), "argmax": () int64}}``: ``jnp.nanpercentile``
    (linear), ``nanmax``, ``nanmean`` and the argmax over the valid
    finite entries (the first of equal maxima) of the JAX package; the
    host maps ``argmax`` (a round slot) to a client id."""
    import torch
    keys = sorted(per_client)
    mat = torch.stack([torch.as_tensor(per_client[k]).to(torch.float32)
                       for k in keys])                           # (K, W)
    valid = (torch.as_tensor(n_valid) > 0).to(mat.device)
    nan = torch.full_like(mat, float("nan"))
    masked = torch.where(valid[None, :], mat, nan)
    finite = valid[None, :] & torch.isfinite(mat)
    q = _nanpercentile(masked, QUANTILE_PCTS)                     # (5, K)
    isnan = torch.isnan(masked)
    n = (~isnan).sum(dim=1)
    mx = torch.where(isnan, float("-inf"), masked).amax(dim=1)
    mx = torch.where(n > 0, mx, float("nan"))
    mean = torch.where(isnan, 0.0, masked).sum(dim=1) / n.to(torch.float32)
    arg = torch.argmax(torch.where(finite, mat, float("-inf")), dim=1)
    return {k: {"q": q[:, i], "max": mx[i], "mean": mean[i],
                "argmax": arg[i]}
            for i, k in enumerate(keys)}


def client_stats_to_host(summary: Optional[Dict[str, Dict[str, Any]]],
                         client_ids) -> Dict[str, Dict[str, Any]]:
    """A fetched summary (numpy arrays: ``signals.tree_to_host``; a
    tensor summary is fetched here in one copy) as the ``quantiles``
    dict of a ``client_stats`` event: every key maps to {p5,...,p95,
    max, mean, argmax_client}, non-finite -> None."""
    if not summary:
        return {}
    from commefficient_torch.telemetry.signals import tree_to_host
    summary = tree_to_host(summary)
    ids = np.asarray(client_ids)

    def fin(x) -> Optional[float]:
        x = float(np.asarray(x))
        return x if np.isfinite(x) else None

    out: Dict[str, Dict[str, Any]] = {}
    for key, s in summary.items():
        q = np.asarray(s["q"], np.float64)
        rec: Dict[str, Any] = {
            name: fin(q[i]) for i, name in enumerate(
                ("p5", "p25", "p50", "p75", "p95"))}
        rec["max"] = fin(s["max"])
        rec["mean"] = fin(s["mean"])
        slot = int(np.asarray(s["argmax"]))
        rec["argmax_client"] = (int(ids[slot])
                                if rec["max"] is not None
                                and 0 <= slot < len(ids) else None)
        out[key] = rec
    return out


def quantiles_ordered(rec: Dict[str, Any]) -> bool:
    """p5 <= p25 <= ... <= p95 <= max over the non-null fields of one
    stat's quantile record — the dryrun/test sanity predicate."""
    seq = [rec.get(k) for k in ("p5", "p25", "p50", "p75", "p95", "max")]
    seq = [v for v in seq if v is not None]
    return all(a <= b + 1e-9 for a, b in zip(seq, seq[1:]))


class ParticipationLedger:
    """Host-side participation accounting for the client universe.

    ``observe`` is called every round with the sampler's host-resident
    ``client_ids`` and per-slot valid-datum counts (no device fetch);
    ``snapshot`` folds the ledger into the participation fields of a
    ``client_stats`` event: coverage (distinct participants over the
    universe), per-seen-client sample-count quantiles, and staleness
    (rounds since each seen client last participated).
    """

    estimated = False

    def __init__(self, num_clients: int):
        self.num_clients = max(int(num_clients), 1)
        self._samples: Dict[int, float] = {}
        self._last_round: Dict[int, int] = {}
        self._loss_wins: Dict[int, float] = {}
        self._strikes: Dict[int, float] = {}
        from commefficient_torch.telemetry.population import P2Quantile
        self._p2 = {"obs_count_p50": P2Quantile(0.50),
                    "obs_count_p95": P2Quantile(0.95),
                    "gap_p50": P2Quantile(0.50),
                    "gap_p95": P2Quantile(0.95)}

    def observe(self, rnd: int, client_ids, samples_per_slot=None) -> None:
        # zero-sample slots did not participate: the async scenario
        # engine's partial-participation masking zeroes whole slots
        # (data/scenarios.py), and crediting them would reset the
        # client's staleness without it having contributed anything.
        # Sync rounds never produce these (the sampler only yields
        # slots with data). _aggregate drops them, dedups repeated ids
        # within the batch and returns ascending unique ids — the bulk
        # form of the old per-slot loop (equivalence pinned in
        # tests/test_population.py).
        from commefficient_torch.telemetry.population import _aggregate
        uniq, sums = _aggregate(client_ids, samples_per_slot)
        rnd = int(rnd)
        for c, n in zip(uniq.tolist(), sums.tolist()):
            c = int(c)
            prev = self._last_round.get(c)
            if prev is not None:
                self._p2["gap_p50"].add(rnd - prev)
                self._p2["gap_p95"].add(rnd - prev)
            self._samples[c] = self._samples.get(c, 0.0) + float(n)
            self._last_round[c] = rnd
            self._p2["obs_count_p50"].add(n)
            self._p2["obs_count_p95"].add(n)

    def observe_loss_argmax(self, client_id: Optional[int]) -> None:
        """One round's highest-loss client (the client_stats
        quantiles[...]["argmax_client"] channel); weight 1 per round."""
        if client_id is not None:
            c = int(client_id)
            self._loss_wins[c] = self._loss_wins.get(c, 0.0) + 1.0

    def observe_strikes(self, client_ids: Sequence[int]) -> None:
        """Quarantine strikes this round (core/quarantine.py ledger)."""
        for c in client_ids:
            c = int(c)
            self._strikes[c] = self._strikes.get(c, 0.0) + 1.0

    @property
    def distinct(self) -> int:
        return len(self._samples)

    def state_dict(self) -> Dict[str, Any]:
        """JSON-serializable ledger state for checkpoint meta: a resumed
        run keeps its coverage/staleness view of the universe instead of
        reporting coverage ~0 until every client is re-seen."""
        return {
            "samples": {str(c): n for c, n in self._samples.items()},
            "last_round": {str(c): r
                           for c, r in self._last_round.items()},
            "loss_wins": {str(c): n for c, n in self._loss_wins.items()},
            "strikes": {str(c): n for c, n in self._strikes.items()},
            "p2": {k: v.state_dict() for k, v in self._p2.items()},
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        if d and d.get("sketch"):
            raise ValueError(
                "checkpoint ledger sidecar holds SKETCH participation "
                "state (--population_sketch on) but this run uses the "
                "exact ledger; resume with the ledger mode the "
                "checkpoint was written under (or drop the sidecar to "
                "start coverage accounting fresh)")
        self._samples = {int(c): float(n)
                         for c, n in (d.get("samples") or {}).items()}
        self._last_round = {int(c): int(r)
                            for c, r in (d.get("last_round") or {}).items()}
        # pre-v11 sidecars legitimately lack the heavy-hitter / P2 keys
        self._loss_wins = {int(c): float(n)
                           for c, n in (d.get("loss_wins") or {}).items()}
        self._strikes = {int(c): float(n)
                         for c, n in (d.get("strikes") or {}).items()}
        for k, v in (d.get("p2") or {}).items():
            if k in self._p2:
                self._p2[k].load_state_dict(v)

    def snapshot(self, rnd: int) -> Dict[str, Any]:
        if not self._samples:
            return {"coverage": 0.0, "distinct_clients": 0,
                    "counts_p50": None, "counts_max": None,
                    "staleness_p50": None, "staleness_max": None,
                    "estimated": False}
        counts = np.fromiter(self._samples.values(), np.float64)
        stale = np.asarray([rnd - lr for lr in self._last_round.values()],
                           np.float64)
        return {
            "coverage": len(counts) / self.num_clients,
            "distinct_clients": int(len(counts)),
            "counts_p50": float(np.percentile(counts, 50)),
            "counts_max": float(counts.max()),
            "staleness_p50": float(np.percentile(stale, 50)),
            "staleness_max": float(stale.max()),
            "estimated": False,
        }

    def memory_bytes(self) -> int:
        """Resident-footprint model: ~76B per dict entry (int key +
        float value + slot), 4 dicts — O(population), which is exactly
        why :mod:`~commefficient_torch.telemetry.population` exists."""
        n = (len(self._samples) + len(self._last_round)
             + len(self._loss_wins) + len(self._strikes))
        return n * 76 + 4 * 256

    def population_snapshot(self, rnd: int) -> Dict[str, Any]:
        """The schema-v11 ``population`` event body — same fields as
        PopulationLedger.population_snapshot, exact values, sketch
        parameters null, ``estimated: False``. The obs_count/gap
        quantiles are P2 estimates in BOTH modes (the per-participation
        streams are unbounded); everything else here is exact."""
        def top10(d: Dict[int, float]):
            order = sorted(d, key=lambda c: (-d[c], c))[:10]
            return [[int(c), float(d[c])] for c in order]

        base = self.snapshot(rnd)
        have = bool(self._samples)
        counts = (np.fromiter(self._samples.values(), np.float64)
                  if have else None)
        stale = (np.asarray([rnd - lr
                             for lr in self._last_round.values()],
                            np.float64) if have else None)
        return {
            "round": int(rnd),
            "estimated": False,
            "registered": self.num_clients,
            "distinct": float(len(self._samples)),
            "coverage": base["coverage"],
            "counts_p50": base["counts_p50"],
            "counts_p95": (float(np.percentile(counts, 95))
                           if have else None),
            "counts_max": base["counts_max"],
            "staleness_p50": base["staleness_p50"],
            "staleness_p95": (float(np.percentile(stale, 95))
                              if have else None),
            "staleness_max": base["staleness_max"],
            "obs_count_p50": self._p2["obs_count_p50"].value(),
            "obs_count_p95": self._p2["obs_count_p95"].value(),
            "gap_p50": self._p2["gap_p50"].value(),
            "gap_p95": self._p2["gap_p95"].value(),
            "top_sampled": top10(self._samples),
            "top_loss": top10(self._loss_wins),
            "top_strikes": top10(self._strikes),
            "memory_bytes": float(self.memory_bytes()),
            "cm_epsilon": None,
            "cm_delta": None,
            "hh_k": None,
            "sample_size": None,
        }


def make_ledger(num_clients: int, population_sketch: str = "auto", *,
                seed: int = 0):
    """Ledger construction policy for the drivers: ``auto`` uses the
    exact ledger below :data:`~commefficient_torch.telemetry.population.
    AUTO_SKETCH_THRESHOLD` registered clients and the bounded-memory
    sketch ledger at/above it; ``on``/``off`` force the choice. Both
    ledgers emit identical event fields; only ``estimated`` differs."""
    from commefficient_torch.telemetry.population import (
        AUTO_SKETCH_THRESHOLD, PopulationLedger)
    if population_sketch not in ("auto", "on", "off"):
        raise ValueError(f"population_sketch must be auto|on|off, "
                         f"got {population_sketch!r}")
    sketch = (population_sketch == "on"
              or (population_sketch == "auto"
                  and int(num_clients) >= AUTO_SKETCH_THRESHOLD))
    if sketch:
        return PopulationLedger(num_clients, seed=seed)
    return ParticipationLedger(num_clients)
