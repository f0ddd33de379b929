"""Straggler scenario engine and adversary plans, a copy of the JAX
package's ``data/scenarios.py`` (numpy only): deterministic per-cohort
fates for async buffered aggregation (core/async_agg.py) and per-client
adversarial assignments, bitwise the JAX package's for equal
``(seed, cohort_idx)`` and ``(seed, client_id)``.

A scenario decides, for each dispatched cohort:

- **latency**: how many dispatch ticks pass before the cohort's upload
  lands at the server (the AsyncAggregator merges in arrival order, so
  latency is what produces staleness);
- **dropout**: whether the cohort never lands at all (the driver skips
  the compute entirely, nothing merges);
- **partial participation**: which of the round's worker slots take part
  (the rest are masked out, contributing no data but keeping the static
  shapes).

Every fate derives from ``(seed, cohort_idx)`` alone
(``np.random.default_rng((seed, cohort_idx))``), never from call order,
so a run replays bit-identically across resumes and pool sizes.

Latency kinds: ``none`` (0 ticks), ``uniform`` (U[max(latency - spread,
0), latency + spread]), ``lognormal`` (exp(N(ln latency, spread))) and
``stragglers`` (``latency`` ticks for most cohorts, ``latency *
straggler_mult`` for a ``straggler_frac`` minority).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

from commefficient_torch.config import ADVERSARY_KINDS

SCENARIO_KINDS = ("none", "uniform", "lognormal", "stragglers")
# salt folded into the per-client adversary draw so it can never collide
# with the per-cohort latency/dropout stream keyed off the same seed
_ADV_SALT = 0xAD5E


class CohortFate(NamedTuple):
    """What the scenario decided for one cohort."""

    latency: float        # dispatch ticks until the upload lands
    dropped: bool         # True: the cohort never lands (skip compute)
    mask: np.ndarray      # (num_workers, B) bool, participation-reduced
    # per-slot adversarial fates (AdversaryPlan; None when no plan or no
    # client_ids were given): True marks a slot whose client is hostile.
    # Unlike latency/dropout these key off (seed, CLIENT_ID), not the
    # cohort index — the same client misbehaves every time it is sampled.
    adversary: Optional[np.ndarray] = None


class AdversaryPlan:
    """Deterministic per-client adversarial fate assignment.

    A client is adversarial iff its (seed, _ADV_SALT, client_id)-keyed
    uniform draw falls below ``frac`` — independent per client, so the
    assignment never depends on the universe size, the sampling order,
    or which other clients were asked about (the same determinism
    contract as the cohort fates above). The runtime bakes
    :meth:`universe_mask` into the jitted round as a tiny boolean
    constant; the driver uses :meth:`slot_mask` for the per-round
    injected-count telemetry — both read the SAME per-client draw.
    """

    def __init__(self, kind: str, frac: float, *, seed: int = 0,
                 scale: float = 10.0):
        if kind not in ADVERSARY_KINDS:
            raise ValueError(f"unknown adversary kind {kind!r}; "
                             f"choices: {ADVERSARY_KINDS}")
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"adversary frac must be in [0, 1], got {frac}")
        if scale <= 0:
            raise ValueError(f"adversary scale must be > 0, got {scale}")
        self.kind = kind
        self.frac = float(frac)
        self.seed = int(seed)
        self.scale = float(scale)
        # per-client draws are pure in (seed, client_id) but each costs a
        # PCG64 construction, and slot_mask runs once per dispatched
        # cohort — memoize per instance
        self._memo: dict = {}

    def is_adversary(self, client_id: int) -> bool:
        if self.kind == "none" or self.frac <= 0.0:
            return False
        cid = int(client_id)
        hit = self._memo.get(cid)
        if hit is None:
            r = np.random.default_rng(
                (self.seed, _ADV_SALT, cid)).random()
            hit = self._memo[cid] = bool(r < self.frac)
        return hit

    def slot_mask(self, client_ids) -> np.ndarray:
        """(W,) bool: which of the round's slots hold hostile clients."""
        ids = np.asarray(client_ids).reshape(-1)
        return np.fromiter((self.is_adversary(c) for c in ids),
                           dtype=bool, count=len(ids))

    def universe_mask(self, num_clients: int) -> np.ndarray:
        """(num_clients,) bool over the whole client universe."""
        return self.slot_mask(np.arange(int(num_clients)))


def make_adversary(cfg, seed: Optional[int] = None
                   ) -> Optional["AdversaryPlan"]:
    """Build the configured AdversaryPlan from a FedConfig, or None when
    injection is off."""
    if cfg.adversary == "none":
        return None
    return AdversaryPlan(cfg.adversary, cfg.adversary_frac,
                         seed=int(cfg.seed if seed is None else seed),
                         scale=cfg.adversary_scale)


class StragglerScenario:
    """Deterministic per-cohort fate generator (see module docstring)."""

    def __init__(self, kind: str = "none", *, seed: int = 0,
                 latency: float = 1.0, spread: float = 0.5,
                 straggler_frac: float = 0.1,
                 straggler_mult: float = 10.0,
                 dropout: float = 0.0, participation: float = 1.0,
                 adversary: Optional[AdversaryPlan] = None):
        if kind not in SCENARIO_KINDS:
            raise ValueError(f"unknown scenario kind {kind!r}; "
                             f"choices: {SCENARIO_KINDS}")
        if latency < 0 or spread < 0:
            raise ValueError(
                f"latency/spread must be >= 0, got latency={latency} "
                f"spread={spread}")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        if not 0.0 < participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {participation}")
        if not 0.0 <= straggler_frac <= 1.0:
            raise ValueError(
                f"straggler_frac must be in [0, 1], got {straggler_frac}")
        if straggler_mult < 1.0:
            # a multiplier below 1 makes the "stragglers" FASTER than the
            # rest — a silently degenerate two-point mixture that inverts
            # every staleness-study conclusion drawn from it
            raise ValueError(
                f"straggler_mult must be >= 1 (stragglers are SLOWER), "
                f"got {straggler_mult}")
        self.kind = kind
        self.seed = int(seed)
        self.latency = float(latency)
        self.spread = float(spread)
        self.straggler_frac = float(straggler_frac)
        self.straggler_mult = float(straggler_mult)
        self.dropout = float(dropout)
        self.participation = float(participation)
        self.adversary = adversary

    def _latency(self, rng: np.random.Generator) -> float:
        if self.kind == "none":
            return 0.0
        if self.kind == "uniform":
            lo = max(self.latency - self.spread, 0.0)
            return float(rng.uniform(lo, self.latency + self.spread))
        if self.kind == "lognormal":
            mu = math.log(max(self.latency, 1e-9))
            return float(rng.lognormal(mean=mu, sigma=self.spread))
        # stragglers: two-point mixture
        lat = self.latency
        if rng.random() < self.straggler_frac:
            lat *= self.straggler_mult
        return float(lat)

    def fate(self, cohort_idx: int, mask: np.ndarray,
             client_ids=None) -> CohortFate:
        """Fate of cohort ``cohort_idx`` (the global round index).

        The per-cohort draws happen in a FIXED order (latency, dropout,
        participation) from a fresh ``(seed, cohort_idx)``-keyed
        generator, so a fate never depends on which other cohorts were
        asked about. Participation only ever REMOVES slots (mask & keep)
        and always keeps at least one, so a participating cohort always
        carries data. With an :class:`AdversaryPlan` attached and
        ``client_ids`` given, the fate also carries each slot's
        adversarial assignment — keyed off the CLIENT id, never the
        cohort, so it cannot perturb (or be perturbed by) the cohort
        draw sequence above.
        """
        rng = np.random.default_rng((self.seed, int(cohort_idx)))
        latency = self._latency(rng)
        dropped = bool(rng.random() < self.dropout)
        mask = np.asarray(mask)
        out_mask = mask
        if self.participation < 1.0:
            keep = rng.random(mask.shape[0]) < self.participation
            if not keep.any():
                keep[int(rng.integers(mask.shape[0]))] = True
            out_mask = mask & keep[:, None]
        adv = (self.adversary.slot_mask(client_ids)
               if self.adversary is not None and client_ids is not None
               else None)
        return CohortFate(latency, dropped, out_mask, adv)


def make_scenario(cfg, seed: Optional[int] = None
                  ) -> Optional[StragglerScenario]:
    """Build the configured scenario from a FedConfig, or None when the
    configuration is trivial (no latency kind, no dropout, full
    participation) — the AsyncAggregator treats None as
    latency-0/no-drop, skipping the per-cohort RNG work entirely."""
    if (cfg.scenario == "none" and cfg.scenario_dropout == 0.0
            and cfg.scenario_participation >= 1.0):
        return None
    return StragglerScenario(
        cfg.scenario,
        seed=int(cfg.seed if seed is None else seed),
        latency=cfg.scenario_latency,
        spread=cfg.scenario_spread,
        straggler_frac=cfg.scenario_straggler_frac,
        straggler_mult=cfg.scenario_straggler_mult,
        dropout=cfg.scenario_dropout,
        participation=cfg.scenario_participation,
        adversary=make_adversary(cfg, seed=seed))
