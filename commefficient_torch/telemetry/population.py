"""Population-scale participation observability: bounded-memory
streaming summaries of a client universe too large to ledger exactly.

ROADMAP item 2 scales the client POPULATION (>=10^6 registered
clients), and the exact :class:`~commefficient_torch.telemetry.clients.
ParticipationLedger` — a per-client host dict — is the first thing that
breaks there: its memory, its observe loop and its checkpoint sidecar
all grow O(population). This module applies FetchSGD's own move to the
telemetry plane: the population stream is summarized by fixed-size,
seed-keyed sketches instead of held exactly.

:class:`PopulationLedger` keeps the exact ledger's interface
(``observe`` / ``snapshot`` / ``state_dict`` / ``load_state_dict``) and
backs it with four summaries:

- **Count-min sketch** (:class:`CountMinSketch`) over per-client
  cumulative sample counts. With depth ``d`` and width ``w`` the
  estimate for any client overestimates its true count by at most
  ``epsilon * N`` (N = total observed weight) with probability at least
  ``1 - delta``, where ``epsilon = e / w`` and ``delta = e ** -d``
  (Cormode & Muthukrishnan). Defaults d=4, w=65536: epsilon ~= 4.15e-5,
  delta ~= 1.8e-2, table 2 MiB.
- **Space-saving top-K** (:class:`SpaceSaving`) over three keyed
  streams — most-sampled clients, per-round loss-argmax winners (the
  client_stats argmax channel) and quarantine-strike ids. Any item
  whose true weight exceeds ``N / K`` is guaranteed present, and every
  reported count overestimates truth by at most its stored error bound
  (<= min-count <= N/K) (Metwally et al.).
- **P² streaming quantiles** (:class:`P2Quantile`) over the two
  insertion-only per-participation streams: the per-slot sample count
  and the staleness-at-participation gap (rounds since the same client
  last participated). O(1) memory per tracked quantile.
- **KMV distinct sample** (:class:`KMVSample`): the S smallest hashes
  over distinct client ids. Yields the distinct-participant estimate
  ``(S-1)/U_(S)`` (relative error ~ 1/sqrt(S); S=4096 -> ~1.6%) AND a
  uniform sample of distinct clients carrying their EXACT cumulative
  sample count and last-participation round — a client whose hash ranks
  in the bottom S now ranked there at every earlier time, so its stats
  have been tracked since its first appearance. Quantiles over the
  sample estimate the population quantiles with DKW rank error
  ``sqrt(ln(2/delta_q) / (2*S))`` (~1.9% rank at delta_q=2e-13... at
  delta_q=0.01 it is ~1.8e-2); snapshot quantile checks in the dryrun
  gate use this bound.

Memory budget (defaults), independent of population size::

    count-min table   d*w*8            = 2.00 MiB
    space-saving x3   3 * K*(3*8B + ~120B dict/heap overhead)  ~ 0.11 MiB
    KMV sample        S*(3*8B + ~180B dict/heap overhead)      ~ 0.80 MiB
    P2 markers        4 quantiles * O(1)                       ~ 0 MiB
    total                                                      < 3 MiB

— documented ceiling 8 MiB (``MEMORY_BUDGET_BYTES``), asserted by the
``dryrun_multichip`` population gate at 10^6 registered clients.

Everything is deterministic: hashing is seed-keyed splitmix64, batch
processing visits unique ids in ascending order, evictions tie-break on
id — so ``state_dict`` after a kill-at-N/2 resume is BITWISE identical
to an uninterrupted run's (the preemption contract of core/preempt.py).
This module imports numpy only — never jax — so the jitted round's HLO
is invariant to the ledger by construction (identity-gated anyway).

The PyTorch port's copy of the JAX package's ``telemetry/population.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import base64
import heapq
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# documented host-memory ceiling for one PopulationLedger (see module
# docstring for the accounting); the dryrun gate asserts the measured
# footprint at 10^6 registered clients stays under it
MEMORY_BUDGET_BYTES = 8 * 1024 * 1024

# registered-population threshold at which --population_sketch auto
# switches from the exact ledger to the sketch ledger
AUTO_SKETCH_THRESHOLD = 100_000

_U64 = np.uint64
_MASK64 = _U64(0xFFFFFFFFFFFFFFFF)


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _unb64(s: str, dtype, shape=None) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(s), dtype=dtype).copy()
    return a.reshape(shape) if shape is not None else a


def mix64(ids, seed: int) -> np.ndarray:
    """Seed-keyed splitmix64 finalizer over an int array -> uint64.

    The same counter-based construction ops/wire.py uses for rounding
    noise, host-side: statistically uniform, keyed so two ledgers with
    different seeds disagree, and bit-reproducible across platforms
    (pure uint64 wraparound arithmetic)."""
    with np.errstate(over="ignore"):
        z = (np.asarray(ids, np.uint64)
             + _U64(seed & 0xFFFFFFFFFFFFFFFF)
             * _U64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        return z ^ (z >> _U64(31))


def _aggregate(client_ids, samples_per_slot) -> Tuple[np.ndarray, np.ndarray]:
    """Unique-aggregate one round's (ids, counts) into ascending unique
    ids and their summed positive weights (zero-sample slots dropped —
    they did not participate; see ParticipationLedger.observe)."""
    ids = np.asarray(client_ids).reshape(-1).astype(np.int64)
    counts = (np.asarray(samples_per_slot, np.float64).reshape(-1)
              if samples_per_slot is not None
              else np.ones(ids.shape[0], np.float64))
    keep = counts > 0
    ids, counts = ids[keep], counts[keep]
    if ids.size == 0:
        return ids, counts
    uniq, inv = np.unique(ids, return_inverse=True)
    sums = np.bincount(inv, weights=counts, minlength=uniq.size)
    return uniq, sums


class CountMinSketch:
    """Seed-keyed count-min over int ids, float64 counters.

    Overestimates only: ``query(c) >= true(c)`` always, and
    ``query(c) <= true(c) + epsilon * N`` with probability >= 1 - delta
    (epsilon = e/width, delta = e^-depth, N = total added weight)."""

    def __init__(self, depth: int = 4, width: int = 65536, seed: int = 0):
        if width & (width - 1):
            raise ValueError(f"count-min width must be a power of two, "
                             f"got {width}")
        self.depth, self.width, self.seed = int(depth), int(width), int(seed)
        self.table = np.zeros((self.depth, self.width), np.float64)
        self.total = 0.0

    @property
    def epsilon(self) -> float:
        return math.e / self.width

    @property
    def delta(self) -> float:
        return math.exp(-self.depth)

    def _rows(self, ids: np.ndarray) -> np.ndarray:
        mask = _U64(self.width - 1)
        return np.stack([mix64(ids, self.seed * 1000003 + d + 1) & mask
                         for d in range(self.depth)]).astype(np.int64)

    def add(self, ids, weights) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        w = np.asarray(weights, np.float64).reshape(-1)
        if ids.size == 0:
            return
        for d, row in enumerate(self._rows(ids)):
            np.add.at(self.table[d], row, w)
        self.total += float(w.sum())

    def query(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return np.zeros(0, np.float64)
        rows = self._rows(ids)
        est = self.table[0][rows[0]]
        for d in range(1, self.depth):
            est = np.minimum(est, self.table[d][rows[d]])
        return est

    @property
    def nbytes(self) -> int:
        return self.table.nbytes

    def state_dict(self) -> Dict[str, Any]:
        return {"depth": self.depth, "width": self.width, "seed": self.seed,
                "total": self.total, "table": _b64(self.table)}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.depth, self.width = int(d["depth"]), int(d["width"])
        self.seed, self.total = int(d["seed"]), float(d["total"])
        self.table = _unb64(d["table"], np.float64,
                            (self.depth, self.width))


class SpaceSaving:
    """Space-saving top-K heavy hitters (Metwally et al.) over a
    weighted id stream. Deterministic: batches are offered in ascending
    id order and eviction picks the (count, id)-lexicographic minimum.
    ``top()`` reports ``[id, count, err]`` with ``true <= count`` and
    ``count - err <= true`` — err is the eviction floor the id inherited
    (0 for items never evicted), bounded by N/K."""

    def __init__(self, k: int = 256):
        self.k = int(k)
        self._counts: Dict[int, float] = {}
        self._errs: Dict[int, float] = {}
        self.total = 0.0

    def offer(self, ids, weights) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        w = np.asarray(weights, np.float64).reshape(-1)
        if ids.size == 0:
            return
        order = np.argsort(ids, kind="stable")
        ids, w = ids[order], w[order]
        self.total += float(w.sum())
        counts, errs = self._counts, self._errs
        for c, n in zip(ids.tolist(), w.tolist()):
            c = int(c)
            if c in counts:
                counts[c] += n
            elif len(counts) < self.k:
                counts[c] = n
                errs[c] = 0.0
            else:
                # evict the lexicographic (count, id) minimum; the
                # newcomer inherits its count as the error floor
                victim = min(counts, key=lambda i: (counts[i], i))
                floor = counts.pop(victim)
                errs.pop(victim, None)
                counts[c] = floor + n
                errs[c] = floor

    def top(self, n: Optional[int] = None) -> List[List[float]]:
        order = sorted(self._counts, key=lambda i: (-self._counts[i], i))
        if n is not None:
            order = order[:n]
        return [[int(i), float(self._counts[i]), float(self._errs[i])]
                for i in order]

    @property
    def nbytes(self) -> int:
        # 2 dict entries/id: ~(key 28B + float 24B + slot 2*16B) * 2
        return len(self._counts) * 168 + 128

    def state_dict(self) -> Dict[str, Any]:
        ids = np.asarray(sorted(self._counts), np.int64)
        return {"k": self.k, "total": self.total,
                "ids": _b64(ids),
                "counts": _b64(np.asarray(
                    [self._counts[i] for i in ids.tolist()], np.float64)),
                "errs": _b64(np.asarray(
                    [self._errs[i] for i in ids.tolist()], np.float64))}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.k = int(d["k"])
        self.total = float(d["total"])
        ids = _unb64(d["ids"], np.int64)
        counts = _unb64(d["counts"], np.float64)
        errs = _unb64(d["errs"], np.float64)
        self._counts = {int(i): float(c) for i, c in zip(ids, counts)}
        self._errs = {int(i): float(e) for i, e in zip(ids, errs)}


class P2Quantile:
    """Jain & Chlamtac's P² single-quantile estimator: five markers,
    O(1) memory, no samples stored. Exact until 5 observations."""

    def __init__(self, p: float):
        self.p = float(p)
        self.n = 0
        self._init: List[float] = []       # first five observations
        self._q = [0.0] * 5                # marker heights
        self._pos = [0.0] * 5              # marker positions (1-based)

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.n <= 5:
            self._init.append(x)
            if self.n == 5:
                self._init.sort()
                self._q = list(self._init)
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
            return
        q, pos, p = self._q, self._pos, self.p
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        want = [1.0,
                1.0 + (self.n - 1) * p / 2.0,
                1.0 + (self.n - 1) * p,
                1.0 + (self.n - 1) * (1.0 + p) / 2.0,
                float(self.n)]
        for i in (1, 2, 3):
            d = want[i] - pos[i]
            if ((d >= 1.0 and pos[i + 1] - pos[i] > 1.0)
                    or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0)):
                s = 1.0 if d >= 0 else -1.0
                # parabolic (P2) update, clamped to the linear one when
                # it would break marker monotonicity
                qi = q[i] + s / (pos[i + 1] - pos[i - 1]) * (
                    (pos[i] - pos[i - 1] + s) * (q[i + 1] - q[i])
                    / (pos[i + 1] - pos[i])
                    + (pos[i + 1] - pos[i] - s) * (q[i] - q[i - 1])
                    / (pos[i] - pos[i - 1]))
                if not (q[i - 1] < qi < q[i + 1]):
                    j = i + int(s)
                    qi = q[i] + s * (q[j] - q[i]) / (pos[j] - pos[i])
                q[i] = qi
                pos[i] += s

    def value(self) -> Optional[float]:
        if self.n == 0:
            return None
        if self.n < 5:
            s = sorted(self._init)
            return s[min(int(self.p * len(s)), len(s) - 1)]
        return self._q[2]

    def state_dict(self) -> Dict[str, Any]:
        return {"p": self.p, "n": self.n, "init": list(self._init),
                "q": _b64(np.asarray(self._q, np.float64)),
                "pos": _b64(np.asarray(self._pos, np.float64))}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.p, self.n = float(d["p"]), int(d["n"])
        self._init = [float(x) for x in d["init"]]
        self._q = _unb64(d["q"], np.float64).tolist()
        self._pos = _unb64(d["pos"], np.float64).tolist()


class KMVSample:
    """Bottom-S hashes over distinct client ids: distinct-count
    estimator AND a uniform distinct-client sample with EXACT per-member
    cumulative sample counts and last-participation rounds (membership
    is hash-rank-based, so a current member has been a member — and
    tracked — since its first appearance; evicted ids never return
    because the rank threshold only tightens)."""

    def __init__(self, size: int = 4096, seed: int = 0):
        self.size, self.seed = int(size), int(seed)
        self._hash: Dict[int, int] = {}          # id -> uint64 hash
        self._samples: Dict[int, float] = {}
        self._last: Dict[int, int] = {}
        self._heap: List[Tuple[int, int]] = []   # (-hash, -id): max first

    def observe(self, rnd: int, uniq_ids: np.ndarray,
                weights: np.ndarray) -> List[Tuple[float, float]]:
        """Fold one round's unique-aggregated batch in. Returns the
        (gap, weight) pairs of sampled REPEAT participants — an unbiased
        subsample of the staleness-at-participation stream, in ascending
        id order (the P2 feed)."""
        gaps: List[Tuple[float, float]] = []
        if uniq_ids.size == 0:
            return gaps
        hashes = mix64(uniq_ids, self.seed * 9176 + 77)
        rnd = int(rnd)
        for c, h, n in zip(uniq_ids.tolist(), hashes.tolist(),
                           weights.tolist()):
            c, h = int(c), int(h)
            if c in self._hash:
                gaps.append((float(rnd - self._last[c]), float(n)))
                self._samples[c] += float(n)
                self._last[c] = rnd
                continue
            if len(self._hash) < self.size:
                self._insert(c, h, n, rnd)
                continue
            top_h, top_id = -self._heap[0][0], -self._heap[0][1]
            if (h, c) < (top_h, top_id):
                heapq.heappop(self._heap)
                del self._hash[top_id]
                del self._samples[top_id]
                del self._last[top_id]
                self._insert(c, h, n, rnd)
        return gaps

    def _insert(self, c: int, h: int, n: float, rnd: int) -> None:
        self._hash[c] = h
        self._samples[c] = float(n)
        self._last[c] = rnd
        heapq.heappush(self._heap, (-h, -c))

    def __len__(self) -> int:
        return len(self._hash)

    def distinct(self) -> float:
        """Distinct-id estimate: exact below capacity, else the KMV
        estimator (S-1)/U_(S) with U the max kept hash normalized to
        (0, 1]. Relative error ~ 1/sqrt(S)."""
        if len(self._hash) < self.size:
            return float(len(self._hash))
        u = (-self._heap[0][0] + 1) / 2.0 ** 64
        return (self.size - 1) / u

    def counts(self) -> np.ndarray:
        return np.asarray(sorted(self._samples.values()), np.float64)

    def staleness(self, rnd: int) -> np.ndarray:
        return np.asarray(sorted(int(rnd) - np.fromiter(
            self._last.values(), np.int64)), np.float64)

    @property
    def nbytes(self) -> int:
        # 3 dict entries + 1 heap tuple per id: ~(28+24+16*2)*3 + 72
        return len(self._hash) * 324 + 128

    def state_dict(self) -> Dict[str, Any]:
        # canonical order: ascending (hash, id) — heap layout is an
        # implementation detail and never serialized
        order = sorted(self._hash, key=lambda c: (self._hash[c], c))
        ids = np.asarray(order, np.int64)
        return {"size": self.size, "seed": self.seed,
                "ids": _b64(ids),
                "hashes": _b64(np.asarray(
                    [self._hash[c] for c in order], np.uint64)),
                "samples": _b64(np.asarray(
                    [self._samples[c] for c in order], np.float64)),
                "last": _b64(np.asarray(
                    [self._last[c] for c in order], np.int64))}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.size, self.seed = int(d["size"]), int(d["seed"])
        ids = _unb64(d["ids"], np.int64)
        hashes = _unb64(d["hashes"], np.uint64)
        samples = _unb64(d["samples"], np.float64)
        last = _unb64(d["last"], np.int64)
        self._hash = {int(c): int(h) for c, h in zip(ids, hashes)}
        self._samples = {int(c): float(n) for c, n in zip(ids, samples)}
        self._last = {int(c): int(r) for c, r in zip(ids, last)}
        self._heap = [(-int(h), -int(c)) for c, h in zip(ids, hashes)]
        heapq.heapify(self._heap)


# the population event's non-envelope fields, in emit order — mirrored
# by the jax-free literal in scripts/teleview.py (pinned by test)
POPULATION_KEYS = (
    "round", "estimated", "registered", "distinct", "coverage",
    "counts_p50", "counts_p95", "counts_max",
    "staleness_p50", "staleness_p95", "staleness_max",
    "obs_count_p50", "obs_count_p95", "gap_p50", "gap_p95",
    "top_sampled", "top_loss", "top_strikes",
    "memory_bytes", "cm_epsilon", "cm_delta", "hh_k", "sample_size",
)


class PopulationLedger:
    """Sketch-backed drop-in for ParticipationLedger (same ``observe`` /
    ``snapshot`` / ``state_dict`` / ``load_state_dict`` interface), host
    memory bounded by :data:`MEMORY_BUDGET_BYTES` independent of the
    population. ``snapshot`` carries ``estimated: True`` — the sketch
    never fakes exactness (the exact ledger's snapshot says False)."""

    estimated = True

    def __init__(self, num_clients: int, *, seed: int = 0,
                 cm_depth: int = 4, cm_width: int = 65536,
                 hh_k: int = 256, sample_size: int = 4096):
        self.num_clients = max(int(num_clients), 1)
        self.seed = int(seed)
        self._cm = CountMinSketch(cm_depth, cm_width, seed=self.seed)
        self._hh_sampled = SpaceSaving(hh_k)
        self._hh_loss = SpaceSaving(hh_k)
        self._hh_strikes = SpaceSaving(hh_k)
        self._kmv = KMVSample(sample_size, seed=self.seed)
        self._p2 = {"obs_count_p50": P2Quantile(0.50),
                    "obs_count_p95": P2Quantile(0.95),
                    "gap_p50": P2Quantile(0.50),
                    "gap_p95": P2Quantile(0.95)}

    # ------------------------------------------------------ ingest
    def observe(self, rnd: int, client_ids, samples_per_slot=None) -> None:
        uniq, sums = _aggregate(client_ids, samples_per_slot)
        if uniq.size == 0:
            return
        self._cm.add(uniq, sums)
        self._hh_sampled.offer(uniq, sums)
        for n in sums.tolist():
            self._p2["obs_count_p50"].add(n)
            self._p2["obs_count_p95"].add(n)
        for gap, _w in self._kmv.observe(rnd, uniq, sums):
            self._p2["gap_p50"].add(gap)
            self._p2["gap_p95"].add(gap)

    def observe_loss_argmax(self, client_id: Optional[int]) -> None:
        """One round's highest-loss client (the client_stats
        quantiles[...]["argmax_client"] channel); weight 1 per round."""
        if client_id is not None:
            self._hh_loss.offer([int(client_id)], [1.0])

    def observe_strikes(self, client_ids: Sequence[int]) -> None:
        """Quarantine strikes this round (core/quarantine.py ledger);
        weight 1 per strike."""
        ids = np.asarray(list(client_ids), np.int64).reshape(-1)
        if ids.size:
            self._hh_strikes.offer(ids, np.ones(ids.size))

    # ------------------------------------------------------ queries
    def participation_count(self, client_ids) -> np.ndarray:
        """Count-min estimate of per-client cumulative sample counts
        (overestimate <= cm_epsilon * total w.p. >= 1 - cm_delta)."""
        return self._cm.query(client_ids)

    @property
    def distinct(self) -> int:
        return int(round(self._kmv.distinct()))

    def memory_bytes(self) -> int:
        """Resident-footprint accounting (the documented budget model;
        the dryrun gate cross-checks it against a deep getsizeof)."""
        return int(self._cm.nbytes + self._hh_sampled.nbytes
                   + self._hh_loss.nbytes + self._hh_strikes.nbytes
                   + self._kmv.nbytes + 4 * 256)

    def snapshot(self, rnd: int) -> Dict[str, Any]:
        """Exact-ledger-compatible participation fields (client_stats
        event), plus ``estimated: True``. counts_max is the space-saving
        top-1 count — an upper estimate of the true maximum (the true
        argmax is either stored, with count >= truth, or bounded by the
        structure's minimum count)."""
        if len(self._kmv) == 0:
            return {"coverage": 0.0, "distinct_clients": 0,
                    "counts_p50": None, "counts_max": None,
                    "staleness_p50": None, "staleness_max": None,
                    "estimated": True}
        counts = self._kmv.counts()
        stale = self._kmv.staleness(rnd)
        top = self._hh_sampled.top(1)
        return {
            "coverage": min(1.0, self._kmv.distinct() / self.num_clients),
            "distinct_clients": self.distinct,
            "counts_p50": float(np.percentile(counts, 50)),
            "counts_max": float(top[0][1]) if top else float(counts.max()),
            "staleness_p50": float(np.percentile(stale, 50)),
            "staleness_max": float(stale.max()),
            "estimated": True,
        }

    def population_snapshot(self, rnd: int) -> Dict[str, Any]:
        """The schema-v11 ``population`` event body (POPULATION_KEYS)."""
        base = self.snapshot(rnd)
        counts = self._kmv.counts()
        stale = self._kmv.staleness(rnd)
        have = counts.size > 0
        return {
            "round": int(rnd),
            "estimated": True,
            "registered": self.num_clients,
            "distinct": float(self._kmv.distinct()),
            "coverage": base["coverage"],
            "counts_p50": base["counts_p50"],
            "counts_p95": float(np.percentile(counts, 95)) if have else None,
            "counts_max": base["counts_max"],
            "staleness_p50": base["staleness_p50"],
            "staleness_p95": (float(np.percentile(stale, 95))
                              if have else None),
            "staleness_max": base["staleness_max"],
            "obs_count_p50": self._p2["obs_count_p50"].value(),
            "obs_count_p95": self._p2["obs_count_p95"].value(),
            "gap_p50": self._p2["gap_p50"].value(),
            "gap_p95": self._p2["gap_p95"].value(),
            "top_sampled": [e[:2] for e in self._hh_sampled.top(10)],
            "top_loss": [e[:2] for e in self._hh_loss.top(10)],
            "top_strikes": [e[:2] for e in self._hh_strikes.top(10)],
            "memory_bytes": float(self.memory_bytes()),
            "cm_epsilon": self._cm.epsilon,
            "cm_delta": self._cm.delta,
            "hh_k": self._hh_sampled.k,
            "sample_size": self._kmv.size,
        }

    # ------------------------------------------------------ persistence
    def state_dict(self) -> Dict[str, Any]:
        """Checkpoint-sidecar state (core/preempt.py). Canonical and
        bitwise-stable: identical observation streams yield identical
        JSON regardless of kill/resume boundaries."""
        return {
            "sketch": True,
            "num_clients": self.num_clients,
            "seed": self.seed,
            "cm": self._cm.state_dict(),
            "hh_sampled": self._hh_sampled.state_dict(),
            "hh_loss": self._hh_loss.state_dict(),
            "hh_strikes": self._hh_strikes.state_dict(),
            "kmv": self._kmv.state_dict(),
            "p2": {k: v.state_dict() for k, v in self._p2.items()},
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        if not d:
            return
        if not d.get("sketch"):
            raise ValueError(
                "checkpoint ledger sidecar holds EXACT participation "
                "state but this run uses --population_sketch on; resume "
                "with the ledger mode the checkpoint was written under "
                "(or drop the sidecar to start coverage accounting fresh)")
        self.num_clients = int(d.get("num_clients", self.num_clients))
        self.seed = int(d.get("seed", self.seed))
        self._cm.load_state_dict(d["cm"])
        self._hh_sampled.load_state_dict(d["hh_sampled"])
        self._hh_loss.load_state_dict(d["hh_loss"])
        self._hh_strikes.load_state_dict(d["hh_strikes"])
        self._kmv.load_state_dict(d["kmv"])
        for k, v in (d.get("p2") or {}).items():
            if k in self._p2:
                self._p2[k].load_state_dict(v)
