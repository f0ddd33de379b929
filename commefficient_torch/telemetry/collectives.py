"""The collectives ledger: the kind, count and size of every launch a
round makes across the ranks, counterpart of the JAX package's
``telemetry/collectives.py``.

The JAX package reads its ledger from the compiled HLO of the round. The
port has no HLO: the ledger records each launch that the round's
``parallel/mesh.py Mesh`` issues while ``recording`` is on. Each entry
holds

- ``kind``: the logical kind the JAX package counts (``all-reduce``,
  ``reduce-scatter``, ``all-gather``, ``all-to-all``,
  ``collective-permute``);
- ``via``: the ``torch.distributed`` call that carried it (the port's
  rank-order all-reduce travels as an ``all_gather_into_tensor``, its
  reduce-scatter as an ``all_to_all_single``, a ring step as a
  ``batch_isend_irecv``);
- ``n_elements``, ``dtype`` (the JAX package's spelling, ``f32``,
  ``s8``, ...) and ``bytes`` of the launch's result, and ``combined_in``,
  its launch index.

Recording is a list append a launch and adds no sync. The launch bounds,
the wire model and the summary are the JAX package's, so a round's
counts are held to the same ceilings in both packages.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

from commefficient_torch.parallel.mesh import record_ledger

COLLECTIVE_KINDS = ("all-reduce", "reduce-scatter", "all-gather",
                    "all-to-all", "collective-permute")

# a round's launch ceilings for every kind (the JAX package's: a layout
# conversion that unrolls into a launch a row or a shard blows through
# one of them by an order of magnitude)
ROUND_COLLECTIVE_LAUNCH_BOUNDS = {
    "all-to-all": 4,
    "reduce-scatter": 2,
    "all-reduce": 12,
    "all-gather": 32,
    "collective-permute": 384,
}


@contextlib.contextmanager
def recording():
    """Record the mesh's launches inside the block into the list it
    yields (nested recordings each see their own launches only)."""
    entries: List[Dict[str, Any]] = []
    before = record_ledger(entries)
    try:
        yield entries
    finally:
        record_ledger(before)


def collective_wire_bytes(entry: Dict[str, Any], n_devices: int) -> float:
    """The bytes a device sends for one launch under ring algorithms (the
    JAX package's model): an all-reduce 2 b (n-1)/n, a reduce-scatter
    b (n-1) (its result is 1/n of its input), an all-gather or
    all-to-all b (n-1)/n, a permute b; none on one device."""
    n = max(int(n_devices), 1)
    if n == 1:
        return 0.0
    b = float(entry["bytes"])
    kind = entry["kind"]
    if kind == "all-reduce":
        return 2.0 * b * (n - 1) / n
    if kind == "reduce-scatter":
        return b * (n - 1)
    if kind in ("all-gather", "all-to-all"):
        return b * (n - 1) / n
    return b


def table_reduce_wire_bytes(entries: List[Dict[str, Any]],
                            n_devices: int) -> float:
    """The wire bytes of a round's table reduce: its reduce-scatters and
    all-to-alls (the float32 or bf16 reduce-scatter, or the int8 wire's
    two all_to_alls of cells and scales)."""
    return sum(collective_wire_bytes(e, n_devices) for e in entries
               if e["kind"] in ("reduce-scatter", "all-to-all"))


def summarize_ledger(entries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The ``collectives`` event's body: launches by kind, their total,
    the total result bytes and the entries."""
    launches_seen: Dict[str, set] = {}
    total_bytes = 0
    for e in entries:
        launches_seen.setdefault(e["kind"], set()).add(e["combined_in"])
        total_bytes += e["bytes"]
    counts = {kind: len(launches) for kind, launches in
              launches_seen.items()}
    return {"n_collectives": sum(counts.values()), "counts": counts,
            "total_bytes": total_bytes, "ops": entries}


def past_bounds(entries: List[Dict[str, Any]]) -> Dict[str, int]:
    """The kinds whose launch count passes its bound, with their counts
    (empty when the round is within every bound)."""
    counts = summarize_ledger(entries)["counts"]
    return {k: v for k, v in counts.items()
            if v > ROUND_COLLECTIVE_LAUNCH_BOUNDS.get(k, 0)}


def round_ledger(runtime, state, client_ids, batch, mask, lr=0.1):
    """One round of ``runtime`` under the recorder: ``(new state, metrics,
    ledger)``. Every rank of the mesh calls it (the round is a
    collective)."""
    with recording() as entries:
        state, metrics = runtime.round(state, client_ids, batch, mask, lr)
    return state, metrics, entries
