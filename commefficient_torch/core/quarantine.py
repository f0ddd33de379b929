"""Host-side quarantine ledger, a copy of the JAX package's
``core/quarantine.py``: bounded re-admission for clients whose uploads
went nonfinite (``--nonfinite_action quarantine``).

The round itself zeroes a nonfinite upload out of the aggregate
(core/runtime.py), so the global model is protected before the host
learns anything. This ledger is the slower control loop on top: it reads
the round's per-client finite flags (one (W,) copy a round) and decides
which clients the next rounds should not dispatch:

- a nonfinite upload is a **strike**: the client is benched for
  ``backoff`` rounds (its sampled slots are masked out by
  data/fed_sampler.mask_blocked: static shapes, zero data);
- after the backoff it is **re-admitted** and retried;
- after ``strikes`` strikes it is **permanently ejected**.

Strikes only accrue on rounds the client took part in (a benched client
cannot strike again: its mask is zeroed). State is a pure function of
the observed (round, client, finite) sequence, so a replayed run
reproduces the same bench and eject decisions.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Set


class QuarantineLedger:
    def __init__(self, backoff: int = 8, strikes: int = 3):
        if backoff < 1:
            raise ValueError(f"backoff must be >= 1, got {backoff}")
        if strikes < 1:
            raise ValueError(f"strikes must be >= 1, got {strikes}")
        self.backoff = int(backoff)
        self.max_strikes = int(strikes)
        self.strikes: Dict[int, int] = {}       # client -> strike count
        self._until: Dict[int, int] = {}        # client -> benched until rnd
        self.ejected: Set[int] = set()
        self.total_strikes = 0

    # ------------------------------------------------------------ observing

    def observe(self, rnd: int, client_ids, finite) -> List[int]:
        """Record one round's per-slot finite flags; returns the clients
        struck THIS round. ``finite`` is the round's (W,) bool vector
        (False = the client's upload was zeroed on device)."""
        struck: List[int] = []
        for cid, fin in zip(list(client_ids), list(finite)):
            if fin:
                continue
            cid = int(cid)
            if cid in self.ejected:
                continue
            n = self.strikes.get(cid, 0) + 1
            self.strikes[cid] = n
            self.total_strikes += 1
            struck.append(cid)
            if n >= self.max_strikes:
                self.ejected.add(cid)
                self._until.pop(cid, None)
            else:
                # benched for the NEXT `backoff` rounds; re-admitted at
                # rnd + backoff + 1
                self._until[cid] = int(rnd) + self.backoff + 1
        return struck

    # ------------------------------------------------------------- queries

    def blocked(self, rnd: int) -> Set[int]:
        """Clients that must not participate at round ``rnd``: the
        permanently ejected plus everyone still inside a backoff."""
        return self.ejected | {c for c, until in self._until.items()
                               if until > int(rnd)}

    def quarantined(self, rnd: int) -> int:
        """Currently benched (backoff running), NOT counting ejections."""
        return sum(1 for until in self._until.values() if until > int(rnd))

    def ids_digest(self, rnd: int) -> Optional[str]:
        """Compact stable digest of the blocked set for the telemetry
        stream: '<n>:<sha1[:12] of the sorted id list>' — readable count,
        diffable identity, bounded size at any population scale."""
        ids = sorted(self.blocked(rnd))
        if not ids:
            return None
        h = hashlib.sha1(",".join(map(str, ids)).encode()).hexdigest()[:12]
        return f"{len(ids)}:{h}"

    def snapshot(self, rnd: int) -> Dict[str, Any]:
        """The defense-event fields this ledger owns."""
        return {
            "quarantined": self.quarantined(rnd),
            "ejected": len(self.ejected),
            "quarantine_ids_digest": self.ids_digest(rnd),
        }

    # -------------------------------------------------------- persistence

    def state_dict(self) -> Dict[str, Any]:
        """JSON-serializable full state, carried in checkpoint meta so a
        resumed run keeps its bench/eject decisions — without this, a
        restart silently RE-ADMITS every benched and permanently-ejected
        client until they strike all over again (keys stringified for
        JSON; ``load_state_dict`` restores the int keys)."""
        return {
            "strikes": {str(c): n for c, n in self.strikes.items()},
            "until": {str(c): u for c, u in self._until.items()},
            "ejected": sorted(self.ejected),
            "total_strikes": self.total_strikes,
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.strikes = {int(c): int(n)
                        for c, n in (d.get("strikes") or {}).items()}
        self._until = {int(c): int(u)
                       for c, u in (d.get("until") or {}).items()}
        self.ejected = {int(c) for c in d.get("ejected") or ()}
        self.total_strikes = int(d.get("total_strikes", 0))
