"""Federated round scheduler with static shapes: a copy of
the JAX package's ``data/fed_sampler.py`` (numpy only), so the two packages
sample identical rounds for the same (seed, epoch).

Each round is ``(client_ids (W,), idx (W, B) flat dataset indices, mask
(W, B) validity)``. Data order is permuted within each client per epoch;
every round samples ``num_workers`` clients uniformly without replacement
from the clients with data left; each contributes up to B of its remaining
items; an epoch ends when fewer than ``num_workers`` clients have data
left (reference fed_sampler.py:5-71 and cv_train.py:205-219).
``local_batch_size == -1`` takes each client's whole dataset, padded to
``max_client_batch`` (a larger client gives a chunk a round).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np


class Round(NamedTuple):
    client_ids: np.ndarray  # (num_workers,)
    idx: np.ndarray         # (num_workers, B)
    mask: np.ndarray        # (num_workers, B)


def mask_blocked(rnd: Round, blocked) -> Round:
    """``rnd`` with the slots of the clients in ``blocked`` (the
    quarantine ledger's benched and ejected ids, core/quarantine.py)
    masked out: static shapes, no data. The Round is never mutated (a
    prefetched round is shared with the pipeline's thread); the decision
    is taken at dispatch against the ledger's current view."""
    if not blocked:
        return rnd
    hit = np.fromiter((int(c) in blocked for c in rnd.client_ids),
                      dtype=bool, count=len(rnd.client_ids))
    if not hit.any():
        return rnd
    return rnd._replace(mask=rnd.mask & ~hit[:, None])


class FedSampler:
    def __init__(self, data_per_client: np.ndarray, num_workers: int,
                 local_batch_size: int, max_client_batch: int = 512,
                 seed: Optional[int] = None):
        self.data_per_client = np.asarray(data_per_client, dtype=np.int64)
        self.num_clients = len(self.data_per_client)
        self.num_workers = min(num_workers, self.num_clients)
        if local_batch_size == -1:
            self.batch = int(max_client_batch)
        else:
            self.batch = int(local_batch_size)
        self.rng = np.random.RandomState(seed)
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.data_per_client)[:-1]])

    def epoch_rounds(self) -> int:
        """Upper bound on rounds this epoch (exact when all clients are the
        same size)."""
        per_client_rounds = -(-self.data_per_client // self.batch)
        return int(per_client_rounds.sum()) // self.num_workers

    def __iter__(self) -> Iterator[Round]:
        perms = [self.offsets[c] + self.rng.permutation(
            self.data_per_client[c]) for c in range(self.num_clients)]
        cursor = np.zeros(self.num_clients, dtype=np.int64)
        while True:
            remaining = self.data_per_client - cursor
            alive = np.where(remaining > 0)[0]
            if len(alive) < self.num_workers:
                return
            chosen = self.rng.choice(alive, self.num_workers, replace=False)

            W, B = self.num_workers, self.batch
            client_ids = np.zeros(W, dtype=np.int64)
            idx = np.zeros((W, B), dtype=np.int64)
            mask = np.zeros((W, B), dtype=bool)
            for slot, c in enumerate(chosen):
                n = int(min(remaining[c], B))
                start = cursor[c]
                idx[slot, :n] = perms[c][start:start + n]
                mask[slot, :n] = True
                client_ids[slot] = c
                cursor[c] += n
            yield Round(client_ids, idx, mask)


class ValSampler:
    """Static-shape validation chunks ``(idx (B,), mask (B,))``; the last
    chunk wraps to the start of the set and masks the wrapped items."""

    def __init__(self, num_items: int, batch_size: int):
        self.num_items = num_items
        self.batch = int(batch_size)

    def __iter__(self):
        for start in range(0, self.num_items, self.batch):
            n = min(self.batch, self.num_items - start)
            idx = np.arange(start, start + self.batch,
                            dtype=np.int64) % self.num_items
            mask = np.zeros(self.batch, dtype=bool)
            mask[:n] = True
            yield idx, mask
