"""The round input pipeline, counterpart of the JAX package's
``core/pipeline.py`` (``RoundPipeline``, ``RoundInput``): a worker thread
fetches the next rounds' batches, at most ``depth`` ahead, while the
current round runs.

Pipelining does not change what trains. The sampler is iterated by one
thread only (the worker, or the caller when inline), in round order, so
its draws are the same either way; the device store's draws are keyed by
the global round; a host transform's generator advances once a gather,
in round order, on that one thread. ``enabled=False`` (``--no_pipeline``)
runs the same fetch inline on the caller's thread.

On the card the fetch runs on a side stream of its own, never on the
round's: the host gather's upload (from pinned memory) and the store's
gather overlap the round's kernels. The fetch ends by recording an event
on that stream and waiting for it on the fetching thread, so ``fetch_s``
is the data path's whole time; the consumer's stream waits for the event
too, and every tensor of the batch is recorded on the consumer's stream,
so the caching allocator does not hand its memory back to the side
stream while the round reads it.

An exception in the worker's fetch is raised again on the consumer's next
``__next__``. ``close()`` (idempotent; also the context manager's exit)
stops the worker, drains the queue so that a blocked put wakes, and joins
the thread.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Optional

import torch

from commefficient_torch.telemetry import tracing

_ITEM, _DONE, _ERR = "item", "done", "err"


class RoundInput(NamedTuple):
    """One fetched round, as the driver consumes it."""

    rnd: Any            # the sampler's Round (client_ids, idx, mask)
    global_round: int   # 1-based global round (the schedule's and draws' key)
    batch: Any          # dict of tensors on the device
    wait_s: float       # seconds the consumer waited for this round
    fetch_s: float      # seconds the fetch took (the worker's wall)


class RoundPipeline:
    """Iterator of ``RoundInput`` over one epoch's sampler ``rounds``.

    ``fetch(rnd, global_round) -> batch`` derives its randomness from
    ``global_round`` or advances a private generator once a call.
    Rounds are numbered ``start_round + 1, ...``; ``max_rounds`` caps them
    (the epoch's fractional cap, counted with the skipped ones); ``skip``
    consumes the first rounds of the sampler without fetching them (a
    resume inside an epoch). ``depth`` bounds the queue; ``enabled=False``
    fetches inline, with no thread. ``device``: a CUDA device runs the
    fetch on a side stream (see the module's docstring)."""

    def __init__(self, rounds: Iterable, fetch: Callable[[Any, int], Any],
                 *, start_round: int, max_rounds: Optional[int] = None,
                 depth: int = 2, enabled: bool = True, skip: int = 0,
                 device=None):
        if skip < 0:
            raise ValueError(f"skip must be >= 0, got {skip}")
        if enabled and depth < 1:
            raise ValueError(
                f"RoundPipeline(depth={depth}) with enabled=True: the "
                "prefetcher needs a queue bound >= 1 (2 = double-"
                "buffered); pass enabled=False to fetch inline")
        self._rounds = iter(rounds)
        self._fetch = fetch
        self._start = int(start_round)
        self._max = None if max_rounds is None else int(max_rounds)
        self._skip = int(skip)
        device = torch.device(device) if device is not None else None
        self._stream = (torch.cuda.Stream(device)
                        if device is not None and device.type == "cuda"
                        else None)
        self.threaded = bool(enabled)
        self._exhausted = False
        self._thread: Optional[threading.Thread] = None
        if self.threaded:
            self._q: queue.Queue = queue.Queue(maxsize=int(depth))
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._worker, name="round-prefetch", daemon=True)
            self._thread.start()
        else:
            self._inline = self._inline_iter()

    def __iter__(self) -> Iterator[RoundInput]:
        return self

    def __next__(self) -> RoundInput:
        if not self.threaded:
            return self._ready(next(self._inline))
        if self._exhausted:
            raise StopIteration
        t0 = time.perf_counter()
        with tracing.span("data_wait"):
            kind, payload = self._q.get()
        wait = time.perf_counter() - t0
        if kind is _ERR:
            self._exhausted = True
            self.close()
            raise payload
        if kind is _DONE:
            self._exhausted = True
            self.close()
            raise StopIteration
        return self._ready(payload._replace(wait_s=wait))

    def _rounds_to_fetch(self):
        """``(global round, sampler round)`` of each round to fetch."""
        for i, rnd in enumerate(self._rounds):
            if self._max is not None and i >= self._max:
                return
            if i >= self._skip:
                yield self._start + i + 1, rnd

    def _timed_fetch(self, rnd, g: int):
        """``(batch, event or None, seconds)``: the fetch, on the side
        stream on the card, waited for on this thread."""
        t0 = time.perf_counter()
        event = None
        with tracing.span("data_fetch"):
            if self._stream is None:
                batch = self._fetch(rnd, g)
            else:
                with torch.cuda.stream(self._stream):
                    batch = self._fetch(rnd, g)
                    event = torch.cuda.Event()
                    event.record(self._stream)
                event.synchronize()
        return batch, event, time.perf_counter() - t0

    def _ready(self, item):
        """The ``RoundInput`` of a fetched item, its batch ordered before
        the consumer stream's next work."""
        rnd, g, batch, event, wait, fetch = item
        if event is not None:
            stream = torch.cuda.current_stream(self._stream.device)
            stream.wait_event(event)
            for leaf in batch.values():
                leaf.record_stream(stream)
        return RoundInput(rnd, g, batch, wait, fetch)

    def _inline_iter(self):
        for g, rnd in self._rounds_to_fetch():
            batch, event, dt = self._timed_fetch(rnd, g)
            # inline the consumer waits for the whole fetch
            yield _Fetched(rnd, g, batch, event, dt, dt)

    def _worker(self) -> None:
        try:
            for g, rnd in self._rounds_to_fetch():
                if self._stop.is_set():
                    return
                batch, event, dt = self._timed_fetch(rnd, g)
                if not self._put((_ITEM, _Fetched(rnd, g, batch, event,
                                                  0.0, dt))):
                    return
        except BaseException as e:  # noqa: BLE001 (relayed to the consumer)
            self._put((_ERR, e))
            return
        self._put((_DONE, None))

    def _put(self, msg) -> bool:
        """A bounded put that a concurrent ``close()`` can always wake."""
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def close(self, join_timeout: float = 30.0) -> None:
        """Stops the worker and joins it; fetched rounds not consumed are
        dropped (a host transform's generator may have advanced past
        them). Idempotent."""
        if self._thread is None:
            return
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=join_timeout)
        if self._thread.is_alive():
            print(f"WARNING: the round-prefetch thread did not join within "
                  f"{join_timeout} s (a fetch hung?); left as a daemon",
                  file=sys.stderr)
        self._thread = None

    def __enter__(self) -> "RoundPipeline":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class _Fetched(NamedTuple):
    rnd: Any
    global_round: int
    batch: Any
    event: Any
    wait_s: float
    fetch_s: float
