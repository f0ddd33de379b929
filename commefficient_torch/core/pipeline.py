"""The round input pipeline, counterpart of the JAX package's
``core/pipeline.py`` (``RoundPipeline``, ``RoundInput``): a worker thread
fetches the next rounds' batches, at most ``depth`` ahead, while the
current round runs; and its server-side twin, ``DecodeOverlapRound``
(``--decode_overlap``), which splits a round so that the host could stage
round t+1 while the card decodes round t (the sketch tail's host read
still blocks it; see the class).

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


class DecodeOverlapRound:
    """``--decode_overlap``: one federated round as its two halves, the
    counterpart of the JAX package's ``core/pipeline.py
    DecodeOverlapRound``. ``round`` enqueues the client half
    (``FedRuntime.cohort``, the synchronous round's client code), records
    a CUDA event on the current stream (``cohort_done``), enqueues the
    server half (``FedRuntime.decode``, its server tail) and records a
    second event behind it (``decode_done``), then returns; the driver
    waits on the first event (``wait_cohort``) and not on the decode, so
    the decode of round t can run on the card while the host stages round
    t+1. The decode half reads nothing back to the host: its sparse
    re-encode's cell sums run in a kernel
    (``ops/circulant_kernels.py cell_sum``), and chip_smoke.py fails on
    any host sync it finds there (the client half's own reads stay, and
    end the overlap at round t+1's cohort). ``decode_done.query()``
    tells a caller whether the decode still ran when ``wait_cohort``
    returned. The rounds are bitwise those of ``FedRuntime.round``: the
    port keys every draw by the round, so splitting it changes no draw.

    The metrics follow ``FedRuntime.round``'s contract, with ``signals``
    and ``layer_signals`` None (the runtime prints the NOTE once)."""

    def __init__(self, runtime):
        if not runtime.cfg.decode_overlap:
            raise ValueError(
                "DecodeOverlapRound needs a runtime built with "
                "cfg.decode_overlap=True (its cohort and decode halves "
                "exist only then)")
        self.runtime = runtime
        self.cohort_done = self.decode_done = None

    def init_state(self):
        """The runtime's: the adapter stands in for it in loops that build
        their state through the object they call ``round`` on."""
        return self.runtime.init_state()

    def round(self, state, client_ids, batch, mask, lr, observe=True):
        """``FedRuntime.round``'s contract: ``(state', metrics)``.
        ``observe=False`` skips the client statistics, as there."""
        rt = self.runtime
        with tracing.span("cohort_dispatch"):
            state, payload = rt.cohort(state, client_ids, batch, mask, lr,
                                       observe)
        if rt.device.type == "cuda":
            self.cohort_done = torch.cuda.Event()
            self.cohort_done.record(torch.cuda.current_stream(rt.device))
        with tracing.span("decode_dispatch"):
            state = rt.decode(state, payload["sum"], payload["n_total"], lr)
        if rt.device.type == "cuda":
            self.decode_done = torch.cuda.Event()
            self.decode_done.record(torch.cuda.current_stream(rt.device))
        metrics = {
            "results": payload["results"],
            "n_valid": payload["n_valid"],
            "download_bytes": payload["download_bytes"],
            "upload_bytes": payload["upload_bytes"],
            "signals": None,
            "layer_signals": None,
            "client_stats": payload["client_stats"],
            "defense": payload["defense"],
            "client_finite": payload["client_finite"],
        }
        return state, metrics

    def wait_cohort(self) -> None:
        """Block the host until the last round's client half has run on
        the card (its decode may still be running)."""
        if self.cohort_done is not None:
            self.cohort_done.synchronize()
