"""Shared helpers of the port's benchmarks, the counterpart of the JAX
package's ``bench_common.py``: ``log``, the peaks, the retry of
transient failures and ``timed_rounds``.

What differs from the JAX package, and why:

- **Peaks.** ``peak_flops`` and ``peak_hbm_gbps`` read the port's table
  (``telemetry/utilization.py``). An unknown device, and the CPU, give
  None with a warning naming the kind, so ``mfu`` and the roofline stay
  null: no other chip's figure enters a number measured here.
- **Transient errors.** The JAX markers are kept, so one message gets
  one verdict in both packages, with two exceptions that are never
  retried: a message holding "CUDA error" (CUDA's "busy or unavailable"
  holds a marker, and a CUDA error leaves the context unusable) and
  ``torch.cuda.OutOfMemoryError`` (deterministic).
- **Which rounds are timed.** ``timed_rounds`` calls
  ``runtime.round(..., observe=False)``: the round the drivers run
  between telemetry records. A bench reads none of the in-round signals,
  and a record round adds host dispatch of its own.
- **Retry and state.** ``FedRuntime.round`` writes the participants'
  rows of the state in place, so the warmed state is kept as a host
  copy and each timing attempt starts from a fresh device copy of it,
  made outside the timer: a retried attempt ends in the same bits as one
  that was not retried.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Optional

import torch

from commefficient_torch.telemetry.utilization import (device_kind_of,
                                                       peak_flops_for,
                                                       peak_hbm_for)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a machine without
    one raises (a bench never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benches run on the card; "
                           "pass --device cpu to run on the CPU")
    return dev


def peak_flops(device) -> Optional[float]:
    """Peak bf16 FLOP/s of ``device`` from the port's table, or None (a
    warning names the kind): an unknown device gets a null MFU."""
    kind = device_kind_of(device)
    peak = peak_flops_for(kind)
    if peak is None:
        log(f"WARNING: no peak FLOP/s for device kind {kind!r}; mfu is "
            "null")
    return peak


def peak_hbm_gbps(device) -> Optional[float]:
    """Peak memory bandwidth (GB/s) of ``device`` from the port's table,
    or None (a warning names the kind): the roofline stays null."""
    kind = device_kind_of(device)
    peak = peak_hbm_for(kind)
    if peak is None:
        log(f"WARNING: no peak memory bandwidth for device kind {kind!r}; "
            "the roofline is null")
    return peak


def mfu_of(flops_per_round: Optional[float], rounds: int, dt: float,
           peak: Optional[float]) -> Optional[float]:
    """Model FLOPs a round x rounds / (seconds x peak), or None where the
    count or the peak is unknown."""
    if not flops_per_round or not peak or dt <= 0:
        return None
    return flops_per_round * rounds / dt / peak


def model_flops(build: Callable, input_shape, images: int) -> float:
    """Forward and backward FLOPs of a CV model on ``images`` images of
    NHWC ``input_shape``, counted by ``FlopCounterMode`` (convolutions and
    matrix products) from the shapes on the ``meta`` device, in bf16 as
    the bench's loss computes. ``build(device=)`` makes the model."""
    from torch.utils.flop_counter import FlopCounterMode
    model = build(device="meta")
    flat = torch.zeros(model.num_params, device="meta", requires_grad=True)
    x = torch.zeros((images, *input_shape), device="meta")
    with FlopCounterMode(display=False) as counter:
        model(x, flat, dtype=torch.bfloat16).float().sum().backward()
    return float(counter.get_total_flops())


def time_chain(rec: dict, setup: Callable, reps: int, dev) -> Optional[float]:
    """One arm of a bare-model bench: ``setup()`` builds the arm and
    returns ``(step, v)``, ``step(v) -> (next v, loss)``, each step's
    weights depending on the previous gradient. One warm step (its loss is
    ``rec["first_loss"]``), then ``reps`` chained steps between two
    ``torch.cuda.synchronize()`` calls. Returns the seconds a step, or
    None with ``rec["error"]`` set if the arm fails; the arm's tensors are
    freed either way, so the next arm starts with the card empty."""
    step = v = None
    try:
        step, v = setup()
        v, first = step(v)
        rec["first_loss"] = float(first)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            v, loss = step(v)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / reps
        float(loss)
        return dt
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        return None
    finally:
        step = v = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()


# substrings (lower-cased) of an infra failure worth retrying: the JAX
# package's list, so that one message gets one verdict in both packages
_TRANSIENT_MARKERS = (
    "read body",
    "response body closed",
    "connection reset",
    "connection refused",
    "connection closed",
    "broken pipe",
    "socket closed",
    "deadline exceeded",
    "deadline_exceeded",
    "unavailable",
)


def is_transient(e: BaseException) -> bool:
    """Whether ``e`` is an infra failure to retry. Never a CUDA error (the
    context is unusable after one; "busy or unavailable" would otherwise
    match) nor an out-of-memory error (deterministic)."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    msg = f"{type(e).__name__}: {e}".lower()
    if "cuda error" in msg:
        return False
    return any(m in msg for m in _TRANSIENT_MARKERS)


def with_retries(fn, *, desc: str, tries: int = 4, base_delay: float = 5.0):
    """Run ``fn()``, retrying transient failures with exponential backoff.
    Other exceptions propagate at once; the last attempt's exception
    propagates regardless, so the caller's partial result still prints."""
    for attempt in range(1, tries + 1):
        try:
            return fn()
        except Exception as e:
            if attempt == tries or not is_transient(e):
                raise
            delay = base_delay * (2 ** (attempt - 1))
            log(f"transient failure in {desc} (attempt {attempt}/{tries}): "
                f"{type(e).__name__}: {e}")
            log(f"  retrying in {delay:.0f}s...")
            time.sleep(delay)


def _map_state(state, fn):
    """``state`` (a FedState) with ``fn`` applied to every tensor field."""
    return dataclasses.replace(state, **{
        f.name: fn(getattr(state, f.name))
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def timed_rounds(runtime, round_args, *, warmup: int, rounds: int,
                 desc: str, profiler=None, round_args_fn=None,
                 device="cuda"):
    """Warmup, then ``rounds`` timed rounds of ``runtime`` (a FedRuntime
    on ``device``), each stage retried on a transient failure.

    ``round_args`` are the ``runtime.round`` arguments after the state;
    ``round_args_fn(i)`` instead builds round ``i``'s arguments inside the
    loops (staging that is part of what the bench measures; it must be
    deterministic in ``i``, and its time lands in ``host_s``).
    ``profiler`` (telemetry.ProfilerWindow) traces the timed rounds,
    numbered 1..rounds; its window syncs the card, so a profiled timing
    is not a clean throughput number.

    The warmup starts from ``runtime.init_state()``; its final state is
    copied to the host and the device copy dropped. Each timing attempt
    copies it to the device again, outside the timer. Every clock is
    ``perf_counter``; the completion barrier is
    ``torch.cuda.synchronize()``.

    Returns ``(dt_seconds, last_metrics, phases)``: ``dispatch_s`` (time
    inside the round calls, which for this eager port holds most of the
    device work too), ``device_wait_s`` (the trailing barrier),
    ``host_s`` (the rest: argument staging, loop, profiler syncs), which
    sum to ``dt`` within 1e-6 s, and ``warmup_s``, the seconds before
    the timed window (the first rounds' one-time set-up, the kernels'
    build at first use included)."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def args_of(i):
        return round_args if round_args_fn is None else round_args_fn(i)

    def warm():
        s = runtime.init_state()
        for w in range(warmup):
            s, _ = runtime.round(s, *args_of(w), observe=False)
        sync()
        return s

    log("warmup...")
    t0 = time.perf_counter()
    state = with_retries(warm, desc=f"{desc} warmup")
    warmup_s = time.perf_counter() - t0
    log(f"warmup done in {warmup_s:.1f}s")
    host_state = _map_state(state, lambda t: t.to("cpu", copy=True))
    del state

    def timed():
        # a fresh device copy an attempt: the round writes rows in place
        s = _map_state(host_state, lambda t: t.to(dev, copy=True))
        sync()
        t0 = time.perf_counter()
        dispatch_s = 0.0
        try:
            for i in range(rounds):
                if profiler is not None:
                    profiler.maybe_start(i + 1)
                args = args_of(i)
                td = time.perf_counter()
                s, m = runtime.round(s, *args, observe=False)
                dispatch_s += time.perf_counter() - td
                if profiler is not None:
                    profiler.maybe_stop(i + 1, sync)
        except BaseException:
            # a retried attempt must not leak an open trace
            if profiler is not None:
                profiler.abort()
            raise
        if profiler is not None:
            profiler.finalize(sync)
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        dt = t2 - t0
        # rounded so that the three sum to round(dt, 6)
        dispatch_r, wait_r = round(dispatch_s, 6), round(t2 - t1, 6)
        phases = {"host_s": round(round(dt, 6) - dispatch_r - wait_r, 6),
                  "dispatch_s": dispatch_r, "device_wait_s": wait_r}
        return dt, m, phases

    dt, m, phases = with_retries(timed, desc=f"{desc} timing loop")
    phases["warmup_s"] = round(warmup_s, 3)
    return dt, m, phases
