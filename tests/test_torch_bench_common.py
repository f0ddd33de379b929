"""The port's bench helpers (``commefficient_torch/bench/bench_common.py``)
against the JAX package's ``bench_common.py``, on the CPU: the transient
verdict of every message the JAX package's tests use and of every marker
(one parametrised test; the port's two CUDA exclusions apart), the retry
loop's three outcomes, and ``timed_rounds`` on a narrow ResNet-9 round.
Timing checks are exact arithmetic on the returned phases (1e-6 s: the
phases are rounded to microseconds); the retried attempt is held bitwise.
"""

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_common as jax_bench_common  # noqa: E402

from commefficient_torch.bench import bench_common  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.resnet9 import ResNet9  # noqa: E402

# every message of tests/test_bench_common.py, then each JAX marker
MESSAGES = [
    RuntimeError("INTERNAL: http://127.0.0.1:8093/remote_compile: read "
                 "body: response body closed before all bytes were read"),
    TypeError("unsupported operand type(s)"),
    ValueError("mode 'sketch' requires num_cols"),
    RuntimeError("remote_compile: read body: response body closed before "
                 "all bytes were read"),
    TypeError("boom"),
    RuntimeError("UNAVAILABLE: connection reset by peer"),
    RuntimeError("INTERNAL: Mosaic failed to compile"),
    TimeoutError("timeout"),
] + [RuntimeError(f"the call failed: {m.upper()} (attempt 1)")
     for m in jax_bench_common._TRANSIENT_MARKERS]


@pytest.mark.parametrize("exc", MESSAGES, ids=lambda e: str(e)[:40])
def test_is_transient_matches_jax(exc):
    assert bench_common.is_transient(exc) == jax_bench_common.is_transient(
        exc)


def test_a_cuda_error_is_never_transient():
    """CUDA's own text holds a JAX marker ("unavailable"); the context is
    unusable after a CUDA error, so the port never retries one."""
    e = RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or "
                     "unavailable")
    assert jax_bench_common.is_transient(e)
    assert not bench_common.is_transient(e)


def test_out_of_memory_is_never_transient():
    e = torch.cuda.OutOfMemoryError("allocator unavailable: out of memory")
    assert jax_bench_common.is_transient(e)
    assert not bench_common.is_transient(e)


def _flaky(kind: str, calls: list):
    def fn():
        calls.append(1)
        if kind == "recovers" and len(calls) < 3:
            raise RuntimeError("remote_compile: read body: response body "
                               "closed before all bytes were read")
        if kind == "propagates":
            raise TypeError("boom")
        if kind == "exhausts":
            raise RuntimeError("UNAVAILABLE: connection reset by peer")
        return "ok"
    return fn


@pytest.mark.parametrize("kind", ["recovers", "propagates", "exhausts"])
def test_with_retries_matches_jax(kind, monkeypatch):
    """Same calls, same outcome in both packages (no sleeping)."""
    monkeypatch.setattr(jax_bench_common.time, "sleep", lambda s: None)
    monkeypatch.setattr(bench_common.time, "sleep", lambda s: None)
    outcomes = []
    for mod in (jax_bench_common, bench_common):
        calls = []
        try:
            got = mod.with_retries(_flaky(kind, calls), desc="t", tries=3)
        except Exception as e:
            got = type(e).__name__
        outcomes.append((got, len(calls)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == {"recovers": ("ok", 3),
                           "propagates": ("TypeError", 1),
                           "exhausts": ("RuntimeError", 3)}[kind]


CH = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32}
W, B = 2, 4


class Recorder:
    """Wraps a runtime's ``round``: records every call's ``observe``, its
    seconds and the last state, can sleep, and can raise once at a given
    call."""

    def __init__(self, runtime, sleep_calls=0, sleep_s=0.0, fail_at=None,
                 exc=None):
        self.rt, self.calls, self.observe, self.last = runtime, 0, [], None
        self.seconds = []
        self.sleep_calls, self.sleep_s = sleep_calls, sleep_s
        self.fail_at, self.exc = fail_at, exc
        self.orig = runtime.round
        runtime.round = self.round

    def round(self, state, *args, observe=True):
        t0 = time.perf_counter()
        self.calls += 1
        self.observe.append(observe)
        if self.calls <= self.sleep_calls:
            time.sleep(self.sleep_s)
        if self.calls == self.fail_at:
            raise self.exc
        out = self.orig(state, *args, observe=observe)
        self.last = out[0]
        self.seconds.append(time.perf_counter() - t0)
        return out


def _runtime(**kw):
    model = ResNet9(num_classes=10, channels=CH,
                    generator=torch.Generator().manual_seed(0))
    cfg = FedConfig(**{**dict(
        mode="sketch", error_type="virtual", local_momentum=0.0,
        virtual_momentum=0.9, weight_decay=5e-4, num_workers=W,
        local_batch_size=B, k=200, num_rows=5, num_cols=4096,
        track_bytes=False, num_clients=10), **kw})
    return FedRuntime(cfg, model, make_cv_loss(model, "float32"),
                      device="cpu")


def _args():
    rng = np.random.RandomState(0)
    return (np.arange(W),
            {"image": rng.randn(W, B, 32, 32, 3).astype(np.float32),
             "target": rng.randint(0, 10, (W, B))},
            np.ones((W, B), bool), 0.1)


def test_timed_rounds_keeps_warmup_out_and_phases_sum():
    rt = _runtime()
    rec = Recorder(rt, sleep_calls=2, sleep_s=0.3)
    dt, m, phases = bench_common.timed_rounds(rt, _args(), warmup=2,
                                              rounds=3, desc="t",
                                              device="cpu")
    assert rec.calls == 5 and rec.observe == [False] * 5
    # the warmup's two rounds (and their 0.6 s of sleep) are in warmup_s;
    # dt is the three timed rounds and the loop around them, whose
    # microseconds stay far under the warmup's 0.6 s on a loaded machine
    warm, timed = sum(rec.seconds[:2]), sum(rec.seconds[2:])
    assert phases["warmup_s"] >= warm - 1e-3 and warm >= 0.6
    assert timed <= dt < timed + 0.5
    assert set(phases) == {"host_s", "dispatch_s", "device_wait_s",
                           "warmup_s"}
    total = phases["host_s"] + phases["dispatch_s"] + phases["device_wait_s"]
    assert abs(total - dt) <= 1e-6
    assert phases["dispatch_s"] > 0 and np.isfinite(
        m["results"][0].numpy()).all()


def test_a_retried_attempt_ends_in_the_same_bits(monkeypatch):
    """A transient failure in round 3 of the first timed attempt (after
    two rounds wrote the state's rows in place: local top-k with local
    momentum and error rows): the retry starts from the warmed state's
    host copy and ends bitwise where an attempt without the failure
    ends."""
    monkeypatch.setattr(bench_common.time, "sleep", lambda s: None)
    finals = []
    for fail_at in (None, 1 + 3):
        rt = _runtime(mode="local_topk", error_type="local",
                      local_momentum=0.9)
        assert rt.init_state().client_velocities is not None
        rec = Recorder(rt, fail_at=fail_at, exc=RuntimeError(
            "UNAVAILABLE: connection reset by peer"))
        bench_common.timed_rounds(rt, _args(), warmup=1, rounds=3,
                                  desc="t", device="cpu")
        finals.append(dataclasses.asdict(rec.last))
        assert rec.calls == (4 if fail_at is None else 1 + 3 + 3)
    for name, a in finals[0].items():
        b = finals[1][name]
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name


class FakeProfiler:
    def __init__(self):
        self.log = []

    def maybe_start(self, rnd):
        self.log.append(("start", rnd))

    def maybe_stop(self, rnd, sync):
        self.log.append(("stop", rnd))

    def finalize(self, sync):
        self.log.append(("finalize",))

    def abort(self):
        self.log.append(("abort",))


def test_an_open_profiler_window_is_aborted_when_the_loop_raises():
    rt = _runtime()
    Recorder(rt, fail_at=1 + 2, exc=TypeError("a real bug"))
    prof = FakeProfiler()
    with pytest.raises(TypeError):
        bench_common.timed_rounds(rt, _args(), warmup=1, rounds=3,
                                  desc="t", profiler=prof, device="cpu")
    assert prof.log == [("start", 1), ("stop", 1), ("start", 2), ("abort",)]


def test_round_args_fn_sees_the_warmup_then_the_timed_rounds():
    rt = _runtime()
    seen, args = [], _args()

    def fn(i):
        seen.append(i)
        return args

    bench_common.timed_rounds(rt, None, warmup=2, rounds=3, desc="t",
                              round_args_fn=fn, device="cpu")
    assert seen == [0, 1, 0, 1, 2]


def test_peaks_are_null_off_the_table(capsys):
    """The CPU (and any unknown kind) gets no peak, with a warning that
    names it; the H100 reads the table."""
    assert bench_common.peak_flops("cpu") is None
    assert bench_common.peak_hbm_gbps("cpu") is None
    assert "'cpu'" in capsys.readouterr().err
    assert bench_common.mfu_of(1e12, 2, 1.0, None) is None
    assert bench_common.mfu_of(1e12, 2, 1.0, 989e12) == 2e12 / 989e12


def test_a_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_common.resolve_device("cuda")
    assert bench_common.resolve_device("cpu").type == "cpu"
