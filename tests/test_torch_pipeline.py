"""The port's round input pipeline (``core/pipeline.py``), the cases of
the JAX package's ``tests/test_pipeline.py``: order and round numbering
as inline, an exception in the fetch raised on the consumer, no thread
left behind (on exhaustion, on a break, after an error), the fractional
cap, the resume skip, the inline mode, the depth refusal, and the wait
against the fetch. Then the driver end to end on the CPU: the same run
pipelined and ``--no_pipeline``, on the device store (whose fetch the
driver runs inline either way) and on the host path, trains on
bitwise-equal batches (a digest a round) and gives
bitwise-equal losses and final weights.
"""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_round import CH  # noqa: F401,E402 (installs the import fix)

from commefficient_tpu.core.pipeline import \
    RoundPipeline as JRoundPipeline  # noqa: E402

from commefficient_torch import cv_train  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core import driver  # noqa: E402
from commefficient_torch.core.pipeline import (RoundInput,  # noqa: E402
                                               RoundPipeline)


@pytest.fixture(autouse=True)
def _runs_under_tmp(tmp_path, monkeypatch):
    """The entry points' default run directory (``runs/<stamp>_...``, the
    telemetry stream) lands under the test's tmp dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


JOIN_S = 10.0
MAKE_FETCH = driver.make_fetch


def _rounds(n):
    return [{"id": i} for i in range(n)]


def _no_prefetch_threads():
    deadline = time.monotonic() + JOIN_S
    while time.monotonic() < deadline:
        if all(t.name != "round-prefetch" for t in threading.enumerate()):
            return True
        time.sleep(0.01)
    return False


def test_overlap_hides_the_fetch():
    """A slow fetch beside a slow consumer: the wall is well under the
    serial sum, and after the first round the consumer hardly waits."""
    n, fetch_s, consume_s = 6, 0.05, 0.05

    def fetch(rnd, g):
        time.sleep(fetch_s)
        return {"g": g}

    t0 = time.perf_counter()
    waits = []
    with RoundPipeline(_rounds(n), fetch, start_round=0, depth=2) as pipe:
        for item in pipe:
            assert isinstance(item, RoundInput)
            waits.append(item.wait_s)
            time.sleep(consume_s)
    wall = time.perf_counter() - t0
    assert wall < n * (fetch_s + consume_s) * 0.9, wall
    assert sum(waits[1:]) < fetch_s * (n - 1) * 0.8, waits
    assert _no_prefetch_threads()


@pytest.mark.parametrize("skip", [0, 2])
def test_order_and_numbering_match_inline_and_the_reference(skip):
    """Rounds come out in sampler order, numbered from start_round + 1
    past the skipped ones, and a stateful fetch generator advances alike
    pipelined, inline and in the JAX package's pipeline."""
    def run(cls, enabled):
        rng = np.random.RandomState(7)
        calls, out = [], []

        def fetch(rnd, g):
            calls.append((rnd["id"], g))
            return {"x": rng.randn(3) + g}

        with cls(_rounds(6), fetch, start_round=10, enabled=enabled,
                 skip=skip, max_rounds=5) as pipe:
            for item in pipe:
                out.append((item.rnd["id"], item.global_round,
                            item.batch["x"]))
        return calls, out

    ref_calls, ref = run(JRoundPipeline, False)
    assert ref_calls == [(i, 11 + i) for i in range(skip, 5)]
    for cls, enabled in ((RoundPipeline, True), (RoundPipeline, False),
                         (JRoundPipeline, True)):
        calls, out = run(cls, enabled)
        assert calls == ref_calls
        assert [o[:2] for o in out] == [r[:2] for r in ref]
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a[2], b[2])
    assert _no_prefetch_threads()


def test_fetch_error_is_raised_on_the_consumer():
    def fetch(rnd, g):
        if rnd["id"] == 2:
            raise ValueError("boom in fetch")
        return {"g": g}

    pipe = RoundPipeline(_rounds(5), fetch, start_round=0, depth=1)
    got = []
    with pytest.raises(ValueError, match="boom in fetch"):
        for item in pipe:
            got.append(item.global_round)
    assert got == [1, 2]
    assert pipe._thread is None and _no_prefetch_threads()
    inline = RoundPipeline(_rounds(5), fetch, start_round=0, enabled=False)
    with pytest.raises(ValueError, match="boom in fetch"):
        list(inline)


def test_early_close_leaves_no_thread():
    pipe = RoundPipeline(_rounds(100), lambda r, g: {"g": g},
                         start_round=0, depth=2)
    with pipe:
        for _ in pipe:
            break
    assert pipe._thread is None and _no_prefetch_threads()
    pipe.close()                    # idempotent


def test_max_rounds_cap_and_exhaustion():
    with RoundPipeline(_rounds(10), lambda r, g: g, start_round=4,
                       max_rounds=3) as pipe:
        assert [i.global_round for i in pipe] == [5, 6, 7]
    with RoundPipeline(_rounds(2), lambda r, g: g, start_round=0,
                       max_rounds=8) as pipe:
        assert [i.global_round for i in pipe] == [1, 2]
    assert _no_prefetch_threads()


def test_inline_mode_runs_no_thread():
    pipe = RoundPipeline(_rounds(3), lambda r, g: {"g": g}, start_round=0,
                         enabled=False, depth=0)
    assert not pipe.threaded and pipe._thread is None
    items = list(pipe)
    assert [i.global_round for i in items] == [1, 2, 3]
    assert all(i.wait_s == i.fetch_s for i in items)
    pipe.close()


def test_depth_and_skip_refusals():
    for depth in (0, -1):
        with pytest.raises(ValueError, match="queue bound"):
            RoundPipeline(_rounds(3), lambda r, g: g, start_round=0,
                          depth=depth)
    with pytest.raises(ValueError, match="skip"):
        RoundPipeline(_rounds(3), lambda r, g: g, start_round=0, skip=-1,
                      enabled=False)
    with pytest.raises(ValueError, match="--prefetch_depth"):
        FedConfig(prefetch_depth=0)
    with pytest.raises(ValueError, match="--prefetch_depth"):
        FedConfig(prefetch_depth=0, pipeline=False)
    assert _no_prefetch_threads()


def test_wait_against_fetch():
    """Pipelined, ``wait_s`` is the consumer's queue wait and ``fetch_s``
    the fetch's own time."""
    def fetch(rnd, g):
        time.sleep(0.03)
        return g

    items = []
    with RoundPipeline(_rounds(4), fetch, start_round=0) as pipe:
        for item in pipe:
            items.append(item)
            time.sleep(0.1)
    assert all(i.fetch_s >= 0.02 for i in items)
    assert all(i.wait_s < 0.02 for i in items[1:]), [i.wait_s
                                                     for i in items]


def _digest(batch) -> str:
    h = hashlib.sha256()
    for key in sorted(batch):
        h.update(key.encode())
        h.update(batch[key].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _run(tmp_path, monkeypatch, extra, host_path):
    digests = []

    def recording(*args, **kw):
        fetch = MAKE_FETCH(*args, **kw)

        def wrapped(rnd, g):
            batch = fetch(rnd, g)
            digests.append((g, _digest(batch)))
            return batch
        return wrapped

    monkeypatch.setattr(driver, "make_fetch", recording)
    if host_path:
        monkeypatch.setattr(cv_train, "make_device_store",
                            lambda *a, **k: None)
    out = cv_train.main([
        "--device", "cpu", "--test", "--dataset_dir", str(tmp_path),
        "--mode", "sketch", "--error_type", "virtual", "--local_momentum",
        "0", "--virtual_momentum", "0.9", "--num_workers", "2",
        "--local_batch_size", "4", "--num_epochs", "2",
        "--synthetic_per_class", "4", "--valid_batch_size", "10",
        *extra])
    return out, digests


@pytest.mark.parametrize("host_path", [False, True], ids=["store", "host"])
def test_driver_pipelined_equals_inline(tmp_path, monkeypatch, capsys,
                                        host_path):
    inline, d_inline = _run(tmp_path, monkeypatch, ["--no_pipeline"],
                            host_path)
    piped, d_piped = _run(tmp_path, monkeypatch,
                          ["--prefetch_depth", "2"], host_path)
    text = capsys.readouterr().out
    assert ("data: host path" in text) == host_path
    assert inline["rounds"] == piped["rounds"] >= 8
    # the same batches, round by round (the pipelined run fetches no
    # round twice and none past the epochs)
    assert d_inline == d_piped
    assert len(d_inline) == inline["rounds"]
    assert inline["losses"] == piped["losses"]
    assert torch.equal(inline["state"].ps_weights, piped["state"].ps_weights)
    assert len(piped["data_s"]) == len(piped["fetch_s"]) == piped["rounds"]
    assert inline["data_s"] == inline["fetch_s"]
    # only the host path's fetch runs on the worker thread; the store's
    # runs inline, where the wait is the whole fetch
    assert (piped["data_s"] == piped["fetch_s"]) == (not host_path)
    assert _no_prefetch_threads()
