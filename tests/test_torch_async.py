"""Asynchronous buffered aggregation (FedBuff) of the port against the
JAX package, on the CPU: ``staleness_weight`` (bitwise), the refusals of
``validate_async_combo``, ``reconcile_resumed_state``, ``commit_loss``,
the split round's identity with the synchronous round (K = 1, M = 1, no
scenario latency: bitwise, in every mode the refusals admit, on the
wires and under the robustness flags, through ``FedRuntime`` and through
the ``cv_train`` entry point), and a K = 4, M = 2 straggler run with
dropout against the JAX ``AsyncAggregator`` on the same scenario (the
same commits, cohorts, staleness and weights; weights to atol 1e-6, the
float32 order of the two frameworks' sums).

The toy model of tests/test_torch_modes.py keeps these fast.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modes import (NUM_CLIENTS, SKETCH, W,  # noqa: E402
                              port_runtime, ref_runtime, round_inputs)

from commefficient_tpu.core import async_agg as jasync  # noqa: E402
from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.data import scenarios as jscen  # noqa: E402
from commefficient_tpu.data.fed_sampler import Round as JRound  # noqa

from commefficient_torch import cv_train  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core import async_agg as tasync  # noqa: E402
from commefficient_torch.data import scenarios as tscen  # noqa: E402
from commefficient_torch.data.fed_sampler import Round  # noqa: E402


@pytest.fixture(autouse=True)
def _runs_under_tmp(tmp_path, monkeypatch):
    """The entry points' default run directory (``runs/<stamp>_...``, the
    telemetry stream) lands under the test's tmp dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The toy and smoke-size models run fastest on one thread, and the
    test run's workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("rule", ["none", "poly", "exp"])
def test_staleness_weight_bitwise(rule):
    for alpha in (0.5, 0.3, 1.7, 1e-3):
        for s in list(range(60)) + [0.5, 1e6]:
            got = tasync.staleness_weight(rule, s, alpha)
            want = jasync.staleness_weight(rule, s, alpha)
            assert got == want and type(got) is type(want)
        assert tasync.staleness_weight(rule, 0, alpha) == 1.0
    for bad in ((rule, -1), ("linear", 1)):
        with pytest.raises(ValueError) as te:
            tasync.staleness_weight(*bad)
        with pytest.raises(ValueError) as je:
            jasync.staleness_weight(*bad)
        assert str(te.value) == str(je.value)


UNSOUND = [dict(local_momentum=0.9),
           dict(mode="local_topk", error_type="local", k=3,
                local_momentum=0.0),
           dict(SKETCH, do_topk_down=True, k=2),
           dict(mode="local_topk", error_type="local", k=3,
                local_momentum=0.9)]


@pytest.mark.parametrize("i", range(len(UNSOUND)))
def test_validate_async_combo_as_reference(i):
    kw = dict(mode="uncompressed", error_type="none", local_momentum=0.0,
              async_agg=True)
    kw.update(UNSOUND[i])
    with pytest.raises(ValueError) as te:
        tasync.validate_async_combo(FedConfig(**kw))
    with pytest.raises(ValueError) as je:
        jasync.validate_async_combo(JConfig(**kw))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="--async_agg: buffered merge"):
        port_runtime(**dict(UNSOUND[i], async_agg=True))
    tasync.validate_async_combo(FedConfig(**dict(kw, async_agg=False)))
    tasync.validate_overlap_combo(FedConfig(**kw))


def test_commit_loss_as_reference():
    rng = np.random.RandomState(0)
    refs = [(rng.rand(4).astype(np.float32), rng.randint(0, 5, 4)
             .astype(np.float32)) for _ in range(3)]
    want = jasync.commit_loss({"loss_refs": [
        (jnp.asarray(a), jnp.asarray(b)) for a, b in refs]})
    got = tasync.commit_loss({"loss_refs": [
        (torch.from_numpy(a), torch.from_numpy(b)) for a, b in refs]})
    assert got == want
    zero = [(torch.ones(2), torch.zeros(2))]
    assert tasync.commit_loss({"loss_refs": zero}) is None
    assert tasync.commit_loss({"loss_refs": [(torch.tensor([math.nan]),
                                              torch.ones(1))]}) is None


def test_reconcile_resumed_state():
    """A missing or mis-shaped buffer starts empty, a non-empty one
    restarts, a synchronous run drops the fields; each said."""
    rt = port_runtime(**SKETCH, async_agg=True)
    sync = port_runtime(**SKETCH)
    bare = sync.init_state()
    state, msgs = tasync.reconcile_resumed_state(bare, rt)
    assert state.async_buffer.shape == (3, 5) and \
        float(state.async_buffer_n) == 0 and "EMPTY" in msgs[0]
    full = state.replace(async_buffer=torch.ones(3, 5),
                         async_buffer_n=torch.tensor(7.0))
    state, msgs = tasync.reconcile_resumed_state(full, rt)
    assert not state.async_buffer.any() and "RESTARTING" in msgs[0]
    empty = rt.init_state()
    state, msgs = tasync.reconcile_resumed_state(empty, rt)
    assert state is empty and msgs == []
    state, msgs = tasync.reconcile_resumed_state(full, sync)
    assert state.async_buffer is None and state.async_buffer_n is None
    assert "discarding a non-empty" in msgs[0]
    wrong = empty.replace(async_buffer=torch.zeros(7))
    state, msgs = tasync.reconcile_resumed_state(wrong, rt)
    assert state.async_buffer.shape == (3, 5)


IDENTITY = {
    "sketch": dict(SKETCH, weight_decay=5e-4),
    "sketch_unfused": dict(SKETCH, sketch_fused_encode="off"),
    "sketch_int8": dict(SKETCH, num_cols=16, wire_dtype="int8",
                        wire_block=8),
    "sketch_bf16": dict(SKETCH, wire_dtype="bfloat16"),
    "uncompressed_bytes": dict(track_bytes=True, virtual_momentum=0.9),
    "true_topk": dict(mode="true_topk", error_type="virtual", k=2,
                      virtual_momentum=0.9),
    "fedavg": dict(mode="fedavg", local_batch_size=-1, max_client_batch=8,
                   fedavg_batch_size=3),
    "sketch_normclip_signflip": dict(SKETCH, defense="normclip",
                                     adversary="signflip",
                                     adversary_frac=0.3),
    "sketch_trim": dict(SKETCH, defense="trim", defense_trim_frac=0.25),
    "sketch_nan_quarantine": dict(SKETCH, adversary="nan",
                                  adversary_frac=0.3,
                                  nonfinite_action="quarantine"),
    "dp_server": dict(do_dp=True, dp_mode="server", noise_multiplier=0.1),
}


def _same_state(a, b):
    assert a.step == b.step
    for name in ("ps_weights", "Vvelocity", "Verror", "coord_last_update",
                 "client_last_round", "nan_round", "defense_ref"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.numpy().tobytes() == y.numpy().tobytes(), name


@pytest.mark.parametrize("case", sorted(IDENTITY))
def test_k1_m1_is_bitwise_the_synchronous_round(case):
    """Five ticks of the AsyncAggregator at K = 1, M = 1 and no scenario
    give the synchronous rounds' state bit for bit, and each tick's
    metrics are the round's."""
    kw = IDENTITY[case]
    sync, asy = port_runtime(**kw), port_runtime(**kw, async_agg=True)
    agg = tasync.AsyncAggregator(asy, max_inflight=1, buffer_goal=1)
    ss, sa = sync.init_state(), asy.init_state()
    for g, (ids, batch, mask) in enumerate(round_inputs(5, ragged=True),
                                           1):
        ss, ms = sync.round(ss, ids, batch, mask, 0.05)
        sa, ma, commits = agg.step(sa, Round(ids, None, mask), g, batch,
                                   0.05)
        assert len(commits) == 1 and commits[0]["staleness_max"] == 0
        for key in ("n_valid", "client_finite"):
            x, y = ms[key], ma[key]
            assert (x is None) == (y is None) and (
                x is None or torch.equal(x, y)), key
        assert torch.equal(ms["results"][0], ma["results"][0])
    _same_state(ss, sa)
    assert sa.async_buffer_n == 0 and agg.commits == 5


def _run_reference(kw, scenario_kw, n_ticks, lr=0.05):
    """The JAX AsyncAggregator over the toy rounds; returns its commit
    records, counters and final weights."""
    cfg_kw = dict(kw, async_agg=True, max_inflight=4, buffer_goal=2,
                  staleness_discount="poly", **scenario_kw)
    jrt = ref_runtime(**cfg_kw)
    jagg = jasync.AsyncAggregator(
        jrt, scenario=jscen.make_scenario(jrt.cfg))
    js = jrt.init_state()
    recs = []
    for g, (ids, batch, mask) in enumerate(round_inputs(n_ticks, seed=9),
                                           1):
        js, _, commits = jagg.step(
            js, JRound(ids.astype(np.int32), None, mask), g,
            {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.float32(lr))
        recs += commits
    js, commits = jagg.flush(js, jnp.float32(lr))
    return recs + commits, jagg, np.asarray(js.ps_weights)


@pytest.mark.parametrize("kw", [dict(virtual_momentum=0.9),
                                dict(SKETCH, weight_decay=5e-4)],
                         ids=["uncompressed", "sketch"])
def test_stragglers_k4_m2_match_reference(kw):
    """K = 4 in flight, a commit every M = 2 cohorts, the poly discount,
    the stragglers scenario with dropout: both aggregators dispatch,
    drop, merge and commit the same cohorts at the same staleness, and
    end at the same weights."""
    scenario_kw = dict(scenario="stragglers", scenario_latency=1.0,
                       scenario_straggler_frac=0.3,
                       scenario_straggler_mult=4.0, scenario_dropout=0.2)
    n_ticks = 14
    jrecs, jagg, jw = _run_reference(kw, scenario_kw, n_ticks)
    rt = port_runtime(**dict(kw, async_agg=True, max_inflight=4,
                             buffer_goal=2, staleness_discount="poly",
                             **scenario_kw))
    agg = tasync.AsyncAggregator(rt, scenario=tscen.make_scenario(rt.cfg))
    state = rt.init_state()
    recs = []
    for g, (ids, batch, mask) in enumerate(round_inputs(n_ticks, seed=9),
                                           1):
        state, _, commits = agg.step(state, Round(ids, None, mask), g,
                                     batch, 0.05)
        recs += commits
    state, commits = agg.flush(state, 0.05)
    recs += commits
    assert (agg.dispatched, agg.dropped, agg.merged, agg.commits) == \
        (jagg.dispatched, jagg.dropped, jagg.merged, jagg.commits)
    assert agg.dropped > 0 and agg.staleness_max_seen > 0
    keys = ("round", "n_cohorts", "cohorts", "staleness_mean",
            "staleness_max", "discount_mean", "discount_min", "partial")
    assert [{k: r[k] for k in keys} for r in recs] == \
        [{k: r[k] for k in keys} for r in jrecs]
    for r, jr in zip(recs, jrecs):
        assert float(r["buffer_n"]) == float(jr["buffer_n"])
        np.testing.assert_allclose(tasync.commit_loss(r),
                                   jasync.commit_loss(jr), rtol=1e-5)
    assert state.step == agg.commits
    np.testing.assert_allclose(state.ps_weights.numpy(), jw, rtol=0,
                               atol=1e-6)


def test_dropout_never_takes_a_pool_slot(monkeypatch):
    """A dropped cohort is decided before the pool-full wait: it neither
    forces an in-flight cohort to land nor computes; the async_pool
    fault point sees every dispatched tick."""
    calls = []
    monkeypatch.setattr(tasync, "maybe_fault",
                        lambda point, n=None: calls.append((point, n)))
    rt = port_runtime(async_agg=True, max_inflight=2, buffer_goal=1,
                      scenario="uniform", scenario_latency=3.0,
                      scenario_spread=0.0, scenario_dropout=0.5)
    agg = tasync.AsyncAggregator(rt, scenario=tscen.make_scenario(rt.cfg))
    state = rt.init_state()
    dropped_ticks = []
    for g, (ids, batch, mask) in enumerate(round_inputs(12), 1):
        due = sum(item.arrival <= g for item in agg._inflight)
        before = agg.inflight
        state, m, _ = agg.step(state, Round(ids, None, mask), g, batch,
                               0.05)
        if m is None:
            # only the cohorts due by this tick landed
            dropped_ticks.append(g)
            assert agg.inflight == before - due
    assert dropped_ticks and agg.dispatched + agg.dropped == 12
    assert [n for p, n in calls] == [g for g in range(1, 13)
                                     if g not in dropped_ticks]
    assert {p for p, _ in calls} == {"async_pool"}


def test_cv_train_async_k1_m1_bitwise_the_synchronous_run(tmp_path):
    """The entry point: --async_agg --max_inflight 1 --buffer_goal 1
    ends at the synchronous run's weights and losses, bit for bit; the
    straggler arm runs, flushes every epoch and commits."""
    argv = ["--device", "cpu", "--test", "--dataset_dir",
            str(tmp_path / "ds"), "--num_workers", "4",
            "--local_batch_size", "8", "--iid", "--num_clients", "20",
            "--synthetic_per_class", "16", "--error_type", "virtual",
            "--local_momentum", "0", "--virtual_momentum", "0.9",
            "--num_epochs", "2"]
    sync = cv_train.main(argv)
    asy = cv_train.main(argv + ["--async_agg", "--max_inflight", "1",
                                "--buffer_goal", "1"])
    assert sync["losses"] == asy["losses"] and len(sync["losses"]) == 10
    assert torch.equal(sync["state"].ps_weights, asy["state"].ps_weights)
    assert asy["services"].async_agg.commits == 10
    slow = cv_train.main(argv + [
        "--async_agg", "--max_inflight", "4", "--buffer_goal", "2",
        "--scenario", "stragglers", "--scenario_dropout", "0.1"])
    aggr = slow["services"].async_agg
    assert aggr.inflight == 0 and aggr.pending == 0
    assert aggr.commits == slow["state"].step > 0
    assert np.isfinite(slow["losses"]).all()
