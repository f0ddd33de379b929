"""The robustness services of the port against the JAX package, on the
CPU: adversary plans and straggler fates (bitwise), the quarantine
ledger's traces (bitwise), ``mask_blocked``, the update-space injections
and the quarantine's zeroing (bitwise, but for the noise attack),
``robust_aggregate`` (normclip and trim, within 1e-6 relative), the
NaN-skipping median (bitwise), the A10 flags of both parsers, and three
whole rounds of a narrow ResNet-9 under each study arm against the JAX
``FedRuntime`` from the same weights.

The noise attack is drawn from the port's (seed, round, slot) generators
with the adversary's fold; the JAX package draws it with ``jax.random``,
whose bits the port cannot reproduce (as for DP noise), so it is held by
its moments and its determinism under a fixed seed instead.

Whole rounds hold losses to rtol 1e-5 and weights to atol 1e-6, as
tests/test_torch_round.py does: the port sums the robust aggregate in
another order than ``tx.sum(axis=0)`` of the JAX package, and under the
quarantine arm the JAX round (its fused per-client tables) and the
port's (dense uploads, one deferred encode) sum in other orders again.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modes import (B, NUM_CLIENTS, SKETCH, W,  # noqa: E402
                              port_runtime, round_inputs)
from test_torch_round import CH, SLICE  # noqa: E402

from commefficient_tpu import config as jconfig  # noqa: E402
from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.core import client as jclient  # noqa: E402
from commefficient_tpu.core import server as jserver  # noqa: E402
from commefficient_tpu.core.quarantine import \
    QuarantineLedger as JLedger  # noqa: E402
from commefficient_tpu.data import scenarios as jscen  # noqa: E402
from commefficient_tpu.data.fed_sampler import Round as JRound  # noqa
from commefficient_tpu.data.fed_sampler import \
    mask_blocked as j_mask_blocked  # noqa: E402
from commefficient_tpu.losses import make_cv_loss as j_make_cv_loss  # noqa
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9  # noqa

from commefficient_torch import cv_train, gpt2_train  # noqa: E402
from commefficient_torch.config import (FedConfig, add_args,  # noqa: E402
                                        config_from_args)
from commefficient_torch.core import client as tclient  # noqa: E402
from commefficient_torch.core.quarantine import QuarantineLedger  # noqa
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.core.server import (nanmedian,  # noqa: E402
                                             robust_aggregate)
from commefficient_torch.data import scenarios as tscen  # noqa: E402
from commefficient_torch.data.fed_sampler import Round, mask_blocked  # noqa
from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.resnet9 import ResNet9  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


@pytest.fixture(autouse=True)
def _runs_under_tmp(tmp_path, monkeypatch):
    """The entry points' default run directory (``runs/<stamp>_...``, the
    telemetry stream) lands under the test's tmp dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


NAN, INF = float("nan"), float("inf")


def _same(a, b) -> bool:
    """Bitwise equality of two float32 arrays (NaN payloads included)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return a.shape == b.shape and a.tobytes() == b.tobytes()


# ----------------------------------------------------------- plans, fates

@pytest.mark.parametrize("kind", jconfig.ADVERSARY_KINDS[1:])
@pytest.mark.parametrize("seed", [0, 21, 12345])
def test_adversary_plan_bitwise(kind, seed):
    for frac in (0.05, 0.25, 0.5, 1.0):
        jp = jscen.AdversaryPlan(kind, frac, seed=seed, scale=3.0)
        tp = tscen.AdversaryPlan(kind, frac, seed=seed, scale=3.0)
        assert np.array_equal(tp.universe_mask(3500),
                              jp.universe_mask(3500))
        ids = np.random.RandomState(seed).randint(0, 10**6, 64)
        assert np.array_equal(tp.slot_mask(ids), jp.slot_mask(ids))
    cfg_kw = dict(adversary=kind, adversary_frac=0.3, seed=seed,
                  adversary_scale=4.0)
    jplan = jscen.make_adversary(JConfig(**cfg_kw))
    tplan = tscen.make_adversary(FedConfig(**cfg_kw))
    assert (tplan.kind, tplan.frac, tplan.seed, tplan.scale) == \
        (jplan.kind, jplan.frac, jplan.seed, jplan.scale)
    assert np.array_equal(tplan.universe_mask(100), jplan.universe_mask(100))
    assert tscen.make_adversary(FedConfig()) is None


SCENARIOS = {
    "none_dropout": dict(scenario="none", scenario_dropout=0.3),
    "uniform": dict(scenario="uniform", scenario_latency=2.0,
                    scenario_spread=1.5),
    "lognormal_partial": dict(scenario="lognormal", scenario_latency=3.0,
                              scenario_spread=0.7,
                              scenario_participation=0.4),
    "stragglers": dict(scenario="stragglers", scenario_latency=1.0,
                       scenario_straggler_frac=0.3,
                       scenario_straggler_mult=7.0, scenario_dropout=0.1),
    "stragglers_adversary": dict(scenario="stragglers",
                                 scenario_participation=0.6,
                                 adversary="signflip", adversary_frac=0.25),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_scenario_fates_bitwise(case):
    kw = dict(SCENARIOS[case], async_agg=True, seed=7)
    js = jscen.make_scenario(JConfig(**kw))
    ts = tscen.make_scenario(FedConfig(**kw))
    rng = np.random.RandomState(0)
    for cohort in list(range(60)) + [10**6, 2**31 - 1]:
        mask = rng.rand(8, 16) < 0.9
        ids = rng.randint(0, 500, 8)
        jf = js.fate(cohort, mask, client_ids=ids)
        tf = ts.fate(cohort, mask, client_ids=ids)
        assert tf.latency == jf.latency and tf.dropped == jf.dropped
        assert np.array_equal(tf.mask, jf.mask)
        assert (tf.adversary is None) == (jf.adversary is None)
        if jf.adversary is not None:
            assert np.array_equal(tf.adversary, jf.adversary)
    assert tscen.make_scenario(FedConfig(async_agg=True)) is None


def test_scenario_refusals_as_reference():
    bad = [dict(kind="zipf"), dict(latency=-1.0), dict(dropout=1.0),
           dict(participation=0.0), dict(straggler_frac=1.5),
           dict(straggler_mult=0.5)]
    for kw in bad:
        kind = kw.pop("kind", "uniform")
        with pytest.raises(ValueError) as je:
            jscen.StragglerScenario(kind, **kw)
        with pytest.raises(ValueError) as te:
            tscen.StragglerScenario(kind, **kw)
        assert str(te.value) == str(je.value)
    for args in (("ddos", 0.1), ("nan", 1.5), ("scale", 0.1)):
        kw = {"scale": -1.0} if args[0] == "scale" else {}
        with pytest.raises(ValueError) as je:
            jscen.AdversaryPlan(*args, **kw)
        with pytest.raises(ValueError) as te:
            tscen.AdversaryPlan(*args, **kw)
        assert str(te.value) == str(je.value)


# ------------------------------------------------- quarantine and masking

@pytest.mark.parametrize("backoff,strikes", [(1, 1), (2, 3), (8, 3)])
def test_quarantine_ledger_trace_bitwise(backoff, strikes):
    """One random (round, clients, finite) sequence through both ledgers:
    every round's struck list, blocked set, snapshot and digest equal,
    and the state round-trips through JSON into the other package's
    ledger."""
    import json
    jl, tl = JLedger(backoff, strikes), QuarantineLedger(backoff, strikes)
    rng = np.random.RandomState(backoff * 10 + strikes)
    for rnd in range(1, 80):
        blocked = tl.blocked(rnd)
        assert blocked == jl.blocked(rnd)
        ids = rng.choice(30, 8, replace=False)
        fin = rng.rand(8) > 0.2
        fin[[i for i, c in enumerate(ids) if c in blocked]] = True
        assert tl.observe(rnd, ids, fin) == jl.observe(rnd, ids, fin)
        assert tl.snapshot(rnd) == jl.snapshot(rnd)
        assert tl.quarantined(rnd) == jl.quarantined(rnd)
    state = json.loads(json.dumps(tl.state_dict()))
    assert state == json.loads(json.dumps(jl.state_dict()))
    back = QuarantineLedger(backoff, strikes)
    back.load_state_dict(jl.state_dict())
    assert back.state_dict() == tl.state_dict()
    assert back.ids_digest(80) == jl.ids_digest(80)
    for bad in (dict(backoff=0), dict(strikes=0)):
        with pytest.raises(ValueError):
            QuarantineLedger(**bad)


def test_mask_blocked_bitwise():
    rng = np.random.RandomState(3)
    for _ in range(20):
        ids = rng.choice(50, 8, replace=False).astype(np.int64)
        idx = rng.randint(0, 1000, (8, 4))
        mask = rng.rand(8, 4) < 0.8
        blocked = set(rng.choice(50, 10, replace=False).tolist())
        got = mask_blocked(Round(ids, idx, mask), blocked)
        want = j_mask_blocked(JRound(ids, idx, mask), blocked)
        assert np.array_equal(got.mask, want.mask)
        assert got.idx is idx and np.array_equal(got.client_ids, ids)
    r = Round(ids, idx, mask)
    assert mask_blocked(r, set()) is r
    assert mask_blocked(r, {10**6}) is r


# ------------------------------------------- injection and quarantine ops

def _uploads(shape, seed=0):
    rng = np.random.RandomState(seed)
    tx = rng.randn(6, *shape).astype(np.float32)
    tx[1] = 0.0
    tx[2, ..., 0] = -0.0
    n_valid = np.array([5, 0, 3, 7, 2, 4], np.float32)
    adv = np.array([True, True, False, True, False, True])
    return tx, n_valid, adv


@pytest.mark.parametrize("kind", ["signflip", "scale", "nan"])
@pytest.mark.parametrize("shape", [(40,), (3, 7)], ids=["dense", "table"])
def test_inject_adversary_bitwise(kind, shape):
    tx, n_valid, adv = _uploads(shape)
    jc = JConfig(adversary=kind, adversary_frac=0.5, adversary_scale=3.7)
    tc = FedConfig(adversary=kind, adversary_frac=0.5, adversary_scale=3.7)
    want = jclient.inject_adversary(jc, jnp.asarray(tx), jnp.asarray(adv),
                                    jax.random.split(jax.random.PRNGKey(0),
                                                     6),
                                    n_valid=jnp.asarray(n_valid))
    got = tclient.inject_adversary(tc, torch.from_numpy(tx),
                                   torch.from_numpy(adv), None,
                                   torch.from_numpy(n_valid))
    assert _same(got.numpy(), want)
    # a slot with no datum is never injected
    assert _same(got[1].numpy(), tx[1])


def test_inject_noise_moments_and_determinism():
    """The noise attack: the adversarial slots' uploads move by
    adversary_scale x N(0, 1) (mean within 4 sigma of 0, standard
    deviation within 2%), the honest and the zero-datum slots not at all,
    and the same (seed, round, slot) keys draw the same bits."""
    from commefficient_torch.core.runtime import ADV_FOLD, noise_generator
    d = 200_000
    tx = torch.randn(4, d, generator=torch.Generator().manual_seed(0))
    n_valid = torch.tensor([3.0, 0.0, 5.0, 2.0])
    adv = torch.tensor([True, True, False, True])
    cfg = FedConfig(adversary="noise", adversary_frac=0.5,
                    adversary_scale=2.5)

    def draw(step):
        gens = [noise_generator(21, step, w + 1, "cpu", fold=ADV_FOLD)
                for w in range(4)]
        return tclient.inject_adversary(cfg, tx, adv, gens, n_valid)

    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[1], tx[1]) and torch.equal(a[2], tx[2])
    for w in (0, 3):
        noise = (a[w] - tx[w]) / 2.5
        assert abs(float(noise.mean())) < 4 / d ** 0.5
        assert abs(float(noise.std()) - 1.0) < 0.02
    # another stream than DP noise of the same slot
    dp = torch.randn(d, generator=noise_generator(21, 3, 1, "cpu"))
    assert not torch.equal(dp, (a[0] - tx[0]) / 2.5)


@pytest.mark.parametrize("shape", [(40,), (3, 7)], ids=["dense", "table"])
def test_quarantine_zero_bitwise(shape):
    tx, n_valid, _ = _uploads(shape)
    tx[3, 0] = NAN
    tx[5, -1] = INF
    results = np.random.RandomState(1).rand(6, 2).astype(np.float32)
    results[4, 0] = NAN
    want = jclient.quarantine_zero(jnp.asarray(tx), jnp.asarray(n_valid),
                                   (jnp.asarray(results[:, 0]),
                                    jnp.asarray(results[:, 1])))
    got = tclient.quarantine_zero(torch.from_numpy(tx),
                                  torch.from_numpy(n_valid),
                                  torch.from_numpy(results))
    assert _same(got[0].numpy(), want[0])
    assert _same(got[1].numpy(), want[1])
    assert _same(got[2].numpy(), np.stack([np.asarray(r)
                                           for r in want[2]], 1))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].tolist() == [True, True, True, False, False, False]


def test_flip_labels_as_reference():
    t = np.random.RandomState(0).randint(0, 10, (4, 6))
    adv = np.array([True, False, True, False])
    want = jclient.flip_labels({"target": jnp.asarray(t)},
                               jnp.asarray(adv), 10)["target"]
    got = tclient.flip_labels({"target": torch.from_numpy(t)},
                              torch.from_numpy(adv), 10)["target"]
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="labelflip"):
        tclient.flip_labels({"x": torch.zeros(2)}, torch.ones(2, dtype=bool),
                            10)


# ------------------------------------------------------- robust aggregate

def _hard_uploads(shape, seed):
    """Uploads with zeros, ties, +-inf, a NaN, a zero-datum slot and
    -0, times each slot's datum count."""
    rng = np.random.RandomState(seed)
    W = 9
    per_datum = rng.randn(W, *shape).astype(np.float32)
    per_datum[2] = per_datum[3]                  # a tie of two clients
    per_datum[4] = 0.0                           # an all-zero upload
    per_datum[5, ..., 0] = -0.0
    per_datum[6] *= 40.0                         # a boosted client
    n_valid = np.array([4, 6, 3, 3, 5, 0, 2, 7, 1], np.float32)
    tx = per_datum * n_valid.reshape((W,) + (1,) * len(shape))
    return tx, n_valid


def _nonfinite(tx):
    tx = tx.copy()
    tx[7].flat[1] = INF
    tx[8].flat[2] = -INF
    tx[1].flat[3] = NAN
    return tx


def _aggregate(defense, tx, n_valid, ref, **kw):
    jc = JConfig(defense=defense, **kw)
    tc = FedConfig(defense=defense, **kw)
    want = jserver.robust_aggregate(
        jc, jnp.asarray(tx), jnp.asarray(n_valid),
        ref_thresh=None if ref is None else jnp.float32(ref))
    got = robust_aggregate(tc, torch.from_numpy(tx),
                           torch.from_numpy(n_valid),
                           None if ref is None else torch.tensor(ref))
    return got, want


@pytest.mark.parametrize("shape", [(50,), (3, 17)], ids=["dense", "table"])
@pytest.mark.parametrize("ref", [None, NAN, 0.7], ids=["none", "cold",
                                                        "warm"])
@pytest.mark.parametrize("finite", [True, False], ids=["finite", "inf_nan"])
def test_normclip_matches_reference(shape, ref, finite):
    tx, n_valid = _hard_uploads(shape, 1)
    if not finite:
        tx = _nonfinite(tx)
    if ref is None:
        ref = NAN    # the JAX package always passes the ring's median
    (agg, med, stats), (jagg, jmed, jstats) = _aggregate(
        "normclip", tx, n_valid, ref, defense_clip_mult=1.5)
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-6,
                               atol=1e-6, equal_nan=True)
    assert np.array_equal(np.isnan(agg.numpy()), np.isnan(np.asarray(jagg)))
    np.testing.assert_allclose(float(med), float(jmed), rtol=1e-6)
    for key in ("clip_frac", "clip_thresh", "clipped_mass", "trim_frac"):
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]),
                                   rtol=1e-5, equal_nan=True, err_msg=key)
    assert float(stats["clip_frac"]) > 0


@pytest.mark.parametrize("shape", [(50,), (3, 17)], ids=["dense", "table"])
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.25, 0.45])
@pytest.mark.parametrize("finite", [True, False], ids=["finite", "inf_nan"])
def test_trim_matches_reference(shape, frac, finite):
    tx, n_valid = _hard_uploads(shape, 2)
    if not finite:
        tx = _nonfinite(tx)
    (agg, med, stats), (jagg, jmed, jstats) = _aggregate(
        "trim", tx, n_valid, None, defense_trim_frac=frac)
    assert med is None and jmed is None
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-6,
                               atol=1e-6, equal_nan=True)
    assert np.array_equal(np.isnan(agg.numpy()), np.isnan(np.asarray(jagg)))
    assert _same(stats["trim_frac"].numpy(), jstats["trim_frac"])


def test_trim_sort_orders_inf_and_nan_as_reference():
    """The per-coordinate order of trim: invalid slots at +inf, a live
    NaN after them, -0 beside +0 in input order; torch.sort(dim=0,
    stable) gives jnp.sort's bits."""
    x = np.array([[NAN, 1.0, -0.0, INF], [INF, -INF, 0.0, NAN],
                  [0.0, 1.0, INF, -0.0], [-INF, NAN, 0.0, 2.0],
                  [INF, INF, -0.0, INF]], np.float32)
    got = torch.sort(torch.from_numpy(x), dim=0, stable=True).values
    assert _same(got.numpy(), jnp.sort(jnp.asarray(x), axis=0))


def test_trim_count_in_float32():
    """t = floor(trim_frac V) in float32: 0.29 x 100 is 29 in float32
    (28.999999999999996 in float64)."""
    W = 100
    tx = np.random.RandomState(0).randn(W, 5).astype(np.float32)
    n_valid = np.ones(W, np.float32)
    (agg, _, stats), (jagg, _, jstats) = _aggregate(
        "trim", tx, n_valid, None, defense_trim_frac=0.29)
    assert float(stats["trim_frac"]) == float(jstats["trim_frac"]) \
        == float(np.float32(0.58))
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", range(8))
def test_nanmedian_bitwise(case):
    """Even counts average the two middle values, ties, +-0, NaN skipped,
    all-NaN gives NaN, as jnp.nanmedian."""
    fixed = [[1, 2, 3, 4], [NAN] * 8, [-0.0, 0.0, NAN, -0.0],
             [0.0, -0.0, -0.0], [1, 1, 2, 2, NAN, 3, NAN, 5],
             [INF, -INF, 1, NAN], [-0.0, -0.0], [2.5]]
    rng = np.random.RandomState(case)
    cases = [np.array(fixed[case], np.float32)]
    for _ in range(25):
        x = rng.randn(8).astype(np.float32)
        x[rng.rand(8) < 0.3] = NAN
        x[rng.rand(8) < 0.2] = rng.choice([0.0, -0.0, 1.0])
        cases.append(x)
    for x in cases:
        assert _same(nanmedian(torch.from_numpy(x)).numpy(),
                     jnp.nanmedian(jnp.asarray(x)))


# -------------------------------------------------------------- the flags

FLAG_ARGV = [
    [],
    ["--defense", "normclip", "--defense_clip_mult", "2",
     "--defense_window", "4"],
    ["--defense", "trim", "--defense_trim_frac", "0.2"],
    ["--adversary", "nan", "--adversary_frac", "0.25",
     "--nonfinite_action", "quarantine", "--quarantine_backoff", "2",
     "--quarantine_strikes", "5"],
    ["--adversary", "scale", "--adversary_frac", "0.1",
     "--adversary_scale", "4"],
    ["--async_agg", "--max_inflight", "3", "--buffer_goal", "2",
     "--staleness_discount", "exp", "--staleness_alpha", "0.3",
     "--scenario", "lognormal", "--scenario_latency", "2",
     "--scenario_spread", "0.4", "--scenario_straggler_frac", "0.2",
     "--scenario_straggler_mult", "5", "--scenario_dropout", "0.2",
     "--scenario_participation", "0.5"],
    ["--preempt_grace", "12", "--watchdog", "--watchdog_mult", "3"],
]
A10_FIELDS = ("async_agg", "max_inflight", "buffer_goal",
              "staleness_discount", "staleness_alpha", "scenario",
              "scenario_latency", "scenario_spread",
              "scenario_straggler_frac", "scenario_straggler_mult",
              "scenario_dropout", "scenario_participation", "adversary",
              "adversary_frac", "adversary_scale", "defense",
              "defense_clip_mult", "defense_window", "defense_trim_frac",
              "nonfinite_action", "quarantine_backoff",
              "quarantine_strikes", "preempt_grace", "watchdog",
              "watchdog_mult")


def _port_config(argv):
    tp = argparse.ArgumentParser()
    add_args(tp)
    return config_from_args(tp.parse_args(argv))


@pytest.mark.parametrize("i", range(len(FLAG_ARGV)))
def test_a10_flags_parse_as_reference(i):
    """One argv, one config: each of the 25 flags with the JAX package's
    default and value (the watchdog arm with telemetry on in the JAX
    package, where its records exist)."""
    argv = FLAG_ARGV[i]
    jc = jconfig.parse_args(argv)
    tc = _port_config(argv)
    for name in A10_FIELDS:
        assert getattr(tc, name) == getattr(jc, name), name
    assert len(A10_FIELDS) == 25


REFUSED = [
    ["--scenario", "uniform"], ["--scenario_dropout", "0.1"],
    ["--scenario_participation", "0.5"],
    ["--async_agg", "--buffer_goal", "0"],
    ["--async_agg", "--max_inflight", "0"],
    ["--async_agg", "--scenario_dropout", "1.0"],
    ["--async_agg", "--scenario_participation", "0"],
    ["--adversary", "signflip"], ["--adversary_frac", "0.2"],
    ["--adversary", "nan", "--adversary_frac", "1.5"],
    ["--adversary", "scale", "--adversary_frac", "0.1",
     "--adversary_scale", "0"],
    ["--defense_clip_mult", "0"], ["--defense_window", "0"],
    ["--defense_trim_frac", "0.5"], ["--quarantine_backoff", "0"],
    ["--quarantine_strikes", "0"], ["--preempt_grace", "0"],
    ["--watchdog_mult", "0.5"], ["--staleness_alpha", "0"],
]


@pytest.mark.parametrize("i", range(len(REFUSED)))
def test_a10_refusals_as_reference(i):
    """Each refusal of the JAX package's config is the port's, with the
    same message where the JAX package raises a ValueError."""
    argv = REFUSED[i]
    with pytest.raises((ValueError, AssertionError)) as je:
        jconfig.parse_args(argv)
    with pytest.raises(ValueError) as te:
        _port_config(argv)
    if je.type is ValueError:
        assert str(te.value) == str(je.value)


def test_choice_refusals_name_the_flag():
    for argv in (["--defense", "krum"], ["--adversary", "ddos"],
                 ["--nonfinite_action", "skip"], ["--scenario", "zipf",
                                                  "--async_agg"],
                 ["--staleness_discount", "linear"]):
        with pytest.raises(ValueError, match=argv[0]):
            cv_train.main(["--device", "cpu"] + argv)


def test_labelflip_refused_without_classes():
    from commefficient_torch.core.server import validate_defense_combo
    with pytest.raises(ValueError) as te:
        validate_defense_combo(FedConfig(
            model="GPT2", dataset_name="PERSONA", adversary="labelflip",
            adversary_frac=0.1))
    with pytest.raises(ValueError) as je:
        jserver.validate_defense_combo(JConfig(
            dataset_name="PERSONA", adversary="labelflip",
            adversary_frac=0.1))
    assert str(te.value) == str(je.value)
    validate_defense_combo(FedConfig(adversary="labelflip",
                                     adversary_frac=0.1))


def test_fused_encode_on_refused_with_a_robust_flag():
    """``--sketch_fused_encode on`` refuses a defense on the deferred
    uploads (the JAX package's blocker) and an update-space adversary or
    the quarantine (the JAX package's default round blocks them by its
    per-client statistics); ``auto`` falls back to one deferred encode."""
    for kw in (dict(defense="normclip"), dict(defense="trim"),
               dict(adversary="signflip", adversary_frac=0.25),
               dict(nonfinite_action="quarantine")):
        # the default round: telemetry on, its per-client statistics
        kw = dict(kw, telemetry=True)
        with pytest.raises(ValueError, match="fused sketch encode"):
            port_runtime(**SKETCH, sketch_fused_encode="on", **kw)
        rt = port_runtime(**SKETCH, **kw)
        assert rt._fused_fn is None and rt._encode_sum
    with pytest.raises(ValueError, match="fused sketch encode"):
        JRuntime(JConfig(mode="sketch", error_type="virtual",
                         local_momentum=0.0, k=3, num_rows=3, num_cols=5,
                         defense="normclip", sketch_fused_encode="on",
                         telemetry=False, local_batch_size=B,
                         num_workers=W, num_clients=NUM_CLIENTS),
                 {"w": jnp.zeros(6), "b": jnp.zeros(())},
                 lambda p, b, m: (0.0, (0.0,)), num_clients=NUM_CLIENTS)
    # the default round keeps its running sum
    assert not port_runtime(**SKETCH)._per_client


def test_default_round_unchanged_by_the_services():
    """Flags off: the round returns no defense scalars and no finite
    flags, and its state holds no service field."""
    rt = port_runtime(**SKETCH)
    state = rt.init_state()
    ids, batch, mask = round_inputs(1)[0]
    state, m = rt.round(state, ids, batch, mask, 0.05)
    assert m["defense"] is None and m["client_finite"] is None
    assert state.async_buffer is None and state.defense_ref is None


# ------------------------------------------------ whole rounds (ResNet-9)

ARMS = {
    "normclip": dict(defense="normclip", defense_clip_mult=1.2),
    "trim": dict(defense="trim", defense_trim_frac=0.25),
    "signflip_normclip": dict(adversary="signflip", adversary_frac=0.25,
                              defense="normclip", defense_clip_mult=1.2),
    "nan_quarantine": dict(adversary="nan", adversary_frac=0.25,
                           nonfinite_action="quarantine"),
}
RW, RB, RC = 4, 4, 4096


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_three_robust_rounds_match_reference(arm):
    """Three sketch rounds of a narrow ResNet-9 under each study arm, the
    JAX ``FedRuntime`` (telemetry on for its defense scalars, its
    signals and client statistics off) against the port from the same
    weights and batches: losses, datum counts, finite flags, defense
    scalars, the normclip ring and the weights."""
    kw = ARMS[arm]
    num_clients = 12
    jm = JResNet9(num_classes=10, channels=CH)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)))
    jrt = JRuntime(JConfig(**SLICE, k=200, num_rows=5, num_cols=RC,
                           num_workers=RW, local_batch_size=RB,
                           compute_dtype="float32", track_bytes=False,
                           telemetry=True, signals=False,
                           client_stats=False, num_clients=num_clients,
                           **kw),
                   params, j_make_cv_loss(jm, "float32"),
                   num_clients=num_clients)
    tm = ResNet9(num_classes=10, channels=CH)
    with torch.no_grad():
        tm.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params), tm))
    trt = FedRuntime(FedConfig(**SLICE, k=200, num_rows=5, num_cols=RC,
                               num_workers=RW, local_batch_size=RB,
                               compute_dtype="float32", track_bytes=False,
                               num_clients=num_clients, **kw),
                     tm, make_cv_loss(tm, "float32"), device="cpu")
    assert trt._encode_sum and trt._per_client
    if trt.adversary_plan is not None:
        assert np.array_equal(trt._adv_universe.numpy(),
                              np.asarray(jrt._adv_universe))
    jst, tst = jrt.init_state(), trt.init_state()
    rng = np.random.RandomState(5)
    hit = False
    for rnd in range(3):
        ids = rng.choice(num_clients, RW, replace=False)
        image = rng.randn(RW, RB, 32, 32, 3).astype(np.float32)
        target = rng.randint(0, 10, (RW, RB))
        mask = np.ones((RW, RB), bool)
        mask[1, 2:] = False
        if rnd == 2:
            mask[3] = False          # a zero-datum slot
        lr = 0.1 * (rnd + 1)
        jst, jmet = jrt.round(jst, jnp.asarray(ids.astype(np.int32)),
                              {"image": jnp.asarray(image),
                               "target": jnp.asarray(target)},
                              jnp.asarray(mask), lr)
        tst, tmet = trt.round(tst, ids, {"image": image, "target": target},
                              mask, lr)
        np.testing.assert_allclose(tmet["results"][0].numpy(),
                                   np.asarray(jmet["results"][0]),
                                   rtol=1e-5)
        assert np.array_equal(tmet["n_valid"].numpy(),
                              np.asarray(jmet["n_valid"]))
        if jmet["client_finite"] is not None:
            fin = tmet["client_finite"].numpy()
            assert np.array_equal(fin, np.asarray(jmet["client_finite"]))
            hit |= not fin.all()
        for key, want in jmet["defense"].items():
            np.testing.assert_allclose(float(tmet["defense"][key]),
                                       float(want), rtol=1e-4,
                                       equal_nan=True, err_msg=key)
    if "quarantine" in arm:
        assert hit, "no client of the arm went nonfinite"
    if jst.defense_ref is not None:
        np.testing.assert_allclose(tst.defense_ref.numpy(),
                                   np.asarray(jst.defense_ref), rtol=1e-5)
        assert np.isfinite(tst.defense_ref.numpy()).sum() == 3
    assert int(tst.nan_round) == int(jst.nan_round) == -1
    w_got, w_ref = tst.ps_weights.numpy(), np.asarray(jst.ps_weights)
    assert (w_got != tm.flat.detach().numpy()).sum() > 0
    np.testing.assert_allclose(w_got, w_ref, rtol=0, atol=1e-6)


def test_fully_nonfinite_round_still_aborts():
    """Under the quarantine a round whose every live client went
    nonfinite sets nan_round; one finite live client keeps it at -1."""
    rt = port_runtime(**SKETCH, adversary="nan", adversary_frac=1.0,
                      nonfinite_action="quarantine")
    state = rt.init_state()
    ids, batch, mask = round_inputs(1)[0]
    new, m = rt.round(state, ids, batch, mask, 0.05)
    assert not m["client_finite"].any() and int(new.nan_round) == 0
    assert torch.equal(new.ps_weights, state.ps_weights) or \
        torch.isfinite(new.ps_weights).all()
    rt = port_runtime(**SKETCH, adversary="nan", adversary_frac=0.5,
                      nonfinite_action="quarantine")
    plan = rt.adversary_plan.universe_mask(NUM_CLIENTS)
    ids = np.array([i for i in range(NUM_CLIENTS) if plan[i]][:W - 1]
                   + [int(np.flatnonzero(~plan)[0])])
    new, m = rt.round(rt.init_state(), ids, batch, mask, 0.05)
    assert m["client_finite"].tolist() == [False] * (W - 1) + [True]
    assert int(new.nan_round) == -1
    assert torch.isfinite(new.ps_weights).all()


def test_gpt2_round_under_normclip_matches_reference():
    """The GPT-2 entry point's runtime applies the in-round defense: two
    float32 sketch rounds of GPT2Config.small (S = 128) under --defense
    normclip against the JAX package's FedRuntime from the same weights
    and batches, losses to rtol 1e-5 and weights to rtol 1e-5 plus atol
    1e-6 (tests/test_torch_gpt2.py's bounds)."""
    from test_torch_gpt2 import _batch, _models
    from commefficient_tpu.losses import (
        make_gpt2_train_loss as j_train_loss,
        make_gpt2_val_loss as j_val_loss)
    from commefficient_torch.losses import (make_gpt2_train_loss,
                                            make_gpt2_val_loss)
    Wg, Bg, C, S = 3, 2, 2, 128
    jm, params, tm, flat = _models("float32", "dense")
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, weight_decay=5e-4, k=200, num_rows=5,
              num_cols=4096, num_workers=Wg, local_batch_size=Bg,
              defense="normclip", defense_clip_mult=0.9)
    jrt = JRuntime(JConfig(**kw, track_bytes=False, telemetry=True,
                           signals=False, client_stats=False),
                   params, j_train_loss(jm), j_val_loss(jm), num_clients=12)
    with torch.no_grad():
        tm.flat.copy_(flat)
    trt = FedRuntime(FedConfig(**kw, model="GPT2", dataset_name="PERSONA"),
                     tm, make_gpt2_train_loss(tm), device="cpu",
                     loss_fn_val=make_gpt2_val_loss(tm))
    jst, tst = jrt.init_state(), trt.init_state()
    clipped = 0.0
    for rnd in range(2):
        parts = [_batch(Bg, C, S, seed=10 * rnd + w) for w in range(Wg)]
        batch = {key: np.stack([p[0][key] for p in parts])
                 for key in parts[0][0]}
        mask = np.ones((Wg, Bg), bool)
        mask[1, 1] = False
        ids = np.arange(Wg)
        jst, jmet = jrt.round(jst, jnp.asarray(ids),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(mask), 0.05)
        tst, tmet = trt.round(tst, ids, batch, mask, 0.05)
        np.testing.assert_allclose(tmet["results"][0].numpy(),
                                   np.asarray(jmet["results"][0]),
                                   rtol=1e-5)
        for key in ("clip_frac", "clip_thresh", "clipped_mass"):
            np.testing.assert_allclose(float(tmet["defense"][key]),
                                       float(jmet["defense"][key]),
                                       rtol=1e-4, err_msg=key)
        clipped += float(tmet["defense"]["clip_frac"])
    assert clipped > 0
    np.testing.assert_allclose(tst.ps_weights.numpy(),
                               np.asarray(jrt.flat_weights(jst)),
                               rtol=1e-5, atol=1e-6)
    ns = gpt2_train.build_parser().parse_known_args(
        ["--defense", "normclip"])[0]
    assert ns.defense == "normclip"
