"""The port's in-round telemetry against the JAX package's, on the CPU:
``ops/segments.py``, ``telemetry/layer_signals.py`` (the groups of the
flat layout and their reductions), ``telemetry/signals.py
round_signals`` and ``telemetry/clients.py summarize_per_client`` on the
same seeded inputs (zeros, ties, +-inf, NaN, all-NaN client rows); the
runtime's ``signals``, ``layer_signals`` and ``client_stats`` against the
JAX ``FedRuntime`` built with its default telemetry, in each mode, on
the toy model and a narrow ResNet-9; the fused-encode route of every
per-client sketch configuration; and a ``--signals_exact`` checkpoint
crossing between the packages in both directions.

Tolerances: norms, masses and quantiles rtol 1e-5 (float32 summation
order); ``support_density``, ``topk_count``, the overlaps, counts and
argmax slots exact; the conservation laws (group masses sum to the
vector's norm squared, counts to nnz) rtol 1e-5."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modes import (NUM_CLIENTS, SKETCH, Toy, base_kw,  # noqa
                              init_params, j_loss, round_inputs, t_loss)

from commefficient_tpu import checkpoint as j_ckpt  # noqa: E402
from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.losses import make_cv_loss as j_make_cv_loss  # noqa
from commefficient_tpu.models.gpt2 import GPT2Config as JGPT2Config  # noqa
from commefficient_tpu.models.gpt2 import \
    GPT2DoubleHeads as JGPT2DoubleHeads  # noqa: E402
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9  # noqa
from commefficient_tpu.ops import segments as jseg  # noqa: E402
from commefficient_tpu.ops.sketch import \
    make_sketch_impl as j_make_sketch_impl  # noqa: E402
from commefficient_tpu.telemetry import clients as jclients  # noqa: E402
from commefficient_tpu.telemetry import layer_signals as jls  # noqa: E402
from commefficient_tpu.telemetry import signals as jsig  # noqa: E402

from commefficient_torch.checkpoint import (CheckpointManager,  # noqa
                                            fit_services, layout_fingerprint,
                                            sketch_generation)
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.gpt2 import (GPT2Config,  # noqa: E402
                                             param_tree, ravel_layout)
from commefficient_torch.models.resnet9 import ResNet9  # noqa: E402
from commefficient_torch.ops import segments as tseg  # noqa: E402
from commefficient_torch.ops.sketch import make_sketch_impl  # noqa: E402
from commefficient_torch.telemetry import (layer_signals as tls,  # noqa
                                           tree_to_host)
from commefficient_torch.telemetry.clients import \
    summarize_per_client  # noqa: E402
from commefficient_torch.telemetry.signals import round_signals  # noqa

RTOL = 1e-5
NAN, INF = float("nan"), float("inf")
# the toy model's layout in the JAX package's ravel order (b, then w)
D_FEAT = len(init_params()[1]) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


class LaidToy(Toy):
    """The toy model with its flat layout, as the JAX tree {b, w}."""

    def __init__(self, flat):
        super().__init__(flat)
        self.layout = [("params/b", ()), ("params/w", (D_FEAT,))]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(_np(got), np.float64),
                               np.asarray(_np(want), np.float64),
                               rtol=RTOL, atol=0, equal_nan=True,
                               err_msg=what)


# --------------------------------------------------------------- groups


def _jax_params_gpt2():
    jcfg = JGPT2Config.small()
    model = JGPT2DoubleHeads(jcfg)
    ids = jnp.zeros((1, 2, 8), jnp.int32)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), ids,
                                             jnp.zeros((1, 2), jnp.int32)))


@pytest.mark.parametrize("mode", ["coarse", "leaf"])
@pytest.mark.parametrize("model", ["resnet9", "gpt2"])
def test_group_spec_matches_reference(model, mode):
    """The port's groups of its flat layout are the JAX package's groups of
    the parameter tree: the same names, sizes and coordinate ranges."""
    if model == "resnet9":
        layout = ResNet9(num_classes=10, device="meta").layout
        params = jax.eval_shape(lambda: JResNet9(num_classes=10).init(
            jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3))))
    else:
        layout = ravel_layout(param_tree(GPT2Config.small(), True))
        params = _jax_params_gpt2()
    ours = tls.make_group_spec(layout, mode)
    ref = jls.make_group_spec(params, mode)
    assert ours.names == ref.names and ours.sizes == ref.sizes
    assert ours.ranges == ref.ranges and ours.d == ref.d
    np.testing.assert_array_equal(ours.gid(), ref.gid())


def _spec_and_vectors(seed=0, d=None):
    layout = ravel_layout(param_tree(GPT2Config.small(), True))
    spec = tls.make_group_spec(layout, "coarse")
    rs = np.random.RandomState(seed)
    x = rs.randn(spec.d).astype(np.float32)
    x[::7] = 0.0                               # zeros
    x[5:40] = 1.5                              # ties
    return spec, x, rs


def test_segment_reductions_match_reference():
    """group_sq_mass, group_count, group_sum_cols and group_sum_at against
    the JAX scatter-adds through the group-id map; +-inf and NaN travel
    into their groups alone; the conservation laws hold."""
    spec, x, rs = _spec_and_vectors()
    gid, G, plan = jnp.asarray(spec.gid()), spec.n_groups, spec.plan
    _close(tseg.group_sq_mass(torch.from_numpy(x), plan),
           jseg.group_sq_mass(jnp.asarray(x), gid, G))
    mask = x != 0
    got = tseg.group_count(torch.from_numpy(mask), plan)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jseg.group_count(jnp.asarray(mask), gid, G)))
    assert float(got.sum()) == float(mask.sum())
    mass = tseg.group_sq_mass(torch.from_numpy(x), plan)
    np.testing.assert_allclose(float(mass.sum(dtype=torch.float64)),
                               float((x.astype(np.float64) ** 2).sum()),
                               rtol=RTOL)
    # non-negative columns, as the layer signals' (masses, counts): a
    # signed sum that cancels has no relative tolerance
    cols = rs.rand(spec.d, 3).astype(np.float32)
    _close(tseg.group_sum_cols([torch.from_numpy(cols[:, j].copy())
                                for j in range(3)], plan),
           jseg.group_sum_cols(jnp.asarray(cols), gid, G))
    idx = rs.choice(spec.d, 300, replace=False)
    vals = (rs.rand(300) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tseg.group_sum_at(torch.from_numpy(vals), torch.from_numpy(idx),
                              plan)),
        np.asarray(jseg.group_sum_at(jnp.asarray(vals), jnp.asarray(idx),
                                     gid, G)))
    special = x.copy()
    special[100], special[30_000], special[90_000] = INF, -INF, NAN
    _close(tseg.group_sq_mass(torch.from_numpy(special), plan),
           jseg.group_sq_mass(jnp.asarray(special), gid, G))


def test_layer_group_signals_match_reference():
    """Every field, with the dense gradient, the dense error and the
    --signals_exact pre-feedback error (hh_overlap: NaN where a group owns
    no winner), against layer_group_signals through the JAX map."""
    spec, grad, rs = _spec_and_vectors(1)
    k = 200
    err_pre = rs.randn(spec.d).astype(np.float32)
    update = np.zeros(spec.d, np.float32)
    keep = np.argsort(-np.abs(err_pre), kind="stable")[: k // 2]
    keep = np.concatenate([keep, rs.choice(spec.d, k // 2)])
    update[keep] = rs.randn(keep.size).astype(np.float32)
    err = rs.randn(spec.d).astype(np.float32)
    cfg = types.SimpleNamespace(k=k)
    ours = tls.layer_group_signals(
        cfg, spec=spec, update=torch.from_numpy(update),
        grad_dense=torch.from_numpy(grad), err_dense=torch.from_numpy(err),
        err_pre=torch.from_numpy(err_pre))
    ref = jls.layer_group_signals(
        cfg, gid=jnp.asarray(spec.gid()), n_groups=spec.n_groups,
        update=jnp.asarray(update), grad_dense=jnp.asarray(grad),
        err_dense=jnp.asarray(err), err_pre=jnp.asarray(err_pre))
    assert set(ours) == set(ref) == set(tls.LAYER_SIGNAL_KEYS)
    for key in ("grad_mass", "update_mass", "error_mass"):
        _close(ours[key], ref[key], key)
    for key in ("topk_count", "hh_overlap"):
        np.testing.assert_array_equal(_np(ours[key]), np.asarray(ref[key]),
                                      err_msg=key)
    assert float(ours["topk_count"].sum()) == float((update != 0).sum())
    none = tls.layer_group_signals(cfg, spec=spec,
                                   update=torch.from_numpy(update))
    assert none["grad_mass"] is None and none["error_mass"] is None
    assert none["hh_overlap"] is None


# -------------------------------------------------------------- signals


def _sig_cfg(**kw):
    base = dict(grad_size=400, signals_exact=True, virtual_momentum=0.9,
                k=20, mode="true_topk", error_decay=1.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _dense_inputs(rs, d, k, special=False):
    agg = rs.randn(d).astype(np.float32)
    if special:
        agg[3], agg[4], agg[5] = 0.0, -0.0, 2.5
        agg[6] = 2.5                                    # a tie
    vel, err = (rs.randn(d).astype(np.float32) for _ in range(2))
    upd = np.zeros(d, np.float32)
    upd[rs.choice(d, k, replace=False)] = rs.randn(k).astype(np.float32)
    return agg, upd, vel, err


@pytest.mark.parametrize("case", ["dense", "dense_special", "true_topk",
                                  "sketch_dense_state", "sketch_table",
                                  "sketch_shadow", "nonfinite"])
def test_round_signals_match_reference(case):
    """Every key of round_signals against the JAX package's: the dense
    modes, true_topk's overlap, the dense pre-image sketch state, the
    table state (l2estimate of the same tables), the --signals_exact
    shadow pair (and its new values), and a nonfinite update."""
    rs = np.random.RandomState(hash(case) % 2**31)
    d, k, c, r = 400, 20, 64, 5
    agg, upd, vel, err = _dense_inputs(rs, d, k, case == "dense_special")
    mode = {"dense": "uncompressed", "dense_special": "uncompressed",
            "true_topk": "true_topk", "nonfinite": "true_topk"}.get(
                case, "sketch")
    cfg = _sig_cfg(mode=mode, signals_exact=case != "dense",
                   error_decay=0.9 if case == "sketch_shadow" else 1.0)
    if case == "nonfinite":
        upd[0], agg[1] = NAN, INF
    kw_t, kw_j = {}, {}
    vel_prev, err_prev = vel * 0.5, err * 0.5
    if case in ("sketch_table", "sketch_shadow"):
        cs_t = make_sketch_impl("circ", d, c, r, seed=42, device="cpu")
        cs_j = j_make_sketch_impl("circ", d, c, r, seed=42)
        tabs = [rs.randn(r, c).astype(np.float32) for _ in range(5)]
        agg, vel_prev, err_prev, vel, err = tabs
        kw_t["cs"], kw_j["cs"] = cs_t, cs_j
        dense = rs.randn(d).astype(np.float32)
        kw_t["dense_agg"] = torch.from_numpy(dense)
        kw_j["dense_agg"] = jnp.asarray(dense)
        if case == "sketch_shadow":
            sv, se = (rs.randn(d).astype(np.float32) for _ in range(2))
            kw_t.update(sig_vel=torch.from_numpy(sv),
                        sig_err=torch.from_numpy(se))
            kw_j.update(sig_vel=jnp.asarray(sv), sig_err=jnp.asarray(se))
    T = torch.from_numpy
    got, gv, ge = round_signals(cfg, agg=T(agg), update=T(upd),
                                Vvel_prev=T(vel_prev), Verr_prev=T(err_prev),
                                Vvel_new=T(vel), Verr_new=T(err), **kw_t)
    J = jnp.asarray
    want, wv, we = jsig.round_signals(cfg, agg=J(agg), update=J(upd),
                                      Vvel_prev=J(vel_prev),
                                      Verr_prev=J(err_prev), Vvel_new=J(vel),
                                      Verr_new=J(err), **kw_j)
    assert tuple(got) == tuple(want) or set(got) == set(jsig.SIGNAL_KEYS)
    for key in jsig.SIGNAL_KEYS:
        if key in ("support_density", "topk_overlap"):
            np.testing.assert_array_equal(_np(got[key]),
                                          np.asarray(want[key]), key)
        else:
            _close(got[key], want[key], key)
    if case == "sketch_shadow":
        _close(gv, wv, "sig_vel")
        _close(ge, we, "sig_err")
    else:
        assert gv is None and ge is None


# ---------------------------------------------------------- client stats


def _client_rows(rs, W=9):
    """Per-client rows with zeros, ties, +-inf, NaN, an all-NaN stat and
    slots without data."""
    per = {"loss": rs.rand(W).astype(np.float32),
           "grad_norm_pre": np.full(W, 2.0, np.float32),        # ties
           "grad_norm_post": rs.randn(W).astype(np.float32),
           "clip_frac": np.full(W, NAN, np.float32),            # all NaN
           "tx_norm": rs.randn(W).astype(np.float32),
           "upload_bytes": np.zeros(W, np.float32)}             # zeros
    per["tx_norm"][[1, 4]] = [INF, -INF]
    per["grad_norm_post"][2] = NAN
    per["loss"][[3, 5]] = per["loss"][0]                        # ties
    n_valid = rs.randint(1, 5, W).astype(np.float32)
    n_valid[[6, 8]] = 0.0                                       # no data
    return per, n_valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summarize_per_client_matches_reference(seed):
    """Quantiles (jnp.nanpercentile, linear), max, mean and the argmax
    slot of each stat, on rows holding ties, +-inf, NaN, an all-NaN stat
    and empty slots."""
    rs = np.random.RandomState(seed)
    per, n_valid = _client_rows(rs)
    got = tree_to_host(summarize_per_client(
        {k: torch.from_numpy(v) for k, v in per.items()},
        torch.from_numpy(n_valid)))
    want = jax.tree.map(np.asarray, jclients.summarize_per_client(
        {k: jnp.asarray(v) for k, v in per.items()}, jnp.asarray(n_valid)))
    assert set(got) == set(want)
    for key in want:
        for field in ("q", "max", "mean"):
            _close(got[key][field], want[key][field], f"{key}.{field}")
        assert int(got[key]["argmax"]) == int(want[key]["argmax"]), key
    ids = np.arange(100, 109)
    a = jclients.client_stats_to_host(want, ids)
    b = jclients.client_stats_to_host(got, ids)
    for key in a:
        assert a[key]["argmax_client"] == b[key]["argmax_client"], key
        for field in ("p5", "p25", "p50", "p75", "p95", "max", "mean"):
            assert (a[key][field] is None) == (b[key][field] is None)
            if a[key][field] is not None:
                assert b[key][field] == pytest.approx(a[key][field],
                                                      rel=RTOL)


# --------------------------------------------------------- round metrics


def _toy_pair(**kw):
    kw = base_kw(**kw)
    trt = FedRuntime(FedConfig(**kw), LaidToy(init_params()[1]), t_loss,
                     device="cpu")
    jrt = JRuntime(JConfig(**kw, num_results_train=2), init_params()[0],
                   j_loss, num_clients=NUM_CLIENTS)
    return trt, jrt


def _compare_metrics(tm, jm, spec_names=None):
    """signals, layer_signals and client_stats of one round."""
    jm = jax.tree.map(np.asarray, {k: jm.get(k) for k in (
        "signals", "layer_signals", "client_stats")})
    tm = tree_to_host({k: tm.get(k) for k in (
        "signals", "layer_signals", "client_stats")})
    for name in ("signals", "layer_signals", "client_stats"):
        assert (tm[name] is None) == (jm[name] is None), name
    if jm["signals"] is not None:
        for key in jsig.SIGNAL_KEYS:
            if key in ("support_density", "topk_overlap"):
                np.testing.assert_array_equal(tm["signals"][key],
                                              jm["signals"][key], key)
            else:
                _close(tm["signals"][key], jm["signals"][key], key)
    if jm["layer_signals"] is not None:
        for key in jls.LAYER_SIGNAL_KEYS:
            a, b = tm["layer_signals"][key], jm["layer_signals"][key]
            assert (a is None) == (b is None), key
            if a is None:
                continue
            if key in ("topk_count", "hh_overlap"):
                np.testing.assert_array_equal(a, b, key)
            else:
                _close(a, b, key)
    if jm["client_stats"] is not None:
        assert set(tm["client_stats"]) == set(jm["client_stats"])
        for key, s in jm["client_stats"].items():
            for field in ("q", "max", "mean"):
                _close(tm["client_stats"][key][field], s[field],
                       f"{key}.{field}")
            assert int(tm["client_stats"][key]["argmax"]) == int(
                s["argmax"]), key


TOY_MODES = {
    "uncompressed": dict(mode="uncompressed"),
    "uncompressed_clip": dict(mode="uncompressed", max_grad_norm=0.5),
    "true_topk": dict(mode="true_topk", error_type="virtual", k=3,
                      virtual_momentum=0.9),
    "true_topk_exact": dict(mode="true_topk", error_type="virtual", k=3,
                            virtual_momentum=0.9, signals_exact=True),
    "local_topk": dict(mode="local_topk", error_type="local", k=3,
                       local_momentum=0.9),
    "fedavg": dict(mode="fedavg", local_batch_size=-1,
                   max_client_batch=8),
    "sketch_fused": dict(SKETCH),
    "sketch_unfused": dict(SKETCH, sketch_fused_encode="off"),
    "sketch_exact": dict(SKETCH, signals_exact=True),
    "sketch_table_clip": dict(SKETCH, max_grad_norm=1.0),
    "sketch_dense_state": dict(SKETCH, sketch_server_state="dense",
                               signals_exact=True),
}


@pytest.mark.parametrize("case", sorted(TOY_MODES))
def test_toy_round_metrics_match_reference(case):
    """Two rounds of the toy model in each mode against the JAX runtime
    with its default telemetry: the same metrics (null where the JAX
    package's are), within the stated tolerances."""
    trt, jrt = _toy_pair(**TOY_MODES[case])
    assert trt.fused_encode == bool(getattr(jrt, "_fused_encode", False))
    ts, js = trt.init_state(), jrt.init_state()
    for ids, batch, mask in round_inputs(2, ragged=True):
        ts, tm = trt.round(ts, ids, batch, mask, 0.05)
        js, jm = jrt.round(js, jnp.asarray(ids.astype(np.int32)),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(mask), 0.05)
        _compare_metrics(tm, jm)
    if trt._signals_shadow:
        # accumulated state, as the round tests hold the weights: atol
        for name in ("sig_Verror", "sig_Vvelocity"):
            np.testing.assert_allclose(_np(getattr(ts, name)),
                                       np.asarray(getattr(js, name)),
                                       rtol=RTOL, atol=1e-6, err_msg=name)


def test_narrow_resnet9_round_metrics_match_reference():
    """One round of a narrow ResNet-9 (the sketch round's default route,
    float32) against the JAX runtime with its default telemetry."""
    from test_torch_round import CH, SLICE
    W, B, c, r, k = 2, 4, 4096, 5, 200
    jmod = JResNet9(num_classes=10, channels=CH)
    params = jmod.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)))
    kw = dict(SLICE, k=k, num_rows=r, num_cols=c, num_workers=W,
              local_batch_size=B, compute_dtype="float32")
    jrt = JRuntime(JConfig(**kw), params, j_make_cv_loss(jmod, "float32"),
                   num_clients=10)
    tm_ = ResNet9(num_classes=10, channels=CH)
    with torch.no_grad():
        tm_.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params),
                                       tm_))
    trt = FedRuntime(FedConfig(**kw), tm_, make_cv_loss(tm_, "float32"),
                     device="cpu")
    assert trt.group_spec.names == jrt.group_spec.names
    rng = np.random.RandomState(0)
    image = rng.randn(W, B, 32, 32, 3).astype(np.float32)
    target = rng.randint(0, 10, (W, B))
    mask = np.ones((W, B), bool)
    mask[1, 3:] = False
    ids = np.arange(W)
    _, jm = jrt.round(jrt.init_state(), jnp.asarray(ids),
                      {"image": jnp.asarray(image),
                       "target": jnp.asarray(target)}, jnp.asarray(mask), 0.1)
    _, tm = trt.round(trt.init_state(), ids,
                      {"image": image, "target": target}, mask, 0.1)
    _compare_metrics(tm, jm)
    # the fused route: no dense gradient, so no grad_true_norm and no
    # per-group gradient mass, and NaN gradient quantiles (never zeros)
    host = tree_to_host(tm)
    assert np.isnan(host["signals"]["grad_true_norm"])
    assert tm["layer_signals"]["grad_mass"] is None
    assert np.isnan(host["client_stats"]["grad_norm_pre"]["q"]).all()


# ----------------------------------------------------------------- route

ROUTES = {
    "fused": dict(SKETCH),
    "table_clip": dict(SKETCH, max_grad_norm=1.0),
    "int8_clip": dict(SKETCH, max_grad_norm=1.0, wire_dtype="int8",
                      wire_block=8, num_cols=16),
    "topk_down": dict(SKETCH, do_topk_down=True, k=2),
    "normclip": dict(SKETCH, defense="normclip"),
    "signflip": dict(SKETCH, adversary="signflip", adversary_frac=0.5),
    "quarantine": dict(SKETCH, nonfinite_action="quarantine"),
    "dense_clip": dict(SKETCH, max_grad_norm=1.0, sketch_dense_clip=True),
    "dp": dict(SKETCH, do_dp=True, noise_multiplier=0.1),
    "ragged_microbatch": dict(SKETCH, microbatch_size=3),
    "signals_exact": dict(SKETCH, signals_exact=True),
}


@pytest.mark.parametrize("stats", [True, False],
                         ids=["default", "no_client_stats"])
@pytest.mark.parametrize("case", sorted(ROUTES))
def test_fused_encode_route_is_the_references(case, stats):
    """Under the default telemetry (per-client gradient statistics on)
    and under --no_client_stats, the port takes the fused per-client
    encode exactly where the JAX runtime does."""
    trt, jrt = _toy_pair(**ROUTES[case], client_stats=stats)
    assert trt.fused_encode == jrt._fused_encode
    assert trt._client_grad_stats == jrt._client_grad_stats
    assert trt._signals_dense_cap == jrt._signals_dense_cap


# ------------------------------------------------------------ checkpoint


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_signals_exact_checkpoint_crosses_packages(tmp_path, direction):
    """A --signals_exact checkpoint of the table-state sketch, written by
    one package after two rounds, restores into the other with its shadow
    pair bit for bit, and the next round's signals agree; a run without
    the flag drops the pair, one with it re-zeros a missing pair."""
    kw = dict(SKETCH, signals_exact=True)
    trt, jrt = _toy_pair(**kw)
    inputs = round_inputs(3, ragged=True)

    def j_round(state, ids, batch, mask):
        return jrt.round(state, jnp.asarray(ids.astype(np.int32)),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.asarray(mask), 0.05)

    gen = sketch_generation(trt.cfg)
    if direction == "jax_to_port":
        js = jrt.init_state()
        for ids, batch, mask in inputs[:2]:
            js, _ = j_round(js, ids, batch, mask)
        jmgr = j_ckpt.CheckpointManager(str(tmp_path / "ck"))
        jmgr.default_meta = {"sketch_gen": gen}
        jmgr.save(js, 1, meta={"global_round": 2})
        ts, _ = CheckpointManager(str(tmp_path / "ck")).restore_latest(
            "cpu", expect_layout=layout_fingerprint(trt.layout),
            expect_shapes=trt.state_shapes(), expect_sketch_gen=gen)
        src = js
    else:
        ts = trt.init_state()
        for ids, batch, mask in inputs[:2]:
            ts, _ = trt.round(ts, ids, batch, mask, 0.05)
        mgr = CheckpointManager(str(tmp_path / "ck"))
        mgr.default_meta = {"sketch_gen": gen}
        mgr.save(ts, 1, meta={"global_round": 2})
        # the port's round draws no key: the reference's gets one
        js = j_ckpt.load_state(mgr.path(1)).replace(
            rng=jax.random.PRNGKey(0))
        src = ts
    for name in ("sig_Vvelocity", "sig_Verror", "Verror"):
        a = np.asarray(_np(getattr(ts, name)))
        b = np.asarray(_np(getattr(js, name)))
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
    assert getattr(src, "sig_Verror") is not None
    ids, batch, mask = inputs[2]
    _, tm = trt.round(ts, ids, batch, mask, 0.05)
    _, jm = j_round(js, ids, batch, mask)
    _compare_metrics(tm, jm)
    # a run without the flag drops the pair; one with it and a checkpoint
    # without it starts the shadow at zero
    plain, _ = _toy_pair(**SKETCH)
    dropped = fit_services(ts, plain)
    assert dropped.sig_Verror is None and dropped.sig_Vvelocity is None
    refilled = fit_services(dropped, trt)
    assert not refilled.sig_Verror.any() and not refilled.sig_Vvelocity.any()
