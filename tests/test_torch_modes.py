"""The port's single-device round in every mode against the JAX package,
on the CPU, with the toy model of the JAX package's tests/test_core.py
(masked linear regression, b then w in ravel order).

The same seeded numpy inputs go through the reference's ``FedRuntime``
and the port's. Per-round losses are held to rtol 1e-5, the final
weights to atol 1e-6 and the client rows to rtol 1e-5 (float32 summation
order differs: the reference sums a round's gradients in one scan, the
port client by client); byte vectors, ``coord_last_update``,
``client_last_round`` and ``nan_round`` are held exactly. The port-only
classes follow tests/test_core.py: golden numpy trajectories, lossless
limits, the error-feedback variants, byte accounting, local state and the
NaN flag.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch


from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.core.server import \
    server_update as j_server_update  # noqa: E402
from commefficient_tpu.ops.circulant import \
    make_circulant_sketch as j_make_sketch  # noqa: E402

from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import (FedRuntime,  # noqa: E402
                                              download_coord_counts)
from commefficient_torch.core.server import server_update  # noqa: E402
from commefficient_torch.ops.circulant import \
    make_circulant_sketch  # noqa: E402

D_FEAT = 6
D = D_FEAT + 1
NUM_CLIENTS = 10
W = 4          # clients a round
B = 8          # local batch size


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def j_loss(params, batch, mask):
    """Masked linear-regression MSE and mean absolute error."""
    pred = batch["x"] @ params["w"] + params["b"]
    mask = mask.astype(jnp.float32)
    denom = jnp.maximum(mask.sum(), 1.0)
    err = pred - batch["y"]
    return ((err ** 2) * mask).sum() / denom, \
        ((jnp.abs(err) * mask).sum() / denom,)


def t_loss(flat, batch, mask):
    """``j_loss`` on the flat vector [b, w]."""
    pred = batch["x"] @ flat[1:] + flat[0]
    m = mask.to(torch.float32)
    denom = torch.clamp(m.sum(), min=1.0)
    err = pred - batch["y"]
    return ((err ** 2) * m).sum() / denom, ((err.abs() * m).sum() / denom,)


class Toy:
    """A port model: its parameters are one flat vector."""

    def __init__(self, flat):
        self.flat = torch.tensor(flat)
        self.num_params = len(flat)


def init_params(seed=0):
    w = np.random.RandomState(seed).randn(D_FEAT).astype(np.float32)
    return {"w": jnp.asarray(w), "b": jnp.zeros(())}, \
        np.concatenate([[0.0], w]).astype(np.float32)


def make_data(seed=1):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(D_FEAT).astype(np.float32)
    xs = rng.randn(NUM_CLIENTS, B, D_FEAT).astype(np.float32)
    ys = xs @ w_true + 0.01 * rng.randn(NUM_CLIENTS, B).astype(np.float32)
    return xs, ys


def base_kw(**kw):
    out = dict(mode="uncompressed", local_momentum=0.0,
               virtual_momentum=0.0, weight_decay=0.0, error_type="none",
               local_batch_size=B, num_workers=W, num_clients=NUM_CLIENTS)
    out.update(kw)
    return out


def port_runtime(**kw):
    # the route without telemetry, as ref_runtime builds the reference's:
    # the default route's parity is tests/test_torch_signals.py's
    return FedRuntime(FedConfig(**base_kw(**dict({"telemetry": False},
                                                 **kw))),
                      Toy(init_params()[1]), t_loss, device="cpu")


def ref_runtime(**kw):
    return JRuntime(JConfig(**base_kw(**kw), num_results_train=2,
                            telemetry=False),
                    init_params()[0], j_loss, num_clients=NUM_CLIENTS)


def round_inputs(n_rounds, seed=3, ragged=False):
    """Per round: client ids, batch and mask (one underfull client when
    ``ragged``)."""
    xs, ys = make_data()
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_rounds):
        ids = rng.choice(NUM_CLIENTS, W, replace=False)
        mask = np.ones((W, B), bool)
        if ragged:
            mask[1, 5:] = False
        out.append((ids, {"x": xs[ids], "y": ys[ids]}, mask))
    return out


def run_port(n_rounds, lr=0.05, seed=3, ragged=False, **kw):
    rt = port_runtime(**kw)
    state = rt.init_state()
    traj, hist = [], []
    for ids, batch, mask in round_inputs(n_rounds, seed, ragged):
        state, m = rt.round(state, ids, batch, mask, lr)
        traj.append(state.ps_weights.numpy().copy())
        hist.append(m)
    return rt, state, traj, hist


def numpy_sgd(n_rounds, lr=0.05, seed=3, rho=0.0):
    """Uncompressed federated SGD with virtual momentum on the host."""
    w = init_params()[1].astype(np.float64)
    xs, ys = make_data()
    rng = np.random.RandomState(seed)
    vel = np.zeros_like(w)
    traj = []
    for _ in range(n_rounds):
        ids = rng.choice(NUM_CLIENTS, W, replace=False)
        x = xs[ids].reshape(-1, D_FEAT)
        err = x @ w[1:] + w[0] - ys[ids].reshape(-1)
        g = np.concatenate([[2 * err.mean()],
                            2 * (x * err[:, None]).mean(0)])
        vel = g + rho * vel
        w = w - lr * vel
        traj.append(w.copy())
    return traj


SKETCH = dict(mode="sketch", error_type="virtual", k=3, num_rows=3,
              num_cols=5, virtual_momentum=0.9)
PARITY_CASES = {
    "uncompressed": dict(weight_decay=5e-4),
    "uncompressed_momentum": dict(virtual_momentum=0.9),
    "true_topk": dict(mode="true_topk", error_type="virtual", k=2,
                      virtual_momentum=0.9),
    "true_topk_local_momentum": dict(mode="true_topk",
                                     error_type="virtual", k=2,
                                     local_momentum=0.9),
    "local_topk_local_error_momentum": dict(
        mode="local_topk", error_type="local", k=3, local_momentum=0.9,
        lr_scale=0.01),
    "local_topk_no_error": dict(mode="local_topk", error_type="none", k=3),
    "fedavg_chunked": dict(mode="fedavg", local_batch_size=-1,
                           max_client_batch=B, fedavg_batch_size=3,
                           num_fedavg_epochs=2, fedavg_lr_decay=0.9,
                           weight_decay=5e-4),
    "sketch_zero": dict(SKETCH, weight_decay=5e-4),
    "sketch_subtract": dict(SKETCH, sketch_ef="subtract"),
    # the EF study's tables: 9 rows (past the 8 K1/K2 once took), and 2
    # rows of a wider table
    "sketch_zero_r9": dict(SKETCH, num_rows=9, weight_decay=5e-4),
    "sketch_subtract_r9": dict(SKETCH, num_rows=9, sketch_ef="subtract"),
    "sketch_zero_r2": dict(SKETCH, num_rows=2, num_cols=13),
    "sketch_subtract_r2": dict(SKETCH, num_rows=2, num_cols=13,
                               sketch_ef="subtract"),
    "sketch_unfused": dict(SKETCH, sketch_fused_encode="off"),
    "sketch_microbatched": dict(SKETCH, microbatch_size=3),
    "uncompressed_microbatched": dict(microbatch_size=3),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_round_matches_reference(case):
    kw = PARITY_CASES[case]
    jrt, trt = ref_runtime(**kw), port_runtime(**kw)
    js, ts = jrt.init_state(), trt.init_state()
    for ids, batch, mask in round_inputs(5, ragged=True):
        js, jm = jrt.round(js, jnp.asarray(ids.astype(np.int32)),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(mask), 0.05)
        ts, tm = trt.round(ts, ids, batch, mask, 0.05)
        for got, want in zip(tm["results"], jm["results"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
        assert np.array_equal(tm["n_valid"].numpy(),
                              np.asarray(jm["n_valid"]))
        for key in ("download_bytes", "upload_bytes"):
            assert np.array_equal(tm[key].numpy(), np.asarray(jm[key])), key
    np.testing.assert_allclose(ts.ps_weights.numpy(),
                               np.asarray(js.ps_weights), rtol=0, atol=1e-6)
    assert (ts.ps_weights.numpy() != init_params()[1]).any()
    for key in ("coord_last_update", "client_last_round", "nan_round"):
        assert np.array_equal(getattr(ts, key).numpy(),
                              np.asarray(getattr(js, key))), key
    for key in ("client_velocities", "client_errors"):
        want = getattr(js, key)
        assert (getattr(ts, key) is None) == (want is None), key
        if want is not None:
            # the rows sum n_c-weighted gradients (entries up to ~30 here):
            # 1e-5 relative, and 1e-6 of the largest entry where they cancel
            want = np.asarray(want)
            np.testing.assert_allclose(getattr(ts, key).numpy(), want,
                                       rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max())
    assert ts.step == int(js.step) == 5


class TestGoldenTrajectories:
    @pytest.mark.parametrize("rho", [0.0, 0.9])
    def test_uncompressed_matches_numpy(self, rho):
        _, _, traj, _ = run_port(5, virtual_momentum=rho)
        for got, want in zip(traj, numpy_sgd(5, rho=rho)):
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)

    @pytest.mark.parametrize("kw", [
        dict(mode="true_topk", error_type="virtual", k=D),
        dict(mode="local_topk", error_type="none", k=D),
        dict(mode="sketch", error_type="virtual", k=D, num_rows=7,
             num_cols=4096),
        dict(mode="sketch", error_type="virtual", k=D, num_rows=7,
             num_cols=4096, sketch_fused_encode="off")],
        ids=["true_topk", "local_topk", "sketch", "sketch_unfused"])
    def test_lossless_limit_matches_uncompressed(self, kw):
        """k = d and a table without collisions reproduce uncompressed
        SGD."""
        _, _, traj, _ = run_port(5, **kw)
        _, _, traj_u, _ = run_port(5)
        for got, want in zip(traj, traj_u):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)

    def test_fedavg_single_step_matches_sgd(self):
        """One local epoch on the whole client batch: the transmit is lr x
        the mean gradient, so the server step is plain SGD."""
        _, _, traj, _ = run_port(3, mode="fedavg", local_batch_size=-1,
                                 max_client_batch=B)
        for got, want in zip(traj, numpy_sgd(3)):
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


class TestSketchEFVariants:
    def test_subtract_ef_lossless_matches_zero(self):
        kw = dict(mode="sketch", error_type="virtual", k=D, num_rows=7,
                  num_cols=4096)
        _, _, traj_z, _ = run_port(5, **kw)
        _, _, traj_s, _ = run_port(5, sketch_ef="subtract", **kw)
        for got, want in zip(traj_s, traj_z):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("rule", ["zero", "subtract"])
    def test_server_update_with_collisions_matches_reference(self, rule):
        """A 64-coordinate vector in 16 columns (every cell collides): the
        sparse re-encode sums a cell's addends in the reference's order, so
        the tables come out with the reference's bits."""
        d, c, r, k = 64, 16, 3, 5
        rng = np.random.RandomState(0)
        g = (0.01 * rng.randn(d)).astype(np.float32)
        g[[5, 21, 37]] = [10.0, -8.0, 6.0]
        js = j_make_sketch(d, c, r, seed=3, pallas="off")
        ts = make_circulant_sketch(d, c, r, seed=3, device="cpu")
        table = np.array(js.encode(jnp.asarray(g)))
        vel = rng.randn(r, c).astype(np.float32)
        kw = dict(mode="sketch", error_type="virtual", k=k, num_rows=r,
                  num_cols=c, grad_size=d, virtual_momentum=0.9,
                  sketch_ef=rule)
        ref = j_server_update(JConfig(**base_kw(**kw)), jnp.asarray(table),
                              jnp.asarray(vel), jnp.zeros((r, c)),
                              jnp.asarray(1.0), cs=js)
        got = server_update(FedConfig(**base_kw(**kw)),
                            torch.from_numpy(table), torch.from_numpy(vel),
                            torch.zeros(r, c), torch.tensor(1.0), ts)
        for a, b in zip(got[:3], ref[:3]):
            assert np.array_equal(a.numpy().view(np.int32),
                                  np.asarray(b).view(np.int32))

    def test_subtract_ef_preserves_colliding_error(self):
        d, c, r, k = 64, 16, 3, 1
        cs = make_circulant_sketch(d, c, r, seed=3, device="cpu")
        rng = np.random.RandomState(0)
        g = torch.from_numpy((0.01 * rng.randn(d)).astype(np.float32))
        g[5] = 10.0
        table, zeros = cs.encode(g), cs.empty_table()
        kw = base_kw(mode="sketch", error_type="virtual", k=k, num_rows=r,
                     num_cols=c, grad_size=d)
        _, _, verr_z, _ = server_update(FedConfig(**kw), table, zeros,
                                        zeros, torch.tensor(1.0), cs)
        _, _, verr_s, _ = server_update(
            FedConfig(**kw).replace(sketch_ef="subtract"), table, zeros,
            zeros, torch.tensor(1.0), cs)
        assert float(verr_s.abs().sum()) > float(verr_z.abs().sum())
        assert abs(float(cs.decode_at(verr_s, torch.tensor([5]))[0])) < 1.0

    def test_error_decay_scales_verror(self):
        kw = base_kw(mode="true_topk", error_type="virtual", k=2,
                     grad_size=16)
        g = torch.arange(1.0, 17.0)
        zeros = torch.zeros(16)
        u1, _, e1, _ = server_update(FedConfig(**kw), g, zeros, zeros,
                                     torch.tensor(1.0))
        u2, _, e2, _ = server_update(FedConfig(**kw, error_decay=0.5), g,
                                     zeros, zeros, torch.tensor(1.0))
        assert torch.equal(u1, u2)
        torch.testing.assert_close(e2, 0.5 * e1)


class TestByteAccounting:
    def test_first_round_download_is_zero(self):
        _, _, _, hist = run_port(3)
        assert float(hist[0]["download_bytes"].sum()) == 0

    def test_dense_update_downloads_full_model(self):
        _, _, _, hist = run_port(3, seed=5)
        later = hist[1]["download_bytes"].numpy()
        nz = later[later > 0]
        assert nz.size > 0 and np.all(nz == 4 * D), nz

    @pytest.mark.parametrize("kw,floats", [
        ({}, D), (dict(mode="local_topk", k=3), 3),
        (dict(mode="sketch", error_type="virtual", k=3, num_rows=3,
              num_cols=64), 3 * 64),
        (dict(mode="fedavg", local_batch_size=-1, max_client_batch=B), D)],
        ids=["uncompressed", "local_topk", "sketch", "fedavg"])
    def test_upload_matches_mode_table(self, kw, floats):
        _, _, _, hist = run_port(1, **kw)
        up = hist[0]["upload_bytes"].numpy()
        assert (up > 0).sum() == W and np.all(up[up > 0] == 4 * floats)

    def test_sparse_update_downloads_only_changed(self):
        _, _, _, hist = run_port(4, seed=7, mode="true_topk",
                                 error_type="virtual", k=2)
        later = hist[1]["download_bytes"].numpy()
        nz = later[later > 0]
        assert nz.size > 0 and np.all(nz <= 4 * 2 * 2), nz

    @pytest.mark.parametrize("kind", ["random", "never", "all_last"])
    def test_download_counts_equal_a_plain_recount(self, kind):
        """The counts equal a plain recount on random rounds and on the
        skewed states of a run: nothing updated yet (-1), and everything
        updated in the last round (the dense modes)."""
        rng = np.random.RandomState(len(kind))
        step, d = 7, 10_000
        cul = {"random": rng.randint(-1, step, size=d),
               "never": np.full(d, -1),
               "all_last": np.full(d, step - 1)}[kind]
        cul = torch.from_numpy(cul.astype(np.int32))
        thr = torch.from_numpy(rng.randint(0, step + 1, size=8)
                               .astype(np.int32))
        want = torch.stack([(cul >= t).sum() for t in thr])
        assert torch.equal(download_coord_counts(cul, thr), want)

    def test_no_track_bytes_keeps_no_counters(self):
        rt, state, _, hist = run_port(2, track_bytes=False)
        assert state.coord_last_update is None
        assert hist[0]["download_bytes"] is None


class TestLocalState:
    def test_local_rows_update_only_for_participants(self):
        rt = port_runtime(mode="local_topk", error_type="local", k=3,
                          local_momentum=0.9, lr_scale=0.01)
        state = rt.init_state()
        xs, ys = make_data()
        ids = np.array([1, 3, 5, 7])
        state, _ = rt.round(state, ids, {"x": xs[ids], "y": ys[ids]},
                            np.ones((W, B), bool), 0.05)
        vel = state.client_velocities.abs().sum(1).numpy()
        err = state.client_errors.abs().sum(1).numpy()
        for c in range(NUM_CLIENTS):
            assert (vel[c] > 0) == (c in ids)
            assert (err[c] > 0) == (c in ids)

    @pytest.mark.parametrize("kw", [{}, SKETCH], ids=["uncompressed",
                                                      "sketch"])
    def test_microbatching_equivalence(self, kw):
        """Splitting a batch into 2 microbatches sums 2 mean gradients (the
        reference's accumulation), so half the rate gives the same
        trajectory."""
        _, _, traj_a, _ = run_port(3, lr=0.05, microbatch_size=B, **kw)
        _, _, traj_b, _ = run_port(3, lr=0.025, microbatch_size=B // 2,
                                   **kw)
        for got, want in zip(traj_b, traj_a):
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


class TestNanFlag:
    @pytest.mark.parametrize("kw", [{}, dict(SKETCH, k=2)],
                             ids=["uncompressed", "sketch"])
    def test_records_first_bad_round_as_reference(self, kw):
        """A NaN input in round 1: the flag records round 1 and keeps it;
        in sketch mode the NaN reaches the update through the top-k."""
        jrt, trt = ref_runtime(**kw), port_runtime(**kw)
        js, ts = jrt.init_state(), trt.init_state()
        xs, ys = make_data()
        ids = np.arange(W)
        good = {"x": xs[ids], "y": ys[ids]}
        bad = {"x": xs[ids].copy(), "y": ys[ids]}
        bad["x"][0, 0, 0] = np.nan
        mask = np.ones((W, B), bool)
        flags = []
        for batch in (good, bad, good):
            js, _ = jrt.round(js, jnp.asarray(ids.astype(np.int32)),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(mask), 0.05)
            ts, _ = trt.round(ts, ids, batch, mask, 0.05)
            flags.append((int(ts.nan_round), int(js.nan_round)))
        assert flags == [(-1, -1), (1, 1), (1, 1)]
        assert not np.isfinite(ts.ps_weights.numpy()).all()


@pytest.mark.parametrize("mode", ["sketch", "true_topk", "local_topk",
                                  "fedavg", "uncompressed"])
def test_mode_combos_legal_as_in_reference(mode):
    """Every (error type, local momentum) under ``mode``: the port's
    ``validate_mode_combo`` refuses exactly what the reference's refuses,
    and its message names a flag."""
    from commefficient_tpu.core.server import \
        validate_mode_combo as j_validate

    from commefficient_torch.core.server import validate_mode_combo
    for error_type in ("none", "local", "virtual"):
        for lm in (0.0, 0.9):
            kw = base_kw(mode=mode, error_type=error_type, local_momentum=lm,
                         local_batch_size=-1 if mode == "fedavg" else B)
            try:
                j_validate(JConfig(**kw))
                ref_ok = True
            except (ValueError, AssertionError):
                ref_ok = False
            try:
                validate_mode_combo(FedConfig(**kw))
                ok = True
            except ValueError as e:
                ok = False
                assert "--" in str(e)
            assert ok == ref_ok, (mode, error_type, lm)


def test_regime_warnings_and_strict_refusal(capsys):
    from commefficient_tpu.core.server import \
        check_regime_health as j_health

    from commefficient_torch.core.server import (check_regime_health,
                                                 validate_regimes)
    cases = [base_kw(mode="local_topk", error_type="local", k=3),
             base_kw(mode="local_topk", error_type="local", k=3,
                     lr_scale=0.01),
             base_kw(**dict(SKETCH, sketch_ef="subtract"), grad_size=1000),
             base_kw(**SKETCH, grad_size=1000)]
    counts = [len(check_regime_health(FedConfig(**kw))) for kw in cases]
    assert counts == [len(j_health(JConfig(**kw))) for kw in cases]
    assert counts == [1, 0, 1, 0]
    validate_regimes(FedConfig(**cases[0]))
    assert "WARNING: mode=local_topk" in capsys.readouterr().err
    with pytest.raises(ValueError, match="--strict_regimes"):
        validate_regimes(FedConfig(**cases[2], strict_regimes=True))
