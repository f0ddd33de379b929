"""The FetchSGD round of the PyTorch port against the JAX package, on the
CPU: the sketch-mode server update on identical tables, three whole
rounds of a narrow ResNet-9 from identical weights and batches, and the
``cv_train`` entry point.

Round parity runs in float32 (the JAX package's CPU round takes the roll
path of the sketch, the port its plain kernel versions). Per-round losses
are held to rtol 1e-5 and the final weights to atol 1e-6, a bound that
covers float32 summation-order differences in the gradients but not one
coordinate more or fewer in any round's top-k (an update moves a weight by
lr x its estimate, ~1e-3 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.core.server import server_update as j_update  # noqa
from commefficient_tpu.losses import make_cv_loss as j_make_cv_loss  # noqa
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9  # noqa
from commefficient_tpu.ops.circulant import \
    make_circulant_sketch as j_make_sketch  # noqa: E402

from commefficient_torch import cv_train  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.core.server import server_update  # noqa: E402
from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.resnet9 import ResNet9  # noqa: E402
from commefficient_torch.ops.circulant import make_circulant_sketch  # noqa


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


CH = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32}
SLICE = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
             virtual_momentum=0.9, weight_decay=5e-4)


def _jcfg(**kw):
    return JConfig(**SLICE, track_bytes=False, telemetry=False, **kw)


@pytest.mark.parametrize("c,decay", [(4000, 1.0), (4096, 0.9)])
def test_server_update_matches_reference(c, decay):
    """Identical tables in: the decode is bitwise equal, so the top-k picks
    the same coordinates and the zeroed cells are the same; only the
    scatter-add order of the sparse re-encode differs (exact 0 tests)."""
    d, r, k = 20_000, 5, 500
    rng = np.random.RandomState(c)
    grad, vel, err = (rng.randn(r, c).astype(np.float32) for _ in range(3))
    js = j_make_sketch(d, c, r, pallas="off")
    ts = make_circulant_sketch(d, c, r, device="cpu")
    jc = _jcfg(k=k, num_rows=r, num_cols=c, error_decay=decay)
    tc = FedConfig(**SLICE, k=k, num_rows=r, num_cols=c, error_decay=decay)
    ref = j_update(jc, jnp.asarray(grad), jnp.asarray(vel), jnp.asarray(err),
                   jnp.float32(0.1), cs=js)
    got = server_update(tc, torch.from_numpy(grad), torch.from_numpy(vel),
                        torch.from_numpy(err), torch.tensor(0.1), ts)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert int(got[3].sum()) > 0


def test_three_rounds_match_reference():
    W, B, c, r, k = 2, 8, 4096, 5, 200
    jm = JResNet9(num_classes=10, channels=CH)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)))
    jrt = JRuntime(_jcfg(k=k, num_rows=r, num_cols=c, num_workers=W,
                         local_batch_size=B, compute_dtype="float32"),
                   params, j_make_cv_loss(jm, "float32"), num_clients=10)
    assert jrt._fused and jrt._fused_encode

    tm = ResNet9(num_classes=10, channels=CH)
    with torch.no_grad():
        tm.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params), tm))
    trt = FedRuntime(FedConfig(**SLICE, k=k, num_rows=r, num_cols=c,
                               num_workers=W, local_batch_size=B,
                               compute_dtype="float32"),
                     tm, make_cv_loss(tm, "float32"), device="cpu")

    jst, tst = jrt.init_state(), trt.init_state()
    rng = np.random.RandomState(0)
    for rnd in range(3):
        image = rng.randn(W, B, 32, 32, 3).astype(np.float32)
        target = rng.randint(0, 10, (W, B))
        mask = np.ones((W, B), bool)
        mask[1, 5:] = False          # an underfull client
        ids = np.arange(W)
        lr = 0.1 * (rnd + 1)
        jst, jm_ = jrt.round(jst, jnp.asarray(ids),
                             {"image": jnp.asarray(image),
                              "target": jnp.asarray(target)},
                             jnp.asarray(mask), lr)
        tst, tm_ = trt.round(tst, ids, {"image": image, "target": target},
                             mask, lr)
        np.testing.assert_allclose(tm_["results"][0].numpy(),
                                   np.asarray(jm_["results"][0]), rtol=1e-5)
        np.testing.assert_allclose(tm_["results"][1].numpy(),
                                   np.asarray(jm_["results"][1]))
        np.testing.assert_array_equal(tm_["n_valid"].numpy(),
                                      np.asarray(jm_["n_valid"]))
    assert tst.step == int(jst.step) == 3
    w_ref = np.asarray(jrt.flat_weights(jst))
    w_got = tst.ps_weights.numpy()
    assert (w_got != tm.flat.detach().numpy()).sum() > 0
    np.testing.assert_allclose(w_got, w_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tst.Verror.numpy(), np.asarray(jst.Verror),
                               rtol=1e-4, atol=1e-6)


def test_cv_train_runs_on_cpu(tmp_path, capsys):
    """The entry point at full width on the CPU: two rounds, finite
    losses, one printed row per round."""
    out = cv_train.main([
        "--device", "cpu", "--dataset_name", "CIFAR10", "--model", "ResNet9",
        "--dataset_dir", str(tmp_path),
        "--mode", "sketch", "--error_type", "virtual", "--local_momentum",
        "0", "--virtual_momentum", "0.9", "--num_workers", "2",
        "--local_batch_size", "4", "--k", "500", "--num_rows", "5",
        "--num_cols", "262144", "--num_rounds", "2",
        "--synthetic_per_class", "4", "--valid_batch_size", "20"])
    assert out["rounds"] == 2 and np.isfinite(out["losses"]).all()
    text = capsys.readouterr().out
    assert "d=6568640 c=262144" in text
    with pytest.raises(ValueError, match="--defense"):
        cv_train.main(["--device", "cpu", "--defense", "trimmed_mean"])
