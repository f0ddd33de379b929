"""Whole rounds of the new CV models, the PyTorch port against the JAX
package's ``FedRuntime`` on the CPU, and the ``cv_train`` entry point on
FEMNIST and with Fixup's rates.

The rounds follow tests/test_torch_round.py: the same weights (carried by
the converter) and the same seeded batches, float32; the per-client
losses held to rtol 1e-5, the final weights to atol 1e-6 (float32
summation-order differences in the gradients, but not one coordinate more
or fewer in a top-k: an update moves a weight by about 1e-3 here), the
server's momentum and error to rtol 1e-4 and atol 1e-6.

- one sketch round of a shallow LayerNorm torchvision ResNet over a 28 x
  28 x 1 EMNIST batch (62 classes);
- one true_topk round of a shallow FixupResNet50 with the (d,) Fixup rate
  vector ``lr * fixup_lr_multiplier``;
- one fedavg round of a narrow FixupResNet9 with the rate vector.

Shallow: the first two stages, one block each (``layers=(1, 1)``; both
packages zip the stages with the layer counts), so d is about 0.3 M.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_round import CH  # noqa: E402 (installs the import fix)

from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.cv_train import \
    fixup_lr_multiplier as j_fixup_lr_multiplier  # noqa: E402
from commefficient_tpu.losses import make_cv_loss as j_make_cv_loss  # noqa
from commefficient_tpu.models.fixup_resnet import \
    FixupResNetImageNet as JFixupResNetImageNet  # noqa: E402
from commefficient_tpu.models.resnet9 import \
    FixupResNet9 as JFixupResNet9  # noqa: E402
from commefficient_tpu.models.resnets import (  # noqa: E402
    BasicBlock as JBasicBlock, ResNet as JResNet)

from commefficient_torch import cv_train  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.cv_train import fixup_lr_multiplier  # noqa: E402
from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.fixup_resnet import \
    FixupResNetImageNet  # noqa: E402
from commefficient_torch.models.resnet9 import FixupResNet9  # noqa: E402
from commefficient_torch.models.resnets import ResNet, basic_block  # noqa


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


W, B, NUM_CLIENTS = 2, 4, 6
SHALLOW = (1, 1)
EMNIST, CIFAR = (28, 28, 1), (32, 32, 3)


def _round_pair(jm, tm, shape, classes, kw, lr_of):
    """Both runtimes from the JAX initialisation; one round on the same
    seeded batch, an underfull client included. ``lr_of(params, jrt)``
    gives the rate (scalar or (d,)). Returns the two states and metrics."""
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.ones((1,) + shape))
    jrt = JRuntime(JConfig(**kw, track_bytes=False, telemetry=False),
                   params, j_make_cv_loss(jm, "float32"),
                   num_clients=NUM_CLIENTS)
    with torch.no_grad():
        tm.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params), tm))
    trt = FedRuntime(FedConfig(**kw), tm, make_cv_loss(tm, "float32"),
                     device="cpu")
    rng = np.random.RandomState(0)
    image = rng.randn(W, B, *shape).astype(np.float32)
    target = rng.randint(0, classes, (W, B))
    mask = np.ones((W, B), bool)
    mask[1, 3:] = False
    ids = np.array([4, 1])
    lr = lr_of(params, jrt)
    js, jmet = jrt.round(jrt.init_state(), jnp.asarray(ids.astype(np.int32)),
                         {"image": jnp.asarray(image),
                          "target": jnp.asarray(target)},
                         jnp.asarray(mask), jnp.asarray(lr))
    ts, tmet = trt.round(trt.init_state(), ids,
                         {"image": image, "target": target}, mask,
                         torch.as_tensor(np.asarray(lr)))
    return jrt, js, jmet, trt, ts, tmet


def _check(jrt, js, jmet, ts, tmet, initial):
    np.testing.assert_allclose(tmet["results"][0].numpy(),
                               np.asarray(jmet["results"][0]), rtol=1e-5)
    np.testing.assert_allclose(tmet["results"][1].numpy(),
                               np.asarray(jmet["results"][1]))
    np.testing.assert_array_equal(tmet["n_valid"].numpy(),
                                  np.asarray(jmet["n_valid"]))
    w_got = ts.ps_weights.numpy()
    assert (w_got != initial).sum() > 0
    np.testing.assert_allclose(w_got, np.asarray(jrt.flat_weights(js)),
                               rtol=0, atol=1e-6)
    for name in ("Vvelocity", "Verror"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-4, atol=1e-6)


def test_layer_norm_resnet_sketch_round_on_emnist_matches_reference():
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, weight_decay=5e-4, k=500, num_rows=5,
              num_cols=16_384, num_workers=W, local_batch_size=B,
              num_clients=NUM_CLIENTS, compute_dtype="float32",
              dataset_name="EMNIST")
    jm = JResNet(block=JBasicBlock, layers=SHALLOW, num_classes=62,
                 norm="layer")
    tm = ResNet(basic_block, SHALLOW, num_classes=62, norm="layer",
                input_shape=EMNIST)
    initial = tm.flat.detach().numpy().copy()
    jrt, js, jmet, trt, ts, tmet = _round_pair(
        jm, tm, EMNIST, 62, kw, lambda params, jrt: np.float32(0.1))
    assert trt.cfg.num_cols == 16_384 and trt.cs.m == -(-tm.num_params
                                                         // 16_384)
    _check(jrt, js, jmet, ts, tmet, tm.flat.detach().numpy())
    assert not np.array_equal(initial, ts.ps_weights.numpy())


def test_fixup_resnet50_true_topk_round_with_rate_vector_matches_reference():
    kw = dict(mode="true_topk", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, weight_decay=5e-4, k=50_000,
              num_workers=W, local_batch_size=B, num_clients=NUM_CLIENTS,
              compute_dtype="float32", dataset_name="CIFAR100",
              model="FixupResNet50")
    jm = JFixupResNetImageNet(layers=SHALLOW, num_classes=100)
    tm = FixupResNetImageNet(layers=SHALLOW, num_classes=100,
                             input_shape=CIFAR)
    mult = fixup_lr_multiplier(tm.layout)

    def lr_of(params, jrt):
        ref = np.asarray(j_fixup_lr_multiplier(params, jrt.initial_weights))
        assert np.array_equal(ref, mult.numpy())
        return 0.1 * ref

    jrt, js, jmet, trt, ts, tmet = _round_pair(jm, tm, CIFAR, 100, kw, lr_of)
    _check(jrt, js, jmet, ts, tmet, tm.flat.detach().numpy())
    # k is about a tenth of d, so the support holds coordinates at either
    # rate: the scalar biases, scales and the head's bias at a tenth
    moved = ts.ps_weights != torch.as_tensor(trt.initial_weights)
    assert int((moved & (mult != 1.0)).sum()) > 0
    assert int((moved & (mult == 1.0)).sum()) > 0


def test_fixup_resnet9_fedavg_round_with_rate_vector_matches_reference():
    """The fedavg client applies the rate itself: the (d,) vector reaches
    its local steps."""
    kw = dict(mode="fedavg", error_type="none", local_momentum=0.0,
              virtual_momentum=0.0, weight_decay=5e-4, num_workers=W,
              local_batch_size=-1, max_client_batch=B, fedavg_batch_size=2,
              num_clients=NUM_CLIENTS, compute_dtype="float32",
              model="FixupResNet9")
    jm = JFixupResNet9(num_classes=10, channels=CH)
    tm = FixupResNet9(num_classes=10, channels=CH)
    mult = fixup_lr_multiplier(tm.layout)
    jrt, js, jmet, trt, ts, tmet = _round_pair(
        jm, tm, CIFAR, 10, kw, lambda params, jrt: 0.1 * mult.numpy())
    _check(jrt, js, jmet, ts, tmet, tm.flat.detach().numpy())


def _cv_train(tmp_path, *flags):
    """``--test`` runs the JAX package's smoke size: one-channel ResNet-9
    widths and a 1 x 10 sketch (k = 10)."""
    return cv_train.main([
        "--device", "cpu", "--dataset_name", "EMNIST", "--test",
        "--dataset_dir", str(tmp_path), "--error_type", "virtual",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--num_workers", "2", "--local_batch_size", "4",
        "--num_rounds", "2", "--valid_batch_size", "32", *flags])


def test_cv_train_runs_emnist_on_cpu(tmp_path, capsys):
    """The entry point on FEMNIST (the synthetic writers), the sketch
    round of a narrow ResNet-9: two rounds from the device store, finite
    losses, the epoch row."""
    out = _cv_train(tmp_path, "--model", "ResNet9", "--mode", "sketch")
    assert out["rounds"] == 2 and np.isfinite(out["losses"]).all()
    assert out["train_store"].augment == "emnist_train"
    assert out["lr_mult"] is None
    rt = out["runtime"]
    assert rt.num_clients == 20 and rt.cfg.num_cols == 10
    assert rt.layout[0] == ("params/ConvBN_0/Conv_0/kernel", (3, 3, 1, 1))
    assert rt.layout[-1] == ("params/head/kernel", (1, 62))
    text = capsys.readouterr().out
    assert "emnist_train" in text and "test_acc" in text


def test_cv_train_fixup_rates_reach_the_round(tmp_path, capsys):
    """``--test`` FixupResNet9 (one-channel widths, a 1 x 10 sketch) in
    true_topk: the driver builds the (d,) multiplier once and the round
    takes ``lr * multiplier``."""
    seen = []
    orig = FedRuntime.round

    def round(rt, state, ids, batch, mask, lr, **kw):
        seen.append(torch.as_tensor(lr).clone())
        return orig(rt, state, ids, batch, mask, lr, **kw)

    FedRuntime.round = round
    try:
        out = _cv_train(tmp_path, "--model", "FixupResNet9", "--mode",
                        "true_topk")
    finally:
        FedRuntime.round = orig
    mult = out["lr_mult"]
    d = out["runtime"].cfg.grad_size
    assert mult.shape == (d,) and len(seen) == 2
    for lr in seen:
        assert lr.shape == (d,)
        scalar = float(lr[mult == 1.0][0])
        assert torch.equal(lr, scalar * mult)
    assert "using fixup learning rates" in capsys.readouterr().out
