"""``--finetune`` and the reference-API facade (``compat.py``) of the port
against the JAX package, on the CPU, with a narrow ResNet-9 (the widths
of tests/test_torch_round.py) and its tolerances: losses rtol 1e-5,
weights atol 1e-6.

Finetune: a weights file written as the JAX package's ``--checkpoint``
writes it, at CIFAR100's 100 classes, split by the port's
``load_finetune_params`` into the trainable head (zeros, at CIFAR10's 10
classes) and the frozen backbone, each bitwise the JAX package's
``load_finetune_params`` trees; three rounds of the head through both
runtimes (the JAX loss's ``frozen_params`` merge applied to the model at
the new class count: the JAX package's own driver applies it to the model
at the old count, which Flax refuses); the backbone stays bitwise the
file's. Then the entry point's two steps (``--checkpoint``, then
``--finetune --finetuned_from``), and the refusals.

Facade: ``split_by_client`` bitwise, a sketch-mode train step (losses,
weights, byte counts), the rate from the optimizer, validation and
``get_params`` against the JAX package's ``FedModel``.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_round import CH  # noqa: E402 (installs the import fix)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu import compat as j_compat  # noqa: E402
from commefficient_tpu import cv_train as j_cv  # noqa: E402
from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.losses import make_cv_loss as j_cv_loss  # noqa
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9  # noqa

from commefficient_torch import compat, cv_train  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
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


DENSE = dict(mode="uncompressed", error_type="virtual", local_momentum=0.0,
             virtual_momentum=0.9, weight_decay=5e-4, num_workers=2,
             local_batch_size=4, compute_dtype="float32")


def _narrow(cfg, num_classes, device=None):
    return ResNet9(num_classes=num_classes, channels=CH, device=device,
                   generator=torch.Generator().manual_seed(cfg.seed))


def _saved_jax_model(path, classes=100, seed=3):
    """A JAX ResNet-9 at ``classes`` whose flat weights are written where
    ``--finetune_path`` points, as ``--checkpoint`` writes them."""
    jm = JResNet9(num_classes=classes, channels=CH)
    params = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, 32, 32, 3)))
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "ResNet9.npz"),
             ps_weights=np.asarray(ravel_pytree(params)[0]))
    return jm, params


def test_finetune_split_and_rounds_match_reference(tmp_path, monkeypatch):
    path = str(tmp_path / "ft")
    jm100, params100 = _saved_jax_model(path)
    jcfg = JConfig(**DENSE, track_bytes=False, telemetry=False,
                   do_finetune=True, finetune_path=path,
                   finetuned_from="CIFAR100")
    trainable, frozen_tree = j_cv.load_finetune_params(jcfg, jm100,
                                                       params100)
    jrt = JRuntime(jcfg, trainable,
                   j_cv_loss(JResNet9(num_classes=10, channels=CH),
                             "float32", frozen_params=frozen_tree),
                   num_clients=10)

    monkeypatch.setattr(cv_train, "build_model", _narrow)
    cfg = FedConfig(**DENSE, track_bytes=False, do_finetune=True,
                    finetune_path=path, finetuned_from="CIFAR100")
    model = _narrow(cfg, 10, device="meta")
    view, frozen = cv_train.load_finetune_params(cfg, model, "cpu")
    # the head's layout and zeros, and the backbone, as the JAX trees
    assert torch.equal(params_from_jax(jax.tree.map(np.asarray, trainable),
                                       view), view.flat)
    assert not view.flat.any() and view.num_params == 32 * 10
    jax_backbone = params_from_jax(jax.tree.map(np.asarray, frozen_tree),
                                   layout=frozen.layout_frozen)
    assert torch.equal(frozen.frozen_vector, jax_backbone)
    # only the head's views carry a gradient: no backward through the
    # backbone
    views = frozen.views(view.flat.clone().requires_grad_(), torch.float32)
    assert {k for k, v in views.items() if v.requires_grad} == \
        {"head/kernel"}
    assert views.keys() == model.views(torch.zeros(model.num_params)).keys()
    trt = FedRuntime(cfg, view, make_cv_loss(model, "float32",
                                             frozen=frozen),
                     device="cpu")
    assert trt.cfg.grad_size == view.num_params

    jst, tst = jrt.init_state(), trt.init_state()
    rng = np.random.RandomState(0)
    for rnd in range(3):
        image = rng.randn(2, 4, 32, 32, 3).astype(np.float32)
        target = rng.randint(0, 10, (2, 4))
        mask = np.ones((2, 4), bool)
        mask[1, 3:] = False
        jst, jmet = jrt.round(jst, jnp.arange(2),
                              {"image": jnp.asarray(image),
                               "target": jnp.asarray(target)},
                              jnp.asarray(mask), 0.1)
        tst, tmet = trt.round(tst, np.arange(2),
                              {"image": image, "target": target}, mask, 0.1)
        np.testing.assert_allclose(tmet["results"][0].numpy(),
                                   np.asarray(jmet["results"][0]),
                                   rtol=1e-5)
    head = tst.ps_weights.numpy()
    assert np.abs(head).max() > 0
    np.testing.assert_allclose(head, np.asarray(jrt.flat_weights(jst)),
                               rtol=0, atol=1e-6)
    assert torch.equal(frozen.frozen_vector, jax_backbone)


def test_finetune_entry_point_two_steps_and_refusals(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setattr(cv_train, "build_model", _narrow)
    common = ["--device", "cpu", "--mode", "uncompressed", "--error_type",
              "virtual", "--local_momentum", "0", "--num_workers", "2",
              "--local_batch_size", "4", "--num_rounds", "2",
              "--synthetic_per_class", "4", "--valid_batch_size", "20",
              "--checkpoint_path", str(tmp_path / "ck")]
    first = cv_train.main(common + [
        "--dataset_name", "CIFAR100", "--dataset_dir", str(tmp_path / "a"),
        "--checkpoint"])
    saved = np.load(tmp_path / "ck" / "ResNet9.npz")["ps_weights"]
    assert np.array_equal(saved, first["state"].ps_weights.numpy())
    second = cv_train.main(common + [
        "--dataset_name", "CIFAR10", "--dataset_dir", str(tmp_path / "b"),
        "--finetune", "--finetuned_from", "CIFAR100", "--finetune_path",
        str(tmp_path / "ck"), "--eval_before_start"])
    text = capsys.readouterr().out
    assert "Test acc at epoch 0:" in text and "finetune:" in text
    rt = second["runtime"]
    assert rt.cfg.grad_size == 32 * 10
    assert [p for p, _ in rt.layout] == ["params/head/kernel"]
    assert np.isfinite(second["losses"]).all()
    assert second["state"].ps_weights.abs().max() > 0
    # the backbone is the first run's, bit for bit
    full = _narrow(FedConfig(), 100, device="meta")
    keep = torch.cat([torch.from_numpy(saved)[a:b] for (p, s), (a, b) in
                      zip(full.layout, _offsets(full.layout))
                      if not p.startswith("params/head/")])
    assert torch.equal(second["frozen"].frozen_vector, keep)
    with pytest.raises(ValueError, match="holds"):
        cv_train.main(common + [
            "--dataset_name", "CIFAR10", "--dataset_dir",
            str(tmp_path / "b"), "--finetune", "--finetuned_from",
            "CIFAR10", "--finetune_path", str(tmp_path / "ck")])
    monkeypatch.setattr(cv_train, "build_model", _no_head)
    with pytest.raises(ValueError, match="no recognisable head"):
        cv_train.main(common + [
            "--dataset_name", "CIFAR10", "--dataset_dir",
            str(tmp_path / "b"), "--finetune", "--finetuned_from",
            "CIFAR100", "--finetune_path", str(tmp_path / "ck")])


def _offsets(layout):
    at = 0
    for _, shape in layout:
        n = int(np.prod(shape))
        yield at, at + n
        at += n


def _no_head(cfg, num_classes, device=None):
    """A model without a head scope: a narrow ResNet-9 renamed."""
    model = _narrow(cfg, num_classes, device)
    model.layout = [(p.replace("params/head/", "params/linear/"), s)
                    for p, s in model.layout]
    return model


def _facade_models(sketch=True):
    kw = (dict(mode="sketch", error_type="virtual", local_momentum=0.0,
               virtual_momentum=0.9, k=200, num_rows=5, num_cols=4096)
          if sketch else dict(mode="uncompressed", error_type="none",
                              local_momentum=0.0, virtual_momentum=0.0))
    common = dict(weight_decay=5e-4, num_workers=2, local_batch_size=4,
                  valid_batch_size=5, compute_dtype="float32",
                  track_bytes=True, **kw)
    jm = JResNet9(num_classes=10, channels=CH)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)))
    jfm = j_compat.FedModel(jm, params, j_cv_loss(jm, "float32"),
                            JConfig(**common, telemetry=False),
                            num_clients=6)
    jopt = jfm.attach_optimizer(j_compat.FedOptimizer(jfm.cfg, lr=0.1))
    tm = ResNet9(num_classes=10, channels=CH)
    with torch.no_grad():
        tm.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params), tm))
    tfm = compat.FedModel(tm, make_cv_loss(tm, "float32"),
                          FedConfig(**common), num_clients=6, device="cpu")
    topt = tfm.attach_optimizer(compat.FedOptimizer(tfm.cfg, lr=0.1))
    return (jfm, jopt), (tfm, topt)


def _flat_batch(seed, clients):
    rng = np.random.RandomState(seed)
    n = len(clients)
    return {"client_id": np.asarray(clients),
            "image": rng.randn(n, 32, 32, 3).astype(np.float32),
            "target": rng.randint(0, 10, n)}


def test_split_by_client_is_bitwise_the_reference():
    b = _flat_batch(0, [3, 1, 3, 1, 3, 5, 1])
    data = {k: v for k, v in b.items() if k != "client_id"}
    got = compat.split_by_client(b["client_id"], data, 2, 4)
    ref = j_compat.split_by_client(b["client_id"], data, 2, 4)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[2], ref[2])
    for k in data:
        assert np.array_equal(got[1][k], ref[1][k])
    for split in (compat.split_by_client, j_compat.split_by_client):
        with pytest.raises(ValueError, match="num_workers"):
            split(np.array([2, 2]), {"x": np.zeros((2, 1))}, 2, 4)


def test_facade_train_val_and_params_match_reference():
    (jfm, jopt), (tfm, topt) = _facade_models()
    for step in range(2):
        b = _flat_batch(step, [0, 0, 0, 2, 2, 2, 2, 2])
        jl, ja, jd, ju = jfm(b)
        tl, ta, td, tu = tfm(b)
        jopt.step()
        topt.step()
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5)
        np.testing.assert_array_equal(ta, np.asarray(ja))
        np.testing.assert_array_equal(td, np.asarray(jd))
        np.testing.assert_array_equal(tu, np.asarray(ju))
        assert (tu > 0).sum() == 2
    np.testing.assert_allclose(tfm.state.ps_weights.numpy(),
                               np.asarray(jfm.runtime.flat_weights(
                                   jfm.state)), rtol=0, atol=1e-6)
    tfm.train(False)
    jfm.train(False)
    vb = _flat_batch(9, [-1] * 12)
    (tl,), (ta,) = tfm(vb)
    (jl,), (ja,) = jfm(vb)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ta == ja
    got = tfm.get_params()
    ref = jfm.get_params()
    got_leaves = dict(_leaves(got))
    ref_leaves = dict(_leaves(jax.tree.map(np.asarray, ref)))
    assert got_leaves.keys() == ref_leaves.keys()
    for k in ref_leaves:
        np.testing.assert_allclose(got_leaves[k].numpy(), ref_leaves[k],
                                   rtol=0, atol=1e-6)


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path)
        else:
            yield path, tree[key]


def test_facade_rate_flows_from_the_optimizer(tmp_path):
    b = _flat_batch(1, [0, 0, 0, 0, 2, 2, 2, 2])
    moves = []
    for lr in (0.1, 0.2):
        _, (tfm, topt) = _facade_models(sketch=False)
        w0 = tfm.state.ps_weights.clone()
        topt.set_lr(lr)
        tfm(b)
        moves.append(float((tfm.state.ps_weights - w0).abs().max()))
    np.testing.assert_allclose(moves[1], 2 * moves[0], rtol=1e-5)
    tfm.save_pretrained(str(tmp_path / "w"))
    assert np.array_equal(np.load(tmp_path / "w.npz")["ps_weights"],
                          tfm.state.ps_weights.numpy())
