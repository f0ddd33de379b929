"""The CV model zoo of the PyTorch port against the JAX package's, on the
CPU: every registry name's layout against ``jax.eval_shape`` of its
``init`` at its dataset's input shape (no forward pass, no weights),
Fixup's rate multiplier (bitwise), zero leaves and identity blocks, and a
FixupResNet9 checkpoint refused by ResNet9. The forward and the gradient
are in tests/test_torch_cv_forward.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_round import CH  # noqa: E402 (installs the import fix)

from commefficient_tpu import models as jmodels  # noqa: E402
from commefficient_tpu.cv_train import \
    fixup_lr_multiplier as j_fixup_lr_multiplier  # noqa: E402

from commefficient_torch import models as tmodels  # noqa: E402
from commefficient_torch.checkpoint import (CheckpointManager,  # noqa
                                            layout_fingerprint)
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.cv_train import fixup_lr_multiplier  # noqa: E402
from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.fixup_resnet import \
    FixupResNetImageNet  # noqa: E402
from commefficient_torch.models.layers import Params  # noqa: E402
from commefficient_torch.models.resnet9 import (FixupResNet9,  # noqa
                                                fixup_basic_block)
from commefficient_torch.models.resnet18 import FixupResNet18  # noqa: E402

CIFAR, EMNIST = (32, 32, 3), (28, 28, 1)


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


def _dataset_shape(name):
    return (EMNIST, 62) if name == "ResNet101LN" else (CIFAR, 10)


@pytest.mark.parametrize("name", jmodels.MODEL_NAMES)
def test_layout_matches_reference(name):
    shape, classes = _dataset_shape(name)
    ref_shapes = jax.eval_shape(
        jmodels.get_model(name)(num_classes=classes).init,
        jax.random.PRNGKey(0), jnp.ones((1,) + shape))
    leaves, _ = jax.tree_util.tree_flatten_with_path(ref_shapes)
    ref = [("/".join(k.key for k in path), tuple(s.shape))
           for path, s in leaves]
    model = tmodels.get_model(name)(num_classes=classes, input_shape=shape,
                                    device="meta")
    assert model.flat.device.type == "meta"
    assert model.layout == ref
    assert model.num_params == sum(int(np.prod(s)) for _, s in ref)
    if name == "ResNet101LN":
        assert model.num_params == 43_124_350


def test_registry_names_and_refusal():
    assert tmodels.MODEL_NAMES == jmodels.MODEL_NAMES
    with pytest.raises(ValueError, match="unknown model 'resnet7'"):
        tmodels.get_model("resnet7")


def test_layer_norm_layout_follows_the_input():
    """SpatialLayerNorm's scale and bias take the map's (H, W, C), so the
    same network has another layout at 28x28x1 than at 32x32x3."""
    a = tmodels.get_model("ResNet101LN")(input_shape=EMNIST, device="meta")
    b = tmodels.get_model("ResNet101LN")(input_shape=(32, 32, 1),
                                         device="meta")
    assert dict(a.layout)["params/SpatialLayerNorm_0/scale"] == (14, 14, 64)
    assert dict(b.layout)["params/SpatialLayerNorm_0/scale"] == (16, 16, 64)
    # lexicographic, as ravel_pytree sorts: block10 before block2
    paths = [p for p, _ in a.layout]
    assert paths.index("params/stage2_block10/Conv_0/kernel") < \
        paths.index("params/stage2_block2/Conv_0/kernel")


@pytest.mark.parametrize("name", ["FixupResNet9", "FixupResNet18",
                                  "FixupResNet50"])
def test_fixup_lr_multiplier_bitwise(name):
    jm = jmodels.get_model(name)(num_classes=10)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.ones((1,) + CIFAR))
    flat_ref = jax.ShapeDtypeStruct((sum(int(np.prod(s.shape)) for s in
                                         jax.tree.leaves(params)),),
                                    jnp.float32)
    ref = np.asarray(j_fixup_lr_multiplier(params, flat_ref))
    tm = tmodels.get_model(name)(num_classes=10, input_shape=CIFAR,
                                 device="meta")
    got = fixup_lr_multiplier(tm.layout)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    assert 0 < (ref == np.float32(0.1)).sum() < ref.size


def test_fixup_zero_leaves_and_identity_blocks():
    """The zero-initialised leaves (each block's last conv, the zero
    classifiers) are exactly zero, and a Fixup block whose shape does not
    change is the identity at initialisation (of its relu'd input)."""
    gen = torch.Generator().manual_seed(0)
    for model, zero in (
            (FixupResNet9(channels=CH, generator=gen), ("conv2/",)),
            (FixupResNet18(num_blocks=(1, 1, 1, 1), generator=gen),
             ("conv2/", "_DualPoolHead_0/classifier/")),
            (FixupResNetImageNet(layers=(1, 1, 1, 1), num_classes=10,
                                 input_shape=CIFAR, generator=gen),
             ("conv3/", "params/fc/"))):
        views = model.views(model.flat.detach())
        for path, _ in model.layout:
            v = views[path[len("params/"):]]
            if any(z in path for z in zero):
                assert torch.count_nonzero(v) == 0, path
            elif path.endswith("kernel"):
                assert torch.count_nonzero(v) > 0, path
    rng = np.random.RandomState(0)
    x = torch.relu(torch.from_numpy(rng.randn(2, 16, 6, 6).astype(
        np.float32)))
    block = FixupResNet9(channels=CH, generator=gen)
    views = block.views(block.flat.detach())
    y = fixup_basic_block(Params(views).child("layer1").child("block0"),
                          x, 16, 2)
    assert torch.equal(y, x)


def test_fixup_checkpoint_refused_by_resnet9(tmp_path):
    """A FixupResNet9 checkpoint does not load into ResNet9: another
    layout fingerprint, refused without a fallback."""
    cfg = FedConfig(mode="true_topk", error_type="virtual",
                    local_momentum=0.0, k=100, num_clients=4)
    fixup = FixupResNet9(channels=CH)
    plain = tmodels.ResNet9(channels=CH)
    rt = FedRuntime(cfg, fixup, make_cv_loss(fixup, "float32"), "cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.default_meta = {"torch_layout": layout_fingerprint(fixup.layout),
                        "sketch_gen": None}
    mgr.save(rt.init_state(), 1)
    assert layout_fingerprint(plain.layout) != \
        layout_fingerprint(fixup.layout)
    with pytest.raises(ValueError, match="another parameter layout"):
        mgr.restore_latest(expect_layout=layout_fingerprint(plain.layout))
