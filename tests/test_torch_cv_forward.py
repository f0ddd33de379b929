"""The forward and the flat gradient of each CV model family of the
PyTorch port against the JAX package's, on the CPU, at narrow or shallow
forms: FixupResNet9, ResNet18 and FixupResNet18 at full depth,
FixupResNet50 at (1, 1, 1, 1), the torchvision ``ResNet`` at (1, 1, 1, 1)
with ``BasicBlock`` under each norm and with a grouped ``Bottleneck``
(groups 4, width 4).

The weights of the JAX initialisation plus seeded noise (so Fixup's zero
leaves carry a gradient too) go to both packages (``params_from_jax``),
and one seeded batch of 4 images; the logits and the flat gradient of a
masked cross-entropy are computed in float64 on both sides, each within
REL_TOL of the JAX package's, relative to its largest magnitude. In
float32 the summation orders of XLA and oneDNN differ by about 1e-6
relative, and in a deep stack a relu tipped by that noise moved single
gradient coordinates by up to 3e-4 (ResNet18) and 5e-3 (FixupResNet18,
noise 0.05) of the largest: a float32 comparison tests that noise,
float64 tests the network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_round  # noqa: F401,E402 (installs the import fix)

from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu import models as jmodels  # noqa: E402
from commefficient_tpu.models.fixup_resnet import \
    FixupResNetImageNet as JFixupResNetImageNet  # noqa: E402
from commefficient_tpu.models.resnet18 import \
    FixupResNet18 as JFixupResNet18  # noqa: E402
from commefficient_tpu.models.resnets import (  # noqa: E402
    BasicBlock as JBasicBlock, Bottleneck as JBottleneck, ResNet as JResNet)

from commefficient_torch import models as tmodels  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.fixup_resnet import \
    FixupResNetImageNet  # noqa: E402
from commefficient_torch.models.resnet9 import FixupResNet9  # noqa: E402
from commefficient_torch.models.resnet18 import FixupResNet18  # noqa: E402
from commefficient_torch.models.resnets import (ResNet, basic_block,  # noqa
                                                bottleneck)

CIFAR, EMNIST = (32, 32, 3), (28, 28, 1)
REL_TOL = 1e-9

# family -> (JAX module, port model, input shape); narrow or shallow forms
FAMILIES = {
    "FixupResNet9": (lambda: jmodels.FixupResNet9(num_classes=10),
                     lambda: FixupResNet9(num_classes=10), CIFAR),
    "ResNet18": (lambda: jmodels.ResNet18(num_classes=10),
                 lambda: tmodels.ResNet18(num_classes=10), CIFAR),
    "FixupResNet18": (lambda: JFixupResNet18(num_classes=10),
                      lambda: FixupResNet18(num_classes=10), CIFAR),
    "FixupResNet50_1111": (
        lambda: JFixupResNetImageNet(layers=(1, 1, 1, 1), num_classes=10),
        lambda: FixupResNetImageNet(layers=(1, 1, 1, 1), num_classes=10,
                                    input_shape=CIFAR), CIFAR),
    **{f"resnet_basic_{norm}": (
        lambda norm=norm: JResNet(block=JBasicBlock, layers=(1, 1, 1, 1),
                                  num_classes=62, norm=norm),
        lambda norm=norm: ResNet(basic_block, (1, 1, 1, 1), num_classes=62,
                                 norm=norm, input_shape=EMNIST), EMNIST)
       for norm in ("batch", "layer", "none")},
    **{f"resnet_grouped_bottleneck_{norm}": (
        lambda norm=norm: JResNet(block=JBottleneck, layers=(1, 1, 1, 1),
                                  num_classes=62, norm=norm, groups=4,
                                  width_per_group=4),
        lambda norm=norm: ResNet(bottleneck, (1, 1, 1, 1), num_classes=62,
                                 norm=norm, groups=4, width_per_group=4,
                                 input_shape=EMNIST), EMNIST)
       for norm in ("batch", "layer")},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def carried_weights(jm, tm, shape, noise=0.01, seed=0):
    """The JAX initialisation plus seeded noise on every leaf, float32:
    ``(numpy tree, flat vector)``."""
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.ones((1,) + shape))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + noise * rng.standard_normal(
            np.shape(a)).astype(np.float32)), params)
    return params, params_from_jax(params, tm)


def _close(got, ref):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _masked_ce(logp, target, mask):
    """Masked mean cross-entropy of log-probabilities (numpy indexing on
    either framework's arrays)."""
    ce = -logp[np.arange(len(target)), target]
    return (ce * mask).sum() / mask.sum()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_and_flat_grad_match_reference(family):
    """float64 on both sides, so a relu kink or a max that float32 noise
    tips one way or the other cannot move a coordinate of the gradient."""
    make_j, make_t, shape = FAMILIES[family]
    jm, tm = make_j(), make_t()
    rng = np.random.RandomState(1)
    n = 4
    image = rng.randn(n, *shape)
    target = rng.randint(0, tm.num_classes, n)
    mask = np.array([1.0, 1.0, 1.0, 0.0])
    params, flat = carried_weights(jm, tm, shape)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        x = jnp.asarray(image, jnp.float64)

        def j_loss(params):
            logits = jm.apply(params, x)
            return _masked_ce(jax.nn.log_softmax(logits), target,
                              jnp.asarray(mask)), logits

        (l_ref, logits_ref), g_ref = jax.jit(jax.value_and_grad(
            j_loss, has_aux=True))(params)
        g_ref = np.asarray(ravel_pytree(g_ref)[0])
        logits_ref = np.asarray(logits_ref)
    w = flat.double().requires_grad_(True)
    logits = tm(torch.from_numpy(image), w, dtype=torch.float64)
    loss = _masked_ce(torch.log_softmax(logits, dim=1),
                      torch.from_numpy(target), torch.from_numpy(mask))
    (g_got,) = torch.autograd.grad(loss, w)
    assert g_got.dtype == torch.float64 and g_ref.dtype == np.float64
    _close(logits.detach().numpy(), logits_ref)
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               rtol=REL_TOL)
    assert np.abs(g_ref).max() > 0
    _close(g_got.numpy(), g_ref)


