"""ResNet-9 and the CV loss of the PyTorch port against the JAX package,
on the CPU, at narrow channels.

The same numpy batch and the same weights (``params_from_jax`` of the JAX
initialisation) go through ``jax.value_and_grad`` of ``make_cv_loss`` and
through the port; the flat gradients are compared in ravel order. The
float32 arms hold loss and gradient to rtol 1e-4 (convolution summation
order differs between XLA and oneDNN). On the card cuDNN would run float32
convolutions in TF32; these CPU tests are unaffected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.losses import make_cv_loss as j_make_cv_loss  # noqa
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9  # noqa

from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.resnet9 import ResNet9  # noqa: E402

CH = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32}


def _models(bn, channels=CH):
    jm = JResNet9(do_batchnorm=bn, num_classes=10, channels=channels)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)))
    tm = ResNet9(do_batchnorm=bn, num_classes=10, channels=channels)
    flat = params_from_jax(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm, flat


def _batch(n=12, seed=0):
    rng = np.random.RandomState(seed)
    image = rng.randn(n, 32, 32, 3).astype(np.float32)
    target = rng.randint(0, 10, n)
    mask = np.ones(n, bool)
    mask[-3:] = False
    return image, target, mask


@pytest.mark.parametrize("bn", [False, True])
def test_layout_matches_ravel_pytree(bn):
    jm, params, tm, flat = _models(bn)
    ref, _ = ravel_pytree(params)
    assert tm.num_params == ref.size
    assert np.array_equal(flat.numpy(), np.asarray(ref))
    # the flagship width, by shapes alone: d = 6,568,640 without bn
    shapes = jax.eval_shape(JResNet9(do_batchnorm=bn).init,
                            jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    ref_layout = [("/".join(k.key for k in path), tuple(s.shape))
                  for path, s in leaves]
    full = ResNet9(do_batchnorm=bn)
    assert full.layout == ref_layout
    if not bn:
        assert full.num_params == 6_568_640


@pytest.mark.parametrize("bn", [False, True])
def test_forward_and_flat_grad_match_reference_f32(bn):
    jm, params, tm, flat = _models(bn)
    image, target, mask = _batch()
    jloss = j_make_cv_loss(jm, "float32")
    jbatch = {"image": jnp.asarray(image), "target": jnp.asarray(target)}
    (l_ref, (a_ref,)), g_ref = jax.value_and_grad(jloss, has_aux=True)(
        params, jbatch, jnp.asarray(mask))
    g_ref, _ = ravel_pytree(g_ref)
    logits_ref = jm.apply(params, jnp.asarray(image))

    loss = make_cv_loss(tm, "float32")
    w = flat.clone().requires_grad_(True)
    tbatch = {"image": torch.from_numpy(image),
              "target": torch.from_numpy(target)}
    l_got, (a_got,) = loss(w, tbatch, torch.from_numpy(mask))
    (g_got,) = torch.autograd.grad(l_got, w)
    with torch.no_grad():
        logits = tm(torch.from_numpy(image), flat)

    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(l_got.detach()), float(l_ref), rtol=1e-5)
    assert float(a_got) == float(a_ref)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(g_got.numpy(), g_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(g_ref).max())


def test_bf16_loss_tracks_reference():
    """bf16 compute (the default): the frameworks round at different
    places, so the loss is held to 2e-2 relative, the gradient direction
    to cosine > 0.99."""
    jm, params, tm, flat = _models(False)
    image, target, mask = _batch(seed=1)
    jloss = j_make_cv_loss(jm, "bfloat16")
    (l_ref, _), g_ref = jax.value_and_grad(jloss, has_aux=True)(
        params, {"image": jnp.asarray(image), "target": jnp.asarray(target)},
        jnp.asarray(mask))
    g_ref = np.asarray(ravel_pytree(g_ref)[0])
    w = flat.clone().requires_grad_(True)
    l_got, _ = make_cv_loss(tm, "bfloat16")(
        w, {"image": torch.from_numpy(image),
            "target": torch.from_numpy(target)}, torch.from_numpy(mask))
    (g_got,) = torch.autograd.grad(l_got, w)
    np.testing.assert_allclose(float(l_got.detach()), float(l_ref), rtol=2e-2)
    g = g_got.numpy()
    cos = g @ g_ref / (np.linalg.norm(g) * np.linalg.norm(g_ref))
    assert cos > 0.99, cos


def test_params_from_jax_rejects_a_foreign_tree():
    _, params, _, _ = _models(False)
    with pytest.raises(ValueError, match="layout"):
        params_from_jax(jax.tree.map(np.asarray, params),
                        ResNet9(do_batchnorm=True, channels=CH))
