"""GPT-2's two memory levers in the PyTorch port against the JAX package,
on the CPU, at ``GPT2Config.small`` (2 layers, width 64, 4 heads).

``--lm_chunk``: the port's ``_chunked_lm_nll`` against the JAX one, with
a chunk that divides the shifted length and one that does not, and the
chunked DoubleHeads loss and gradient against the dense one (port) and
against the JAX package's ``make_gpt2_train_loss(lm_chunk=)``. float32
throughout: only the order of float additions differs, so losses are
held to 1e-6 relative and gradients to 1e-5 relative plus 1e-6 of the
largest entry (1e-4 and 1e-5 against JAX, whose matrix products block
differently).

``--remat``/``--remat_policy``: recomputing a block repeats its
arithmetic, so the port's gradient under every policy equals the
gradient without remat bit for bit; against the JAX package's
``GPT2Config(remat=True, remat_policy=...)`` it is held to the tolerance
of the no-remat parity test (tests/test_torch_gpt2.py). K3's forward runs
again in each recomputed block, under every policy but
``everything_saveable``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.losses import _chunked_lm_nll as j_chunked
from commefficient_tpu.losses import make_gpt2_train_loss as j_train_loss
from commefficient_tpu.models import gpt2 as jgpt2

from commefficient_torch import gpt2_train
from commefficient_torch.losses import (_chunked_lm_nll, make_gpt2_train_loss,
                                        make_gpt2_val_loss)
from commefficient_torch.models import gpt2 as tgpt2
from commefficient_torch.models.convert import params_from_jax
from commefficient_torch.ops import flash_attention
from test_torch_gpt2 import _batch, _torch


@pytest.fixture(autouse=True)
def _runs_under_tmp(tmp_path, monkeypatch):
    """The entry points' default run directory (``runs/<stamp>_...``, the
    telemetry stream) lands under the test's tmp dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


POLICIES = ["", "nothing_saveable", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims", "everything_saveable"]


def _pair(remat=False, policy="", attn="flash"):
    """The JAX and the port's small float32 DoubleHeads on the same
    weights (the JAX initialisation carried over)."""
    kw = dict(compute_dtype=jnp.float32, remat=remat, remat_policy=policy)
    jm = jgpt2.GPT2DoubleHeads(jgpt2.GPT2Config.small(**kw),
                               attn_impl=jgpt2.resolve_attn(attn))
    ids = jnp.zeros((1, 2, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), ids,
                     jnp.zeros((1, 2), jnp.int32), ids)
    tm = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config.small(
        compute_dtype=torch.float32, remat=remat, remat_policy=policy),
        attn_impl=attn)
    return jm, params, tm, params_from_jax(jax.tree.map(np.asarray, params),
                                           tm)


def _jax_grad(jm, params, batch, mask, lm_chunk=0):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), g = jax.value_and_grad(
        j_train_loss(jm, 1.0, 2.0, lm_chunk=lm_chunk), has_aux=True)(
            params, jb, jnp.asarray(mask))
    return float(loss), np.asarray(ravel_pytree(g)[0])


def _port_grad(tm, flat, batch, mask, lm_chunk=0):
    w = flat.clone().requires_grad_(True)
    loss, _ = make_gpt2_train_loss(tm, 1.0, 2.0, lm_chunk)(
        w, _torch(batch), torch.from_numpy(mask))
    (g,) = torch.autograd.grad(loss, w)
    return float(loss.detach()), g.numpy()


@pytest.mark.parametrize("chunk", [8, 5])
def test_chunked_lm_nll_matches_jax(chunk):
    """T = 32 shifted positions: chunk 8 divides it, chunk 5 pads 3
    positions with label -100. The loss and its gradients with respect to
    the hidden states and wte."""
    rng = np.random.RandomState(chunk)
    B, C, S, E, V = 3, 2, 33, 16, 50
    hidden = rng.randn(B, C, S, E).astype(np.float32)
    wte = rng.randn(V, E).astype(np.float32)
    labels = rng.randint(0, V, (B, C, S)).astype(np.int64)
    labels[:, 0, : S // 2] = -100
    m = np.array([1.0, 1.0, 0.0], np.float32)
    jfun = jax.value_and_grad(
        lambda h, w: j_chunked(h, w, jnp.asarray(labels), jnp.asarray(m),
                               chunk), argnums=(0, 1))
    ref, (gh_ref, gw_ref) = jfun(jnp.asarray(hidden), jnp.asarray(wte))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(wte).requires_grad_(True)
    got = _chunked_lm_nll(h, w, torch.from_numpy(labels),
                          torch.from_numpy(m), chunk)
    gh, gw = torch.autograd.grad(got, (h, w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    for g, r in ((gh, gh_ref), (gw, gw_ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("chunk", [127, 16, 50])
def test_chunked_loss_matches_dense_and_jax(chunk):
    """S = 128, so 127 shifted positions: one chunk of 127, and chunks of
    16 and 50 that leave a padded tail. The chunked train loss and flat
    gradient against the port's dense loss and against the JAX package's
    chunked loss; the chunked validation loss against the dense one."""
    jm, params, tm, flat = _pair(attn="dense")
    batch, mask = _batch(seed=2)
    l_dense, g_dense = _port_grad(tm, flat, batch, mask)
    l_got, g_got = _port_grad(tm, flat, batch, mask, chunk)
    l_ref, g_ref = _jax_grad(jm, params, batch, mask, chunk)
    np.testing.assert_allclose(l_got, l_dense, rtol=1e-6)
    np.testing.assert_allclose(g_got, g_dense, rtol=1e-5,
                               atol=1e-6 * np.abs(g_dense).max())
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-5)
    np.testing.assert_allclose(g_got, g_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(g_ref).max())
    tb, tmask = _torch(batch), torch.from_numpy(mask)
    with torch.no_grad():
        v_dense, (a_dense,) = make_gpt2_val_loss(tm)(flat, tb, tmask)
        v_got, (a_got,) = make_gpt2_val_loss(tm, chunk)(flat, tb, tmask)
    np.testing.assert_allclose(float(v_got), float(v_dense), rtol=1e-6)
    assert float(a_got) == float(a_dense)


@pytest.mark.filterwarnings("ignore:attn_impl='flash' was requested")
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradient_is_bitwise_and_matches_jax(policy, monkeypatch):
    """``attn_impl flash`` (K3's plain version here; dense in the JAX
    package off a TPU). The flat gradient under ``--remat`` and the
    policy equals the no-remat gradient bit for bit; the loss too. K3's
    forward runs once a layer, and once more a layer in the backward
    under every policy that recomputes. Against the JAX package's remat
    gradient: 1e-4 relative plus 1e-5 of the largest entry."""
    calls = []
    forward = flash_attention.forward
    monkeypatch.setattr(flash_attention, "forward",
                        lambda *a: calls.append(1) or forward(*a))
    batch, mask = _batch(seed=3)
    _, _, base, flat = _pair(attn="flash")
    l_base, g_base = _port_grad(base, flat, batch, mask)
    n_layer = base.gcfg.n_layer
    assert len(calls) == n_layer
    calls.clear()
    jm, params, tm, flat_r = _pair(remat=True, policy=policy, attn="flash")
    assert np.array_equal(flat_r.numpy(), flat.numpy())
    l_got, g_got = _port_grad(tm, flat, batch, mask)
    assert len(calls) == (n_layer if policy == "everything_saveable"
                          else 2 * n_layer)
    assert l_got == l_base
    assert np.array_equal(g_got.view(np.uint32), g_base.view(np.uint32))
    l_ref, g_ref = _jax_grad(jm, params, batch, mask)
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-5)
    np.testing.assert_allclose(g_got, g_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(g_ref).max())


def test_remat_bf16_gradient_is_bitwise():
    """The entry point's default bf16 compute: full remat's gradient
    equals the gradient without it bit for bit."""
    batch, mask = _batch(seed=4)
    grads = []
    for remat in (False, True):
        tm = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config.small(remat=remat),
                                   attn_impl="dense",
                                   generator=torch.Generator().manual_seed(1))
        grads.append(_port_grad(tm, tm.flat.detach(), batch, mask)[1])
    assert np.array_equal(grads[0].view(np.uint32), grads[1].view(np.uint32))


@pytest.mark.parametrize("policy", ["save_only_these_names", "bogus"])
def test_unknown_remat_policy_raises(policy):
    """Names outside the policies the port maps (a JAX policy factory,
    or no policy at all) raise and are named; without ``remat`` the
    policy is not read, as in the JAX package."""
    with pytest.raises(ValueError, match=policy):
        tgpt2.GPT2Config.small(remat=True, remat_policy=policy)
    tgpt2.GPT2Config.small(remat_policy=policy)
    with pytest.raises(ValueError, match=policy):
        gpt2_train.main(["--test", "--device", "cpu", "--error_type",
                         "virtual", "--local_momentum", "0", "--remat",
                         "--remat_policy", policy])


def test_scan_layers_false_raises():
    with pytest.raises(ValueError, match="scan_layers"):
        tgpt2.GPT2Config.small(scan_layers=False)


def test_gpt2_train_levers_keep_the_losses(tmp_path):
    """``gpt2_train --test --device cpu --remat --lm_chunk 16`` against
    the same run without the levers, two rounds from one prepared
    directory: the per-round losses, the validation NLL and the final
    weights agree within 1e-5 relative (the chunked loss sums in another
    order; remat changes no bit)."""
    argv = ["--test", "--device", "cpu", "--dataset_dir", str(tmp_path),
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", "2", "--local_batch_size", "2", "--num_cols",
            "4096", "--valid_batch_size", "4", "--num_rounds", "2"]
    base = gpt2_train.main(argv)
    lev = gpt2_train.main(argv + ["--remat", "--lm_chunk", "16"])
    assert lev["rounds"] == base["rounds"] == 2
    np.testing.assert_allclose(lev["losses"], base["losses"], rtol=1e-5)
    assert math.isclose(lev["val_loss"], base["val_loss"], rel_tol=1e-5)
    w, w_base = (o["state"].ps_weights.numpy() for o in (lev, base))
    np.testing.assert_allclose(w, w_base, rtol=1e-5,
                               atol=1e-6 * np.abs(w_base).max())
