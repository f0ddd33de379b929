"""K3, the causal flash attention of the PyTorch port
(ops/flash_attention.py), against the JAX package on the CPU.

The JAX package's ``flash_causal_attention`` runs
``dense_causal_attention`` off a TPU (models/gpt2.py:118-128), so that is
the reference: the port's plain forward must equal it, and the gradients
through the port's ``torch.autograd.Function`` (on the CPU: the plain,
explicit backward from the saved log-sum-exp) must equal ``jax.grad`` of
it. float32 to 1e-5 relative (only the order of float additions differs);
bf16 inputs to 4 bf16 ulps of the output's largest element (the JAX
function rounds the scores and the probabilities to bf16, the plain
version keeps both in float32). The tests marked ``cuda`` hold the
kernels behind the same Function against the plain versions on the card,
each output row against its own norm (``chip_smoke.py``'s rule); the JAX
package is imported inside a fixture, so they also run where it does not
import:

    python -m pytest --noconftest tests/test_torch_attention.py
"""

import math
import warnings

import numpy as np
import pytest
import torch

from commefficient_torch.models import gpt2 as tgpt2
from commefficient_torch.ops import flash_attention as flash


@pytest.fixture(scope="module")
def ref():
    """``(jax, jax.numpy, the JAX package's models.gpt2)``."""
    jax = pytest.importorskip("jax")
    try:
        from commefficient_tpu.models import gpt2 as jgpt2
    except ImportError as e:
        pytest.skip(f"the JAX package does not import here ({e})")
    return jax, jax.numpy, jgpt2


SHAPES = [(2, 128, 2, 16), (1, 256, 3, 32), (2, 128, 1, 64)]


def _inputs(N, S, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(N, S, H, D).astype(np.float32) for _ in range(4)]


def _ulps(ref: np.ndarray, n: int) -> float:
    """``n`` bf16 units in the last place at ref's largest magnitude."""
    return n * 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("N,S,H,D", SHAPES)
def test_plain_forward_matches_jax_dense_f32(ref, N, S, H, D):
    _, jnp, jgpt2 = ref
    q, k, v, _ = _inputs(N, S, H, D)
    want = np.asarray(jgpt2.dense_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    o, lse = flash.forward_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), want, rtol=1e-5, atol=1e-6)
    # lse is the log normaliser of each row: logsumexp of the masked
    # scaled scores, computed here by numpy in float64
    s = np.einsum("nqhd,nkhd->nhqk", q.astype(np.float64), k) / math.sqrt(D)
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    top = s.max(-1)
    lse_ref = top + np.log(np.exp(s - top[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,S,H,D", SHAPES)
def test_plain_forward_tracks_jax_dense_bf16(ref, N, S, H, D):
    _, jnp, jgpt2 = ref
    q, k, v, _ = _inputs(N, S, H, D, seed=1)
    want = np.asarray(jgpt2.dense_causal_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))).astype(
            np.float32)
    o, _ = flash.forward_plain(*(torch.from_numpy(t).bfloat16()
                                 for t in (q, k, v)))
    assert o.dtype == torch.bfloat16
    assert np.abs(o.float().numpy() - want).max() <= _ulps(want, 4)


@pytest.mark.parametrize("N,S,H,D", SHAPES)
def test_gradients_match_jax_grad(ref, N, S, H, D):
    """dq, dk, dv through the autograd.Function (plain backward on the
    CPU) against jax.grad of <dense_causal_attention(q, k, v), dO>."""
    jax, jnp, jgpt2 = ref
    q, k, v, do = _inputs(N, S, H, D, seed=2)

    def objective(q, k, v):
        return (jgpt2.dense_causal_attention(q, k, v) * jnp.asarray(do)).sum()

    refs = jax.grad(objective, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = flash.flash_attention(*ts)
    o.backward(torch.from_numpy(do))
    for t, want in zip(ts, refs):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("N,S,H,D", SHAPES[:2])
def test_plain_backward_matches_autograd_of_plain_forward(N, S, H, D):
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(N, S, H, D, seed=3))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash.forward_plain(*ts)
    o.backward(do)
    got = flash.backward_plain(q, k, v, o.detach(), lse.detach(), do)
    for t, g in zip(ts, got):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-6)


def test_dispatch_follows_the_jax_rules(monkeypatch):
    """auto: K3 from S = 1024 up, dense below; flash: K3 when S % 128 ==
    0, else dense with the JAX package's warning. K3 is the only other
    route: the dispatch never falls back on a failure."""
    calls = []
    monkeypatch.setattr(tgpt2, "flash_attention",
                        lambda q, k, v: calls.append(q.shape[-3]) or q)
    q = torch.zeros(1, 1024, 1, 16)
    tgpt2.resolve_attn("auto")(q, q, q)
    tgpt2.resolve_attn("auto")(q[:, :512], q[:, :512], q[:, :512])
    tgpt2.resolve_attn("flash")(q[:, :256], q[:, :256], q[:, :256])
    with pytest.warns(UserWarning, match="ineligible"):
        tgpt2.resolve_attn("flash")(q[:, :200], q[:, :200], q[:, :200])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tgpt2.resolve_attn("dense")(q[:, :256], q[:, :256], q[:, :256])
    tgpt2.resolve_attn("auto")(q[:, :1000], q[:, :1000], q[:, :1000])
    assert calls == [1024, 256]
    with pytest.raises(ValueError, match="attn_impl"):
        tgpt2.resolve_attn("ring")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [192, 256, 1024])
def test_function_on_card_matches_plain(cuda, S):
    """The autograd.Function on the card at GPT-2's head width: q, k, v
    are the slices of one c_attn-shaped buffer, and the kernels' gradients
    land in that buffer through the split's backward. Tolerances as in
    tests/test_torch_kernels.py: each row of o, dq, dk and dv within
    ``chip_smoke.FLASH_ROW_RTOL`` of its own norm."""
    import chip_smoke
    N, H, D = 2, 12, 64
    rng = np.random.RandomState(4)
    qkv_np = rng.randn(N, S, 3 * H * D).astype(np.float32)
    do = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32)).to(
        cuda, torch.bfloat16)
    flash.reset_launches()
    qkv = torch.from_numpy(qkv_np).to(cuda, torch.bfloat16).requires_grad_()
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    o = flash.flash_attention(q, k, v)
    o.backward(do)
    torch.cuda.synchronize()
    assert flash.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                              "flash_bwd_dkv": 1}
    qp, kp, vp = (t.detach() for t in (q, k, v))
    o_ref, lse = flash.forward_plain(qp, kp, vp)
    assert float(chip_smoke.row_errors(o.detach(), o_ref).max()) <= \
        chip_smoke.FLASH_ROW_RTOL
    grads = flash.backward_plain(qp, kp, vp, o.detach(), lse, do)
    got = qkv.grad.unflatten(-1, (3, H, D))
    for j, want in enumerate(grads):
        assert float(chip_smoke.row_errors(got[:, :, j], want).max()) <= \
            chip_smoke.FLASH_ROW_RTOL
