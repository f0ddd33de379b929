"""The GPT-2 slice of the PyTorch port against the JAX package, on the CPU,
at ``GPT2Config.small`` (2 layers, width 64, 4 heads).

The same weights (``params_from_jax`` of the JAX initialisation) and the
same numpy inputs go through both packages: the layout and the weight
carry-over, the forward (float32 and bf16, ``attn_impl`` dense and flash:
off a TPU the JAX package's flash runs dense attention, the port's runs
K3's plain version), the DoubleHeads losses and their gradients, the packed
synthetic PersonaChat arrays (bitwise), the GPT-2 LR schedule, three
sketch rounds through both ``FedRuntime``s, and the ``gpt2_train`` entry
point. float32 arms are held to 1e-4 relative or tighter (only the order
of float additions differs); bf16 arms to the stated looser bounds (the
frameworks round at different places).
"""

import math
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.data import fed_persona as jpersona  # noqa: E402
from commefficient_tpu.gpt2_train import \
    make_gpt2_schedule as j_schedule  # noqa: E402
from commefficient_tpu.losses import (  # noqa: E402
    make_gpt2_train_loss as j_train_loss, make_gpt2_val_loss as j_val_loss)
from commefficient_tpu.models import gpt2 as jgpt2  # noqa: E402

from commefficient_torch import gpt2_train  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.data import fed_persona as tpersona  # noqa: E402
from commefficient_torch.losses import (  # noqa: E402
    make_gpt2_train_loss, make_gpt2_val_loss)
from commefficient_torch.models import gpt2 as tgpt2  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.utils.schedules import (  # noqa: E402
    make_gpt2_schedule)


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


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _models(dtype="float32", attn="dense", seed=0):
    jd, td = DTYPES[dtype]
    jm = jgpt2.GPT2DoubleHeads(jgpt2.GPT2Config.small(compute_dtype=jd),
                               attn_impl=jgpt2.resolve_attn(attn))
    ids = jnp.zeros((1, 2, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), ids,
                     jnp.zeros((1, 2), jnp.int32), ids)
    tm = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config.small(compute_dtype=td),
                               attn_impl=attn)
    flat = params_from_jax(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm, flat


def _batch(B=2, C=2, S=128, V=261, seed=0):
    """A PersonaChat-shaped batch: int32 arrays, labels -100 outside a
    reply span of the last (gold) candidate, and a (B,) mask with the last
    item invalid."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, C, S)).astype(np.int32)
    tt = rng.randint(V - 5, V, (B, C, S)).astype(np.int32)
    labels = np.full((B, C, S), -100, np.int32)
    labels[:, -1, S // 2:] = ids[:, -1, S // 2:]
    batch = {"input_ids": ids, "token_type_ids": tt, "lm_labels": labels,
             "mc_token_ids": rng.randint(S // 2, S, (B, C)).astype(np.int32),
             "mc_label": np.full((B,), C - 1, np.int32)}
    mask = np.ones(B, bool)
    mask[-1] = False
    return batch, mask


def _torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_layout_matches_ravel_pytree():
    jm, params, tm, flat = _models()
    ref, _ = ravel_pytree(params)
    assert tm.num_params == ref.size
    assert np.array_equal(flat.numpy(), np.asarray(ref))
    # the slice's width, by shapes alone: GPT-2 small over the
    # HashTokenizer vocabulary, d = 92,138,496
    gcfg = jgpt2.GPT2Config(vocab_size=8192)
    ids = jnp.zeros((1, 2, 8), jnp.int32)
    shapes = jax.eval_shape(jgpt2.GPT2DoubleHeads(gcfg).init,
                            jax.random.PRNGKey(0), ids,
                            jnp.zeros((1, 2), jnp.int32), ids)
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    ref_layout = [("/".join(k.key for k in path), tuple(s.shape))
                  for path, s in leaves]
    full = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config(vocab_size=8192))
    assert full.layout == ref_layout
    assert full.num_params == 92_138_496


def test_params_from_jax_rejects_a_foreign_tree():
    _, params, _, _ = _models()
    wrong = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config.small(n_layer=3))
    with pytest.raises(ValueError, match="layout"):
        params_from_jax(jax.tree.map(np.asarray, params), wrong)


@pytest.mark.parametrize("dtype,attn", [("float32", "dense"),
                                        ("float32", "flash"),
                                        ("bfloat16", "dense"),
                                        ("bfloat16", "flash")])
def test_forward_matches_reference(dtype, attn):
    """lm and mc logits. float32: 1e-4 relative, 1e-4 absolute; bf16:
    within 5% of the largest |logit| (activations are rounded to bf16 at
    different places in every layer)."""
    jm, params, tm, flat = _models(dtype, attn)
    batch, _ = _batch()
    with pytest.warns(UserWarning) if attn == "flash" else nullcontext():
        lm_ref, mc_ref = jm.apply(params, jnp.asarray(batch["input_ids"]),
                                  jnp.asarray(batch["mc_token_ids"]),
                                  jnp.asarray(batch["token_type_ids"]))
    tb = _torch(batch)
    with torch.no_grad():
        lm, mc = tm(tb["input_ids"], tb["mc_token_ids"],
                    tb["token_type_ids"], flat)
    assert lm.dtype == mc.dtype == torch.float32
    lm_ref, mc_ref = np.asarray(lm_ref), np.asarray(mc_ref)
    if dtype == "float32":
        np.testing.assert_allclose(lm.numpy(), lm_ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mc.numpy(), mc_ref, rtol=1e-4, atol=1e-4)
    else:
        for got, ref in ((lm, lm_ref), (mc, mc_ref)):
            assert np.abs(got.numpy() - ref).max() <= \
                0.05 * np.abs(ref).max()


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_losses_and_gradient_match_reference(attn):
    """float32: train loss, its flat gradient and the validation metrics,
    with one item of the batch masked out."""
    jm, params, tm, flat = _models("float32", attn)
    batch, mask = _batch(seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.warns(UserWarning) if attn == "flash" else nullcontext():
        (l_ref, (a_ref,)), g_ref = jax.value_and_grad(
            j_train_loss(jm, 1.0, 2.0), has_aux=True)(
                params, jb, jnp.asarray(mask))
        v_ref, (va_ref,) = j_val_loss(jm)(params, jb, jnp.asarray(mask))
    g_ref = np.asarray(ravel_pytree(g_ref)[0])

    w = flat.clone().requires_grad_(True)
    tb, tmask = _torch(batch), torch.from_numpy(mask)
    l_got, (a_got,) = make_gpt2_train_loss(tm, 1.0, 2.0)(w, tb, tmask)
    (g_got,) = torch.autograd.grad(l_got, w)
    with torch.no_grad():
        v_got, (va_got,) = make_gpt2_val_loss(tm)(flat, tb, tmask)
    np.testing.assert_allclose(float(l_got.detach()), float(l_ref),
                               rtol=1e-5)
    np.testing.assert_allclose(float(v_got), float(v_ref), rtol=1e-5)
    assert float(a_got) == float(a_ref) and float(va_got) == float(va_ref)
    np.testing.assert_allclose(g_got.numpy(), g_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("C,S,hist,perms", [(2, 64, 2, 1), (2, 1024, 1, 2),
                                            (1, 128, 2, 1)])
def test_packed_persona_equals_reference(tmp_path, C, S, hist, perms):
    kw = dict(num_candidates=C, max_seq_len=S, max_history=hist,
              personality_permutations=perms)
    for train in (True, False):
        ref = jpersona.FedPERSONA(str(tmp_path), train=train,
                                  tokenizer=jpersona.HashTokenizer(), **kw)
        got = tpersona.FedPERSONA(str(tmp_path), train=train,
                                  tokenizer=tpersona.HashTokenizer(), **kw)
        assert len(got) == len(ref)
        assert sorted(got.arrays) == sorted(ref.arrays)
        for key, arr in ref.arrays.items():
            assert got.arrays[key].dtype == arr.dtype == np.int32
            np.testing.assert_array_equal(got.arrays[key], arr)
        if train:
            np.testing.assert_array_equal(got.data_per_client,
                                          ref.data_per_client)
            idx = np.array([[0, 5, 2], [7, 1, 3]])
            for key, arr in ref.gather(idx).items():
                np.testing.assert_array_equal(got.gather(idx)[key], arr)


@pytest.mark.parametrize("warmup", [False, True])
def test_gpt2_schedule_matches_reference(warmup):
    jc = JConfig(lr_scale=0.16, num_epochs=4.0, local_momentum=0.0,
                 lr_warmup=warmup, pivot_epoch=1.5)
    tc = FedConfig(model="GPT2", dataset_name="PERSONA", lr_scale=0.16,
                   num_epochs=4.0, lr_warmup=warmup, pivot_epoch=1.5)
    ref, got = j_schedule(jc), make_gpt2_schedule(tc)
    for t in (0.0, 0.5, 1.5, 2.25, 4.0, 5.0):
        assert got(t) == pytest.approx(float(ref(t)), abs=1e-12)
    assert got(0.0) == (0.0 if warmup else 0.16)


@pytest.mark.filterwarnings("ignore:attn_impl='flash' was requested")
def test_three_sketch_rounds_match_reference():
    """float32 FetchSGD rounds of GPT2Config.small at S = 128 with
    ``attn_impl flash`` (dense in the JAX package off a TPU, K3's plain
    version in the port): per-round losses to rtol 1e-5, the final weights
    to rtol 1e-5 plus atol 1e-6 (float32 summation order in the gradients
    and a few ulps of the weights, but not one top-k coordinate more or
    fewer in any round: that would move a weight by lr x its estimate,
    ~1e-3 here)."""
    W, B, C, S, c, r, k = 2, 2, 2, 128, 4096, 5, 200
    jm, params, tm, flat = _models("float32", "flash")
    slice_kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
                    virtual_momentum=0.9, weight_decay=5e-4, k=k,
                    num_rows=r, num_cols=c, num_workers=W,
                    local_batch_size=B)
    jrt = JRuntime(JConfig(**slice_kw, track_bytes=False, telemetry=False),
                   params, j_train_loss(jm), j_val_loss(jm), num_clients=12)
    assert jrt._fused and jrt._fused_encode
    with torch.no_grad():
        tm.flat.copy_(flat)
    trt = FedRuntime(FedConfig(**slice_kw, model="GPT2",
                               dataset_name="PERSONA"),
                     tm, make_gpt2_train_loss(tm), device="cpu",
                     loss_fn_val=make_gpt2_val_loss(tm))
    jst, tst = jrt.init_state(), trt.init_state()
    for rnd in range(3):
        parts = [_batch(B, C, S, seed=10 * rnd + w) for w in range(W)]
        batch = {key: np.stack([p[0][key] for p in parts])
                 for key in parts[0][0]}
        mask = np.ones((W, B), bool)
        mask[1, 1] = False           # an underfull client
        ids, lr = np.arange(W), 0.05 * (rnd + 1)
        jst, jmet = jrt.round(jst, jnp.asarray(ids),
                              {key: jnp.asarray(v)
                               for key, v in batch.items()},
                              jnp.asarray(mask), lr)
        tst, tmet = trt.round(tst, ids, batch, mask, lr)
        np.testing.assert_allclose(tmet["results"][0].numpy(),
                                   np.asarray(jmet["results"][0]), rtol=1e-5)
        np.testing.assert_array_equal(tmet["results"][1].numpy(),
                                      np.asarray(jmet["results"][1]))
    w_ref = np.asarray(jrt.flat_weights(jst))
    w_got = tst.ps_weights.numpy()
    assert (w_got != flat.numpy()).sum() > 0
    np.testing.assert_allclose(w_got, w_ref, rtol=1e-5, atol=1e-6)
    # the error table sums every round's gradients in table space: 1e-4
    # relative, and 1e-5 of its largest cell where entries cancel
    v_ref = np.asarray(jst.Verror)
    np.testing.assert_allclose(tst.Verror.numpy(), v_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(v_ref).max())


@pytest.mark.parametrize("extra,rounds", [([], 1),
                                          (["--num_rounds", "2"], 2)])
def test_gpt2_train_runs_on_cpu(tmp_path, capsys, extra, rounds):
    """``--test`` runs one round, as the JAX package's gpt2_train does, unless
    ``--num_rounds`` asks for more."""
    out = gpt2_train.main([
        "--test", "--device", "cpu", "--dataset_dir", str(tmp_path),
        "--error_type", "virtual", "--local_momentum", "0",
        "--num_workers", "2", "--local_batch_size", "2", "--num_cols",
        "4096", "--valid_batch_size", "4", *extra])
    assert out["rounds"] == rounds and np.isfinite(out["losses"]).all()
    assert math.isfinite(out["val_loss"]) and 0 <= out["val_acc"] <= 1
    assert out["tokens_per_round"] == 2 * 2 * 2 * 64
    text = capsys.readouterr().out
    assert "final val nll" in text and "tokens/s" in text


def test_gpt2_train_validates_before_start(tmp_path, capsys):
    """``--eval_before_start`` validates once before the first round, as
    the JAX package's loop does (``cv_train.py:573``), and leaves the
    run's rounds as they were."""
    argv = ["--test", "--device", "cpu", "--dataset_dir", str(tmp_path),
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", "2", "--local_batch_size", "2", "--num_cols",
            "4096", "--valid_batch_size", "4", "--num_rounds", "2",
            "--no_telemetry"]
    plain = gpt2_train.main(argv)
    assert "Test acc at epoch 0" not in capsys.readouterr().out
    first = gpt2_train.main(argv + ["--eval_before_start"])
    text = capsys.readouterr().out
    assert text.count("Test acc at epoch 0: ") == 1
    assert text.index("Test acc at epoch 0") < text.index("final val nll")
    assert first["losses"] == plain["losses"]
    assert first["val_loss"] == plain["val_loss"]


@pytest.mark.parametrize("flags,name", [
    (["--mesh_axes", "clients,model"], "--mesh_axes"),
    (["--defense", "trimmed_mean"], "--defense"),
    (["--async_agg", "--mode", "true_topk", "--error_type", "virtual"],
     "--async_agg"), (["--mesh_shape", "2"],
                                       "--mesh_shape"),
    (["--scenario", "dropout"], "--scenario")])
def test_gpt2_train_rejects_flags_outside_the_slice(flags, name):
    with pytest.raises(ValueError, match=name):
        gpt2_train.main(["--test", "--device", "cpu", *flags])
