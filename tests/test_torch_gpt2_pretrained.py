"""GPT-2's weight I/O in the PyTorch port against the JAX package, on the
CPU: ``GPT2LMHead``, ``load_state_dict`` from an HF-GPT-2-layout state
dict, ``load_hf_weights`` from local ``pytorch_model.bin`` and
``model.safetensors`` files (no ``transformers``), the JAX package's
layout fingerprint computed without jax, and ``save_pretrained`` /
``load_pretrained`` across the two packages.

The HF checkpoints are written by the tests from a numpy seed. Weight
maps, fingerprints and saved weights are held bit for bit; the LM head's
forward in float32 to 1e-4 (summation order), in bf16 to 5% of the
largest logit (the frameworks round activations at different places),
as tests/test_torch_gpt2.py holds the DoubleHeads forward.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu import gpt2_train as jtrain
from commefficient_tpu.checkpoint import params_fingerprint
from commefficient_tpu.data import fed_persona as jpersona
from commefficient_tpu.models import gpt2 as jgpt2

from commefficient_torch import gpt2_train
from commefficient_torch.checkpoint import params_fingerprint_jax
from commefficient_torch.config import parse_known
from commefficient_torch.data.fed_persona import HashTokenizer
from commefficient_torch.models import gpt2 as tgpt2
from commefficient_torch.models.convert import params_from_jax


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


HEADS = {"doubleheads": (jgpt2.GPT2DoubleHeads, tgpt2.GPT2DoubleHeads),
         "lmhead": (jgpt2.GPT2LMHead, tgpt2.GPT2LMHead)}


def _init(jcls, gcfg, seed=0):
    ids = jnp.zeros((1, 2, 8), jnp.int32)
    if jcls is jgpt2.GPT2LMHead:
        return jcls(gcfg).init(jax.random.PRNGKey(seed), ids)
    return jcls(gcfg).init(jax.random.PRNGKey(seed), ids,
                           jnp.zeros((1, 2), jnp.int32), ids)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def hf_state_dict(E=64, L=2, V=256, P=160, seed=0):
    """An HF ``GPT2Model.state_dict()``-layout mapping at width E, L
    layers, V token rows and P positions, drawn from ``seed``: the
    attention mask buffers a real checkpoint holds too, and ``ln_f.bias``
    exact in bf16 (so a bf16 copy of it reads back bit for bit)."""
    rng = np.random.RandomState(seed)
    sd = {"wte.weight": rng.randn(V, E), "wpe.weight": rng.randn(P, E)}
    for i in range(L):
        for name, shape in (("attn.c_attn.weight", (E, 3 * E)),
                            ("attn.c_attn.bias", (3 * E,)),
                            ("attn.c_proj.weight", (E, E)),
                            ("attn.c_proj.bias", (E,)),
                            ("mlp.c_fc.weight", (E, 4 * E)),
                            ("mlp.c_fc.bias", (4 * E,)),
                            ("mlp.c_proj.weight", (4 * E, E)),
                            ("mlp.c_proj.bias", (E,)),
                            ("ln_1.weight", (E,)), ("ln_1.bias", (E,)),
                            ("ln_2.weight", (E,)), ("ln_2.bias", (E,))):
            sd[f"h.{i}.{name}"] = rng.randn(*shape) * 0.1
        sd[f"h.{i}.attn.bias"] = np.tril(np.ones((1, 1, 16, 16)))
    sd["ln_f.weight"] = rng.randn(E)
    sd["ln_f.bias"] = rng.randn(E)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    sd["ln_f.bias"] = (sd["ln_f.bias"].view(np.uint32)
                       & 0xFFFF0000).view(np.float32)
    return sd


def write_safetensors(path, sd, bf16=()):
    """The safetensors format, written with numpy: the header length (8
    bytes, little-endian), the JSON header, the raw buffers; the keys in
    ``bf16`` as BF16 (their float32's upper halves)."""
    header, chunks, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, arr in sd.items():
        if name in bf16:
            raw, dt = (arr.view(np.uint32) >> 16).astype("<u2").tobytes(), \
                "BF16"
        else:
            raw, dt = np.ascontiguousarray(arr, "<f4").tobytes(), "F32"
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob + b"".join(chunks))


def write_checkpoint(root, sd, fmt, prefix=""):
    """An HF checkpoint directory: ``pytorch_model.bin`` (``fmt`` bin) or
    ``model.safetensors`` (st), keys under ``prefix`` (``transformer.``
    for an LM-head checkpoint, which also holds ``lm_head.weight``)."""
    os.makedirs(root, exist_ok=True)
    sd = {prefix + k: v for k, v in sd.items()}
    if prefix:
        sd["lm_head.weight"] = sd[prefix + "wte.weight"]
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(root, "pytorch_model.bin"))
    else:
        write_safetensors(os.path.join(root, "model.safetensors"), sd,
                          bf16={prefix + "ln_f.bias"})
    return root


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_head_forward_matches_jax(dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = jgpt2.GPT2Config.small(compute_dtype=jd)
    params = _init(jgpt2.GPT2LMHead, jcfg)
    tm = tgpt2.GPT2LMHead(tgpt2.GPT2Config.small(compute_dtype=td))
    flat = params_from_jax(jax.tree.map(np.asarray, params), tm)
    assert all(not p.startswith("params/mc_head") for p, _ in tm.layout)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 261, (2, 3, 128)).astype(np.int32)
    tt = rng.randint(256, 261, (2, 3, 128)).astype(np.int32)
    ref = np.asarray(jgpt2.GPT2LMHead(jcfg).apply(
        params, jnp.asarray(ids), jnp.asarray(tt)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(tt).long(),
                 flat)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got.numpy() - ref).max() <= 0.05 * np.abs(ref).max()


@pytest.mark.parametrize("head", sorted(HEADS))
def test_load_state_dict_bitwise(head):
    """``wte`` padded with its mean row for the 5 added tokens, ``wpe``
    cut from 160 to 128 rows, the layers stacked, ``mc_head`` kept: the
    port's flat vector is the JAX package's tree, raveled, bit for bit,
    whether the port is given the model or its flat vector."""
    jcls, tcls = HEADS[head]
    gcfg_j = jgpt2.GPT2Config.small(compute_dtype=jnp.float32)
    params = _init(jcls, gcfg_j)
    sd = hf_state_dict()
    want = ravel_pytree(jgpt2.load_state_dict(params, gcfg_j, sd))[0]
    tm = tcls(tgpt2.GPT2Config.small(compute_dtype=torch.float32))
    flat = params_from_jax(jax.tree.map(np.asarray, params), tm)
    with torch.no_grad():
        tm.flat.copy_(flat)
    for target in (tm, flat):
        got = tgpt2.load_state_dict(target, tm.gcfg, sd)
        assert got.dtype == torch.float32
        assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_load_state_dict_refusals(fault):
    """A missing key raises KeyError and a wrong shape ValueError, in
    both packages."""
    sd = hf_state_dict()
    if fault == "missing":
        del sd["h.1.mlp.c_fc.bias"]
        err = KeyError
    else:
        sd["h.0.attn.c_proj.weight"] = sd["h.0.attn.c_proj.weight"][:, :60]
        err = ValueError
    gcfg_j = jgpt2.GPT2Config.small(compute_dtype=jnp.float32)
    with pytest.raises(err):
        jgpt2.load_state_dict(_init(jgpt2.GPT2DoubleHeads, gcfg_j), gcfg_j,
                              sd)
    tm = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config.small())
    with pytest.raises(err):
        tgpt2.load_state_dict(tm, tm.gcfg, sd)


@pytest.mark.parametrize("fmt,prefix,where", [
    ("bin", "", "dir"), ("bin", "transformer.", "dir"),
    ("st", "", "dir"), ("st", "transformer.", "dir"), ("st", "", "hub")])
def test_load_hf_weights_reads_local_files(tmp_path, monkeypatch, fmt,
                                           prefix, where):
    """``load_hf_weights`` from a directory or, for a bare hub name, from
    the snapshot ``refs/main`` names in ``HF_HUB_CACHE``: the weights
    ``load_state_dict`` gives for the arrays written, bit for bit (a bf16
    tensor of the safetensors file widened exactly)."""
    sd = hf_state_dict(seed=1)
    if where == "hub":
        repo = tmp_path / "hub" / "models--gpt2"
        write_checkpoint(str(repo / "snapshots" / "abc123"), sd, fmt, prefix)
        (repo / "refs").mkdir()
        (repo / "refs" / "main").write_text("abc123")
        monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
        name = "gpt2"
    else:
        name = write_checkpoint(str(tmp_path / "ckpt"), sd, fmt, prefix)
    tm = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config.small(),
                               generator=torch.Generator().manual_seed(0))
    got = tgpt2.load_hf_weights(tm, tm.gcfg, name)
    want = tgpt2.load_state_dict(tm, tm.gcfg, sd)
    assert got is not None and np.array_equal(_bits(got), _bits(want))


def test_load_hf_weights_is_none_without_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    tm = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config.small())
    (tmp_path / "empty").mkdir()
    assert tgpt2.load_hf_weights(tm, tm.gcfg, str(tmp_path / "empty")) is None
    assert tgpt2.load_hf_weights(tm, tm.gcfg, "gpt2") is None


@pytest.mark.parametrize("config", ["small", "full"])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_params_fingerprint_equals_jax(config, head):
    """The port's fingerprint of a layout is the JAX package's
    ``params_fingerprint`` of the same model's tree (``jax.eval_shape``),
    at ``GPT2Config.small`` and at GPT-2 small's width over the
    HashTokenizer vocabulary."""
    jcls, tcls = HEADS[head]
    kw = dict(vocab_size=8192)
    jcfg = (jgpt2.GPT2Config.small(**kw) if config == "small"
            else jgpt2.GPT2Config(**kw))
    tcfg = (tgpt2.GPT2Config.small(**kw) if config == "small"
            else tgpt2.GPT2Config(**kw))
    shapes = jax.eval_shape(lambda: _init(jcls, jcfg))
    layout = tgpt2.ravel_layout(tgpt2.param_tree(tcfg, tcls.mc_head))
    assert params_fingerprint_jax(layout) == params_fingerprint(shapes)


def test_config_fields_are_the_jax_package_s():
    import dataclasses
    assert [f.name for f in dataclasses.fields(tgpt2.GPT2Config)] == \
        [f.name for f in dataclasses.fields(jgpt2.GPT2Config)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_pretrained_across_packages(tmp_path, writer):
    """A ``save_pretrained`` directory written by either package is read
    by the other's ``load_pretrained``: the config, the tokenizer and the
    weights bit for bit; a directory whose fingerprint is another
    layout's is refused."""
    jcfg = jgpt2.GPT2Config.small(vocab_size=8192, remat=True,
                                  remat_policy="dots_saveable")
    tcfg = tgpt2.GPT2Config.small(vocab_size=8192, remat=True,
                                  remat_policy="dots_saveable")
    params = _init(jgpt2.GPT2DoubleHeads, jcfg, seed=3)
    flat, unravel = ravel_pytree(params)
    out = str(tmp_path / "gpt2_doubleheads")
    if writer == "jax":
        runtime = types.SimpleNamespace(unravel=unravel,
                                        flat_weights=lambda s: s)
        jtrain.save_pretrained(out, runtime, flat, jcfg,
                               jpersona.HashTokenizer())
        model, got, gcfg, tok = gpt2_train.load_pretrained(out)
        assert gcfg == tcfg and isinstance(tok, HashTokenizer)
        assert tok.base_vocab == 8192
        assert np.array_equal(_bits(model.flat.detach()), _bits(flat))
    else:
        tm = tgpt2.GPT2DoubleHeads(tcfg)
        runtime = types.SimpleNamespace(layout=tm.layout)
        state = types.SimpleNamespace(ps_weights=torch.from_numpy(
            np.array(flat)))
        gpt2_train.save_pretrained(out, runtime, state, tcfg,
                                   HashTokenizer())
        _, jparams, gcfg, tok = jtrain.load_pretrained(out)
        assert gcfg == jcfg and tok.base_vocab == 8192
        got = ravel_pytree(jparams)[0]
    assert np.array_equal(_bits(got), _bits(flat))
    with open(os.path.join(out, "config.json")) as f:
        blob = json.load(f)
    blob["n_layer"] = 3
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(blob, f)
    with pytest.raises(ValueError, match="different parameter layout"):
        gpt2_train.load_pretrained(out)
    with pytest.raises(ValueError, match="different parameter layout"):
        jtrain.load_pretrained(out)


def test_entry_point_loads_and_saves_pretrained(tmp_path, capsys):
    """``gpt2_train --model_checkpoint DIR --checkpoint --iid --num_clients
    16``: the initial weights are ``load_state_dict`` of the file's arrays
    (over the seeded initialisation's ``mc_head``) bit for bit, and the
    run's final weights come back from ``load_pretrained`` of both
    packages bit for bit; an empty directory trains from scratch with the
    JAX package's warning."""
    sd = hf_state_dict(V=8192, seed=2)
    ckpt = write_checkpoint(str(tmp_path / "hf"), sd, "bin", "transformer.")
    argv = ["--test", "--device", "cpu", "--dataset_dir",
            str(tmp_path / "data"), "--error_type", "virtual",
            "--local_momentum", "0", "--num_workers", "2",
            "--local_batch_size", "2", "--num_cols", "4096",
            "--valid_batch_size", "4", "--iid", "--num_clients", "16",
            "--model_checkpoint", ckpt]
    runtime = gpt2_train.setup(parse_known(gpt2_train.build_parser(),
                                           argv))[0]
    assert "loaded pretrained GPT-2 weights" in capsys.readouterr().out
    seeded = tgpt2.GPT2DoubleHeads(
        tgpt2.GPT2Config.small(vocab_size=8192),
        generator=torch.Generator().manual_seed(runtime.cfg.seed))
    want = tgpt2.load_state_dict(seeded, seeded.gcfg, sd)
    assert np.array_equal(_bits(runtime.initial_weights), _bits(want))
    assert runtime.cfg.num_clients == 16 and runtime.cfg.do_iid

    out = gpt2_train.main(argv + ["--checkpoint", "--checkpoint_path",
                                  str(tmp_path / "ck")])
    final = out["state"].ps_weights
    assert not np.array_equal(_bits(final), _bits(want))
    saved = str(tmp_path / "ck" / "gpt2_doubleheads")
    assert np.array_equal(_bits(gpt2_train.load_pretrained(saved)[1]),
                          _bits(final))
    assert np.array_equal(
        _bits(ravel_pytree(jtrain.load_pretrained(saved)[1])[0]),
        _bits(final))

    (tmp_path / "empty").mkdir()
    gpt2_train.setup(parse_known(gpt2_train.build_parser(), argv[:-1] + [
        str(tmp_path / "empty")]))
    assert ("WARNING: no local pretrained GPT-2; training from scratch"
            in capsys.readouterr().out)
