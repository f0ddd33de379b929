"""The sketch table's wire in the port (``--wire_dtype``, ``--wire_block``,
``--sketch_dtype``; ops/wire.py) against the JAX package's, on the CPU.

- The int8 wire's draws, ``q``, ``scale`` and reconstructions are held
  bit for bit on tables with zeros, all-zero blocks, NaN, +-inf and
  values at exactly half a step.
- One argv gives the same config fields in both packages, or a refusal
  in both; ``--sketch_dtype`` warns in both.
- ``upload_wire_bytes`` equals the JAX package's across modes, dtypes and
  blocks, and so do both runtimes' bytes a client.
- Whole rounds under the bf16 and int8 wires (fused, unfused deferred,
  per-client under the table clip, the hash sketch) against the JAX
  package's ``FedRuntime`` with tests/test_torch_modes.py's tolerances:
  losses rtol 1e-5, final weights atol 1e-6, bytes exactly.
- An int8 run resumed from its checkpoint equals the run without a break
  bit for bit.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modes import (SKETCH, init_params,  # noqa: E402
                              port_runtime, ref_runtime, round_inputs)

from commefficient_tpu import config as jconfig  # noqa: E402
from commefficient_tpu.ops import circulant as jcirc  # noqa: E402
from commefficient_tpu.ops import sketch as jsketch  # noqa: E402
from commefficient_tpu.ops import wire as jwire  # noqa: E402

from commefficient_torch import config as tconfig  # noqa: E402
from commefficient_torch import cv_train, gpt2_train  # noqa: E402
from commefficient_torch.checkpoint import CheckpointManager  # noqa: E402
from commefficient_torch.checkpoint import sketch_generation  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.ops import circulant as tcirc  # noqa: E402
from commefficient_torch.ops import sketch as tsketch  # noqa: E402
from commefficient_torch.ops import wire as twire  # noqa: E402


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


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want) -> bool:
    """Bitwise, NaN by position (the sign-xor keeps payloads the float
    units canonicalise)."""
    g, w = np.asarray(got), np.asarray(want)
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        return False
    return np.array_equal(_bits(np.nan_to_num(g)), _bits(np.nan_to_num(w)))


def special_table(r=3, c=64, seed=0):
    """Seeded randn with a zero block, a -0 block, a NaN block, +inf and
    -inf blocks, and a block of scale exactly 1 holding half steps."""
    rng = np.random.RandomState(seed)
    t = rng.randn(r, c).astype(np.float32)
    t[0, :8] = 0.0
    t[0, 8:16] = -0.0
    t[1, 3] = np.nan
    t[1, 20] = np.inf
    t[2, 40] = -np.inf
    t[2, :8] = [127.0, 63.5, -63.5, 0.5, 1.5, -2.5, -0.0, 1.0]
    return t


DRAWS = [(21, 0, 0), (7, 5, 3), (2**32 - 1, 2**31 - 1, 2**30)]


@pytest.mark.parametrize("seed,round_idx,salt", DRAWS)
def test_wire_uniform_bitwise(seed, round_idx, salt):
    got = twire.wire_uniform(5, 300, seed=seed, round_idx=round_idx,
                             salt=salt)
    want = jwire.wire_uniform(5, 300, seed=seed, round_idx=round_idx,
                              salt=salt)
    assert _same(got, want)
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("seed,round_idx,salt", DRAWS)
def test_quantize_and_dequantize_bitwise(seed, round_idx, salt,
                                         stochastic):
    t = special_table()
    block = 8
    qj, sj = jwire.quantize_table(jnp.asarray(t), block, seed=seed,
                                  round_idx=round_idx, salt=salt,
                                  stochastic=stochastic)
    qt, st = twire.quantize_table(torch.from_numpy(t), block, seed=seed,
                                  round_idx=round_idx, salt=salt,
                                  stochastic=stochastic)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert _same(st, sj)
    # the zero blocks: scale 0, exact zeros; the NaN and inf blocks: a
    # non-finite scale
    assert float(st[0, 0]) == float(st[0, 1]) == 0.0
    assert not qt[0, :16].any()
    assert np.isnan(float(st[1, 0])) and np.isinf(float(st[1, 2]))
    assert _same(twire.dequantize_table(qt, st, block),
                 jwire.dequantize_table(qj, sj, block))
    if not stochastic:
        # half steps round to even, as jnp.round
        assert qt[2, :8].tolist() == [127, 64, -64, 0, 2, -2, 0, 1]
    assert _same(twire.wire_round_trip(torch.from_numpy(t), block,
                                       seed=seed, round_idx=round_idx,
                                       salt=salt),
                 jwire.wire_round_trip(jnp.asarray(t), block, seed=seed,
                                       round_idx=round_idx, salt=salt))


def test_dequantize_accum_and_sketch_entry_points_bitwise():
    rng = np.random.RandomState(4)
    q = rng.randint(-127, 128, size=(4, 3, 64)).astype(np.int8)
    s = rng.rand(4, 3, 8).astype(np.float32)
    s[0, 0, 0] = 0.0
    assert _same(twire.dequantize_accum(torch.from_numpy(q),
                                        torch.from_numpy(s), 8),
                 jwire.dequantize_accum(jnp.asarray(q), jnp.asarray(s), 8))
    assert twire.WIRE_CELL_BYTES == jwire.WIRE_CELL_BYTES
    assert (twire.INT8_MAX, twire.REDUCE_SALT) == (jwire.INT8_MAX,
                                                   jwire.REDUCE_SALT)
    t = special_table()
    pairs = [(tcirc.make_circulant_sketch(1000, 64, 3, device="cpu"),
              jcirc.make_circulant_sketch(1000, 64, 3)),
             (tsketch.make_sketch(1000, 64, 3, device="cpu"),
              jsketch.make_sketch(1000, 64, 3))]
    for ts, js in pairs:
        qt, st = ts.quantize_wire(torch.from_numpy(t), 16, seed=3,
                                  round_idx=2, salt=1)
        qj, sj = js.quantize_wire(jnp.asarray(t), 16, seed=3, round_idx=2,
                                  salt=1)
        assert np.array_equal(qt.numpy(), np.asarray(qj)) and _same(st, sj)
        assert _same(ts.dequantize_wire(qt, st, 16),
                     js.dequantize_wire(qj, sj, 16))


def test_stochastic_rounding_is_unbiased():
    """Over many rounds' draws the mean reconstruction of a cell is the
    cell: within 4 standard errors of the rounding's (at most half a
    step, over 2,000 draws)."""
    t = torch.from_numpy(special_table()[:, 16:])
    t = torch.nan_to_num(t, posinf=0.0, neginf=0.0)
    recon = torch.stack([twire.wire_round_trip(t, 16, seed=1, round_idx=i,
                                               salt=0)
                         for i in range(2000)])
    step = twire.quantize_table(t, 16, seed=1, round_idx=0, salt=0)[1]
    step = step.repeat_interleave(16, dim=1)
    assert ((recon.mean(0) - t).abs() <= 4 * 0.5 * step / 2000 ** 0.5
            + 1e-6).all()


# ------------------------------------------------------------ config


def _both(argv):
    """The config each package's CV entry point parses from ``argv``."""
    ref = jconfig.parse_args(argv, default_lr=0.4)
    got = tconfig.config_from_args(
        tconfig.parse_known(cv_train.build_parser(), argv))
    return ref, got


SK = ["--mode", "sketch", "--error_type", "virtual", "--local_momentum",
      "0"]
ARGVS = {
    "default": SK,
    "bf16_wire": SK + ["--wire_dtype", "bfloat16"],
    "alias_bf16": SK + ["--sketch_dtype", "bfloat16"],
    "alias_then_float32_wire": SK + ["--sketch_dtype", "bfloat16",
                                     "--wire_dtype", "float32"],
    "alias_then_int8_wire": SK + ["--sketch_dtype", "bfloat16",
                                  "--wire_dtype", "int8"],
    "int8_block": SK + ["--wire_dtype", "int8", "--wire_block", "128"],
    "int8_hash": SK + ["--wire_dtype", "int8", "--sketch_impl", "hash"],
    "rht_scan_bf16": SK + ["--sketch_impl", "rht", "--allow_divergent_rht",
                           "--sketch_scan_rows", "1", "--sketch_dtype",
                           "bfloat16"],
    "rht_batched": SK + ["--sketch_impl", "rht", "--sketch_scan_rows", "0"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_one_argv_one_wire_configuration(name, capsys):
    """Equal values in every field both configs have (the wire fields
    among them), and the deprecation warning of ``--sketch_dtype`` from
    both parsers."""
    ref, got = _both(ARGVS[name])
    shared = sorted(set(vars(ref)) & set(vars(got)))
    assert {"sketch_dtype", "wire_dtype", "wire_block",
            "sketch_scan_rows"} <= set(shared)
    diff = {k: (getattr(got, k), getattr(ref, k)) for k in shared
            if getattr(got, k) != getattr(ref, k)}
    assert not diff
    err = capsys.readouterr().err
    warned = "--sketch_dtype" in ARGVS[name]
    assert err.count("WARNING: --sketch_dtype is a deprecated alias") \
        == 2 * warned
    # the resolution: a bf16 wire and only a bf16 wire sets the alias
    assert got.wire_dtype in ("float32", "bfloat16", "int8")
    assert (got.sketch_dtype == "bfloat16") == (got.wire_dtype ==
                                                "bfloat16")


REFUSED_ARGVS = {
    "int8_true_topk": ["--mode", "true_topk", "--error_type", "virtual",
                       "--local_momentum", "0", "--wire_dtype", "int8"],
    "int8_rht": SK + ["--wire_dtype", "int8", "--sketch_impl", "rht"],
    "int8_dense_state": SK + ["--wire_dtype", "int8",
                              "--sketch_server_state", "dense"],
    "block_below_8": SK + ["--wire_dtype", "int8", "--wire_block", "4"],
}


@pytest.mark.parametrize("name", sorted(REFUSED_ARGVS))
def test_wire_refusals_from_one_argv(name):
    argv = REFUSED_ARGVS[name]
    with pytest.raises(ValueError):
        jconfig.parse_args(argv, default_lr=0.4)
    with pytest.raises(ValueError, match="wire"):
        tconfig.config_from_args(
            tconfig.parse_known(cv_train.build_parser(), argv))


def test_wire_flags_parse_in_both_entry_points():
    """The four flags are the port's now (the GPT-2 entry point too); the
    JAX package's parser holds 7 flags that neither port parser takes
    (8 before --checkpoint_sharded, 11 before the mesh's three, 56 before
    the wire's four, 52 before the runtime services' 25, 27 before the
    telemetry's 16): the XLA-only seven. --checkpoint_sharded parses in
    both entry points."""
    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings
                if o.startswith("--")}

    jp = argparse.ArgumentParser()
    jconfig.add_args(jp)
    ours = flags(cv_train.build_parser()) | flags(gpt2_train.build_parser())
    wire = {"--wire_dtype", "--wire_block", "--sketch_dtype",
            "--sketch_scan_rows"}
    assert wire <= flags(cv_train.build_parser())
    assert wire <= flags(gpt2_train.build_parser())
    assert len(flags(jp) - ours) == 7
    for build in (cv_train.build_parser, gpt2_train.build_parser):
        ns = tconfig.parse_known(build(), ["--checkpoint_sharded"])
        assert tconfig.config_from_args(ns).checkpoint_sharded


BYTE_CASES = [
    dict(mode="sketch", num_rows=5, num_cols=500_736, wire_dtype="int8"),
    dict(mode="sketch", num_rows=5, num_cols=524_288, wire_dtype="int8"),
    dict(mode="sketch", num_rows=5, num_cols=500_736,
         wire_dtype="bfloat16"),
    dict(mode="sketch", num_rows=5, num_cols=500_736, wire_dtype="float32"),
    dict(mode="sketch", num_rows=3, num_cols=1000, wire_dtype="int8",
         wire_block=64),
    dict(mode="sketch", num_rows=3, num_cols=1000, sketch_dtype="bfloat16"),
    dict(mode="true_topk", num_rows=5, num_cols=500_736),
    dict(mode="local_topk", k=1234),
    dict(mode="uncompressed"),
]


@pytest.mark.parametrize("kw", BYTE_CASES,
                         ids=[f"case{i}" for i in range(len(BYTE_CASES))])
@pytest.mark.parametrize("block", [None, 8, 250, 256])
def test_upload_wire_bytes_as_in_reference(kw, block):
    kw = dict(kw, error_type="virtual", local_momentum=0.0,
              grad_size=6_568_640)
    got = FedConfig(**kw).upload_wire_bytes(block)
    assert got == jconfig.FedConfig(**kw).upload_wire_bytes(block)


def test_upload_wire_bytes_at_the_study_tables():
    """A client's bytes a round at ResNet-9's table (c = 500,736) and
    GPT-2's (c = 524,288), r = 5: float32 4 a cell, bf16 2, int8 1 plus a
    float32 scale every 256 columns."""
    def cfg(c, wire):
        return FedConfig(mode="sketch", error_type="virtual",
                         local_momentum=0.0, num_rows=5, num_cols=c,
                         wire_dtype=wire)
    assert cfg(500_736, "float32").upload_wire_bytes() == 10_014_720
    assert cfg(500_736, "bfloat16").upload_wire_bytes() == 5_007_360
    assert cfg(500_736, "int8").upload_wire_bytes() == 2_542_800
    assert cfg(524_288, "float32").upload_wire_bytes() == 10_485_760
    assert cfg(524_288, "int8").upload_wire_bytes() == 2_662_400


# ------------------------------------------------------------ rounds

INT8 = dict(SKETCH, num_cols=16, wire_dtype="int8", wire_block=8)
BF16 = dict(SKETCH, wire_dtype="bfloat16")
CLIP = dict(max_grad_norm=0.5)
WIRE_CASES = {
    "bf16_fused": dict(BF16, weight_decay=5e-4),
    "bf16_unfused": dict(BF16, sketch_fused_encode="off"),
    "bf16_table_clip": dict(BF16, **CLIP),
    "bf16_alias": dict(SKETCH, sketch_dtype="bfloat16"),
    "bf16_hash": dict(BF16, sketch_impl="hash", num_blocks=3),
    "bf16_rht_dense_state": dict(BF16, sketch_impl="rht", num_rows=2,
                                 num_cols=4, k=2),
    "int8_fused": dict(INT8, weight_decay=5e-4),
    "int8_unfused": dict(INT8, sketch_fused_encode="off"),
    "int8_microbatched": dict(INT8, microbatch_size=3),
    "int8_table_clip": dict(INT8, **CLIP),
    "int8_hash": dict(INT8, sketch_impl="hash", num_blocks=3),
    "int8_hash_table_clip": dict(INT8, sketch_impl="hash", **CLIP),
    "int8_topk_down": dict(INT8, do_topk_down=True, k=2),
    "int8_block_above_cols": dict(INT8, wire_block=64),
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_round_matches_reference(case):
    kw = WIRE_CASES[case]
    jrt, trt = ref_runtime(**kw), port_runtime(**kw)
    assert (trt._int8_wire, trt._wire_block, trt._upload_bytes) == \
        (jrt._int8_wire, jrt._wire_block, jrt._upload_bytes)
    assert trt._table_dtype == getattr(torch, str(jrt._table_dtype))
    js, ts = jrt.init_state(), trt.init_state()
    for ids, batch, mask in round_inputs(5, ragged=True):
        js, jm = jrt.round(js, jnp.asarray(ids.astype(np.int32)),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(mask), 0.05)
        ts, tm = trt.round(ts, ids, batch, mask, 0.05)
        for got, want in zip(tm["results"], jm["results"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
        for key in ("download_bytes", "upload_bytes"):
            assert np.array_equal(tm[key].numpy(), np.asarray(jm[key])), key
    np.testing.assert_allclose(ts.ps_weights.numpy(),
                               np.asarray(js.ps_weights), rtol=0, atol=1e-6)
    assert (ts.ps_weights.numpy() != init_params()[1]).any()
    for key in ("coord_last_update", "client_last_round", "nan_round"):
        assert np.array_equal(getattr(ts, key).numpy(),
                              np.asarray(getattr(js, key))), key


def test_wires_change_the_round():
    """The bf16 and int8 wires are not the float32 wire: the first
    round's update differs from it (and the int8 wire's from the bf16
    wire's); each arm is deterministic."""
    ids, batch, mask = round_inputs(1)[0]
    w = {}
    for name, kw in (("f32", dict(SKETCH, num_cols=16)),
                     ("bf16", dict(SKETCH, num_cols=16,
                                   wire_dtype="bfloat16")),
                     ("int8", INT8)):
        for rep in range(2):
            rt = port_runtime(**kw)
            st, _ = rt.round(rt.init_state(), ids, batch, mask, 0.05)
            w[name, rep] = st.ps_weights.numpy()
        assert np.array_equal(w[name, 0], w[name, 1])
    assert not np.array_equal(w["f32", 0], w["bf16", 0])
    assert not np.array_equal(w["f32", 0], w["int8", 0])
    assert not np.array_equal(w["bf16", 0], w["int8", 0])


RUNTIME_REFUSALS = {
    "block_not_dividing": dict(SKETCH, num_cols=24, wire_dtype="int8",
                               wire_block=16),
}


@pytest.mark.parametrize("case", sorted(RUNTIME_REFUSALS))
def test_wire_runtime_refusals_as_in_reference(case):
    kw = RUNTIME_REFUSALS[case]
    with pytest.raises(ValueError):
        ref_runtime(**kw)
    with pytest.raises(ValueError, match="--wire_block 16 does not tile"):
        port_runtime(**kw)


@pytest.mark.parametrize("kw", [INT8, dict(INT8, **CLIP)],
                         ids=["deferred", "table_clip"])
def test_int8_run_resumed_from_checkpoint_is_bitwise(tmp_path, kw):
    """4 rounds in one run against 2 rounds, a checkpoint, a restore and 2
    more: the draws are keyed by the checkpointed round, so the state
    and every round's losses are the same bits."""
    inputs = round_inputs(4, ragged=True)
    rt = port_runtime(**kw)
    state, losses = rt.init_state(), []
    for ids, batch, mask in inputs:
        state, m = rt.round(state, ids, batch, mask, 0.05)
        losses.append(m["results"][0].numpy())
    rt2 = port_runtime(**kw)
    part = rt2.init_state()
    for ids, batch, mask in inputs[:2]:
        part, _ = rt2.round(part, ids, batch, mask, 0.05)
    gen = sketch_generation(rt2.cfg)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.default_meta = {"sketch_gen": gen}
    mgr.save(part, 1)
    rt3 = port_runtime(**kw)
    restored, _ = mgr.restore_latest(expect_shapes=rt3.state_shapes(),
                                     expect_sketch_gen=gen)
    assert restored.step == 2
    resumed = []
    for ids, batch, mask in inputs[2:]:
        restored, m = rt3.round(restored, ids, batch, mask, 0.05)
        resumed.append(m["results"][0].numpy())
    for a, b in zip(resumed, losses[2:]):
        assert np.array_equal(_bits(a), _bits(b))
    for name in ("ps_weights", "Vvelocity", "Verror"):
        assert np.array_equal(_bits(getattr(restored, name)),
                              _bits(getattr(state, name))), name
    assert restored.step == state.step == 4


def test_wire_entry_point_rounds_on_cpu(tmp_path, monkeypatch):
    """``cv_train --wire_dtype int8`` on the CPU: a narrow round's upload
    MiB is the int8 wire's bytes a client."""
    from test_torch_checkpoint import _write_pickles, narrow_model
    monkeypatch.setattr(cv_train, "build_model", narrow_model)
    root = _write_pickles(str(tmp_path / "data"))
    out = cv_train.main(["--device", "cpu", "--dataset_dir", root,
                         "--num_workers", "2", "--local_batch_size", "8",
                         "--num_rounds", "2", "--valid_batch_size", "20",
                         "--compute_dtype", "float32", "--mode", "sketch",
                         "--error_type", "virtual", "--local_momentum", "0",
                         "--k", "50", "--num_cols", "4096",
                         "--wire_dtype", "int8", "--wire_block", "512"])
    per_client = 5 * 4096 + 4 * 5 * (4096 // 512)
    assert out["rounds"] == 2 and np.isfinite(out["losses"]).all()
    assert out["total_upload_mib"] == pytest.approx(
        2 * 2 * per_client / 2**20, rel=1e-9)
