"""The port's GPT-2 benches (``commefficient_torch/bench/bench_gpt2.py``,
``gpt2_mfu_sweep.py``, ``bench_gpt2_model.py``, ``bench_longctx.py``)
against the JAX package's ``bench_gpt2.py`` and scripts, on the CPU:

- each config (full, dryrun and every sweep arm) equals the JAX one on
  every field the two ``FedConfig``s share (the JAX runtime and model
  replaced by stubs that capture the config);
- the FLOPs a round are bitwise the JAX formula's (25.2 TFLOP at the
  bench's shape);
- the dryrun's result line has the JAX keys and equal derived values on
  every wire (the timed loop stubbed in both packages, the JAX round's
  cost analysis skipped);
- the split round's arms run (``--decode_overlap``); the sweep writes a
  line an arm and goes on past a dead one; ``ledger_ab`` gives null
  ledgers off the card, of the async and of the overlap cohort;
- the bare step and the long-context arms run on the CPU at a tiny
  GPT-2, K3's plain version in the flash arms: each flash arm's first
  loss within ``FLASH_LOSS_RTOL`` of the dense arm's (both round the
  probabilities to bf16, in different places);
- their arithmetic against the JAX scripts' on the same weights
  (``params_from_jax``), float32 at a tiny GPT-2: ``bench_longctx``'s
  first-step loss and gradient against ``scripts/bench_longctx.py``'s
  ``loss_fn``, and ``bench_gpt2_model.chained_step`` (the clients'
  gradients summed, the chained weights, the mean loss) against
  ``scripts/bench_gpt2_model.py``'s chain body.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_gpt2 as jax_bench_gpt2  # noqa: E402
from commefficient_tpu import config as jax_config  # noqa: E402
from commefficient_tpu import core as jax_core  # noqa: E402
from commefficient_tpu.models import gpt2 as jax_gpt2  # noqa: E402

from commefficient_torch.bench import bench_gpt2, bench_gpt2_model  # noqa
from commefficient_torch.bench import bench_longctx  # noqa: E402
from commefficient_torch.bench import gpt2_mfu_sweep  # noqa: E402
from commefficient_torch.core.client import make_forward_grad  # noqa
from commefficient_torch.losses import make_gpt2_train_loss  # noqa: E402
from commefficient_torch.models import gpt2 as tgpt2  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.gpt2 import gpt2_model_flops  # noqa: E402

FLASH_LOSS_RTOL = 5e-3
TINY = dict(vocab_size=128, n_embd=64, n_layer=1, n_head=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def _sweep_script():
    spec = importlib.util.spec_from_file_location(
        "jax_script_gpt2_mfu_sweep", ROOT / "scripts" / "gpt2_mfu_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


class _Model:
    def __init__(self, *a, **kw):
        pass

    def init(self, *a, **kw):
        return {}


@pytest.fixture
def jax_capture(monkeypatch):
    seen = []

    def runtime(cfg, *a, **kw):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(jax_core, "FedRuntime", runtime)
    monkeypatch.setattr(jax_config, "enable_compilation_cache",
                        lambda cfg: None)
    monkeypatch.setattr(jax_gpt2, "GPT2DoubleHeads", _Model)
    return seen


def _shared_diff(port_cfg, jax_cfg):
    import dataclasses
    names = ({f.name for f in dataclasses.fields(port_cfg)}
             & {f.name for f in dataclasses.fields(jax_cfg)})
    assert len(names) >= 100
    return {n: (getattr(port_cfg, n), getattr(jax_cfg, n)) for n in names
            if getattr(port_cfg, n) != getattr(jax_cfg, n)}


CASES = [("full", {}, False), ("dryrun", {}, True)] + [
    (arm, over, False) for arm, over in gpt2_mfu_sweep.ARMS.items()]


@pytest.mark.parametrize("name,overrides,dryrun", CASES,
                         ids=[c[0] for c in CASES])
def test_gpt2_config_matches_jax(name, overrides, dryrun, jax_capture):
    with pytest.raises(_Captured):
        jax_bench_gpt2.run(dryrun=dryrun, **overrides)
    jcfg = jax_capture[0]
    _, _, pcfg = bench_gpt2.run_config(dryrun=dryrun, **overrides)
    assert not _shared_diff(pcfg, jcfg)
    if overrides.get("decode_overlap"):
        assert jcfg.decode_overlap and pcfg.decode_overlap


@pytest.mark.parametrize("dryrun", [False, True])
def test_gpt2_flops_are_the_jax_formulas_bits(dryrun):
    gcfg, (W, B, NC, S), _ = bench_gpt2.run_config(dryrun=dryrun)
    jcfg = (jax_gpt2.GPT2Config.small() if dryrun
            else jax_gpt2.GPT2Config())
    tokens = W * B * NC * S
    ours = gpt2_model_flops(gcfg, tokens, S)
    assert ours == jax_gpt2.gpt2_model_flops(jcfg, tokens, S)
    if not dryrun:
        assert tokens == 32_768 and ours == 25_215_853_658_112.0


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_gpt2_full_wire_bytes(wire, jax_capture):
    """At the bench's width: c = 524,288 is aligned, so the JAX bench's
    count and the port's agree; int8 2,662,400 bytes a client."""
    with pytest.raises(_Captured):
        jax_bench_gpt2.run(wire_dtype=wire)
    jcfg = jax_capture[0]
    _, (W, *_), pcfg = bench_gpt2.run_config(wire_dtype=wire)
    block = 256 if wire == "int8" else None
    want = {"float32": 4 * 5 * 524_288, "bfloat16": 2 * 5 * 524_288,
            "int8": 5 * 524_288 + 4 * 5 * 2048}[wire]
    assert W * pcfg.upload_wire_bytes(block) == W * \
        jcfg.upload_wire_bytes(block) == 8 * want


PHASES = {"host_s": 0.25, "dispatch_s": 1.5, "device_wait_s": 0.25,
          "warmup_s": 3.0}


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_gpt2_dryrun_line_matches_jax(wire, monkeypatch):
    """``run(dryrun=True)`` in both packages, the timed loop stubbed: the
    JAX keys (config included) and the derived values equal; the port's
    MFU and memory ledger null on the CPU."""
    monkeypatch.setattr(jax_config, "enable_compilation_cache",
                        lambda cfg: None)
    metrics = {"results": (np.zeros(4, np.float32),
                           np.zeros(4, np.float32))}
    monkeypatch.setattr(jax_bench_gpt2, "timed_rounds",
                        lambda *a, **kw: (2.0, metrics, dict(PHASES)))

    def no_cost(fn, **kw):
        raise RuntimeError("cost analysis skipped in this test")

    monkeypatch.setattr(jax_bench_gpt2, "with_retries", no_cost)
    monkeypatch.setattr(bench_gpt2, "timed_rounds", lambda *a, **kw: (
        2.0, {"results": (torch.zeros(4), torch.zeros(4))}, dict(PHASES)))
    j = jax_bench_gpt2.run(dryrun=True, n_rounds=3, wire_dtype=wire)
    p = bench_gpt2.run(dryrun=True, n_rounds=3, wire_dtype=wire,
                       device="cpu")
    assert set(p) == set(j) and set(p["config"]) == set(j["config"])
    assert set(p["roofline"]) == set(j["roofline"])
    for key in ("metric", "value", "unit", "vs_baseline",
                "tokens_per_round", "timed_rounds", "wire_dtype",
                "wire_bytes_per_round", "warmup_s", "phase_split",
                "input_wait_frac", "dryrun", "config",
                "memory_ledger_decode"):
        assert p[key] == j[key], key
    assert p["tokens_per_round"] == 4 * 4 * 2 * 64
    assert p["mfu"] is None and p["memory_ledger"] is None


def test_decode_overlap_and_its_ledger_are_refused():
    # no longer refused: the split round runs (its timed arm in the
    # sweep test below), and ledger_ab builds the overlap cohort
    rec = bench_gpt2.ledger_ab(dryrun=True, device="cpu",
                               decode_overlap=True)
    assert rec["arms"] == {"auto": None, "off": None}
    assert rec["dense_grad_bytes"] == 4 * rec["d"]


def test_ledger_ab_off_the_card_has_null_ledgers():
    rec = bench_gpt2.ledger_ab(dryrun=True, device="cpu")
    assert set(rec) == {"metric", "d", "dense_grad_bytes", "dryrun",
                        "round_shape", "microbatch", "arms"}
    assert rec["arms"] == {"auto": None, "off": None}
    assert rec["dense_grad_bytes"] == 4 * rec["d"]
    assert rec["round_shape"] == [1, 1, 1, 32] and rec["dryrun"]


def test_sweep_arms_are_the_jax_sweeps():
    script = _sweep_script()
    assert gpt2_mfu_sweep.ARMS == script.ARMS
    assert gpt2_mfu_sweep.DEFAULT_ARMS == script.DEFAULT_ARMS


def test_sweep_writes_a_line_an_arm_past_a_dead_one(tmp_path, capsys,
                                                    monkeypatch):
    out = tmp_path / "sweep.jsonl"
    # an arm that dies at its config (every real arm runs now)
    monkeypatch.setitem(gpt2_mfu_sweep.ARMS, "dead",
                        {"fused_encode": "never"})
    rc = gpt2_mfu_sweep.main(["--dryrun", "--arms", "dead,overlap",
                              "--rounds", "1", "--out", str(out),
                              "--device", "cpu"])
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["arm"] for r in lines] == ["dead", "overlap"]
    assert ("--sketch_fused_encode" in lines[0]["error"]
            and "result" not in lines[0])
    res = lines[1]["result"]
    assert res["dryrun"] and res["timed_rounds"] == 1
    assert res["config"]["decode_overlap"]
    assert res["memory_ledger_decode"] is None
    assert np.isfinite(res["value"]) and res["mfu"] is None
    # no MFU on the CPU: the summary line says so, rc 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and last["arms_run"] == 2 and "error" in last
    with pytest.raises(ValueError, match="--compile_cache"):
        gpt2_mfu_sweep.main(["--compile_cache", "/tmp/x", "--out",
                             str(out)])


def test_bare_model_step_on_the_cpu():
    arms = bench_gpt2_model.run(1, device="cpu",
                                gcfg_kw=dict(TINY, n_positions=128),
                                shape=(2, 1, 2, 128))
    assert [a["arm"] for a in arms] == [a[0] for a in bench_gpt2_model.ARMS]
    assert all("error" not in a and a["ms"] > 0 and a["mfu"] is None
               for a in arms)
    by = {(a["remat"], a["attn"]): a["first_loss"] for a in arms}
    for remat in (True, False):
        assert abs(by[remat, "flash"] - by[remat, "dense"]) <= \
            FLASH_LOSS_RTOL * abs(by[remat, "dense"])
    # remat recomputes, it does not change the loss
    assert by[True, "dense"] == by[False, "dense"]


def test_long_context_arms_on_the_cpu(capsys):
    arms = bench_longctx.run(1, device="cpu", seqs=(128, 256), tokens=512,
                             gcfg_kw=TINY)
    assert [(a["S"], a["B"], a["attn"]) for a in arms] == [
        (128, 4, "dense"), (128, 4, "flash"), (256, 2, "dense"),
        (256, 2, "flash")]
    assert all("error" not in a and a["ms"] > 0 for a in arms)
    for dense, flash in zip(arms[::2], arms[1::2]):
        assert abs(flash["first_loss"] - dense["first_loss"]) <= \
            FLASH_LOSS_RTOL * abs(dense["first_loss"])
    assert "FAILED" not in capsys.readouterr().out


def _float32_pair(cls_name, S, **init):
    """The JAX model, its weights, and the port's model and flat weights
    (``params_from_jax``): the tiny GPT-2, float32, remat as the bench
    sets it."""
    import jax
    import jax.numpy as jnp
    remat = cls_name == "GPT2LMHead"
    jm = getattr(jax_gpt2, cls_name)(jax_gpt2.GPT2Config(
        **TINY, n_positions=S, compute_dtype=jnp.float32, remat=remat))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), **init)
    tm = getattr(tgpt2, cls_name)(tgpt2.GPT2Config(
        **TINY, n_positions=S, compute_dtype=torch.float32, remat=remat))
    flat = params_from_jax(jax.tree.map(np.asarray, params), tm)
    return jm, params, tm, flat


def test_long_context_step_matches_the_jax_script(monkeypatch):
    """``grad_step`` on ``lm_loss`` at (B, S) = (2, 128) against the JAX
    script's ``loss_fn`` and chain body, the chain's step set to 1 in
    both so the next weights carry the whole gradient: loss to 1e-5
    relative, the step w - w' to 1e-4 relative plus 1e-5 of its largest
    entry (float32; only the order of additions differs)."""
    import jax
    import jax.numpy as jnp
    from commefficient_tpu.ops import ravel_params
    B, S = 2, 128
    rng = np.random.RandomState(0)
    ids = rng.randint(0, TINY["vocab_size"], (B, S))
    labels = rng.randint(0, TINY["vocab_size"], (B, S))
    jm, params, tm, flat = _float32_pair("GPT2LMHead", S,
                                         input_ids=jnp.asarray(ids[:1]))
    vec, unravel = ravel_params(params)

    def loss_fn(v):
        logits = jm.apply(unravel(v), jnp.asarray(ids))
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        tgt = jnp.asarray(labels)[:, 1:]
        return -jnp.take_along_axis(lp, tgt[..., None], -1).mean()

    l_ref, g_ref = jax.jit(jax.value_and_grad(loss_fn))(vec)
    step_ref = np.asarray(vec - (vec - 1.0 * g_ref))

    monkeypatch.setattr(bench_longctx, "CHAIN_STEP", 1.0)
    v_next, loss = bench_longctx.grad_step(
        bench_longctx.lm_loss(tm, torch.from_numpy(ids),
                              torch.from_numpy(labels)), flat)
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-5)
    np.testing.assert_allclose((flat - v_next).numpy(), step_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(step_ref).max())


def test_bare_model_step_matches_the_jax_script(monkeypatch):
    """``chained_step`` over W = 2 clients of (B, NC, S) = (2, 2, 128),
    on the bench's batch and config, against the JAX script's chain body
    (the vmapped ``make_forward_grad``, its gradients summed), the chain's
    step set to 1 in both: the mean client loss to 1e-5 relative, the
    step w - w' (the summed gradient) to 1e-4 relative plus 1e-5 of its
    largest entry."""
    import jax
    import jax.numpy as jnp
    from commefficient_tpu.core.client import \
        make_forward_grad as j_make_forward_grad
    from commefficient_tpu.losses import \
        make_gpt2_train_loss as j_train_loss
    from commefficient_tpu.ops import ravel_params
    shape = W, B, NC, S = 2, 2, 2, 128
    batch = bench_gpt2.random_batch(tgpt2.GPT2Config(**TINY), shape, "cpu")
    jm, params, tm, flat = _float32_pair(
        "GPT2DoubleHeads", S,
        input_ids=jnp.asarray(batch["input_ids"][0, :1].numpy()),
        mc_token_ids=jnp.asarray(batch["mc_token_ids"][0, :1].numpy()),
        token_type_ids=jnp.asarray(batch["token_type_ids"][0, :1].numpy()))
    vec, unravel = ravel_params(params)
    jcfg = jax_config.FedConfig(
        mode="uncompressed", error_type="none", local_momentum=0.0,
        virtual_momentum=0.9, weight_decay=0.0, num_workers=W,
        local_batch_size=B, microbatch_size=8, num_clients=100,
        track_bytes=False, num_results_train=2, lm_chunk=128)
    jfwd = j_make_forward_grad(
        jcfg, j_train_loss(jm, lm_chunk=jcfg.lm_chunk), unravel, B)
    jb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
    g, res, _, _ = jax.jit(jax.vmap(jfwd, in_axes=(None, 0, 0, 0)))(
        vec, jb, jnp.ones((W, B), bool),
        jax.random.split(jax.random.PRNGKey(1), W))
    step_ref = np.asarray(vec - (vec - 1.0 * g.sum(axis=0)))

    monkeypatch.setattr(bench_gpt2_model, "CHAIN_STEP", 1.0)
    fwd = make_forward_grad(bench_gpt2_model.model_step_config(W, B),
                            make_gpt2_train_loss(tm, lm_chunk=128), B)
    v_next, loss = bench_gpt2_model.chained_step(
        fwd, flat, batch, torch.ones((W, B), dtype=torch.bool))
    np.testing.assert_allclose(float(loss), float(res[0].mean()), rtol=1e-5)
    np.testing.assert_allclose((flat - v_next).numpy(), step_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(step_ref).max())
