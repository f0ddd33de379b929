"""The port's CIFAR and ImageNet benches and the round-shape grid
(``commefficient_torch/bench/``) against the JAX package's ``bench.py``,
``scripts/bench_imagenet.py`` and ``scripts/round_shape_grid.py``, on
the CPU.

- The slice as a whole: ``run_cifar`` of both packages at W = 2, B = 4
  from the same weights (``models/convert.py params_from_jax``) and the
  same numpy batch (seed 0), the timed loop replaced in both by one real
  round, the loss in float32 (the bench's bf16 convolutions differ
  between the packages' CPU kernels): the weights after the round within
  ``tests/test_torch_round.py``'s atol 1e-6, the losses within rtol
  1e-5, the result's keys and derived values equal; the port's FLOP
  count 1.0 to 1.25 times XLA's cost analysis of the same round.
- Every bench config equals the JAX one on every field the two
  ``FedConfig``s share (the JAX runtime and model replaced by stubs that
  capture the config).
- The wire bytes a round are the JAX ``upload_wire_bytes`` of the sized
  table, exactly; the JAX bench counts the unsized one (ROADMAP C14).
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench as jax_bench  # noqa: E402
from commefficient_tpu import config as jax_config  # noqa: E402
from commefficient_tpu import core as jax_core  # noqa: E402
from commefficient_tpu import losses as jax_losses  # noqa: E402
from commefficient_tpu import models as jax_models  # noqa: E402

from commefficient_torch.bench import bench, bench_imagenet  # noqa: E402
from commefficient_torch.bench import round_shape_grid  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa

PHASES = {"host_s": 0.25, "dispatch_s": 1.5, "device_wait_s": 0.25,
          "warmup_s": 3.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


class _Model:
    def init(self, *a, **kw):
        return {}


@pytest.fixture
def jax_capture(monkeypatch):
    """The JAX benches' FedConfig: their runtime raises with the config it
    was given, their models are stubs, the compile cache stays off."""
    seen = []

    def runtime(cfg, *a, **kw):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(jax_core, "FedRuntime", runtime)
    monkeypatch.setattr(jax_config, "enable_compilation_cache",
                        lambda cfg: None)
    for name in ("ResNet9", "FixupResNet50"):
        monkeypatch.setattr(jax_models, name, lambda **kw: _Model())
    return seen


def shared_fields_equal(port_cfg, jax_cfg):
    names = ({f.name for f in dataclasses.fields(port_cfg)}
             & {f.name for f in dataclasses.fields(jax_cfg)})
    assert len(names) >= 100
    diff = {n: (getattr(port_cfg, n), getattr(jax_cfg, n)) for n in names
            if getattr(port_cfg, n) != getattr(jax_cfg, n)}
    assert not diff


@pytest.mark.parametrize("W,B", [(8, 64), (32, 512)],
                         ids=["headline", "saturated"])
def test_cifar_config_matches_jax(W, B, jax_capture):
    with pytest.raises(_Captured):
        jax_bench.run_cifar({}, W=W, B=B)
    shared_fields_equal(bench.cifar_config(W, B), jax_capture[0])


def test_imagenet_config_matches_jax(jax_capture):
    script = _script("bench_imagenet")
    with pytest.raises(_Captured):
        script.main([])
    shared_fields_equal(bench_imagenet.imagenet_config(), jax_capture[0])


@pytest.mark.parametrize("W,B", [(8, 64), (32, 512), (16, 256)])
def test_round_shape_grid_config_matches_jax(W, B, jax_capture):
    script = _script("round_shape_grid")
    with pytest.raises(_Captured):
        script.measure(W, B)
    shared_fields_equal(round_shape_grid.grid_config(W, B), jax_capture[0])


# the round's upload on each wire at W = 8 (c sized 500,000 -> 500,736;
# int8: a byte a cell and a float32 scale every 256 columns of a row)
WIRE_BYTES = {"float32": 8 * 4 * 5 * 500_736,
              "bfloat16": 8 * 2 * 5 * 500_736,
              "int8": 8 * (5 * 500_736 + 4 * 5 * 1956)}


@pytest.mark.parametrize("wire", sorted(WIRE_BYTES))
def test_wire_bytes_are_the_sized_tables(wire, monkeypatch):
    """``wire_bytes_per_round`` of ``run_cifar`` at W = 8 (the timed loop
    stubbed): the JAX ``upload_wire_bytes`` of the sized table, bitwise;
    80,117,760 on float32, 20,342,400 on int8."""
    monkeypatch.setattr(bench, "timed_rounds", lambda rt, args, **kw: (
        2.0, {"results": (torch.zeros(8), torch.zeros(8))}, dict(PHASES)))
    monkeypatch.setattr(bench, "cifar_flops", lambda n: 1.0)
    res = {}
    bench.run_cifar(res, W=8, B=64, wire_dtype=wire, device="cpu")
    jcfg = jax_config.FedConfig(
        **{f.name: getattr(bench.cifar_config(8, 64, wire), f.name)
           for f in dataclasses.fields(FedConfig)})
    jcfg = jcfg.replace(num_cols=jax_config.auto_num_cols(jcfg.num_cols))
    block = min(jcfg.wire_block, jcfg.num_cols) if wire == "int8" else None
    assert res["wire_bytes_per_round"] == 8 * jcfg.upload_wire_bytes(block)
    assert res["wire_bytes_per_round"] == WIRE_BYTES[wire]
    assert res["wire_dtype"] == wire


def test_cifar_bench_round_against_jax(monkeypatch):
    """The slice as a whole (module docstring): one round of the bench's
    CIFAR config at W = 2, B = 4 in both packages."""
    W, B = 2, 4
    got = {}
    monkeypatch.setattr(jax_config, "enable_compilation_cache",
                        lambda cfg: None)
    j_loss, p_loss = jax_losses.make_cv_loss, make_cv_loss
    monkeypatch.setattr(jax_losses, "make_cv_loss",
                        lambda model, dtype: j_loss(model, "float32"))
    monkeypatch.setattr(bench, "make_cv_loss",
                        lambda model, dtype: p_loss(model, "float32"))

    def jax_loop(runtime, round_args, **kw):
        s, m = runtime.round(runtime.init_state(), *round_args)
        got["jax"] = runtime, s, m
        return 2.0, m, dict(PHASES)

    def port_loop(runtime, round_args, **kw):
        jrt = got["jax"][0]
        runtime.initial_weights = params_from_jax(
            jax.tree.map(np.asarray, jrt.unravel(jrt.initial_weights)),
            layout=runtime.layout)
        s, m = runtime.round(runtime.init_state(), *round_args,
                             observe=False)
        got["port"] = runtime, s, m
        return 2.0, m, dict(PHASES)

    flops = {}
    j_retries = jax_bench.with_retries

    def retries(fn, *, desc, **kw):
        flops[desc] = j_retries(fn, desc=desc, **kw)
        return flops[desc]

    monkeypatch.setattr(jax_bench, "timed_rounds", jax_loop)
    monkeypatch.setattr(jax_bench, "with_retries", retries)
    monkeypatch.setattr(bench, "timed_rounds", port_loop)
    jres, pres = {}, {}
    jax_bench.run_cifar(jres, W=W, B=B, n_rounds=1)
    bench.run_cifar(pres, W=W, B=B, n_rounds=1, device="cpu")

    jrt, jst, jm = got["jax"]
    prt, pst, pm = got["port"]
    w0 = prt.initial_weights.numpy()
    w_ref = np.asarray(jrt.flat_weights(jst))
    w_got = pst.ps_weights.numpy()
    assert (w_got != w0).sum() > 1000
    np.testing.assert_allclose(w_got, w_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pm["results"][0].numpy(),
                               np.asarray(jm["results"][0]), rtol=1e-5)

    assert set(pres) == set(jres)
    for key in ("value", "vs_baseline", "timed_rounds", "wire_dtype",
                "warmup_s", "phase_split", "input_wait_frac"):
        assert pres[key] == jres[key], key
    # the bytes on the wire: the JAX runtime's own count of its sized
    # table; the JAX bench counts the unsized config's (C14)
    assert pres["wire_bytes_per_round"] == W * jrt._upload_bytes \
        == W * 4 * 5 * 500_736
    assert jres["wire_bytes_per_round"] == W * 4 * 5 * 500_000
    # no peak for the CPU in the port: a null MFU, not another chip's
    assert pres["mfu"] is None and jres["mfu"] is not None
    ratio = bench.cifar_flops(W * B) / flops["cifar cost analysis"]
    assert 1.0 <= ratio <= 1.25, ratio


def test_cifar_flops_count():
    """FlopCounterMode's count is linear in the images; 1.454e11 for 64."""
    one = bench.cifar_flops(1)
    assert bench.cifar_flops(64) == 64 * one
    assert round_shape_grid.flops_per_image() == one
    assert abs(64 * one - 1.454e11) < 1e8


def test_bench_main_prints_the_line_when_a_stage_dies(monkeypatch, capsys,
                                                      tmp_path):
    """Both CIFAR stages run (the loop stubbed) and GPT-2 dies: the line
    still prints with the JAX keys at each depth and GPT-2's error, rc 0,
    and the telemetry stream holds a bench and a utilization event a
    stage that ran and the summary."""
    from commefficient_torch.bench import bench_gpt2
    from commefficient_torch.telemetry import validate_file

    def loop(rt, args, **kw):
        W = rt.cfg.num_workers
        return 2.0, {"results": (torch.zeros(W), torch.zeros(W))}, \
            dict(PHASES)

    monkeypatch.setattr(bench, "timed_rounds", loop)
    monkeypatch.setattr(bench, "cifar_flops", lambda n: 1.0)
    monkeypatch.setattr(bench_gpt2, "run", lambda **kw: 1 / 0)
    rc = bench.main(["--device", "cpu", "--telemetry_dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["value"] == 5120.0 and "error" not in line
    stage = {"metric", "value", "unit", "vs_baseline", "mfu",
             "timed_rounds", "wire_dtype", "wire_bytes_per_round",
             "warmup_s", "phase_split", "input_wait_frac", "roofline"}
    assert set(line) == stage | {"cifar_saturated", "gpt2"}
    sat = line["cifar_saturated"]
    assert set(sat) == stage | {"round_images"}
    assert sat["round_images"] == 16_384 and sat["timed_rounds"] == 10
    assert sat["value"] == 10 * 16_384 / 2.0
    assert line["gpt2"] == {"error": "ZeroDivisionError: division by zero"}
    path = tmp_path / "telemetry.jsonl"
    assert validate_file(str(path)) == []
    kinds = [json.loads(ln)["event"] for ln in path.read_text().splitlines()]
    assert kinds.count("bench") == 2 and kinds.count("utilization") == 2
    assert kinds[-1] == "summary"


def test_compile_cache_is_refused_by_name():
    with pytest.raises(ValueError, match="--compile_cache: .*no compile"):
        bench.main(["--device", "cpu", "--compile_cache", ""])
    with pytest.raises(ValueError, match="--mesh_shape"):
        bench.main(["--device", "cpu", "--mesh_shape", "2"])


IMAGENET_KEYS = {"metric", "value", "unit", "mfu", "round_images",
                 "timed_rounds", "layout", "warmup_s", "phase_split",
                 "input_wait_frac", "total_s"}


@pytest.mark.parametrize("layout", ["uint8_device", "float_host"])
def test_imagenet_bench_stages_each_round(layout, monkeypatch, capsys):
    """Both layouts stage a round's batch inside the loop (the loop
    stubbed to build each round's arguments): (7, B, 224, 224, 3)
    normalized float32 images; the JAX script's keys; the FLOP count."""
    shapes = []

    def loop(rt, args, *, warmup, rounds, round_args_fn, **kw):
        assert args is None and (warmup, rounds) == (2, 1)
        for i in range(rounds):
            a = round_args_fn(i)
            shapes.append((tuple(a[1]["image"].shape),
                           a[1]["image"].dtype))
        return 2.0, {"results": (torch.zeros(7), torch.zeros(7))}, \
            dict(PHASES)

    monkeypatch.setattr(bench_imagenet, "timed_rounds", loop)
    res = bench_imagenet.main(["--device", "cpu", "--layout", layout,
                               "--local_batch", "2", "--rounds", "1"])
    assert shapes == [((7, 2, 224, 224, 3), torch.float32)]
    assert set(res) == IMAGENET_KEYS and res["layout"] == layout
    assert res["round_images"] == 14 and res["mfu"] is None
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == res
    # 24.3 GFLOP an image (the JAX script's 3 x 4.1e9 counts multiply-
    # adds as FLOPs: C13)
    assert abs(bench_imagenet.imagenet_flops(448) - 10.886e12) < 5e9


def test_round_shape_grid_records_a_dead_cell(monkeypatch, capsys):
    """Every cell of the 3 x 3 grid; a failing cell records its error and
    the grid goes on; a null MFU off the peak table."""
    def measure(W, B, n_rounds, device):
        if (W, B) == (32, 512):
            raise MemoryError("too big")
        return 1000.0 * W, None, None

    monkeypatch.setattr(round_shape_grid, "measure", measure)
    out = round_shape_grid.main(["--device", "cpu", "--rounds", "1"])
    assert [(r["W"], r["B"]) for r in out["rows"]] == [
        (W, B) for W in (8, 16, 32) for B in (64, 256, 512)]
    assert out["rows"][-1] == {"W": 32, "B": 512, "error": "MemoryError"}
    assert all(r["mfu"] is None for r in out["rows"][:-1])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
