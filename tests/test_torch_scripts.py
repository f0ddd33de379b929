"""The port's stream readers and crash harness
(``commefficient_torch/scripts/``) against the JAX package's scripts,
in process, on the same inputs:

- ``check_telemetry_schema``: the verdict, the problem lines and the exit
  status over ``runs/``, over a port stream, over a port stream with a
  torn last line, under ``--selftest`` and on a missing root;
- ``teleview``: stdout and exit code of every subcommand on the three
  committed streams (``runs/layer_attrib/c10x``, ``c26x``,
  ``runs/population``) and on a port stream, ``diff`` on c10x / c26x with
  the default thresholds and with every threshold flag set, ``trend``
  over the repository's ``BENCH_r0*.json``, ``timeline``'s trace JSON;
  its torch-free literal twins pinned to the port's package;
- ``bench_imagenet_model``: the top-operation table of a narrow model on
  the CPU (its operations sum to the profiled busy time), the FLOP count
  per image against ``bench_imagenet``'s, the ``--s2d`` refusal;
- ``crash_matrix``: ``MATRIX`` against the JAX script's, the stream
  reader's replay check, and (``slow``) the whole matrix on the CPU.

The JAX scripts are loaded from their files with ``importlib``.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from commefficient_torch import cv_train, faults  # noqa: E402
from commefficient_torch.bench.bench_imagenet import \
    imagenet_flops  # noqa: E402
from commefficient_torch.models.fixup_resnet import \
    FixupResNetImageNet  # noqa: E402
from commefficient_torch.scripts import (bench_imagenet_model,  # noqa: E402
                                         check_telemetry_schema,
                                         crash_matrix, teleview)
from commefficient_torch.telemetry import schema as tschema  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = {"c10x": os.path.join(ROOT, "runs", "layer_attrib", "c10x"),
             "c26x": os.path.join(ROOT, "runs", "layer_attrib", "c26x"),
             "population": os.path.join(ROOT, "runs", "population")}
ONE_STREAM = ("summarize", "alerts", "clients", "population", "layers",
              "defense", "memory")
# every threshold flag of ``diff``, each away from its default
DIFF_FLAGS = ["--count_slack", "1", "--wire_bytes_growth", "1.2",
              "--bytes_ratio", "1.1", "--signal_ratio", "1.5",
              "--overlap_drop", "0.1", "--loss_ratio", "1.01",
              "--mfu_drop", "0.3", "--input_wait_rise", "0.05",
              "--starvation_rise", "0.05", "--staleness_rise", "0.5",
              "--temp_bytes_growth", "1.5", "--bw_frac_drop", "0.2",
              "--perchip_drop", "0.1", "--clip_frac_rise", "0.1",
              "--quarantine_growth", "1", "--client_spread_ratio", "1.5",
              "--alert_slack", "1", "--coverage_stall", "0.01"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {n: _load(n) for n in ("check_telemetry_schema", "teleview",
                                  "crash_matrix")}


@pytest.fixture(scope="module")
def port_stream(tmp_path_factory):
    """A port ``cv_train --test`` stream of two rounds, and a copy with a
    torn last line (what a killed writer leaves)."""
    tmp = tmp_path_factory.mktemp("port_stream")
    cv_train.main(["--device", "cpu", "--test", "--error_type", "virtual",
                   "--local_momentum", "0", "--num_rounds", "2",
                   "--dataset_dir", str(tmp / "ds"),
                   "--logdir", str(tmp / "run")])
    path = tmp / "run" / "telemetry.jsonl"
    torn = tmp / "torn" / "telemetry.jsonl"
    torn.parent.mkdir()
    text = path.read_text()
    torn.write_text(text + text.splitlines()[-1][:37])
    return {"port": str(path.parent), "torn": str(torn.parent)}


def _run(fn, *args):
    """``(return value, stdout, stderr)`` of ``fn(*args)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*args)
    return rc, out.getvalue(), err.getvalue()


# ------------------------------------------------- check_telemetry_schema


@pytest.mark.parametrize("case", ["runs", "port", "torn", "selftest",
                                  "missing"])
def test_checker_gives_the_jax_scripts_verdict(case, jax_scripts,
                                               port_stream, tmp_path):
    argv = {"runs": [os.path.join(ROOT, "runs")],
            "selftest": ["--selftest"],
            "missing": [str(tmp_path / "nowhere")]}.get(case)
    if argv is None:
        argv = [port_stream[case]]
    want = _run(jax_scripts["check_telemetry_schema"].main, argv)
    got = _run(check_telemetry_schema.main, argv)
    assert got == want
    assert got[0] == {"runs": 0, "port": 0, "torn": 1, "selftest": 0,
                      "missing": 2}[case]
    if case == "torn":
        assert "INVALID" in got[1] and "line " in got[1]


def test_selftest_covers_every_event_type():
    kinds = {json.loads(line)["event"]
             for line in check_telemetry_schema.sample_stream()}
    assert kinds == set(tschema.EVENT_FIELDS)


# ---------------------------------------------------------------- teleview


@pytest.mark.parametrize("stream", sorted(COMMITTED) + ["port"])
@pytest.mark.parametrize("cmd", ONE_STREAM)
def test_teleview_prints_what_the_jax_script_prints(cmd, stream,
                                                    jax_scripts,
                                                    port_stream):
    path = COMMITTED.get(stream) or port_stream[stream]
    want = _run(jax_scripts["teleview"].main, [cmd, path])
    got = _run(teleview.main, [cmd, path])
    assert got == want
    assert got[1]


@pytest.mark.parametrize("pair,flags", [
    (("c10x", "c26x"), []), (("c26x", "c10x"), DIFF_FLAGS),
    (("c10x", "c26x"), DIFF_FLAGS), (("port", "port"), [])],
    ids=["c10x_c26x", "c26x_c10x_flags", "c10x_c26x_flags", "port"])
def test_teleview_diff(pair, flags, jax_scripts, port_stream):
    paths = [COMMITTED.get(s) or port_stream[s] for s in pair]
    argv = ["diff", *paths, *flags]
    want = _run(jax_scripts["teleview"].main, argv)
    got = _run(teleview.main, argv)
    assert got == want
    assert "== " in got[1]


def test_teleview_trend_over_the_bench_files(jax_scripts):
    argv = ["trend", ROOT]
    want = _run(jax_scripts["teleview"].main, argv)
    got = _run(teleview.main, argv)
    assert got == want and got[0] == 0
    assert "BENCH_r05" in got[1]


@pytest.mark.parametrize("stream", sorted(COMMITTED) + ["port"])
def test_teleview_timeline_trace_is_the_jax_scripts(stream, jax_scripts,
                                                    port_stream, tmp_path):
    path = COMMITTED.get(stream) or port_stream[stream]
    out = str(tmp_path / "trace.json")
    want = _run(jax_scripts["teleview"].main, ["timeline", path, "-o", out])
    with open(out) as f:
        want_trace = json.load(f)
    os.remove(out)
    got = _run(teleview.main, ["timeline", path, "-o", out])
    with open(out) as f:
        assert json.load(f) == want_trace
    assert got == want


def test_teleview_literal_twins_pin_the_port(monkeypatch):
    """Where torch cannot be imported, teleview falls back to literal
    twins of the port's constants and of ``starved_groups``: each equals
    the port's package."""
    from commefficient_torch.telemetry import (clients, health,
                                               layer_signals, memory_ledger,
                                               population, schema, signals,
                                               utilization)
    for mod in ("clients", "health", "layer_signals", "memory_ledger",
                "population", "schema", "signals", "utilization"):
        monkeypatch.setitem(sys.modules,
                            f"commefficient_torch.telemetry.{mod}", None)
    spec = importlib.util.spec_from_file_location("teleview_offline",
                                                  teleview.__file__)
    offline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(offline)
    assert offline.starved_groups is not layer_signals.starved_groups
    for name, want in (
            ("TELEMETRY_BASENAME", schema.TELEMETRY_BASENAME),
            ("SIGNAL_KEYS", signals.SIGNAL_KEYS),
            ("CLIENT_STAT_KEYS", clients.CLIENT_STAT_KEYS),
            ("MEMORY_KEYS", memory_ledger.MEMORY_KEYS),
            ("MEMORY_LEDGER_KEYS", memory_ledger.MEMORY_LEDGER_KEYS),
            ("ROOFLINE_KEYS", utilization.ROOFLINE_KEYS),
            ("LAYER_SIGNAL_KEYS", layer_signals.LAYER_SIGNAL_KEYS),
            ("STARVATION_MASS_SHARE", layer_signals.STARVATION_MASS_SHARE),
            ("STARVATION_WIN_SHARE", layer_signals.STARVATION_WIN_SHARE),
            ("POPULATION_KEYS", population.POPULATION_KEYS),
            ("COVERAGE_STALL_WINDOW", health.COVERAGE_STALL_WINDOW)):
        assert getattr(offline, name) == want, name
    groups = ["embed", "h0/attn", "h0/norm-bias", "head"]
    for gm, tc in (([3.1, 5.4, 0.9, 1.2], [2.0, 5.0, 0.0, 1.0]),
                   ([1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 1.0]),
                   ([1.0, None, 2.0, 0.0], [1.0, 0.0, None, 3.0]),
                   (None, [1.0, 0.0, 0.0, 0.0]), ([0.0] * 4, [1.0] * 4)):
        assert offline.starved_groups(groups, gm, tc) == \
            layer_signals.starved_groups(groups, gm, tc)
    assert set(teleview.ASYNC_ROUND_KEYS) <= set(
        tschema.EVENT_FIELDS["async_round"])
    assert set(teleview.DEFENSE_KEYS) <= set(tschema.EVENT_FIELDS["defense"])


# ---------------------------------------------------- bench_imagenet_model


def test_bench_imagenet_model_table_on_a_narrow_model():
    """A narrow FixupResNet50 (one block a stage, 32 x 32) on the CPU:
    the line and the table print in the JAX script's format, the
    operations sum to the profiled busy time, the gradient is finite."""
    model = FixupResNetImageNet(layers=(1, 1, 1, 1), num_classes=10,
                                input_shape=(32, 32, 3),
                                generator=torch.Generator().manual_seed(0))
    lines = []
    out = bench_imagenet_model.run(model, 2, 32, "cpu", 1.0e9,
                                   timed_steps=1, out=lines.append)
    assert lines[0] == "compiling..."
    assert lines[1].startswith("batch 2: ") and "ms/step" in lines[1] \
        and "img/s" in lines[1] and lines[1].count("MFU n/a") == 2
    span = lines.index(next(ln for ln in lines if ln.startswith("span ")))
    assert lines[span].endswith("ms/step; top 25 ops (ms/step):")
    table = lines[span + 1:span + 1 + bench_imagenet_model.TOP]
    assert len(table) == bench_imagenet_model.TOP
    for row, (name, ms) in zip(table, out["ops_ms_per_step"]):
        assert row == f"  {ms:8.2f}  {name[:110]}"
    total = sum(ms for _, ms in out["ops_ms_per_step"])
    assert total == pytest.approx(out["busy_ms_per_step"], rel=1e-9)
    assert sum(out["groups_ms_per_step"].values()) == pytest.approx(total)
    assert out["grad_finite"] and out["busy_ms_per_step"] > 0


def test_bench_imagenet_model_flops_and_refusal(capsys):
    per_image = imagenet_flops(1)
    assert imagenet_flops(4) == pytest.approx(4 * per_image, rel=1e-12)
    # bench_imagenet's count, 10.886 TFLOP for its 448-image round
    assert 448 * per_image == pytest.approx(10.886e12, rel=1e-3)
    assert bench_imagenet_model.SCRIPT_FLOPS_PER_IMAGE == 3 * 4.1e9
    with pytest.raises(SystemExit) as e:
        bench_imagenet_model.main(["--s2d"])
    assert e.value.code == 2 and "C16" in capsys.readouterr().err


# ------------------------------------------------------------ crash_matrix


def test_crash_matrix_rows_are_the_jax_scripts(jax_scripts):
    assert crash_matrix.MATRIX == jax_scripts["crash_matrix"].MATRIX
    assert crash_matrix.KILL_EXIT == faults.KILL_EXIT_CODE
    for _, spec, _, _ in crash_matrix.MATRIX:
        assert spec.split(":")[1] in faults.FAULT_POINTS


def test_crash_matrix_reads_a_stitched_stream(tmp_path):
    """The stream reader: a torn fragment skipped, a replayed round that
    agrees kept once, one that disagrees reported."""
    lines = [{"event": "round", "round": 1, "loss": 0.5},
             {"event": "resume"},
             {"event": "round", "round": 1, "loss": 0.5},
             {"event": "round", "round": 2, "loss": 0.25},
             {"event": "round", "round": 2, "loss": 0.3}]
    path = tmp_path / "telemetry.jsonl"
    path.write_text("\n".join(json.dumps(x) for x in lines)
                    + '\n{"event": "rou')
    rounds, conflicts, kinds = crash_matrix._read_rounds(str(tmp_path))
    assert rounds == {1: 0.5, 2: 0.3}
    assert conflicts == [(2, 0.25, 0.3)]
    assert kinds == ["round", "resume", "round", "round", "round"]
    jrounds = _load("crash_matrix")._read_rounds(str(tmp_path))
    assert (rounds, conflicts, kinds) == jrounds


@pytest.mark.slow
def test_crash_matrix_whole_on_the_cpu():
    """Every row of the matrix with children on the CPU: killed (or
    drained), resumed, bit for bit the straight child."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("COMMEFFICIENT_FAULT", None)
    proc = subprocess.run(
        [sys.executable, "-m", "commefficient_torch.scripts.crash_matrix",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for label, _, _, _ in crash_matrix.MATRIX:
        assert f"RESULT {label}: PASS" in proc.stdout
