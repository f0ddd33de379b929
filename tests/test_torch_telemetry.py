"""The port's telemetry stream (``commefficient_torch/telemetry/``
schema.py, run.py, tracing.py, utilization.py, memory_ledger.py,
profiling.py) and its wiring into both entry points, on the CPU.

- The schema: the port's copy is the JAX package's (version, event
  fields, field vintages).
- One run, both packages: ``cv_train --test`` of each package on the same
  argv (the port adds ``--device cpu --num_rounds 1``, the JAX package's
  ``--test`` length) writes a stream that validates under both
  validators, with the same sequence of event kinds except the JAX
  package's ``compile``/``collectives`` and either package's
  ``memory_ledger`` (XLA's static inventories, the port's measured one);
  the port's ``teleview summarize`` reads the port's stream in process
  and prints what ``scripts/teleview.py`` prints.
- ``gpt2_train --test``: the stream's layer signals over GPT-2's coarse
  groups and an MFU from the analytic FLOP count.
- The stream's recovery: append behind a ``resume`` record, NaN to null,
  a truncated line terminated, and ``mid_telemetry_flush`` in a child.
- The 16 flags with the JAX package's defaults and refusals; the peak
  table by the card's full name; memory on the CPU null, never zero; the
  profiler window's trace.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from commefficient_tpu import config as jconfig  # noqa: E402
from commefficient_tpu.telemetry import schema as jschema  # noqa: E402

from commefficient_torch import config as tconfig  # noqa: E402
from commefficient_torch import cv_train, gpt2_train  # noqa: E402
from commefficient_torch.telemetry import (RunTelemetry,  # noqa: E402
                                           check_dense_grad_floor,
                                           measure_round, peak_flops_for,
                                           peak_hbm_for)
from commefficient_torch.telemetry import schema as tschema  # noqa: E402
from commefficient_torch.telemetry.profiling import \
    ProfilerWindow  # noqa: E402
from commefficient_torch.telemetry.utilization import \
    utilization_fields  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# event kinds only one package writes: XLA's compile, collective and
# static memory inventories, and the port's measured round ledger
ONE_SIDED = ("compile", "collectives", "memory_ledger")
TELEMETRY_FLAGS = ("--logdir", "--tensorboard", "--no_telemetry",
                   "--telemetry_every", "--no_signals", "--signals_exact",
                   "--signal_groups", "--no_client_stats",
                   "--population_sketch", "--alert_action",
                   "--alert_window", "--alert_zscore", "--peak_flops",
                   "--peak_hbm_gbps", "--profile_dir", "--profile_rounds")
TELEMETRY_FIELDS = ("logdir", "use_tensorboard", "telemetry",
                    "telemetry_every", "signals", "signals_exact",
                    "signal_groups", "client_stats", "population_sketch",
                    "alert_action", "alert_window", "alert_zscore",
                    "peak_flops", "peak_hbm_gbps", "profile_dir",
                    "profile_rounds")


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
    """The entry points' default run directory lands under the test's tmp
    dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


def _events(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _vals(table):
    return {k: getattr(v, "__name__", repr(v)) for k, v in table.items()}


def test_schema_is_the_references():
    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION == 11
    assert tschema.SUPPORTED_SCHEMA_VERSIONS == \
        jschema.SUPPORTED_SCHEMA_VERSIONS
    assert tschema.TELEMETRY_BASENAME == jschema.TELEMETRY_BASENAME
    assert _vals(tschema.ENVELOPE) == _vals(jschema.ENVELOPE)
    assert set(tschema.EVENT_FIELDS) == set(jschema.EVENT_FIELDS)
    for kind, fields in jschema.EVENT_FIELDS.items():
        assert _vals(tschema.EVENT_FIELDS[kind]) == _vals(fields), kind
    for v in (6, 7, 8, 9, 11):
        name = f"FIELDS_SINCE_V{v}"
        assert getattr(tschema, name) == getattr(jschema, name), name


def _cv_argv(tmp_path, logdir):
    return ["--test", "--error_type", "virtual", "--local_momentum", "0",
            "--dataset_dir", str(tmp_path / "ds"), "--logdir",
            str(tmp_path / logdir)]


def test_one_run_both_packages(tmp_path):
    """The same run in both packages: both streams valid under both
    validators, the same event kinds in the same order but the one-sided
    ones, a port manifest with torch's device fields; teleview reads the
    port's stream."""
    from commefficient_tpu import cv_train as j_cv_train
    j_cv_train.main(_cv_argv(tmp_path, "jax"))
    out = cv_train.main(_cv_argv(tmp_path, "port")
                        + ["--device", "cpu", "--num_rounds", "1"])
    streams = {name: str(tmp_path / name / "telemetry.jsonl")
               for name in ("jax", "port")}
    for path in streams.values():
        assert jschema.validate_file(path) == []
        assert tschema.validate_file(path) == []
    kinds = {name: [e["event"] for e in _events(p)
                    if e["event"] not in ONE_SIDED]
             for name, p in streams.items()}
    assert kinds["port"] == kinds["jax"]
    ev = _events(streams["port"])
    man = ev[0]
    assert man["event"] == "manifest" and ev[-1]["event"] == "summary"
    assert (man["backend"], man["device_kind"], man["device_count"]) == \
        ("cpu", "cpu", 1)
    assert man["torch_version"] == torch.__version__
    assert not man["jax_version"][:1].isdigit()
    assert (man["mesh_shape"], man["mesh_axes"]) == \
        (_events(streams["jax"])[0]["mesh_shape"],
         _events(streams["jax"])[0]["mesh_axes"])
    assert out["telemetry"].path == streams["port"]
    led = [e for e in ev if e["event"] == "memory_ledger"]
    assert [(e["name"], e["source"], e["temp_bytes"]) for e in led] == \
        [("round_step", "measured", None)]
    mem = [e for e in ev if e["event"] == "memory"]
    assert all(e["live_bytes"] is None and e["peak_bytes"] is None
               for e in mem)
    # the port's teleview, in process, prints what the JAX script prints
    import contextlib
    import importlib.util
    import io
    from commefficient_torch.scripts import teleview
    spec = importlib.util.spec_from_file_location(
        "jax_teleview", os.path.join(ROOT, "scripts", "teleview.py"))
    jax_teleview = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_teleview)
    said = {}
    for name, main in (("port", teleview.main),
                       ("jax", jax_teleview.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            said[name] = (main(["summarize", streams["port"]]),
                          buf.getvalue())
    assert said["port"] == said["jax"]
    assert said["port"][0] == 0 and "cv_train" in said["port"][1]


def test_gpt2_stream_has_groups_and_mfu(tmp_path):
    """gpt2_train's stream: layer signals over GPT-2's coarse groups (a
    group per block's attn, mlp and norm-bias, embed, head), the fused
    route's null gradient mass, and an MFU from the analytic FLOP count
    against the --peak_flops given."""
    out = gpt2_train.main([
        "--test", "--device", "cpu", "--error_type", "virtual",
        "--local_momentum", "0", "--dataset_dir", str(tmp_path / "ds"),
        "--logdir", str(tmp_path / "g"), "--peak_flops", "1e12"])
    path = str(tmp_path / "g" / "telemetry.jsonl")
    assert jschema.validate_file(path) == []
    ev = _events(path)
    ls = [e for e in ev if e["event"] == "layer_signals"]
    assert len(ls) == out["rounds"] == 1
    groups = ls[0]["groups"]
    assert {"embed", "head", "h0/attn", "h0/mlp", "h0/norm-bias"} <= \
        set(groups)
    assert ls[0]["grad_mass"] is None
    assert sum(ls[0]["topk_count"]) == pytest.approx(
        sum(ls[0]["sizes"]) * [e for e in ev if e["event"] == "signals"][0][
            "support_density"], rel=1e-5)
    util = [e for e in ev if e["event"] == "utilization"]
    assert util and util[0]["flops_per_round"] == pytest.approx(
        out["model_flops_per_round"])
    assert util[0]["mfu"] is not None and util[0]["mfu"] > 0
    assert util[0]["flops_source"] == "analytic"


def test_stream_appends_behind_resume_and_nulls_nan(tmp_path):
    """A second stream on the same logdir appends: a ``resume`` record
    naming the first's stream_id and event count, a fresh manifest, seq
    contiguous; NaN and inf (floats and tensors) serialise as null; a
    truncated last line is terminated."""
    a = RunTelemetry(str(tmp_path), "cv_train")
    a.event("round", round=1, epoch=1, lr=0.1, loss=float("nan"),
            acc=torch.tensor(float("inf")), n_valid=torch.tensor(4.0),
            download_bytes=None, upload_bytes=None, host_s=0.0,
            dispatch_s=0.0, device_s=0.0)
    a_id = a.stream_id
    a.close()
    n_before = len(_events(a.path))
    with open(a.path, "a") as f:
        f.write('{"event": "round", "t": 1.0, "se')    # died mid-write
    b = RunTelemetry(str(tmp_path), "cv_train",
                     resume_info={"round": 2, "epoch": 0,
                                  "checkpoint": "ck/x"})
    b.write_summary(aborted=False, n_rounds=2)
    b.close()
    lines = open(b.path).read().splitlines()
    parsed = []
    for line in lines:
        try:
            parsed.append(json.loads(line))
        except ValueError:
            parsed.append(None)
    assert parsed.count(None) == 1
    events = [e for e in parsed if e is not None]
    rec = events[1]
    assert rec["event"] == "round"
    assert rec["loss"] is None and rec["acc"] is None
    assert rec["n_valid"] == 4.0
    res = events[n_before]
    assert (res["event"], res["prior_stream"], res["prior_events"],
            res["round"], res["checkpoint"]) == \
        ("resume", a_id, n_before, 2, "ck/x")
    assert [e["event"] for e in events].count("manifest") == 2
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert len(jschema.validate_lines(lines)) == 1


def test_mid_telemetry_flush_kills_a_child_and_resume_repairs(tmp_path):
    """COMMEFFICIENT_FAULT=kill:mid_telemetry_flush:3: the child writes
    half of event 3 and dies with 137; the next stream on the logdir
    terminates that line and continues behind a resume record."""
    code = (
        "import sys\n"
        "from commefficient_torch.telemetry import RunTelemetry\n"
        "t = RunTelemetry(sys.argv[1], 'cv_train')\n"
        "for i in range(6):\n"
        "    t.round_event(rnd=i, epoch=1, lr=0.1, loss=1.0, acc=0.5,\n"
        "                  n_valid=8.0, download_bytes=None,\n"
        "                  upload_bytes=None, host_s=0.0, dispatch_s=0.0,\n"
        "                  device_s=0.0)\n")
    env = dict(os.environ, COMMEFFICIENT_FAULT="kill:mid_telemetry_flush:3",
               OMP_NUM_THREADS="1")
    child = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                           cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
    assert child.returncode == 137, child.stderr
    path = str(tmp_path / "telemetry.jsonl")
    raw = open(path).read()
    assert not raw.endswith("\n")
    assert [json.loads(x)["seq"] for x in raw.splitlines()[:-1]] == \
        [0, 1, 2]
    t = RunTelemetry(str(tmp_path), "cv_train",
                     resume_info={"round": 3, "epoch": 0,
                                  "checkpoint": None})
    t.close()
    lines = open(path).read().splitlines()
    assert len(jschema.validate_lines(lines)) == 1       # the torn line
    assert json.loads(lines[-2])["event"] == "resume"
    assert json.loads(lines[-2])["prior_events"] == 3
    assert json.loads(lines[-1])["event"] == "manifest"


def _port_cfg(argv):
    return tconfig.config_from_args(
        tconfig.parse_known(cv_train.build_parser(), argv))


def test_telemetry_flags_defaults_and_refusals_match_reference():
    """The 16 flags parse in both entry points with the JAX package's
    defaults; the JAX package's refusals refuse here too (a ValueError
    naming the flag), the watchdog's need of round records included."""
    for build in (cv_train.build_parser, gpt2_train.build_parser):
        have = {o for a in build()._actions for o in a.option_strings}
        assert set(TELEMETRY_FLAGS) <= have
    ours, ref = _port_cfg([]), jconfig.parse_args([], default_lr=0.4)
    for name in TELEMETRY_FIELDS:
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.telemetry_round_every == ref.telemetry_round_every == 64
    assert _port_cfg(["--test"]).telemetry_round_every == 1
    for argv in (["--watchdog", "--no_telemetry"],
                 ["--watchdog", "--telemetry_every", "0"],
                 ["--profile_dir", "p", "--profile_rounds", "4:2"],
                 ["--profile_dir", "p", "--profile_rounds", "x"],
                 ["--telemetry_every", "-2"], ["--alert_window", "3"],
                 ["--alert_zscore", "0"], ["--signal_groups", "layer"],
                 ["--population_sketch", "maybe"],
                 ["--alert_action", "page"]):
        with pytest.raises((ValueError, AssertionError, SystemExit)):
            jconfig.parse_args(argv, default_lr=0.4)
        with pytest.raises(ValueError):
            _port_cfg(argv)
    cfg = _port_cfg(["--watchdog", "--telemetry_every", "5"])
    assert cfg.watchdog and cfg.telemetry_round_every == 5


def test_peak_table_keys_the_full_card_name():
    """989 TFLOP/s and 3,350 GB/s for the H100 SXM's full name; the PCIe
    and NVL cards (a shared prefix) and the CPU get null, never a guess;
    --peak_flops wins."""
    assert peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_hbm_for("NVIDIA H100 80GB HBM3") == 3350.0
    for kind in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "cpu"):
        assert peak_flops_for(kind) is None and peak_hbm_for(kind) is None
    assert peak_flops_for("cpu", 2e12) == 2e12
    f = utilization_fields(rounds=4, wall_s=2.0, host_s=0.5,
                           dispatch_s=0.5, device_s=0.5,
                           flops_per_round=1e12, flops_source="analytic",
                           device_kind="NVIDIA H100 80GB HBM3",
                           peak_flops=989e12)
    assert math.isclose(f["mfu"], 2e12 / 989e12, rel_tol=1e-5)
    assert f["input_wait_frac"] == 0.25


def test_memory_on_the_cpu_is_null_and_the_floor_reads_it(tmp_path):
    """Off the card every residency field is null (never zero) and the
    measured ledger's bytes are null; the dense-gradient floor refuses a
    null ledger and reads a measured one in either direction."""
    tel = RunTelemetry(str(tmp_path), "cv_train", device="cpu")
    tel.memory_event("init")
    with measure_round("cpu") as m:
        torch.ones(10).sum()
    tel.memory_ledger_event("round_step", m.ledger(), source="measured")
    tel.close()
    ev = _events(tel.path)
    assert ev[1]["live_bytes"] is None and ev[1]["devices"][0][
        "stats"] is None
    assert ev[2]["temp_bytes"] is None and ev[2]["source"] == "measured"
    assert jschema.validate_file(tel.path) == []
    assert check_dense_grad_floor(m.ledger(), 100)
    assert check_dense_grad_floor({"temp_bytes": 399}, 100) == []
    assert check_dense_grad_floor({"temp_bytes": 400}, 100)
    assert check_dense_grad_floor({"temp_bytes": 400}, 100,
                                  fused=False) == []


def test_profiler_window_writes_the_rounds_trace(tmp_path):
    """--profile_rounds 2:3 over five rounds: the trace opens at round 2,
    closes after round 3 and is written as a chrome trace; a window the
    run ends inside of is closed by finalize."""
    logs = []
    win = ProfilerWindow(str(tmp_path / "prof"), "2:3", log=logs.append)
    x = torch.ones(64)
    for rnd in range(1, 6):
        win.maybe_start(rnd)
        x = (x * 1.0001).sqrt()
        win.maybe_stop(rnd)
    assert win.done and not win.active
    trace = json.load(open(win.path))
    assert trace.get("traceEvents")
    assert os.path.basename(win.path) == "trace_rounds_2-3.json"
    late = ProfilerWindow(str(tmp_path / "late"), "4:9", log=logs.append)
    for rnd in range(1, 6):
        late.maybe_start(rnd)
        late.maybe_stop(rnd)
    late.finalize()
    assert os.path.exists(late.path) and "closed early" in logs[-1]
    assert np.isfinite(x.numpy()).all()


def test_profile_round_parser_takes_the_telemetry_flags():
    """profile_round extends an entry point's parser: its own round count
    (``--rounds``) must not collide with the telemetry's window flag; on
    the CPU it then refuses for want of a card."""
    from commefficient_torch import profile_round
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_round.main(["--device", "cpu", "--rounds", "2",
                            "--profile_rounds", "2:3"])
