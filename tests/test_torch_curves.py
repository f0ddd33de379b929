"""The learning-curve recipes (``commefficient_torch/scripts/curves.py``)
and their data tools against the JAX package's records, on the CPU:

- each arm's argv parsed by both packages' parsers gives equal values in
  every configuration field both have;
- at the TPU's seed the port's samplers deal each epoch the TPU run's
  rounds: each epoch's upload MiB is the TPU log's;
- ``make_persona_corpus``: the JSON bytes of the JAX script;
- ``gpt2log2tsv``: the JAX script's TSV from a committed TPU log;
- ``curve_band`` on the committed TSVs: a TPU curve against itself
  passes at every epoch, against a copy shifted past its band fails;
  ``tpu_log_column`` reads the TPU logs' upload MiB; ``band``'s second
  line sums up each arm's runs; an arm whose TPU run aborted (six of the
  EF study's) is held by ``abort_verdict`` to its abort epoch, its round
  read from the log; header-only TSVs read as no rows;
- ``chip_smoke.CURVE_LAUNCHES`` names each arm's kernels a round;
- ``run_arm`` end to end at the entry points' smoke size;
- ``slow``: the epoch rows of both packages from the same weights and
  data (``torch_curve_parity.py``): hard-v2 at a narrow ResNet-9 for 2
  and 6 epochs, the clipped dense GPT-2 arms and three EF arms at a
  narrow ``GPT2DoubleHeads`` for 3.
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest

from commefficient_tpu import config as jconfig  # noqa: E402

from commefficient_torch import config as tconfig  # noqa: E402
from commefficient_torch.scripts import (curves, gpt2log2tsv,  # noqa: E402
                                         make_persona_corpus)

import torch_curve_parity as parity  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _without_device(argv):
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


@pytest.mark.parametrize("arm", sorted(curves.ARMS))
def test_arm_argv_gives_one_configuration(arm, tmp_path):
    argv = curves.arm_argv(arm, 22, str(tmp_path))
    kind = curves.ARMS[arm].kind
    entry = curves._entry(kind)
    got = tconfig.config_from_args(tconfig.parse_known(entry.build_parser(),
                                                       argv))
    ref = jconfig.parse_args(_without_device(argv),
                             default_lr=0.4 if kind == "cv" else 0.16)
    if kind == "gpt2":
        # each package's gpt2_train sets these itself (the JAX one in its
        # main, the port's parser by its defaults)
        ref = ref.replace(model="GPT2", dataset_name="PERSONA")
    shared = sorted(set(vars(ref)) & set(vars(got)))
    assert len(shared) > 60
    diff = {k: (getattr(got, k), getattr(ref, k)) for k in shared
            if getattr(got, k) != getattr(ref, k)}
    assert not diff
    assert (got.seed, got.num_epochs) == (22, curves.ARMS[arm].epochs)


# the bytes a client uploads a round, by arm: the dense (d,) float32
# gradient, d of ResNet-9 with --batchnorm or of GPT-2 over the hash
# vocabulary, or the 5 x c float32 table
UPLOAD_BYTES = {"cv_uncompressed24": 4 * 6_573_120,
                "cv_true_topk24": 4 * 6_573_120,
                "cv_sketch96": 4 * 5 * 500_000,
                "gpt2_uncompressed24": 4 * 92_138_496,
                "gpt2_true_topk24_clip": 4 * 92_138_496,
                "gpt2_sketch24": 4 * 5 * 524_288,
                "gpt2_sketch24_clip": 4 * 5 * 524_288,
                "gpt2_sketch24_denseclip": 4 * 5 * 524_288,
                "gpt2_sketch24_clip8": 4 * 5 * 524_288,
                "gpt2_sketch24_c1048576": 4 * 5 * 1_048_576,
                "gpt2_sketch24_c2097152": 4 * 5 * 2_097_152,
                "gpt2_true_topk24": 4 * 92_138_496,
                "gpt2_sketch48": 4 * 5 * 524_288,
                "gpt2_sketch24_clip1_decay95": 4 * 5 * 524_288,
                "gpt2_sketch24_clip1_k200k": 4 * 5 * 524_288,
                "gpt2_sketch24_clip1_r9": 4 * 9 * 524_288,
                "gpt2_sketch24_clip1_c1p8m": 4 * 5 * 1_835_008,
                "gpt2_sketch24_clip1_c4m": 4 * 5 * 4_194_304,
                "gpt2_sketch24_clip1_c8m": 4 * 5 * 8_388_608,
                "gpt2_sketch24_clip1_r2_c4p6m": 4 * 2 * 4_603_904,
                "gpt2_sketch24_densestate_clip1": 4 * 5 * 524_288,
                "gpt2_sketch24_densestate_clip1_decay95": 4 * 5 * 524_288}
# the EF study's arms whose TPU run aborted in its first epoch, with the
# first non-finite round of each one's log
ABORTED = {"gpt2_sketch24_sub": 7, "gpt2_sketch24_sub_clip1": 11,
           "gpt2_sketch24_sub_clip1_decay90": 11,
           "gpt2_sketch24_sub_clip1_r9": 16,
           "gpt2_sketch24_sub_clip1_c1p8m": 29,
           "gpt2_sketch24_densestate": 24}


@pytest.mark.parametrize("arm", ["cv_uncompressed24", "cv_true_topk24",
                                 "cv_sketch96", "gpt2_sketch24",
                                 "gpt2_sketch24_clip",
                                 "gpt2_sketch24_denseclip",
                                 "gpt2_sketch24_clip8",
                                 "gpt2_sketch24_c1048576",
                                 "gpt2_sketch24_c2097152",
                                 "gpt2_true_topk24", "gpt2_sketch48",
                                 "gpt2_sketch24_clip1_decay95",
                                 "gpt2_sketch24_clip1_k200k",
                                 "gpt2_sketch24_clip1_r9",
                                 "gpt2_sketch24_clip1_c1p8m",
                                 "gpt2_sketch24_clip1_c4m",
                                 "gpt2_sketch24_clip1_c8m",
                                 "gpt2_sketch24_clip1_r2_c4p6m",
                                 "gpt2_sketch24_densestate_clip1",
                                 "gpt2_sketch24_densestate_clip1_decay95"])
def test_upload_column_is_the_tpu_logs_at_its_seed(arm, tmp_path):
    """At the TPU's seed the port's sampler deals each epoch the TPU
    run's rounds (hard-v2: 9 or 10 of 8 clients; GPT-2: 32), so the
    epoch rows' upload MiB are the TPU log's at every epoch."""
    spec = curves.ARMS[arm]
    argv = curves.arm_argv(arm, curves.TPU_SEED, str(tmp_path), "cpu")
    if spec.kind == "gpt2":
        with contextlib.redirect_stdout(io.StringIO()):
            curves.ensure_corpus(str(tmp_path))
    rounds = curves.epoch_rounds(spec.kind, argv, spec.epochs)
    want = curves.tpu_log_column(os.path.join(ROOT, spec.tpu_log))
    got = {e + 1: round(n * 8 * UPLOAD_BYTES[arm] / 2**20)
           for e, n in enumerate(rounds)}
    assert got == want
    if spec.kind == "cv":
        assert set(rounds) == {9, 10}


def test_upload_bytes_are_the_models():
    from commefficient_torch import cv_train
    cfg = tconfig.config_from_args(tconfig.parse_known(
        cv_train.build_parser(), list(curves.CV_COMMON)))
    model = cv_train.build_model(cfg, 10, device="meta")
    assert 4 * model.num_params == UPLOAD_BYTES["cv_uncompressed24"]


def test_persona_corpus_bytes_are_the_jax_scripts(tmp_path):
    jax_corpus = _load("make_persona_corpus")
    for kw in ({}, {"n_train": 5, "n_valid": 2, "seed": 3}):
        assert json.dumps(make_persona_corpus.make_corpus(**kw)) == \
            json.dumps(jax_corpus.make_corpus(**kw))
    with contextlib.redirect_stdout(io.StringIO()):
        path = make_persona_corpus.main([str(tmp_path / "port")])
    want = jax_corpus.make_corpus()
    with open(path, "rb") as f:
        assert f.read() == json.dumps(want).encode()


@pytest.mark.parametrize("log", ["gpt2_sketch24", "gpt2_true_topk24_clip"])
def test_gpt2log2tsv_is_the_jax_scripts(log, tmp_path):
    src = os.path.join(ROOT, "runs", "gpt2_conv", f"{log}.log")
    with contextlib.redirect_stdout(io.StringIO()):
        gpt2log2tsv.main(src, str(tmp_path / "port.tsv"))
        _load("gpt2log2tsv").main(src, str(tmp_path / "jax.tsv"))
    got = (tmp_path / "port.tsv").read_bytes()
    assert got == (tmp_path / "jax.tsv").read_bytes()
    assert got == open(os.path.join(ROOT, "runs", "gpt2_conv",
                                    f"{log}.tsv"), "rb").read()


def _shifted(src, dst, col, by):
    rows = curves.read_tsv(src)
    with open(src) as f:
        head = f.readline().strip()
    sep = "\t" if "\t" in head else ","
    cols = head.split(sep)
    with open(dst, "w") as f:
        f.write(head + "\n")
        for e in sorted(rows):
            vals = dict(rows[e], **{col: rows[e][col] + by})
            f.write(sep.join(str(int(vals[c])) if c == "epoch"
                             else repr(vals[c]) for c in cols) + "\n")
    return str(dst)


def _port_run(stem, log_text, rows):
    """A port run's log and TSV under ``stem``: the log's text, and a
    GPT-2 TSV with finite epoch rows 1 .. ``rows``."""
    with open(f"{stem}.log", "w") as f:
        f.write(log_text)
    with open(f"{stem}.tsv", "w") as f:
        f.write("epoch\thours\ttest_nll\tppl\tmc_acc\n" + "".join(
            f"{e}\t0.1\t3.0\t20.09\t0.5\n" for e in range(1, rows + 1)))
    return str(stem)


@pytest.mark.parametrize("arm", sorted(curves.ARMS))
def test_curve_band_on_the_committed_curves(arm, tmp_path):
    """A TPU curve against itself passes at every epoch and against a
    copy shifted past its band fails. An arm whose TPU run aborted is
    held by ``abort_verdict``: its round is read from the log, a run that
    aborts in the same epoch is inside, one with 2 finite epochs outside
    (also one with none that did not abort)."""
    spec = curves.ARMS[arm]
    tpu = os.path.join(ROOT, spec.tpu_tsv)
    band = curves.BAND[spec.kind]
    if arm in ABORTED:
        assert (spec.tpu_abort, spec.tpu_abort_epoch) == (ABORTED[arm], 1)
        assert curves.read_tsv(tpu) == {}
        line = ("TRAINING DIVERGED (first non-finite update at round "
                f"{spec.tpu_abort + 2}), TERMINATING\n")
        aborted = _port_run(tmp_path / "a", "Test acc at epoch 0\n" + line,
                            0)
        two = _port_run(tmp_path / "b", "", 2)
        late = _port_run(tmp_path / "c", line, 2)
        silent = _port_run(tmp_path / "d", "", 0)
        out = curves.abort_verdict([aborted], spec)
        assert out["inside"] and out["runs"][0][1:] == (
            spec.tpu_abort + 2, 0, True)
        for stem in (two, late, silent):
            assert not curves.abort_verdict([aborted, stem], spec)["inside"]
        return
    assert spec.tpu_abort is None
    same = curves.curve_band([tpu, tpu], tpu, band)
    assert same["first_miss"] is None and same["last"]["inside"]
    assert same["inside_epochs"] == same["epochs"] == spec.epochs
    for col, width in band.items():
        past = _shifted(tpu, tmp_path / f"{col}_past.tsv", col, 1.5 * width)
        out = curves.curve_band([past, past], tpu, band)
        assert out["first_miss"] == 1 and out["inside_epochs"] == 0
        assert not out["last"]["inside"]
        near = _shifted(tpu, tmp_path / f"{col}_near.tsv", col, 0.5 * width)
        assert curves.curve_band([tpu, near], tpu, band)["first_miss"] \
            is None
    # a port curve that stops early: the missing epochs are outside
    cut = tmp_path / "cut.tsv"
    with open(tpu) as f:
        cut.write_text("".join(f.readlines()[:3]))
    short = curves.curve_band([str(cut)], tpu, band)
    assert short["inside_epochs"] == 2 and short["first_miss"] == 3


@pytest.fixture
def one_thread():
    """The entry points at smoke size run on one intra-op thread: the
    test run's workers share the machine's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_arm_writes_its_records(tmp_path, monkeypatch, one_thread):
    """One CIFAR10 and one GPT-2 arm at the entry points' smoke size on
    the CPU: the TSV in its format, the JSON record, the log; a one-epoch
    cut of a two-epoch arm runs the first epoch's rounds."""
    monkeypatch.setattr(curves, "CV_COMMON", (
        "--test", "--iid", "--num_clients", "8", "--num_workers", "2",
        "--local_batch_size", "4", "--synthetic_per_class", "4",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--valid_batch_size", "20", "--no_telemetry"))
    monkeypatch.setattr(curves, "GPT2_COMMON", (
        "--test", "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--eval_before_start", "--no_telemetry"))
    monkeypatch.setitem(curves.ARMS, "t_cv", curves.Arm(
        "cv", 2, ("--mode", "sketch", "--error_type", "virtual"),
        "runs/cifar10_hard24v2_sketch.tsv",
        "runs/cifar10_hard24v2_sketch.log"))
    monkeypatch.setitem(curves.ARMS, "t_gpt2", curves.Arm(
        "gpt2", 1, ("--mode", "sketch", "--error_type", "virtual"),
        "runs/gpt2_conv/gpt2_sketch24.tsv",
        "runs/gpt2_conv/gpt2_sketch24.log"))
    out = str(tmp_path / "out")
    one = curves.run_arm("t_cv", 5, out, "cpu", epochs=1)
    assert [r["epoch"] for r in one["epochs"]] == [1]
    assert one["rounds"] == curves.epoch_rounds(
        "cv", curves.arm_argv("t_cv", 5, out, "cpu"), 1)[0]
    with open(one["tsv"]) as f:
        lines = f.read().splitlines()
    assert lines[0] == "epoch,hours,top1Accuracy" and len(lines) == 2
    with open(os.path.join(out, "t_cv_s5.json")) as f:
        assert json.load(f)["rounds"] == one["rounds"]
    g = curves.run_arm("t_gpt2", 5, out, "cpu")
    with open(g["tsv"]) as f:
        head, row = f.read().splitlines()
    assert head == "epoch\thours\ttest_nll\tppl\tmc_acc"
    assert row.split("\t")[0] == "1"
    assert os.path.exists(os.path.join(out, "data_gpt2", curves.CORPUS))
    assert "=== t_gpt2 seed 5" in open(
        os.path.join(out, "t_gpt2_s5.log")).read()


def test_band_command_reports_misses_and_missing_runs(tmp_path, capsys):
    """``band`` exits 2 without a run's TSV, 1 when a curve misses."""
    out = tmp_path / "out"
    out.mkdir()
    assert curves.main(["band", "--arms", "cv_true_topk24", "--seeds",
                        "21", "--out", str(out)]) == 2
    tpu = os.path.join(ROOT, curves.ARMS["cv_true_topk24"].tpu_tsv)
    _shifted(tpu, out / "cv_true_topk24_s21.tsv", "top1Accuracy", 3.0)
    up = curves.tpu_log_column(os.path.join(
        ROOT, curves.ARMS["cv_true_topk24"].tpu_log))
    (out / "cv_true_topk24_s21.json").write_text(json.dumps(
        {"epochs": [{"epoch": e, "up (MiB)": v} for e, v in up.items()]}))
    assert curves.main(["band", "--arms", "cv_true_topk24", "--seeds",
                        "21", "--out", str(out)]) == 1
    text = capsys.readouterr().out
    assert "inside at 0 of 24 epochs" in text
    assert "equal to the TPU log's at every epoch" in text


def test_band_prints_the_runs_summary(tmp_path, capsys):
    """``band``'s second line: the last epoch's port range beside the
    TPU's value, the runs' wall seconds and round medians, and each
    kernel's launches a round from the runs' records."""
    out = tmp_path / "out"
    out.mkdir()
    spec = curves.ARMS["gpt2_sketch24_denseclip"]
    tpu = os.path.join(ROOT, spec.tpu_tsv)
    up = curves.tpu_log_column(os.path.join(ROOT, spec.tpu_log))
    for seed, wall in ((21, 270.5), (22, 280.0)):
        stem = out / f"gpt2_sketch24_denseclip_s{seed}"
        (stem.parent / (stem.name + ".tsv")).write_bytes(open(tpu,
                                                              "rb").read())
        (stem.parent / (stem.name + ".json")).write_text(json.dumps(
            {"epochs": [{"epoch": e, "up (MiB)": v} for e, v in up.items()],
             "rounds": 768, "round_s_median": wall / 800, "wall_s": wall,
             "launches": {"circ_encode": 768, "circ_decode": 768,
                          "cell_sum": 768, "flash_fwd": 0}}))
    assert curves.main(["band", "--arms", "gpt2_sketch24_denseclip",
                        "--seeds", "21,22", "--out", str(out)]) == 0
    second = capsys.readouterr().out.splitlines()[1]
    assert second == ("  epoch 24: test_nll tpu 2.399 port 2.399; mc_acc "
                      "tpu 0.5208 port 0.5208; wall 270.5-280.0 s; round "
                      "median 338.1-350.0 ms; a round: cell_sum 1, "
                      "circ_decode 1, circ_encode 1")
    assert second in (out / "gpt2_sketch24_denseclip_band.txt").read_text()


def test_chip_smoke_checks_each_arms_launches(tmp_path, capsys):
    """``chip_smoke.CURVE_LAUNCHES`` names every arm: K1, K2 and a cell
    sum a round for the sketch arms only (one K1 under the dense clip),
    none for the dense ones. ``check_curve_record`` passes a record with
    those counts and the TPU log's upload MiB, and reports (not strict)
    or fails (strict) one that launched otherwise."""
    import chip_smoke
    assert set(chip_smoke.CURVE_LAUNCHES) == set(curves.ARMS)
    assert set(chip_smoke.CURVE_SMOKE_ARMS) <= set(curves.ARMS)
    for name, (k1, k2, cells) in chip_smoke.CURVE_LAUNCHES.items():
        flags = curves.ARMS[name].flags
        sketch = flags[flags.index("--mode") + 1] == "sketch"
        dense_state = "--sketch_server_state" in flags
        assert (k2, cells) == ((0, 0) if not sketch else (1, 0)
                               if dense_state else (1, 2)
                               if "subtract" in flags else (1, 1))
        assert k1 == (0 if not sketch else 1 if "--sketch_dense_clip"
                      in flags or dense_state else 9
                      if name.startswith("cv") else 8)
    arm = curves.ARMS["gpt2_sketch24_denseclip"]
    tsv = tmp_path / "r.tsv"
    tsv.write_text("epoch\thours\ttest_nll\tppl\tmc_acc\n1\t0\t9\t8e3\t0.5\n")
    up = curves.tpu_log_column(os.path.join(ROOT, arm.tpu_log))
    rec = {"arm": "gpt2_sketch24_denseclip", "seed": curves.TPU_SEED,
           "tsv": str(tsv), "rounds": 32,
           "epochs": [{"epoch": 1, "test_loss": 9.0, "up (MiB)": up[1]}],
           "launches": {"circ_encode": 32, "circ_decode": 32,
                        "cell_sum": 32, "flash_fwd": 0}}
    assert chip_smoke.check_curve_record(rec, arm)
    rec["launches"]["circ_encode"] = 256
    assert not chip_smoke.check_curve_record(rec, arm, strict=False)
    assert "want 1 K1 + 1 K2 + 1 cell sum a round" in capsys.readouterr().out
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        chip_smoke.check_curve_record(rec, arm)
    # an arm whose TPU run aborted: a record without an epoch row passes,
    # and its launches over the rounds it ran are still held
    sub = curves.ARMS["gpt2_sketch24_sub"]
    head = tmp_path / "h.tsv"
    head.write_text("epoch\thours\ttest_nll\tppl\tmc_acc\n")
    rec = {"arm": "gpt2_sketch24_sub", "seed": curves.TPU_SEED,
           "tsv": str(head), "rounds": 32, "epochs": [],
           "launches": {"circ_encode": 256, "circ_decode": 32,
                        "cell_sum": 64}}
    assert chip_smoke.check_curve_record(rec, sub)
    rec["launches"]["cell_sum"] = 32
    assert not chip_smoke.check_curve_record(rec, sub, strict=False)
    # a full arm's record without an epoch row is reported
    rec = dict(rec, arm="gpt2_sketch24_clip1_r9", launches={
        "circ_encode": 256, "circ_decode": 32, "cell_sum": 32})
    assert not chip_smoke.check_curve_record(
        rec, curves.ARMS["gpt2_sketch24_clip1_r9"], strict=False)
    assert "no epoch row" in capsys.readouterr().out


def test_curve_study_prepares_shared_data_before_its_children(
        tmp_path, monkeypatch):
    """``chip_smoke.run_curve_study`` over CIFAR10 and GPT-2 arms writes
    each kind's shared data once, in the parent, before it starts any
    child, and then runs every (arm, seed) as a child, CURVE_PROCS at
    once, the longest first."""
    import chip_smoke
    calls = []
    monkeypatch.setattr(curves, "prepare_data",
                        lambda name, out: calls.append(("prepare", name)))

    def children(jobs, procs, out):
        calls.append(("children", [name for name, _ in jobs], procs))
        return {name: 1 for name, _ in jobs}
    monkeypatch.setattr(chip_smoke, "run_children", children)
    monkeypatch.setattr(chip_smoke, "smi_line", lambda: "no card")
    monkeypatch.setattr(curves, "main", lambda argv: 0)
    arms = ["gpt2_sketch24_sub", "cv_sketch96", "gpt2_sketch24_clip1_c8m",
            "cv_true_topk24"]
    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.run_curve_study(arms, [21, 22], str(tmp_path))
    assert calls[:2] == [("prepare", "gpt2_sketch24_sub"),
                         ("prepare", "cv_sketch96")]
    (what, names, procs), = calls[2:]
    assert what == "children" and procs == chip_smoke.CURVE_PROCS
    assert sorted(names) == sorted(f"{a}_s{s}" for a in arms
                                   for s in (21, 22))
    assert names[:2] == ["cv_sketch96_s21", "cv_sketch96_s22"]
    assert names[-2:] == ["gpt2_sketch24_sub_s21", "gpt2_sketch24_sub_s22"]


def test_prepare_data_writes_what_a_run_reads(tmp_path, monkeypatch,
                                              one_thread):
    """``curves.prepare_data`` writes a CIFAR10 and a GPT-2 arm's data
    under ``out`` (the entry points' smoke size on the CPU): GPT-2's
    corpus and prepared sets, CIFAR10's prepared clients; a second call
    finds them and rewrites nothing."""
    monkeypatch.setattr(curves, "CV_COMMON", (
        "--test", "--iid", "--num_clients", "8", "--num_workers", "2",
        "--local_batch_size", "4", "--synthetic_per_class", "4",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--valid_batch_size", "20", "--no_telemetry"))
    monkeypatch.setattr(curves, "GPT2_COMMON", (
        "--test", "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--no_telemetry"))
    monkeypatch.setitem(curves.ARMS, "t_cv", curves.Arm(
        "cv", 1, ("--mode", "sketch", "--error_type", "virtual"),
        "runs/cifar10_hard24v2_sketch.tsv",
        "runs/cifar10_hard24v2_sketch.log"))
    monkeypatch.setitem(curves.ARMS, "t_gpt2", curves.Arm(
        "gpt2", 1, ("--mode", "sketch", "--error_type", "virtual"),
        "runs/gpt2_conv/gpt2_sketch24.tsv",
        "runs/gpt2_conv/gpt2_sketch24.log"))
    out = str(tmp_path / "out")

    def files():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for d, _, fs in os.walk(out) for f in fs}
    for name in ("t_cv", "t_gpt2"):
        curves.prepare_data(name, out)
    written = files()
    names = [os.path.relpath(f, out) for f in written]
    assert os.path.join("data_gpt2", curves.CORPUS) in names
    assert any(f.endswith("persona_train.npz") for f in names)
    assert any(f.endswith("persona_val.npz") for f in names)
    assert any(f.startswith("data_cv") for f in names)
    for name in ("t_cv", "t_gpt2"):
        curves.prepare_data(name, out)
    assert files() == written


def test_header_only_records_read(tmp_path):
    """A run that aborted before its first epoch row: ``gpt2log2tsv``
    writes the header alone from its log (the TPU's and the port's), and
    ``read_tsv`` reads such a TSV as no rows."""
    src = os.path.join(ROOT, "runs", "gpt2_conv", "gpt2_sketch24_sub.log")
    with contextlib.redirect_stdout(io.StringIO()):
        gpt2log2tsv.main(src, str(tmp_path / "t.tsv"))
    assert (tmp_path / "t.tsv").read_text() == open(os.path.join(
        ROOT, "runs", "gpt2_conv", "gpt2_sketch24_sub.tsv")).read()
    assert curves.read_tsv(str(tmp_path / "t.tsv")) == {}
    assert curves.abort_round(open(src).read()) == 7


def test_band_holds_an_aborted_arm_to_the_tpus_epoch(tmp_path, capsys):
    """``band`` on an arm whose TPU run aborted: exit 0 when every run
    aborts in the same epoch, its second line putting each run's first
    non-finite round beside the TPU's; exit 1 when a run trains past
    it."""
    out = tmp_path / "out"
    out.mkdir()
    name = "gpt2_sketch24_sub_clip1_r9"
    line = "TRAINING DIVERGED (first non-finite update at round {}), " \
        "TERMINATING\n"
    for seed, rnd in ((21, 14), (22, 19)):
        _port_run(out / f"{name}_s{seed}", line.format(rnd), 0)
        (out / f"{name}_s{seed}.json").write_text(json.dumps(
            {"epochs": [], "rounds": 32, "round_s_median": 0.4,
             "wall_s": 50.0, "launches": {"circ_encode": 256,
                                          "circ_decode": 32,
                                          "cell_sum": 64}}))
    argv = ["band", "--arms", name, "--seeds", "21,22", "--out", str(out)]
    assert curves.main(argv) == 0
    text = capsys.readouterr().out.splitlines()
    assert text[0] == (f"== {name}: aborted at the end of epoch 1 as the "
                       "TPU's did in 2 of 2 runs")
    assert text[1] == ("  first non-finite round tpu 16 port 14/19; wall "
                       "50.0 s; round median 400.0 ms; a round: cell_sum "
                       "2, circ_decode 1, circ_encode 8")
    _port_run(out / f"{name}_s22", "", 2)
    assert curves.main(argv) == 1
    assert "in 1 of 2 runs" in capsys.readouterr().out


def test_cli_refuses_an_unknown_arm():
    with pytest.raises(SystemExit) as e, \
            contextlib.redirect_stderr(io.StringIO()):
        curves.main(["band", "--arms", "nope"])
    assert e.value.code == 2


@pytest.mark.slow
def test_narrow_hard_v2_epochs_track_the_jax_package(tmp_path):
    """The CIFAR10 hard-v2 uncompressed recipe at a narrow ResNet-9
    (channels 16/32/64/128, float32), from the same weights and data:
    two epochs of the JAX package's ``cv_train.train`` and of the port's
    driver give the same epoch rows within 0.01 (about 5 minutes, most of
    it the JAX package on the CPU)."""
    import numpy as np
    argv = parity.hard_v2_argv(str(tmp_path), 21, num_epochs=2)
    jax_rows = parity.hard_v2_jax(argv, 2, 21, parity.NARROW)
    port_rows = parity.hard_v2_port(argv, 2, 21, parity.NARROW)
    assert len(port_rows) == len(jax_rows) == 2
    np.testing.assert_allclose(port_rows, jax_rows, atol=0.01)


@pytest.mark.slow
def test_narrow_hard_v2_six_epochs_track_the_jax_package(tmp_path):
    """The first six epochs of ``cv_uncompressed24`` on its own 24-epoch
    schedule, where the port's curves on the card part from the TPU's
    (C17), at the narrow ResNet-9 in float32 from the same weights and
    data: the JAX package's ``cv_train.train`` and the port's driver give
    the same epoch rows within 0.01 (1,707 s on two CPU cores beside
    other runs). It fails at epoch 6's train accuracy, 0.7972 against
    0.8073: there the port alone moves 0.0117 between two intra-op
    threads and one (ROADMAP C17)."""
    import numpy as np
    argv = parity.hard_v2_argv(str(tmp_path), 21)
    jax_rows = parity.hard_v2_jax(argv, 6, 21, parity.NARROW)
    port_rows = parity.hard_v2_port(argv, 6, 21, parity.NARROW)
    assert len(port_rows) == len(jax_rows) == 6
    np.testing.assert_allclose(port_rows, jax_rows, atol=0.01)


@pytest.mark.slow
@pytest.mark.parametrize("arm", ["gpt2_uncompressed24",
                                 "gpt2_true_topk24_clip"])
def test_narrow_gpt2_clipped_epochs_track_the_jax_package(arm, tmp_path):
    """The two clipped dense GPT-2 arms (``--max_grad_norm 1``; C18) at a
    narrow ``GPT2DoubleHeads`` (2 layers, 64 wide, float32) over the hash
    vocabulary, from the same weights and corpus: the first three epochs
    of the JAX package's gpt2_train loop and of the port's driver give
    each epoch's test NLL within 0.01 and MC accuracy within one of the
    192 validation items (296 s and 1,393 s on two CPU cores beside other
    runs). The true_topk case fails at epoch 3's MC accuracy, 0.500
    against 0.484, as far as the port alone moves under a one-ulp change
    of its initial weights (ROADMAP C18)."""
    import numpy as np
    argv = parity.gpt2_argv(arm, str(tmp_path))
    jax_rows = np.array(parity.gpt2_jax(argv, 3))
    port_rows = np.array(parity.gpt2_port(argv, 3))
    assert jax_rows.shape == port_rows.shape == (3, 3)
    nll, mc = (parity.GPT2_COLUMNS.index(c) for c in ("test_loss",
                                                      "test_acc"))
    assert np.all(np.abs(port_rows[:, nll] - jax_rows[:, nll]) <= 0.01)
    assert np.all(np.abs(port_rows[:, mc] - jax_rows[:, mc])
                  <= 1 / 192 + 1e-9)


@pytest.mark.slow
@pytest.mark.parametrize("arm", ["gpt2_sketch24_sub_clip1",
                                 "gpt2_sketch24_densestate_clip1",
                                 "gpt2_sketch24_densestate_clip1_decay95",
                                 "gpt2_sketch24_clip1_r9"])
def test_narrow_gpt2_ef_epochs_track_the_jax_package(arm, tmp_path):
    """Four EF arms (the subtract rule, the dense state with the dense
    clip, with and without decay 0.95, 9 rows) at the narrow
    ``GPT2DoubleHeads`` over the hash vocabulary, from the same weights
    and corpus, with
    ``--num_cols`` cut to ceil(d / 176) of the narrow d, the arms' load
    at GPT-2's width (``torch_curve_parity.GPT2_LOAD``; k and the rest
    unchanged): the first three epochs of the JAX package's gpt2_train
    loop and of the port's driver give each epoch's test NLL within 0.01
    and MC accuracy within one of the 192 validation items, and where
    either aborts, both abort at the same first non-finite round."""
    import numpy as np
    argv = parity.gpt2_argv(arm, str(tmp_path), load=parity.GPT2_LOAD)
    jax_rows, jax_abort = parity.with_abort(parity.gpt2_jax, argv, 3)
    port_rows, port_abort = parity.with_abort(parity.gpt2_port, argv, 3)
    assert port_abort == jax_abort
    jax_rows, port_rows = np.array(jax_rows), np.array(port_rows)
    assert jax_rows.shape == port_rows.shape
    if jax_abort is None:
        assert len(jax_rows) == 3
    if len(jax_rows):
        nll, mc = (parity.GPT2_COLUMNS.index(c) for c in ("test_loss",
                                                          "test_acc"))
        assert np.all(np.abs(port_rows[:, nll] - jax_rows[:, nll]) <= 0.01)
        assert np.all(np.abs(port_rows[:, mc] - jax_rows[:, mc])
                      <= 1 / 192 + 1e-9)
