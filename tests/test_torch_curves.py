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
  ``tpu_log_column`` reads the TPU logs' upload MiB;
- ``run_arm`` end to end at the entry points' smoke size.
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
                "gpt2_sketch24": 4 * 5 * 524_288}


@pytest.mark.parametrize("arm", ["cv_uncompressed24", "cv_true_topk24",
                                 "cv_sketch96", "gpt2_sketch24"])
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


@pytest.mark.parametrize("arm", sorted(curves.ARMS))
def test_curve_band_on_the_committed_curves(arm, tmp_path):
    spec = curves.ARMS[arm]
    tpu = os.path.join(ROOT, spec.tpu_tsv)
    band = curves.BAND[spec.kind]
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
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from commefficient_tpu import cv_train as j_cv
    from commefficient_tpu.core import FedRuntime as JRuntime
    from commefficient_tpu.losses import make_cv_loss as j_make_cv_loss
    from commefficient_tpu.models import ResNet9 as JResNet9
    from commefficient_torch import cv_train as t_cv
    from commefficient_torch.core import driver
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.convert import params_from_jax
    from commefficient_torch.models.resnet9 import ResNet9
    from commefficient_torch.utils.schedules import lr_schedule_for

    ch = {"prep": 16, "layer1": 32, "layer2": 64, "layer3": 128}
    argv = curves.arm_argv("cv_uncompressed24", 21, str(tmp_path), "cpu")
    argv[argv.index("--num_epochs") + 1] = "2"
    argv += ["--compute_dtype", "float32", "--no_telemetry"]
    rows = {"jax": [], "port": []}

    class Rows:
        def __init__(self, key):
            self.key = key

        def append(self, row):
            rows[self.key].append([row[k] for k in (
                "train_loss", "train_acc", "test_loss", "test_acc")])

    jcfg = jconfig.parse_args(_without_device(argv), default_lr=0.4)
    jmod = JResNet9(do_batchnorm=True, num_classes=10, channels=ch)
    params = jmod.init(jax.random.PRNGKey(21), jnp.ones((1, 32, 32, 3)))
    jtrain, jval = j_cv.build_datasets(jcfg)
    jcfg = jcfg.replace(num_clients=jtrain.num_clients)
    jrt = JRuntime(jcfg, params, j_make_cv_loss(jmod, "float32"),
                   num_clients=jtrain.num_clients)
    j_cv.train(jcfg, jrt, jrt.init_state(), jtrain, jval,
               loggers=(Rows("jax"),))
    tcfg = tconfig.config_from_args(
        tconfig.parse_known(t_cv.build_parser(), argv))
    ttrain, tval = t_cv.build_datasets(tcfg)
    tcfg = tcfg.replace(num_clients=ttrain.num_clients)
    model = ResNet9(do_batchnorm=True, num_classes=10, channels=ch)
    with torch.no_grad():
        model.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params),
                                         model))
    trt = FedRuntime(tcfg, model, make_cv_loss(model, "float32"),
                     device="cpu")
    stores = t_cv.make_stores(trt, ttrain, tval)
    driver.train(trt, trt.init_state(), ttrain, tval,
                 lr_schedule_for(trt.cfg), loggers=(Rows("port"),),
                 train_store=stores[0], val_store=stores[1])
    assert len(rows["port"]) == len(rows["jax"]) == 2
    np.testing.assert_allclose(rows["port"], rows["jax"], atol=0.01)
