"""The preemption layer of the port against the JAX package, on the CPU:
the fault-spec parser (bitwise), ``PreemptGuard`` (first signal flags,
second forces exit, the grace budget), ``stall_deadline_s`` (bitwise)
and ``RoundWatchdog``, ``with_retries``, the ledger sidecar, the
preempt-tagged generations (their names, order and rotation; a JAX-
written one resumed by the port at its round), ``save_postmortem``, and
the entry point: a SIGTERM drain, a ``kill`` at ``pre_round`` and a
``kill`` inside a checkpoint write, each resumed to the uninterrupted
run's weights bit for bit (child processes, ``--device cpu``, 120 s
each at most), the quarantine's abort with its postmortem, the ledger's
resume, and ``--watchdog`` leaving the weights as they were.
"""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modes import (SKETCH, port_runtime,  # noqa: E402
                              ref_runtime, round_inputs)

from commefficient_tpu import checkpoint as j_ckpt  # noqa: E402
from commefficient_tpu import faults as jfaults  # noqa: E402
from commefficient_tpu.core import preempt as jpreempt  # noqa: E402
from commefficient_tpu.core.quarantine import \
    QuarantineLedger as JLedger  # noqa: E402

from commefficient_torch import checkpoint as t_ckpt  # noqa: E402
from commefficient_torch import cv_train, faults  # noqa: E402
from commefficient_torch.core import preempt  # noqa: E402
from commefficient_torch.core.quarantine import QuarantineLedger  # noqa


@pytest.fixture(autouse=True)
def _runs_under_tmp(tmp_path, monkeypatch):
    """The entry points' default run directory (``runs/<stamp>_...``, the
    telemetry stream) lands under the test's tmp dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The toy and smoke-size models run fastest on one thread, and the
    test run's workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SPECS = ["kill:pre_round", "kill:pre_round:3", "sigterm:mid_round:12",
         "kill:mid_checkpoint_write", "sigterm:async_pool:0",
         "kill:mid_telemetry_flush:7", "", None, "boom:pre_round",
         "kill:nowhere", "kill", "kill:pre_round:3:4", "kill:pre_round:x"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parser_as_reference(spec):
    try:
        want = jfaults._parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            faults._parse(spec)
        assert str(te.value) == str(e)
        return
    assert faults._parse(spec) == want
    assert faults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert faults.KILL_EXIT_CODE == jfaults.KILL_EXIT_CODE == 137


def test_fault_matching_as_reference():
    try:
        for spec in ("sigterm:pre_round:3", "kill:mid_round", None):
            faults.set_fault(spec)
            jfaults.set_fault(spec)
            assert faults.faults_enabled() == jfaults.faults_enabled()
            for point in faults.FAULT_POINTS:
                for n in (None, 2, 3):
                    assert faults.fault_matches(point, n) == \
                        jfaults.fault_matches(point, n)
    finally:
        faults.set_fault(None)
        jfaults.set_fault(None)
    faults.maybe_fault("pre_round", 3)      # disarmed: a no-op


def test_preempt_guard_flags_then_forces_exit():
    exits = []
    guard = preempt.PreemptGuard(5.0, _exit=exits.append)
    old = signal.getsignal(signal.SIGTERM)
    with guard:
        assert guard.installed and not guard.requested
        assert guard.grace_used_s() is None
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert guard.requested and guard.signal_name == "SIGTERM"
        assert exits == [] and guard.grace_used_s() >= 0
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert exits == [128 + signal.SIGTERM]
    assert signal.getsignal(signal.SIGTERM) == old and not guard.installed
    timer = guard.force_exit_after(0.01)
    timer.join(1.0)
    assert exits[-1] == 1
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            preempt.PreemptGuard(bad)
    guard = preempt.PreemptGuard(1.0)
    guard.request("manual")
    assert guard.requested and guard.signal_name == "manual"


def test_stall_deadline_bitwise_and_watchdog_fires():
    rng = np.random.RandomState(0)
    for n in (0, 3, 4, 7, 32):
        hist = list(rng.rand(n) * 0.5)
        for mult in (1.0, 10.0):
            assert preempt.stall_deadline_s(hist, mult) == \
                jpreempt.stall_deadline_s(hist, mult)
            assert preempt.stall_deadline_s(hist, mult, floor_s=0.01) == \
                jpreempt.stall_deadline_s(hist, mult, floor_s=0.01)
    stalls = []
    wd = preempt.RoundWatchdog(lambda *a: stalls.append(a), mult=1.0,
                               floor_s=0.05, poll_s=0.01)
    try:
        for r in range(4):
            wd.arm(r)
            wd.disarm()
        # the MAD floor's 50 ms times z = 6 over a near-zero median
        deadline = wd.deadline_s()
        assert deadline == pytest.approx(0.3, abs=0.01)
        wd.arm(7)
        time.sleep(deadline + 0.3)
        wd.disarm(observe=False)
        assert len(stalls) == 1 and stalls[0][0] == 7
        assert stalls[0][1] >= stalls[0][2] == deadline
        assert wd.stalls == 1 and len(wd.history) == 4
    finally:
        wd.close()
    with pytest.raises(ValueError):
        preempt.RoundWatchdog(lambda *a: None, mult=0.5)


def test_with_retries():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    retried = []
    assert preempt.with_retries(flaky, attempts=3, base_s=0.001,
                                on_retry=lambda a, e: retried.append(a)) \
        == "ok"
    assert retried == [1, 2]
    calls.clear()
    with pytest.raises(OSError):
        preempt.with_retries(flaky, attempts=2, base_s=0.001)
    with pytest.raises(ValueError):
        preempt.with_retries(flaky, attempts=0)


def test_ledger_sidecar_round_trips_across_the_packages():
    jl, tl = JLedger(2, 2), QuarantineLedger(2, 2)
    for led in (jl, tl):
        led.observe(3, [1, 4, 9], [False, True, False])
        led.observe(7, [1, 2], [False, True])
    side = preempt.collect_ledger_state(tl)
    jside = jpreempt.collect_ledger_state(qledger=jl)
    assert side == jside
    back = QuarantineLedger(2, 2)
    # the JAX package's other ledgers are read past
    preempt.restore_ledger_state(dict(jside, participation={"x": 1},
                                      monitor={}), qledger=back)
    assert back.state_dict() == tl.state_dict()
    assert preempt.collect_ledger_state(None) == {}
    preempt.restore_ledger_state(None, qledger=back)
    preempt.restore_ledger_state(side, qledger=None)


# ------------------------------------------------------------ checkpoints

def test_preempt_generations_order_and_rotate(tmp_path):
    rt = port_runtime(**SKETCH)
    state = rt.init_state()
    mgr = t_ckpt.CheckpointManager(str(tmp_path), keep_last=3)
    mgr.save(state, 1)
    mgr.save(state, 1, round_in_epoch=3, tag="preempt")
    mgr.save(state, 2)
    mgr.save(state, 0, round_in_epoch=7, tag="preempt")
    assert [s for _, s in mgr.generations()] == [
        "ckpt_000001", "ckpt_000001_r000003_preempt", "ckpt_000002"]
    jm = j_ckpt.CheckpointManager(str(tmp_path))
    assert [s for _, _, s in jm.generations()] == [
        s for _, s in mgr.generations()]
    assert os.path.basename(mgr.path(1, 3, "preempt")) == \
        os.path.basename(jm._path(1, 3, "preempt"))
    _, meta = mgr.restore_latest()
    assert meta["round_in_epoch"] == 0 and meta["epoch"] == 2


def test_jax_preempt_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package drains to ckpt_000000_r000002_preempt with its
    ledger sidecar; the port's resume restores it bit for bit, at its
    round, with the ledger, and a round from it equals the JAX round
    from the same file."""
    kw = dict(SKETCH, defense="normclip")
    jrt = ref_runtime(**kw)
    js = jrt.init_state()
    inputs = round_inputs(3)

    def j_round(state, ids, batch, mask):
        return jrt.round(state, jnp.asarray(ids.astype(np.int32)),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.asarray(mask), 0.05)

    for ids, batch, mask in inputs[:2]:
        js, _ = j_round(js, ids, batch, mask)
    jl = JLedger(8, 3)
    jl.observe(2, [3], [False])
    directory = tmp_path / "Toy"
    jmgr = j_ckpt.CheckpointManager(str(directory))
    jmgr.default_meta = {"sketch_gen": t_ckpt.sketch_generation(
        port_runtime(**kw).cfg)}
    jmgr.save(js, 0, meta={"global_round": 2,
                           "ledgers": jpreempt.collect_ledger_state(
                               qledger=jl)},
              round_in_epoch=2, tag="preempt")
    rt = port_runtime(**kw, checkpoint_path=str(tmp_path), do_resume=True)
    mgr, epoch, ts, g = t_ckpt.setup_checkpointing(rt.cfg, rt, "Toy")
    assert (epoch, g, mgr.resume["round_in_epoch"]) == (0, 2, 2)
    assert mgr.resume["ledgers"]["quarantine"] == jl.state_dict()
    for name in ("ps_weights", "Vvelocity", "Verror", "defense_ref"):
        assert np.asarray(getattr(js, name)).tobytes() == \
            getattr(ts, name).numpy().tobytes(), name
    ids, batch, mask = inputs[2]
    js2, jm = j_round(js, ids, batch, mask)
    ts2, tm = rt.round(ts, ids, batch, mask, 0.05)
    np.testing.assert_allclose(tm["results"][0].numpy(),
                               np.asarray(jm["results"][0]), rtol=1e-5)
    np.testing.assert_allclose(ts2.ps_weights.numpy(),
                               np.asarray(js2.ps_weights), rtol=0, atol=1e-6)


def test_save_postmortem_full_and_degraded(tmp_path, monkeypatch, capsys):
    rt = port_runtime(**SKETCH)
    state = rt.init_state()
    path = t_ckpt.save_postmortem(str(tmp_path / "pm"), state, {"rule": "x"})
    back = t_ckpt.load_state(str(tmp_path / "pm"))
    assert torch.equal(back.ps_weights, state.ps_weights)
    assert path.endswith("pm.npz")

    def refuse(*a, **k):
        raise ValueError("above the host-copy guard")

    monkeypatch.setattr(t_ckpt, "save_state", refuse)
    t_ckpt.save_postmortem(str(tmp_path / "small"), state, {"rule": "x"})
    meta = t_ckpt.load_meta(str(tmp_path / "small"))
    assert meta["degraded"].startswith("weights-only") and \
        meta["rule"] == "x"
    arrays = t_ckpt.load_arrays(str(tmp_path / "small"), meta["digests"])
    assert list(arrays) == ["ps_weights"]
    assert "degraded to weights-only" in capsys.readouterr().err


# --------------------------------------------------------- entry point

def _argv(tmp_path, ckpt: str, epochs: int = 2, extra=()):
    """The smoke-size CV run (5 rounds an epoch), checkpointed every
    epoch under ``tmp_path / ckpt``, its final weights saved there, its
    telemetry stream in ``tmp_path / ckpt / logs`` (a resumed run appends
    to it)."""
    return ["--device", "cpu", "--test", "--dataset_dir",
            str(tmp_path / "ds"), "--num_workers", "4",
            "--local_batch_size", "8", "--iid", "--num_clients", "20",
            "--synthetic_per_class", "16", "--error_type", "virtual",
            "--local_momentum", "0", "--virtual_momentum", "0.9",
            "--num_epochs", str(epochs), "--checkpoint_every", "1",
            "--checkpoint", "--checkpoint_path", str(tmp_path / ckpt),
            "--logdir", str(tmp_path / ckpt / "logs"), *extra]


def _child(argv, fault=None):
    # one thread: the model is tiny, and the test run's workers share the
    # machine's cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("COMMEFFICIENT_FAULT", None)
    if fault:
        env["COMMEFFICIENT_FAULT"] = fault
    return subprocess.run(
        [sys.executable, "-m", "commefficient_torch.cv_train"] + argv,
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)


def _weights(tmp_path, ckpt):
    with np.load(str(tmp_path / ckpt / "ResNet9.npz")) as z:
        return z["ps_weights"]


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The uninterrupted run's final weights (a child, as the others)."""
    tmp = tmp_path_factory.mktemp("straight")
    out = _child(_argv(tmp, "ck"))
    assert out.returncode == 0, out.stderr[-2000:]
    return tmp, _weights(tmp, "ck")


def test_sigterm_drain_then_resume_is_bitwise(straight):
    tmp, want = straight
    first = _child(_argv(tmp, "sig"), "sigterm:pre_round:3")
    assert first.returncode == 0, first.stderr[-2000:]
    assert "PREEMPT: drained at epoch 0 + 3 round(s)" in first.stdout
    assert sorted(os.listdir(tmp / "sig" / "ResNet9")) == [
        "ckpt_000000_r000003_preempt.meta.json",
        "ckpt_000000_r000003_preempt.npz"]
    second = _child(_argv(tmp, "sig") + ["--resume"])
    assert second.returncode == 0, second.stderr[-2000:]
    assert "epoch 0 + 3 rounds (preempt checkpoint)" in second.stdout
    assert _weights(tmp, "sig").tobytes() == want.tobytes()


def test_kill_at_pre_round_then_resume_is_bitwise(straight):
    """Killed at round 8 (epoch 2's third): the epoch-1 generation
    resumes, and the run ends where the uninterrupted one ends."""
    tmp, want = straight
    first = _child(_argv(tmp, "kill"), "kill:pre_round:8")
    assert first.returncode == faults.KILL_EXIT_CODE
    assert "FAULT INJECTED: kill at pre_round" in first.stderr
    second = _child(_argv(tmp, "kill") + ["--resume"])
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed from" in second.stdout and "epoch 1," in second.stdout
    assert _weights(tmp, "kill").tobytes() == want.tobytes()


def test_kill_inside_a_checkpoint_write_falls_back(straight):
    """Epoch 1 written; the resumed run is killed inside epoch 2's
    write: the previous generation and .tmp litter remain, the next
    resume restores epoch 1 and ends at the uninterrupted weights."""
    tmp, want = straight
    argv = _argv(tmp, "cut")
    first = _child(_argv(tmp, "cut", epochs=1))
    assert first.returncode == 0, first.stderr[-2000:]
    cut = _child(argv + ["--resume"], "kill:mid_checkpoint_write")
    assert cut.returncode == faults.KILL_EXIT_CODE
    files = os.listdir(tmp / "cut" / "ResNet9")
    assert [f for f in files if f.endswith(".npz")] == ["ckpt_000001.npz"]
    assert any(f.endswith(".tmp") for f in files)
    last = _child(argv + ["--resume"])
    assert last.returncode == 0, last.stderr[-2000:]
    assert "resumed from" in last.stdout and "epoch 1," in last.stdout
    assert "stale .tmp" in last.stderr
    assert _weights(tmp, "cut").tobytes() == want.tobytes()


def test_quarantine_ejects_everyone_then_aborts_with_a_postmortem(
        tmp_path, capsys):
    argv = _argv(tmp_path, "q", extra=(
        "--adversary", "nan", "--adversary_frac", "1.0",
        "--nonfinite_action", "quarantine", "--quarantine_strikes", "1"))
    out = cv_train.main(argv)
    text = capsys.readouterr()
    assert out["summary"] is None and "QUARANTINE ABORT" in text.out
    assert text.err.count("EJECTED (strikes exhausted)") == 20
    ledger = out["services"].qledger
    assert len(ledger.ejected) == 20
    pm = sorted(f for f in os.listdir(tmp_path / "q" / "ResNet9")
                if f.startswith("postmortem"))
    assert pm == ["postmortem_r000005.meta.json", "postmortem_r000005.npz"]
    meta = t_ckpt.load_meta(str(tmp_path / "q" / "ResNet9" /
                                "postmortem_r000005"))
    assert meta["ledgers"]["quarantine"] == ledger.state_dict()


def test_quarantine_ledger_rides_the_checkpoint(tmp_path):
    """The epoch checkpoint's meta carries the ledger; the resume restores
    it, so a benched or ejected client stays out."""
    extra = ("--adversary", "nan", "--adversary_frac", "0.3",
             "--nonfinite_action", "quarantine")
    first = cv_train.main(_argv(tmp_path, "led", 1, extra))
    ledger = first["services"].qledger
    assert ledger.total_strikes > 0
    meta = t_ckpt.load_meta(str(tmp_path / "led" / "ResNet9" /
                                "ckpt_000001"))
    assert meta["ledgers"]["quarantine"] == ledger.state_dict()
    second = cv_train.main(_argv(tmp_path, "led", 2,
                                 extra + ("--resume",)))
    again = second["services"].qledger
    assert again.total_strikes >= ledger.total_strikes
    assert again.ejected >= ledger.ejected


def test_watchdog_leaves_the_weights_as_they_were(tmp_path):
    plain = cv_train.main(_argv(tmp_path, "plain"))
    watched = cv_train.main(_argv(tmp_path, "wd", extra=(
        "--watchdog", "--watchdog_mult", "2")))
    assert torch.equal(plain["state"].ps_weights,
                       watched["state"].ps_weights)
    assert watched["services"].watchdog is not None
