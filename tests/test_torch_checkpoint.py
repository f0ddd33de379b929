"""The port's checkpoints (checkpoint.py) and resume in both drivers, on
the CPU.

Save and load are bitwise, with the JAX package's per-entry sha256
digests; a flipped byte is caught; ``restore_latest`` falls back past a
damaged newest generation and names it; the refusals (layout, sketch,
shapes, fields the port does not run) hold unless ``--resume_unverified``
waives them. A checkpoint written by the JAX package's ``save_state``
loads into the port bit for bit, and a round from it matches the JAX
package's round from the same file within tests/test_torch_modes.py's
tolerances. An uninterrupted run ends bit for bit where its interrupted
and resumed twin ends: ``cv_train`` in sketch mode and in ``local_topk``
(client rows, byte accounting) and ``gpt2_train --test``.
"""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modes import (NUM_CLIENTS, SKETCH, W,  # noqa: E402
                              port_runtime, ref_runtime, round_inputs)
from test_torch_round import CH  # noqa: E402

from commefficient_tpu import checkpoint as j_ckpt  # noqa: E402

from commefficient_torch import cv_train, gpt2_train  # noqa: E402
from commefficient_torch.checkpoint import (  # noqa: E402
    DEFAULT_MAX_HOST_BYTES, CheckpointIntegrityError, CheckpointManager,
    entry_digest, layout_fingerprint, load_meta, load_state, save_state,
    setup_checkpointing, sketch_generation)
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core import driver  # noqa: E402
from commefficient_torch.core.state import FedState  # noqa: E402
from commefficient_torch.models.resnet9 import ResNet9  # noqa: E402
from commefficient_torch.utils.schedules import lr_schedule_for  # noqa


@pytest.fixture(autouse=True)
def _runs_under_tmp(tmp_path, monkeypatch):
    """The entry points' default run directory (``runs/<stamp>_...``, the
    telemetry stream) lands under the test's tmp dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


LOCAL = dict(mode="local_topk", error_type="local", k=3,
             local_momentum=0.9, lr_scale=0.01)
TOPK_DOWN = dict(SKETCH, do_topk_down=True, k=2)
DENSE = dict(SKETCH, sketch_server_state="dense")


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_state(a: FedState, b: FedState):
    assert a.step == b.step
    for name in ("ps_weights", "Vvelocity", "Verror", "client_velocities",
                 "client_errors", "client_weights", "coord_last_update",
                 "client_last_round", "nan_round", "async_buffer",
                 "async_buffer_n", "defense_ref"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(_bits(x),
                                                         _bits(y)), name


def run_rounds(rt, n=3, state=None):
    state = state if state is not None else rt.init_state()
    for ids, batch, mask in round_inputs(n, ragged=True):
        state, _ = rt.round(state, ids, batch, mask, 0.05)
    return state


@pytest.mark.parametrize("kw", [SKETCH, LOCAL], ids=["sketch", "local_topk"])
def test_save_load_bitwise_with_digests(tmp_path, kw):
    rt = port_runtime(**kw)
    state = run_rounds(rt)
    path = str(tmp_path / "ck")
    assert save_state(path, state, meta={"note": 1}) == path + ".npz"
    meta = load_meta(path)
    assert meta["note"] == 1
    with np.load(path + ".npz") as z:
        assert set(z.files) == set(meta["digests"])
        for name in z.files:
            arr = z[name]
            assert arr.dtype in (np.float32, np.int32), name
            # the same digest as the JAX package's
            assert meta["digests"][name] == entry_digest(arr) == \
                j_ckpt._entry_digest(arr)
        assert z["step"].shape == () and int(z["step"]) == 3
    loaded = load_state(path, "cpu", meta["digests"], rt.state_shapes())
    assert_same_state(state, loaded)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with pytest.raises(ValueError, match="host-copy guard"):
        save_state(path, state, max_host_bytes=16)
    assert DEFAULT_MAX_HOST_BYTES == 8 << 30


def _flip_byte_in(path: str, name: str):
    """Flips one byte of entry ``name``'s data in an uncompressed npz."""
    import zipfile
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(name + ".npy")
    # the local header is 30 bytes, the name and the extra field; the
    # entry's last bytes are array data
    end = (info.header_offset + 30 + len(info.filename) + len(info.extra)
           + info.compress_size)
    with open(path, "r+b") as f:
        f.seek(end - 5)
        byte = f.read(1)
        f.seek(end - 5)
        f.write(bytes([byte[0] ^ 0x10]))


def test_flipped_byte_and_rewritten_entry_are_caught(tmp_path):
    rt = port_runtime(**SKETCH)
    state = run_rounds(rt)
    path = str(tmp_path / "ck")
    save_state(path, state)
    digests = load_meta(path)["digests"]
    _flip_byte_in(path + ".npz", "ps_weights")
    with pytest.raises(CheckpointIntegrityError, match="ps_weights"):
        load_state(path, "cpu", digests)
    # a rewritten entry with a valid zip CRC fails its sha256 digest
    save_state(path, state)
    digests = load_meta(path)["digests"]
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["Verror"] = arrays["Verror"].copy()
    arrays["Verror"][0, 0] += 1.0
    np.savez(path + ".npz", **arrays)
    with pytest.raises(CheckpointIntegrityError, match="sha256 digest"):
        load_state(path, "cpu", digests)


def test_restore_latest_falls_back_past_a_damaged_generation(tmp_path,
                                                             capsys):
    rt = port_runtime(**SKETCH)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=3)
    states = {}
    state = rt.init_state()
    for epoch in (1, 2, 3):
        state = run_rounds(rt, 1, state)
        states[epoch] = state
        mgr.save(state, epoch, meta={"global_round": epoch})
    assert [s for _, s in mgr.generations()] == \
        ["ckpt_000001", "ckpt_000002", "ckpt_000003"]
    with open(mgr.path(3) + ".npz", "r+b") as f:
        f.truncate(200)
    restored, meta = mgr.restore_latest("cpu",
                                        expect_shapes=rt.state_shapes())
    assert meta["epoch"] == 2 and meta["global_round"] == 2
    assert_same_state(restored, states[2])
    assert [fb["path"] for fb in mgr.restore_fallbacks] == [mgr.path(3)]
    err = capsys.readouterr().err
    assert f"WARNING: checkpoint {mgr.path(3)} is unreadable" in err
    # a damaged meta sidecar is a damaged generation too
    with open(mgr.path(2) + ".meta.json", "w") as f:
        f.write("{not json")
    restored, meta = mgr.restore_latest("cpu")
    assert meta["epoch"] == 1 and len(mgr.restore_fallbacks) == 2
    _flip_byte_in(mgr.path(1) + ".npz", "Verror")
    with pytest.raises(CheckpointIntegrityError, match="every checkpoint"):
        mgr.restore_latest("cpu")
    assert CheckpointManager(str(tmp_path / "none")).restore_latest() == \
        (None, {})


@pytest.mark.parametrize("how", ["meta_deleted", "write_cut"])
def test_generation_without_its_meta_is_passed_over(tmp_path, monkeypatch,
                                                    capsys, how):
    """A newest npz whose meta is gone is damaged, and a save cut between
    its two files leaves no newest npz: either way the restore is the
    generation before, with its epoch and global round."""
    from commefficient_torch import checkpoint as ckpt
    rt = port_runtime(**SKETCH)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    states, state = {}, rt.init_state()
    for epoch in (1, 2):
        state = run_rounds(rt, 1, state)
        states[epoch] = state
        if epoch == 2 and how == "write_cut":
            write, calls = ckpt._atomic_write, []

            def cut(path, fn):
                calls.append(path)
                if len(calls) == 2:
                    raise KeyboardInterrupt("killed between the two files")
                write(path, fn)

            monkeypatch.setattr(ckpt, "_atomic_write", cut)
            with pytest.raises(KeyboardInterrupt):
                mgr.save(state, epoch, meta={"global_round": epoch})
            assert calls == [mgr.path(2) + ".meta.json",
                             mgr.path(2) + ".npz"]
        else:
            mgr.save(state, epoch, meta={"global_round": epoch})
    if how == "meta_deleted":
        os.unlink(mgr.path(2) + ".meta.json")
    restored, meta = mgr.restore_latest("cpu",
                                        expect_shapes=rt.state_shapes())
    assert meta["epoch"] == 1 and meta["global_round"] == 1
    assert_same_state(restored, states[1])
    if how == "meta_deleted":
        assert [fb["path"] for fb in mgr.restore_fallbacks] == [mgr.path(2)]
        assert "has no ckpt_000002.meta.json" in capsys.readouterr().err
    else:
        assert [s for _, s in mgr.generations()] == ["ckpt_000001"]
        assert mgr.restore_fallbacks == []


def test_stale_tmp_removed_and_rotation_keeps_last(tmp_path, capsys):
    rt = port_runtime()
    directory = tmp_path / "ck"
    directory.mkdir()
    (directory / "ckpt_000001.npz.abc.tmp").write_bytes(b"half a write")
    mgr = CheckpointManager(str(directory), keep_last=2)
    state = rt.init_state()
    for epoch in range(1, 5):
        mgr.save(state, epoch)
    assert sorted(os.listdir(directory)) == [
        "ckpt_000003.meta.json", "ckpt_000003.npz",
        "ckpt_000004.meta.json", "ckpt_000004.npz"]
    assert "removed 1 stale .tmp" in capsys.readouterr().err


def test_refusals_and_resume_unverified(tmp_path):
    rt = port_runtime(**SKETCH)
    cfg = rt.cfg
    state = run_rounds(rt)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    gen = sketch_generation(cfg)
    assert gen == "circ-v1-3x5-42"
    assert sketch_generation(FedConfig(num_cols=500_736)) == \
        "circ-aligned1024-5x500736-42"
    assert sketch_generation(FedConfig(mode="true_topk")) is None
    mgr.default_meta = {"torch_layout": "aaaa", "sketch_gen": gen}
    mgr.save(state, 1)
    shapes = rt.state_shapes()
    with pytest.raises(ValueError, match="another parameter layout"):
        mgr.restore_latest(expect_layout="bbbb", expect_sketch_gen=gen)
    with pytest.raises(ValueError, match="sketch generation"):
        mgr.restore_latest(expect_layout="aaaa",
                           expect_sketch_gen="circ-v1-3x5-43")
    for kw in (dict(expect_layout="bbbb", expect_sketch_gen=gen),
               dict(expect_layout="aaaa",
                    expect_sketch_gen="circ-v1-3x5-43")):
        restored, _ = mgr.restore_latest(expect_shapes=shapes,
                                         unverified=True, **kw)
        assert_same_state(restored, state)
    with pytest.raises(ValueError, match="dense"):
        mgr.default_meta = {"sketch_gen": gen + "-densestate"}
        mgr.save(state, 2)
        mgr.restore_latest(expect_sketch_gen=gen, unverified=True)
    other = port_runtime(**dict(SKETCH, num_cols=6))
    with pytest.raises(ValueError, match="'Vvelocity' has shape"):
        CheckpointManager(str(tmp_path / "ck")).restore_latest(
            expect_shapes=other.state_shapes())
    # the JAX package's normclip ring loads (the port runs it now), under
    # a normclip run's shapes too
    path = str(tmp_path / "foreign")
    save_state(path, state)
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    ring = np.array([0.5, np.nan, 1.25, np.nan], np.float32)
    np.savez(path + ".npz", defense_ref=ring, **arrays)
    normclip = port_runtime(**dict(SKETCH, defense="normclip",
                                   defense_window=4))
    loaded = load_state(path, expect_shapes=normclip.state_shapes())
    assert loaded.defense_ref.numpy().tobytes() == ring.tobytes()
    # a preempt generation inside an epoch resumes at its round
    CheckpointManager(str(tmp_path / "ck")).save(
        state, 5, meta={"global_round": 12}, round_in_epoch=2,
        tag="preempt")
    assert os.path.exists(str(tmp_path / "ck" / "ckpt_000005_r000002_"
                              "preempt.npz"))
    restored, meta = CheckpointManager(str(tmp_path / "ck")).restore_latest(
        expect_shapes=shapes)
    assert (meta["epoch"], meta["round_in_epoch"], meta["tag"],
            meta["global_round"]) == (5, 2, "preempt", 12)
    assert_same_state(restored, state)


@pytest.mark.parametrize("kw", [TOPK_DOWN, DENSE],
                         ids=["client_weights", "dense_state"])
def test_state_saves_restores_bitwise_and_resumes(tmp_path, kw):
    """A run with per-client download weights, and one with the dense
    server state: saved after 3 rounds, restored bit for bit under the
    run's shapes and marker, and a fourth round from the restored state
    equals the uninterrupted run's fourth round bit for bit."""
    rt = port_runtime(**kw)
    state = run_rounds(rt)
    gen = sketch_generation(rt.cfg)
    assert gen.endswith("-densestate") == (kw is DENSE)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.default_meta = {"sketch_gen": gen}
    mgr.save(state, 1)
    restored, _ = mgr.restore_latest(expect_shapes=rt.state_shapes(),
                                     expect_sketch_gen=gen)
    assert_same_state(restored, state)
    ids, batch, mask = round_inputs(4, ragged=True)[3]
    want, _ = rt.round(state, ids, batch, mask, 0.05)
    got, _ = rt.round(restored, ids, batch, mask, 0.05)
    assert_same_state(got, want)


def test_hash_generation_refused_in_a_circ_run(tmp_path):
    """The tables of a hash sketch decode as garbage under the circulant
    one: refused unless --resume_unverified, which then zeroes them."""
    rt = port_runtime(**dict(SKETCH, sketch_impl="hash"))
    state = run_rounds(rt)
    assert sketch_generation(rt.cfg) == "hash-v1-3x5-42"
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.default_meta = {"sketch_gen": sketch_generation(rt.cfg)}
    mgr.save(state, 1, meta={"global_round": 3})
    circ = port_runtime(**SKETCH, checkpoint_path=str(tmp_path),
                        do_resume=True)
    assert sketch_generation(circ.cfg) == "circ-v1-3x5-42"
    with pytest.raises(ValueError, match="'hash-v1-3x5-42' does not match"):
        setup_checkpointing(circ.cfg, circ, "ck")
    circ = port_runtime(**SKETCH, checkpoint_path=str(tmp_path),
                        do_resume=True, resume_unverified=True)
    _, _, restored, _ = setup_checkpointing(circ.cfg, circ, "ck")
    assert torch.equal(restored.ps_weights, state.ps_weights)
    assert not restored.Verror.any()


def test_resume_unverified_under_another_sketch_zeroes_tables(tmp_path,
                                                              capsys):
    """The driver wiring: another sketch seed with --resume_unverified
    keeps the weights and zeroes the momentum and error tables."""
    rt = port_runtime(**SKETCH, checkpoint_path=str(tmp_path),
                      checkpoint_every=1)
    state = run_rounds(rt)
    mgr, start, restored, rnd = setup_checkpointing(rt.cfg, rt, "Toy")
    assert restored is None and start == 0 and rnd == 0
    mgr.save(state, 2, meta={"global_round": 3})
    other = port_runtime(**SKETCH, checkpoint_path=str(tmp_path),
                         do_resume=True, sketch_seed=7)
    with pytest.raises(ValueError, match="sketch generation"):
        setup_checkpointing(other.cfg, other, "Toy")
    other = port_runtime(**SKETCH, checkpoint_path=str(tmp_path),
                         do_resume=True, resume_unverified=True,
                         sketch_seed=7)
    _, start, restored, rnd = setup_checkpointing(other.cfg, other, "Toy")
    assert (start, rnd) == (2, 3)
    assert torch.equal(restored.ps_weights, state.ps_weights)
    assert not restored.Vvelocity.any() and not restored.Verror.any()
    assert "tables RESET" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [SKETCH, LOCAL, TOPK_DOWN, DENSE],
                         ids=["sketch", "local_topk", "topk_down",
                              "dense_state"])
def test_jax_checkpoint_loads_and_its_round_matches(tmp_path, kw):
    """The JAX package writes a checkpoint after 3 rounds; the port loads
    it bit for bit (``rng`` skipped), through ``restore_latest`` with no
    layout fingerprint in the meta (held to d and the field shapes), and
    a round from it equals the JAX package's round from the same file:
    also with ``client_weights`` (``--topk_down``) and with the dense
    server state's (d,) momentum and error (``-densestate``)."""
    jrt, trt = ref_runtime(**kw), port_runtime(**kw)
    js = jrt.init_state()
    inputs = round_inputs(4, ragged=True)

    def j_round(state, ids, batch, mask):
        return jrt.round(state, jnp.asarray(ids.astype(np.int32)),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.asarray(mask), 0.05)

    for ids, batch, mask in inputs[:3]:
        js, _ = j_round(js, ids, batch, mask)
    jmgr = j_ckpt.CheckpointManager(str(tmp_path / "ck"))
    jmgr.default_meta = {"params_fingerprint": "f" * 16,
                         "sketch_gen": sketch_generation(trt.cfg)}
    jmgr.save(js, 1, meta={"global_round": 3})
    mgr = CheckpointManager(str(tmp_path / "ck"))
    ts, meta = mgr.restore_latest(
        "cpu", expect_layout=layout_fingerprint([("x", (7,))]),
        expect_shapes=trt.state_shapes(),
        expect_sketch_gen=sketch_generation(trt.cfg))
    assert meta["global_round"] == 3 and "torch_layout" not in meta
    for name in ("ps_weights", "Vvelocity", "Verror", "client_velocities",
                 "client_errors", "client_weights", "coord_last_update",
                 "client_last_round", "nan_round", "async_buffer",
                 "async_buffer_n", "defense_ref"):
        want = getattr(js, name)
        got = getattr(ts, name)
        assert (want is None) == (got is None), name
        if want is not None:
            assert np.array_equal(np.asarray(want).view(np.int32),
                                  _bits(got).view(np.int32)), name
    assert ts.step == 3
    j_loaded = j_ckpt.load_state(jmgr._path(1))
    ids, batch, mask = inputs[3]
    js2, jm = j_round(j_loaded, ids, batch, mask)
    ts2, tm = trt.round(ts, ids, batch, mask, 0.05)
    for got, want in zip(tm["results"], jm["results"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(ts2.ps_weights.numpy(),
                               np.asarray(js2.ps_weights), rtol=0, atol=1e-6)
    for key in ("download_bytes", "upload_bytes"):
        assert np.array_equal(tm[key].numpy(), np.asarray(jm[key])), key
    for key in ("coord_last_update", "client_last_round", "nan_round"):
        assert np.array_equal(getattr(ts2, key).numpy(),
                              np.asarray(getattr(js2, key))), key


def test_no_checkpoint_after_a_divergence(tmp_path):
    """A client whose data holds a NaN first trains in epoch 1: epoch 0 is
    checkpointed, the aborted epoch is not."""
    from test_torch_driver import ToyDataset, _first_epoch_of
    client = next(c for c in range(NUM_CLIENTS) if _first_epoch_of(c) == 1)
    trt = port_runtime(num_epochs=3.0)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    state, summary, log = driver.train(
        trt, trt.init_state(), ToyDataset(client), ToyDataset(),
        lr_schedule_for(trt.cfg), ckpt_mgr=mgr, checkpoint_every=1)
    assert summary is None and int(state.nan_round) >= 0
    assert [s for _, s in mgr.generations()] == ["ckpt_000001"]
    restored, meta = mgr.restore_latest()
    assert int(restored.nan_round) == -1 and meta["global_round"] == 2


# ------------------------------------------------------------------ resume


def _write_pickles(root):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for i, fn in enumerate([f"data_batch_{j}" for j in range(1, 6)]
                           + ["test_batch"]):
        r = np.random.RandomState(i)
        with open(os.path.join(d, fn), "wb") as f:
            pickle.dump({b"data": r.randint(0, 256, (20, 3072),
                                            dtype=np.uint8),
                         b"labels": [int(x) for x in
                                     r.randint(0, 10, 20)]}, f)
    return root


def narrow_model(cfg, num_classes):
    return ResNet9(num_classes=num_classes, channels=CH,
                   generator=torch.Generator().manual_seed(cfg.seed))


CV_RESUME = {
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--local_momentum", "0", "--virtual_momentum", "0.9", "--k",
               "200", "--num_cols", "4096"],
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0.9", "--k", "200",
                   "--lr_scale", "0.01"],
}


@pytest.mark.parametrize("mode", sorted(CV_RESUME))
def test_cv_train_resumed_ends_where_uninterrupted_ends(tmp_path,
                                                        monkeypatch, mode):
    """3 epochs in one run, against 1 epoch (stopped by ``--num_rounds``
    at its end) and a ``--resume`` of the rest: the same final state bit
    for bit, the same rows of epochs 2-3, the same bytes; the store's
    augmented draws continue across the resume."""
    monkeypatch.setattr(cv_train, "build_model", narrow_model)
    root = _write_pickles(str(tmp_path / "data"))
    argv = ["--device", "cpu", "--dataset_dir", root, "--num_workers",
            str(W), "--local_batch_size", "8", "--num_epochs", "3",
            "--valid_batch_size", "20", "--compute_dtype", "float32",
            "--checkpoint_every", "1", *CV_RESUME[mode]]
    whole = cv_train.main(argv + ["--checkpoint_path",
                                  str(tmp_path / "a"), "--checkpoint"])
    first_epoch = load_meta(str(tmp_path / "a" / "ResNet9" /
                                "ckpt_000001"))["global_round"]
    ckb = ["--checkpoint_path", str(tmp_path / "b")]
    part = cv_train.main(argv + ckb + ["--num_rounds", str(first_epoch)])
    assert [r["epoch"] for r in part["epochs"]] == [1]
    rest = cv_train.main(argv + ckb + ["--resume"])
    assert [r["epoch"] for r in rest["epochs"]] == [2, 3]
    assert_same_state(whole["state"], rest["state"])
    assert whole["losses"] == part["losses"] + rest["losses"]
    for got, want in zip(rest["epochs"], whole["epochs"][1:]):
        for key in ("train_loss", "train_acc", "test_loss", "test_acc",
                    "lr", "down (MiB)", "up (MiB)"):
            assert got[key] == want[key], key
    assert whole["total_upload_mib"] == pytest.approx(
        part["total_upload_mib"] + rest["total_upload_mib"], rel=1e-12)
    with np.load(str(tmp_path / "a" / "ResNet9.npz")) as z:
        assert np.array_equal(z["ps_weights"],
                              whole["state"].ps_weights.numpy())
    if mode == "local_topk":
        assert whole["state"].client_errors.abs().sum() > 0


def test_gpt2_train_resumed_ends_where_uninterrupted_ends(tmp_path):
    argv = ["--test", "--device", "cpu", "--dataset_dir", str(tmp_path),
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", "2", "--local_batch_size", "2", "--num_cols",
            "4096", "--valid_batch_size", "4", "--checkpoint_every", "1"]
    whole = gpt2_train.main(argv + ["--num_rounds", "3",
                                    "--checkpoint_path",
                                    str(tmp_path / "a")])
    ckb = ["--checkpoint_path", str(tmp_path / "b")]
    gpt2_train.main(argv + ckb + ["--num_rounds", "2"])
    meta = load_meta(str(tmp_path / "b" / "gpt2_doubleheads" /
                         "ckpt_000002"))
    assert meta["global_round"] == 2 and meta["sketch_gen"] == \
        "circ-v1-1x10-42"
    assert json.dumps(meta["summary"])
    rest = gpt2_train.main(argv + ckb + ["--num_rounds", "3", "--resume"])
    assert rest["rounds"] == 1
    assert_same_state(whole["state"], rest["state"])
    assert rest["losses"] == whole["losses"][2:]
