"""``cv_train --mesh_shape 2`` on 2 gloo CPU ranks against the same command
in one process: the sketch main path at the ``--test`` size with the
sharded server tail, one epoch with its checkpoint, then ``--resume`` to
the second, in one rank group, as ``torchrun --nproc_per_node 2 -m ...``
would run it (the harness joins the group first). The losses of every
round are held to rtol 1e-5, the final weights to rtol 1e-4 and atol
1e-6 (the ranks' partial sums add in another order than one device's),
the validation to rtol 1e-5 and the byte totals exactly; every rank
reports the same numbers; rank 0 alone writes the telemetry stream and
the checkpoint, whose fields and shapes are the one-process file's.
``test_torch_mesh_gpt2.py`` runs ``gpt2_train`` so.

The same rank group runs the flags lifted on a mesh: ``--wire_dtype
int8 --checkpoint_sharded`` (the sharded tail's int8 reduce, one epoch,
the sharded generation, ``--resume`` to the second epoch bitwise the
straight two-epoch run, and the file in the sharded layout),
``--alert_action abort`` (rank 0's monitor fires at its second round
record: both ranks stop there) and the preemption drain (SIGTERM to rank 1 alone before
round 3: both ranks drain after round 3 and write one preempt
generation)."""

import os

import numpy as np
import pytest

from commefficient_torch import cv_train
from commefficient_torch.parallel import spawn_ranks
import torch_mesh_ranks as ranks

CV = ["--device", "cpu", "--test", "--mode", "sketch", "--error_type",
      "virtual", "--local_momentum", "0", "--num_workers", "2",
      "--local_batch_size", "4", "--synthetic_per_class", "4",
      "--valid_batch_size", "20", "--checkpoint_every", "1"]


def cv_argvs(tmp, data, tag, mesh=()):
    """The first epoch with its checkpoint, then ``--resume`` to the
    second."""
    base = CV + ["--dataset_dir", data, "--checkpoint_path",
                 str(tmp / f"ck_{tag}"), *mesh]
    return (base + ["--num_epochs", "1", "--logdir", str(tmp / f"cv_{tag}")],
            base + ["--num_epochs", "2", "--resume", "--logdir",
                    str(tmp / f"cv_{tag}_resumed")])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_entry")
    single = {}

    def one_process():
        first, resumed = cv_argvs(tmp, str(tmp / "data_one"), "one")
        with ranks.one_thread():
            single["cv"] = ranks.cv_result(cv_train.main(first))
            single["cv_resumed"] = ranks.cv_result(cv_train.main(resumed))

    # the one-process run goes while the ranks run, on one thread as each
    # rank does; each prepares its own directory (the same seeded
    # synthetic set), so neither races the other
    first, resumed = cv_argvs(tmp, str(tmp / "data_mesh"), "mesh",
                              ("--mesh_shape", "2"))
    lifted = lifted_argvs(tmp, str(tmp / "data_mesh"))
    mesh = spawn_ranks(ranks.group_body, 2, {
        "entry": (ranks.cv_entry_body, (first, resumed)),
        "lifted": (ranks.lifted_body, lifted)}, meanwhile=one_process)
    return tmp, single, mesh


def lifted_argvs(tmp, data):
    mesh = ["--mesh_shape", "2", "--dataset_dir", data]
    int8 = CV + mesh + ["--wire_dtype", "int8", "--checkpoint_sharded",
                        "--num_cols", "4096"]
    first = int8 + ["--num_epochs", "1", "--checkpoint_path",
                    str(tmp / "ck_int8"), "--logdir", str(tmp / "int8_1")]
    resumed = int8 + ["--num_epochs", "2", "--resume", "--checkpoint_path",
                      str(tmp / "ck_int8"), "--logdir", str(tmp / "int8_2")]
    straight = int8 + ["--num_epochs", "2", "--checkpoint_path",
                       str(tmp / "ck_int8_straight"), "--logdir",
                       str(tmp / "int8_straight")]
    abort = CV + mesh + ["--alert_action", "abort", "--num_epochs", "1",
                         "--checkpoint_path", str(tmp / "ck_abort"),
                         "--logdir", str(tmp / "abort")]
    drain = CV + mesh + ["--num_epochs", "1", "--checkpoint_path",
                         str(tmp / "ck_drain"), "--logdir", str(tmp / "drain")]
    return (first, resumed, straight), abort, drain


@pytest.mark.parametrize("run", ["cv", "cv_resumed"])
def test_cv_train_on_two_ranks_matches_one_process(runs, run):
    tmp, single, mesh = runs
    want = single[run]
    for res in mesh:
        got = res["entry"][run]
        assert got["n"] == 2 and got["sharded"]
        assert len(got["losses"]) == len(want["losses"]) > 0
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["weights"], want["weights"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["val"], want["val"], rtol=1e-5)
        assert got["bytes"] == want["bytes"]
    assert np.array_equal(mesh[0]["entry"][run]["weights"],
                          mesh[1]["entry"][run]["weights"])
    # rank 0 alone writes the stream
    logdir = {"cv": "cv_mesh", "cv_resumed": "cv_mesh_resumed"}[run]
    assert os.listdir(tmp / logdir) == ["telemetry.jsonl"]


def test_mesh_checkpoint_is_the_single_device_file(runs):
    """Rank 0 writes the gathered state in the single-device format: the
    same fields and shapes as the one-process run's file, the same
    numbers to the round's tolerance."""
    from commefficient_torch.checkpoint import load_arrays
    tmp = runs[0]
    files = {}
    for tag in ("one", "mesh"):
        d = tmp / f"ck_{tag}" / "ResNet9"
        gens = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
        assert gens, tag
        files[tag] = load_arrays(str(d / gens[-1])[:-4])
    one, mesh = files["one"], files["mesh"]
    assert set(one) == set(mesh)
    for key in one:
        assert one[key].shape == mesh[key].shape, key
        if one[key].dtype.kind == "f":
            np.testing.assert_allclose(mesh[key], one[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)
        else:
            assert np.array_equal(mesh[key], one[key]), key


def test_int8_wire_and_sharded_checkpoint_on_two_ranks(runs):
    tmp, _, mesh = runs
    for res in mesh:
        first, resumed, straight = res["lifted"]["int8"]
        assert first["n"] == 2 and first["sharded"]
        assert np.isfinite(resumed["losses"]).all()
        # the resumed second epoch is the straight run's, bit for bit
        assert np.array_equal(resumed["weights"], straight["weights"])
        assert np.array_equal(resumed["losses"],
                              straight["losses"][len(first["losses"]):])
    d = tmp / "ck_int8" / "ResNet9"
    gens = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    with np.load(d / gens[0]) as z:
        assert "__sharded__" in z.files
        assert "ps_weights__shard1" in z.files


def test_alert_abort_stops_every_rank_at_one_round(runs):
    """Rank 0's monitor fires at its second round record; both ranks stop
    there, each with the first round's time alone (the aborting round is
    not counted)."""
    _, _, mesh = runs
    assert [res["lifted"]["abort"] for res in mesh] == [(1, True)] * 2


def test_preemption_drain_agreed_across_ranks(runs):
    tmp, _, mesh = runs
    assert [res["lifted"]["drain"] for res in mesh] == [(3, True, True)] * 2
    gens = [f for f in os.listdir(tmp / "ck_drain" / "ResNet9")
            if f.endswith(".npz")]
    assert gens == ["ckpt_000000_r000003_preempt.npz"]
