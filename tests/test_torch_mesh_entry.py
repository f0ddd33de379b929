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
``test_torch_mesh_gpt2.py`` runs ``gpt2_train`` so."""

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
    mesh = spawn_ranks(ranks.cv_entry_body, 2, first, resumed,
                       meanwhile=one_process)
    return tmp, single, mesh


@pytest.mark.parametrize("run", ["cv", "cv_resumed"])
def test_cv_train_on_two_ranks_matches_one_process(runs, run):
    tmp, single, mesh = runs
    want = single[run]
    for res in mesh:
        got = res[run]
        assert got["n"] == 2 and got["sharded"]
        assert len(got["losses"]) == len(want["losses"]) > 0
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["weights"], want["weights"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["val"], want["val"], rtol=1e-5)
        assert got["bytes"] == want["bytes"]
    assert np.array_equal(mesh[0][run]["weights"], mesh[1][run]["weights"])
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
