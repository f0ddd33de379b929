"""``gpt2_train --mesh_shape 2`` (one round of the ``--test`` GPT-2) on 2
gloo CPU ranks against the same command in one process, in one rank
group: the round's losses to rtol 1e-5, the weights to rtol 1e-4 and
atol 1e-6 (the ranks' partial sums add in another order), the MC
accuracy to rtol 1e-5 and the validation NLL to 1e-3 (the ranks'
per-token NLL means recombine weighted by their dialogues, the JAX
package's sharded validation's approximation, its runtime.py
``_val_step_sharded``)."""

import numpy as np
import pytest

from commefficient_torch import gpt2_train
from commefficient_torch.parallel import spawn_ranks
import torch_mesh_ranks as ranks

GPT2 = ["--test", "--device", "cpu", "--error_type", "virtual",
        "--local_momentum", "0", "--num_workers", "2", "--local_batch_size",
        "2", "--num_cols", "4096", "--valid_batch_size", "4",
        "--num_rounds", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_gpt2")
    single = {}

    def one_process():
        with ranks.one_thread():
            single.update(ranks.gpt2_result(gpt2_train.main(GPT2 + [
                "--dataset_dir", str(tmp / "data_one"),
                "--logdir", str(tmp / "one")])))

    # the one-process run goes while the ranks run, on one thread as each
    # rank does; each prepares its own directory (the same seeded
    # synthetic corpus), so neither races the other
    mesh = spawn_ranks(ranks.gpt2_entry_body, 2, GPT2 + [
        "--dataset_dir", str(tmp / "data_mesh"), "--mesh_shape", "2",
        "--logdir", str(tmp / "mesh")], meanwhile=one_process)
    return single, mesh


def test_gpt2_round_on_two_ranks_matches_one_process(runs):
    single, mesh = runs
    for res in mesh:
        np.testing.assert_allclose(res["losses"], single["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["weights"], single["weights"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(res["val"][0], single["val"][0],
                                   rtol=1e-3)
        np.testing.assert_allclose(res["val"][1], single["val"][1],
                                   rtol=1e-5)
