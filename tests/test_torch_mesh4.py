"""The six mode cases of ``test_torch_mesh.py`` on 4 gloo CPU ranks:
against the JAX package's mesh on 4 of the virtual CPU devices and
against the port's single-device round (itself held to the JAX
package's by tests/test_torch_modes.py), at the JAX test's tolerances
(weights rtol 1e-4 and atol 1e-6, losses rtol 1e-5, download bytes
allclose, the padding d = 18 -> 20 exactly 0), and the vector rate on a
mesh whose d does not divide (tests/test_parallel.py:355, :376: rtol
1e-5 against the scalar rate). The same rank group runs
``test_torch_sharded_server.py``'s round-level cases at 4 ranks: the
port's sharded sketch server tail bitwise its replicated tail for
``{}``, hash, subtract and the bf16 wire and under a per-parameter rate
vector, each variant against the JAX package's replicated mesh tail on 4
virtual devices at that file's tolerances, and the ``on`` refusal and
auto's fallback."""

import numpy as np
import pytest

import test_torch_checkpoint_sharded as ckpt  # noqa: E402
import test_torch_collectives as coll  # noqa: E402
import test_torch_int8_mesh as int8  # noqa: E402
import test_torch_mesh as base  # noqa: E402
import test_torch_sharded_server as sharded  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402
from commefficient_torch.parallel import spawn_ranks  # noqa: E402

N = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The file's one rank group and the JAX references, computed while
    the ranks run."""
    refs = {}
    tmp = str(tmp_path_factory.mktemp("mesh4"))

    def references():
        refs.update(base.jax_refs(N, tmp))

    res = spawn_ranks(ranks.group_body, N, {
        "modes": base.modes_part(False), "sharded": sharded.sharded_part(),
        "a9b": int8.a9b_part(N, tmp, ckpt.jax_file_path(tmp))},
        meanwhile=references)
    return res, refs


@pytest.fixture(scope="module")
def groups(run):
    return run[0]


@pytest.fixture(scope="module")
def refs(run):
    return run[1]


@pytest.fixture(scope="module")
def group(groups):
    return [g["modes"] for g in groups]


@pytest.mark.parametrize("i", range(len(base.MODE_CASES)),
                         ids=base.MODE_IDS)
def test_mesh4_round_matches_jax_mesh_and_single_device(group, refs, i):
    assert group[0]["cases"][i]["d_pad"] == 20
    base.check_mode_case(group, i, refs["modes"][i],
                         base.port_single(*base.MODE_CASES[i]))


@pytest.mark.parametrize("mode", ["fedavg", "sketch"])
def test_vector_lr_on_mesh(group, mode):
    for res in group:
        w_vec, w_ref, padded = res["vector_lr"][mode]
        assert padded
        np.testing.assert_allclose(w_vec, w_ref, rtol=1e-5)


@pytest.mark.parametrize("v", range(len(sharded.VARIANTS)),
                         ids=sharded.VARIANT_IDS)
def test_sharded_tail4_bitwise_replicated_and_near_jax(groups, refs, v):
    sharded.check_variant([g["sharded"] for g in groups], v,
                          refs["sharded"][v])


def test_sharded_tail4_per_param_lr_vector_and_refusals(groups):
    sharded.check_lr_vec_and_refusals([g["sharded"] for g in groups])


def test_int8_reduce4_bitwise_jax(groups, refs):
    int8.check_reduce(groups, refs["int8"]["reduce"])


def test_int8_round4_monolithic_split_and_jax(groups, refs):
    int8.check_rounds(groups, refs["int8"]["round"])


@pytest.mark.parametrize("check", ["bounds", "w8_w16", "sharded_kinds",
                                   "int8_bytes", "event"])
def test_collectives_ledger4(groups, check):
    getattr(coll, f"check_{check}")(groups)


def test_sharded_checkpoint_written_from_4_ranks(groups):
    ckpt.check_written(groups)


def test_jax_sharded_checkpoint_restores_into_4_ranks(groups, refs):
    ckpt.check_jax_restore(groups, refs["jax_ckpt"])
