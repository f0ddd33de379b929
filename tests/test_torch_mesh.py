"""The port's clients mesh (``commefficient_torch/parallel/``) on 2 gloo CPU
ranks, against the JAX package's mesh on 2 of the virtual CPU devices
(``tests/test_parallel.py`` with ``make_mesh((2,), ("clients",))``) and
against the port's single-device round (held to the JAX package's
single device by ``tests/test_torch_modes.py``).

One rank group (``spawn_ranks``) runs every case of this file; the JAX
references run in the test process. Held as the JAX package's tests hold
its mesh: the weights to rtol 1e-4 and atol 1e-6 against both the JAX
mesh round and the single-device round, the losses to rtol 1e-5, the
download bytes to allclose, the mesh padding of the weights exactly 0;
the layout, sharded validation (rtol 1e-5), the defaults, normclip
(against the port's single-device round, the same tolerances), trim's
refusal on a mesh and the signals of a recorded mesh round; the dense
client rows' momentum masking and the top-k download on the rows' column
blocks against the port's single device. The same group runs the 2-rank
cases of ``test_torch_sharded_server.py`` (the sharded tail bitwise the
replicated one, near the JAX replicated mesh tail) and of
``test_torch_decode_overlap.py`` (the reduce in the decode, the async
cohort), whose checks those files define. ``test_torch_mesh4.py`` runs
the mode cases, the vector rate and the sharded tail at 4 ranks, where
d = 18 pads to 20.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.parallel import make_mesh as j_make_mesh  # noqa
from test_parallel import make_batch as j_make_batch  # noqa: E402
from test_parallel import make_cfg as j_make_cfg  # noqa: E402
from test_parallel import quad_loss as j_quad_loss  # noqa: E402

from commefficient_torch.parallel import spawn_ranks  # noqa: E402
import test_torch_checkpoint_sharded as ckpt  # noqa: E402
import test_torch_collectives as coll  # noqa: E402
import test_torch_decode_overlap as overlap  # noqa: E402
import test_torch_int8_mesh as int8  # noqa: E402
import test_torch_seq as seq  # noqa: E402
import test_torch_sharded_server as sharded  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

N = 2
# the six mode cases of tests/test_parallel.py:48-61
MODE_CASES = [
    ("uncompressed", {}),
    ("true_topk", {"error_type": "virtual", "k": 5}),
    ("sketch", {"error_type": "virtual", "k": 5, "num_rows": 3,
                "num_cols": 32, "num_blocks": 2, "sketch_impl": "hash"}),
    ("sketch", {"error_type": "virtual", "k": 5, "num_rows": 3,
                "num_cols": 32, "sketch_impl": "rht"}),
    ("local_topk", {"error_type": "local", "k": 5, "local_momentum": 0.9}),
    ("fedavg", {"error_type": "none", "local_batch_size": -1,
                "max_client_batch": 4, "fedavg_batch_size": 2,
                "num_fedavg_epochs": 2}),
]
MODE_IDS = [f"{m}-{e.get('sketch_impl', '')}" for m, e in MODE_CASES]
# the mesh paths the six cases leave out, against the port's single
# device: the momentum masking of dense client rows (true_topk with local
# momentum) and the top-k download on the rows' column blocks
MORE_CASES = [("true_topk", {"error_type": "virtual", "k": 5,
                             "local_momentum": 0.9}),
              ("true_topk", {"error_type": "virtual", "k": 5,
                             "do_topk_down": True}),
              ("uncompressed", {"k": 5, "local_momentum": 0.9,
                                "do_topk_down": True})]
MORE_IDS = ["true_topk-momentum", "true_topk-topk_down",
            "uncompressed-momentum-topk_down"]
PARAMS = np.random.RandomState(0).randn(6, 3).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread in this process for the toy sizes, as in the
    ranks: more only spin on a shared CPU."""
    with ranks.one_thread():
        yield


def inputs(n_rounds=3):
    """The JAX test's one batch, every round, as numpy."""
    batch, mask, ids = j_make_batch(1)
    one = (np.asarray(ids), {k: np.asarray(v) for k, v in batch.items()},
           np.asarray(mask))
    return [one] * n_rounds


def jax_run(mode, extra, mesh_n, n_rounds=3):
    cfg = j_make_cfg(mode=mode, **extra)
    mesh = j_make_mesh((mesh_n,), ("clients",))
    rt = JRuntime(cfg, {"w": jnp.asarray(PARAMS)}, j_quad_loss,
                  num_clients=16, mesh=mesh)
    st = rt.init_state()
    batch, mask, ids = j_make_batch(1)
    losses = []
    for _ in range(n_rounds):
        st, m = rt.round(st, ids, batch, mask, 0.1)
        losses.append(np.asarray(m["results"][0]))
    return {"weights": np.asarray(rt.flat_weights(st)),
            "losses": np.stack(losses),
            "download": np.asarray(m["download_bytes"])}


def val_sets():
    rng = np.random.RandomState(5)
    out = []
    for n_items in (32, 13):  # mesh-divisible and not
        batch = {"x": rng.randn(n_items, 6).astype(np.float32),
                 "y": rng.randn(n_items, 3).astype(np.float32)}
        out.append((batch, rng.rand(n_items) > 0.3))
    return out


def modes_part(with_extras, more=()):
    """The mode cases' part of a mesh file's rank group
    (``torch_mesh_ranks.group_body``)."""
    cases = [dict(mode=m, **e) for m, e in list(MODE_CASES) + list(more)]
    return ranks.modes_body, (cases, PARAMS, inputs(),
                              val_sets() if with_extras else None)


def side_by_side(jobs):
    """Each callable of ``jobs`` on a thread of one pool, their results in
    order: the JAX references compile side by side (XLA's compiles
    release the interpreter)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(4) as pool:
        return [f.result() for f in [pool.submit(job) for job in jobs]]


def jax_refs(n, tmp=None, int8_round: bool = True):
    """The JAX package's references on n virtual devices: its mesh round
    of each mode case and its replicated sketch server tail of each
    sharded-server variant; with ``tmp``, the A9b cases' too (the int8
    reduce, with ``int8_round`` its round, and the sharded file the ranks
    read at their end, written first)."""
    if tmp is not None:
        jax_ckpt = ckpt.write_jax_file(tmp)
    jobs = ([functools.partial(jax_run, m, e, mesh_n=n)
             for m, e in MODE_CASES]
            + [functools.partial(sharded.jax_replicated, n, kw)
               for _, kw in sharded.VARIANTS])
    if tmp is not None:
        jobs.append(functools.partial(int8.jax_int8_reduce, n))
        if int8_round:
            jobs.append(functools.partial(int8.jax_int8_round, n))
    got = side_by_side(jobs)
    k, v = len(MODE_CASES), len(sharded.VARIANTS)
    out = {"modes": got[:k], "sharded": got[k:k + v]}
    if tmp is not None:
        out.update(jax_ckpt=jax_ckpt, int8={"reduce": got[k + v]})
        if int8_round:
            out["int8"]["round"] = got[k + v + 1]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The file's one rank group (the mode cases, the sharded tail's
    variants, the split round's mesh cases, the A9b cases: the int8 wire,
    the ledger, the sharded checkpoint, and the ring over both ranks) and
    the JAX references, computed while the ranks run."""
    refs = {}
    tmp = str(tmp_path_factory.mktemp("mesh2"))

    def references():
        refs.update(jax_refs(N, tmp, int8_round=False))

    res = spawn_ranks(ranks.group_body, N, {
        "modes": modes_part(True, MORE_CASES),
        "sharded": sharded.sharded_part(),
        "overlap": overlap.overlap_part(),
        "a9b": int8.a9b_part(N, tmp, ckpt.jax_file_path(tmp)),
        "ring": (ranks.ring_body, (seq.RING_SHAPES,))},
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


def check_mode_case(res_ranks, i, ref_mesh, ref_single, d=18):
    for res in res_ranks:
        case = res["cases"][i]
        # the mesh pads d = 18 to a multiple of n; the padding stays 0
        assert case["d_pad"] == -(-d // len(res_ranks)) * len(res_ranks)
        np.testing.assert_array_equal(case["ps_padded"][d:], 0.0)
        np.testing.assert_array_equal(case["ps_padded"][:d],
                                      case["weights"])
        for ref in (ref_mesh, ref_single):
            np.testing.assert_allclose(case["weights"], ref["weights"],
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(case["losses"], ref["losses"],
                                       rtol=1e-5)
            np.testing.assert_allclose(case["download"], ref["download"])


def port_single(mode, extra):
    """The port's single-device round (itself held to the JAX package's
    by tests/test_torch_modes.py and test_torch_clip_dp.py)."""
    return ranks.run_rounds(ranks.quad_cfg(mode=mode, **extra), PARAMS,
                            ranks.quad_loss, inputs())[0]


@pytest.mark.parametrize("i", range(len(MODE_CASES)), ids=MODE_IDS)
def test_mesh_round_matches_jax_mesh_and_single_device(group, refs, i):
    check_mode_case(group, i, refs["modes"][i], port_single(*MODE_CASES[i]))


def test_mesh_state_layout(group):
    lay = group[0]["layout"]
    # client count padded to a multiple of the mesh, d = 18 to d_pad
    assert lay["num_clients"] == 10 + (-10) % N and lay["d_pad"] == 18
    sh = lay["shard_of"]
    # dense client rows column-sharded; the dense server state in blocks
    assert sh["client_errors"] == "cols"
    for name in ("ps_weights", "Vvelocity", "Verror", "coord_last_update"):
        assert sh[name] == "dense"
        assert lay["held"][name] == (18 // N,)
    assert lay["held"]["client_errors"] == (lay["num_clients"], 18 // N)
    assert lay["shapes"]["client_errors"] == lay["held"]["client_errors"]


def test_sharded_val_matches_dense(group):
    rt = JRuntime(j_make_cfg(mode="uncompressed"),
                  {"w": jnp.asarray(PARAMS)}, j_quad_loss, num_clients=16)
    st = rt.init_state()
    for (batch, mask), got in zip(val_sets(), group[0]["val"]):
        (loss, acc), cnt = rt.val(st, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                                  jnp.asarray(mask))
        assert float(cnt) == got[2]
        np.testing.assert_allclose(got[:2], [float(loss), float(acc)],
                                   rtol=1e-5)
    for res in group[1:]:
        assert res["val"] == group[0]["val"]


def test_make_mesh_defaults(group):
    for rank, res in enumerate(group):
        size, got_rank, too_big = res["defaults"]
        assert (size, got_rank) == (N, rank)
        assert too_big is not None and f"needs {2 * N} ranks" in too_big


def test_normclip_on_mesh_and_trim_refused(group):
    single, _, _ = ranks.run_rounds(
        ranks.quad_cfg(defense="normclip", adversary="scale",
                       adversary_frac=0.25, telemetry=True),
        PARAMS, ranks.quad_loss, inputs())
    for res in group:
        got = res["normclip"]
        np.testing.assert_allclose(got["weights"], single["weights"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["losses"], single["losses"],
                                   rtol=1e-5)
        assert "--defense trim" in res["trim"]
        assert "normclip" in res["trim"]


@pytest.mark.parametrize("mode", ["uncompressed", "sketch"])
def test_mesh_signals_match_single_device(group, mode):
    kw = ({} if mode == "uncompressed"
          else dict(mode="sketch", error_type="virtual", k=5, num_rows=3,
                    num_cols=32))
    rt = ranks.FedRuntime(ranks.quad_cfg(telemetry=True, **kw),
                          ranks.Flat(PARAMS), ranks.quad_loss, device="cpu")
    st = rt.init_state()
    for ids, batch, mask in inputs():
        st, m = rt.round(st, ids, batch, mask, 0.1)
    for res in group:
        got = res["signals"][mode]
        assert set(got) == set(m["signals"])
        for k, v in m["signals"].items():
            if v is None:
                assert got[k] is None, k
            else:
                np.testing.assert_allclose(got[k], float(v), rtol=1e-4,
                                           atol=1e-6, err_msg=k)


@pytest.mark.parametrize("j", range(len(MORE_CASES)), ids=MORE_IDS)
def test_mesh_row_paths_match_single_device(group, j):
    single = port_single(*MORE_CASES[j])
    check_mode_case(group, len(MODE_CASES) + j, single, single)


# the 2-rank cases of test_torch_sharded_server.py


@pytest.mark.parametrize("v", range(len(sharded.VARIANTS)),
                         ids=sharded.VARIANT_IDS)
def test_sharded_tail_bitwise_replicated_and_near_jax(groups, refs, v):
    sharded.check_variant([g["sharded"] for g in groups], v,
                          refs["sharded"][v])


def test_sharded_tail_per_param_lr_vector_and_refusals(groups):
    sharded.check_lr_vec_and_refusals([g["sharded"] for g in groups])


# the 2-rank cases of test_torch_decode_overlap.py


def test_reduce_in_decode_bitwise_the_sharded_round(groups):
    overlap.check_reduce_in_decode([g["overlap"] for g in groups])


def test_async_cohort_on_a_mesh_bitwise_the_round(groups):
    overlap.check_async_cohort([g["overlap"] for g in groups])


# ------------------------------------------------------------ A9b


def test_int8_reduce_bitwise_jax(groups, refs):
    int8.check_reduce(groups, refs["int8"]["reduce"])


def test_int8_round_monolithic_split(groups):
    int8.check_rounds(groups)


def test_int8_refused_without_the_sharded_tail(groups):
    int8.check_refusal(groups)


@pytest.mark.parametrize("check", ["bounds", "w8_w16", "sharded_kinds",
                                   "int8_bytes", "event"])
def test_collectives_ledger(groups, check):
    getattr(coll, f"check_{check}")(groups)


def test_sharded_checkpoint_written_from_the_ranks(groups):
    ckpt.check_written(groups)


def test_jax_sharded_checkpoint_restores_into_the_ranks(groups, refs):
    ckpt.check_jax_restore(groups, refs["jax_ckpt"])


@pytest.mark.parametrize("j", range(len(seq.RING_SHAPES)))
def test_ring_on_2_ranks_matches_dense(groups, j):
    for r in groups:
        assert max(r["ring"][j]) <= 2e-5, r["ring"][j]
