"""``--checkpoint_sharded`` (``commefficient_torch/checkpoint.py
save_sharded``, ``restore_own_shards``, ``assemble_sharded``) against the
JAX package's sharded layout (``checkpoint.py:177-262, 296-408``).

On 2 and 4 gloo ranks (the rank groups of ``test_torch_mesh.py`` and
``test_torch_mesh4.py``, which hold these checks):

- a file written from the ranks (a dense-row state and a sharded-tail
  state after two rounds) loads through the JAX package's ``load_state``
  with each rank's block bitwise where its offset says, every shard
  once and a replicated field once; the same ranks read their own shards
  back bitwise;
- a JAX sharded file written on 8 virtual devices (d = 18 padded to 24)
  restores into the ranks (assembled on the host, the padding cut off)
  bitwise the JAX state, and the next round matches the JAX package's
  next round at the mesh test's tolerance.

Here, on one process: the single-device sharded file read back bitwise
by both packages, a corrupted shard refused by its digest, and the plain
save's host-memory guard naming ``--checkpoint_sharded``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from commefficient_tpu import checkpoint as jckpt  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.parallel import make_mesh as j_make_mesh  # noqa
from test_parallel import make_batch as j_make_batch  # noqa: E402
from test_parallel import make_cfg as j_make_cfg  # noqa: E402
from test_parallel import quad_loss as j_quad_loss  # noqa: E402

from commefficient_torch import checkpoint as tckpt  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

ROWS = dict(mode="local_topk", error_type="local", k=5, local_momentum=0.9)


def jax_file_path(directory: str) -> str:
    return os.path.join(directory, "jax_rows8")


def write_jax_file(directory: str):
    """The JAX package's sharded file of the dense-row state after two
    rounds on 8 virtual devices, and its third round's weights."""
    import test_torch_mesh as base
    cfg = j_make_cfg(**ROWS)
    rt = JRuntime(cfg, {"w": jnp.asarray(base.PARAMS)}, j_quad_loss,
                  num_clients=16, mesh=j_make_mesh((8,), ("clients",)))
    st = rt.init_state()
    batch, mask, ids = j_make_batch(1)
    for _ in range(2):
        st, _ = rt.round(st, ids, batch, mask, 0.1)
    path = jax_file_path(directory)
    jckpt.save_state(path, st, {"epoch": 1}, sharded=True)
    fields = {f: np.asarray(getattr(st, f)) for f in
              ("ps_weights", "client_velocities", "client_errors",
               "coord_last_update", "client_last_round", "Vvelocity",
               "Verror")}
    st3, _ = rt.round(st, ids, batch, mask, 0.1)
    return path, fields, np.asarray(rt.flat_weights(st3))


def check_written(res):
    """Each rank's blocks, where the JAX package's reader puts them."""
    n = len(res)
    for name in ("rows", "tables"):
        path = res[0]["a9b"]["saved"][name][0]
        loaded = jckpt.load_state(path, verify_digests=jckpt.load_meta(
            path)["digests"])
        with np.load(path + ".npz") as z:
            assert "__sharded__" in z.files
            for field, kind in res[0]["a9b"]["saved"][name][2].items():
                if kind is None:
                    continue
                n_shards = sum(1 for k in z.files
                               if k.startswith(f"{field}__shard"))
                assert n_shards == (n if kind in ("dense", "cols") else 1)
        for rank, r in enumerate(res):
            _, held, shard_of, d_pad, n_clients, same = r["a9b"]["saved"][
                name]
            assert same
            for field, (kind, arr) in held.items():
                whole = np.asarray(getattr(loaded, field))
                if kind == "dense":
                    blk = whole[rank * arr.shape[0]:(rank + 1)
                                * arr.shape[0]]
                elif kind == "cols":
                    w = arr.shape[-1]
                    blk = whole[..., rank * w:(rank + 1) * w]
                else:
                    blk = whole
                assert blk.dtype == arr.dtype and np.array_equal(
                    np.ascontiguousarray(blk).reshape(-1).view(np.uint8),
                    np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
                ), field


def check_jax_restore(res, jax_ref):
    _, fields, w3 = jax_ref
    for r in res:
        whole, w_next = r["a9b"]["jax_restore"]
        assert whole["ps_weights"].shape == (18,)
        for f, ref in fields.items():
            got = whole[f]
            cut = ref[tuple(slice(0, s) for s in got.shape)]
            assert np.array_equal(got, cut), f
            if f == "ps_weights":
                assert np.all(ref[18:] == 0)
        np.testing.assert_allclose(w_next, w3, rtol=1e-4, atol=1e-6)


# ------------------------------------------------------- one process


def single_device(tmp_path):
    rt = FedRuntime(ranks.quad_cfg(**ROWS), ranks.Flat(
        np.random.RandomState(0).randn(18).astype(np.float32)),
        ranks.quad_loss, device="cpu")
    st = rt.init_state()
    batch, mask, ids = j_make_batch(1)
    st, _ = rt.round(st, np.asarray(ids),
                     {k: np.asarray(v) for k, v in batch.items()},
                     np.asarray(mask), 0.1)
    path = str(tmp_path / "one")
    tckpt.save_sharded(path, st, rt, {"epoch": 1})
    return rt, st, path


def test_single_device_sharded_file_reads_back_in_both_packages(tmp_path):
    rt, st, path = single_device(tmp_path)
    digests = tckpt.load_meta(path)["digests"]
    own = tckpt.restore_own_shards(path, rt, digests)
    host = tckpt.load_state(path, "cpu", digests, rt.full_state_shapes())
    jax_st = jckpt.load_state(path, verify_digests=digests)
    for f in tckpt.FIELDS:
        ref = getattr(st, f)
        if ref is None:
            continue
        if f == "step":
            assert own.step == host.step == int(jax_st.step) == ref
            continue
        for got in (getattr(own, f), getattr(host, f),
                    torch.from_numpy(np.asarray(getattr(jax_st, f)))):
            assert torch.equal(got, ref), f


def test_corrupted_shard_is_refused_by_its_digest(tmp_path):
    rt, _, path = single_device(tmp_path)
    digests = tckpt.load_meta(path)["digests"]
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["client_errors__shard0"] = arrays["client_errors__shard0"].copy()
    arrays["client_errors__shard0"].flat[3] += 1.0
    np.savez(path + ".npz", **arrays)
    with pytest.raises(tckpt.CheckpointIntegrityError,
                       match="client_errors__shard0"):
        tckpt.restore_own_shards(path, rt, digests)
    with pytest.raises(tckpt.CheckpointIntegrityError,
                       match="client_errors__shard0"):
        tckpt.load_state(path, "cpu", digests, rt.full_state_shapes())


def test_plain_save_guard_names_the_sharded_flag(tmp_path):
    rt, st, _ = single_device(tmp_path)
    with pytest.raises(ValueError, match="--checkpoint_sharded"):
        tckpt.save_state(str(tmp_path / "plain"), st, max_host_bytes=16)


def test_manager_writes_sharded_generations(tmp_path):
    """``CheckpointManager`` under the flag: the generation is sharded and
    its meta carries every entry's digest; the newest restores."""
    rt, st, _ = single_device(tmp_path)
    mgr = tckpt.CheckpointManager(str(tmp_path / "gen"))
    mgr.sharded, mgr.runtime = True, rt
    out = mgr.save(st, 1, meta={"global_round": 1})
    with np.load(out) as z:
        names = set(z.files)
    meta = json.load(open(out[:-len(".npz")] + ".meta.json"))
    assert "__sharded__" in names and set(meta["digests"]) == names
    back, meta = mgr.restore_latest("cpu",
                                    expect_shapes=rt.full_state_shapes())
    assert mgr.restored_local and meta["global_round"] == 1
    assert torch.equal(back.client_errors, st.client_errors)
