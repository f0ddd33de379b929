"""The port's sharded sketch server tail (``core/server.py
sharded_sketch_server_update``) and its pieces, against the JAX
package's (``tests/test_sharded_server.py``), on the CPU.

- ``decode_range`` of the circulant and the hash sketch, on the JAX
  package's table, bitwise the JAX full decode's slice at several offsets,
  exactly 0 past d, over 8 shards of d_pad, and on a bf16-rounded table
  (:39-140), on one JAX table a sketch;
- the candidate top-k (``local_topk_candidates``,
  ``merge_topk_candidates``) bitwise the JAX functions and the unsharded
  top-k on the same numpy inputs, ties across shard edges included
  (:148-198);
- on 2 and 4 gloo ranks (in the rank groups of ``test_torch_mesh.py``
  and ``test_torch_mesh4.py``, which hold these checks), the port's
  sharded tail BITWISE its replicated tail for ``{}``, hash, subtract and the bf16
  wire, and under a per-parameter rate vector; each variant against the
  JAX package's REPLICATED mesh tail (``--sketch_sharded_server off``) on
  as many virtual devices, weights to rtol 1e-4 and atol 1e-6 and losses
  to rtol 1e-5 on the float32 wire, 2e-2 and 1e-3 on the bf16 wire (the
  JAX test's bf16 tolerance: the partials add in another order). The JAX
  package's own sharded tail is not the
  reference: on jax 0.9 it departs from its replicated tail for hash and
  bf16;
- the refusals of ``--sketch_sharded_server on`` (:317-340) and auto's
  fallback on a table that does not split.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.ops.circulant import \
    make_circulant_sketch as j_circ  # noqa: E402
from commefficient_tpu.ops.sketch import make_sketch as j_hash  # noqa
from commefficient_tpu.ops.topk import \
    local_topk_candidates as j_local  # noqa: E402
from commefficient_tpu.ops.topk import \
    merge_topk_candidates as j_merge  # noqa: E402
from commefficient_tpu.ops.topk import topk_with_idx as j_topk  # noqa
from commefficient_tpu.parallel import make_mesh as j_make_mesh  # noqa
from test_sharded_server import _params_and_loss, _sketch_cfg  # noqa

from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.ops.circulant import make_circulant_sketch  # noqa
from commefficient_torch.ops.sketch import make_sketch  # noqa: E402
from commefficient_torch.ops.topk import (local_topk_candidates,  # noqa
                                          merge_topk_candidates,
                                          topk_with_idx)
import torch_mesh_ranks as ranks  # noqa: E402


def sketches(impl, d, c=64, r=3):
    """The JAX package's sketch and the port's, same seeds."""
    if impl == "hash":
        return (j_hash(d, c, r, num_blocks=4),
                make_sketch(d, c, r, num_blocks=4, device="cpu"))
    return j_circ(d, c, r), make_circulant_sketch(d, c, r, device="cpu")


D_RANGE = 1000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for this file's toy sizes: more only spin on
    a shared CPU."""
    with ranks.one_thread():
        yield


@functools.lru_cache(maxsize=None)
def jax_table(impl):
    """The JAX package's sketch of a seeded d = 1000 vector (c = 64, r =
    3), the port's sketch, the table (JAX and torch) and the JAX full
    decode, built once a file for every range-decode case."""
    jcs, cs = sketches(impl, D_RANGE)
    v = jnp.asarray(np.random.RandomState(0).randn(D_RANGE), jnp.float32)
    table = jcs.encode(v)
    return (jcs, cs, table, torch.tensor(np.asarray(table)),
            np.asarray(jcs.decode(table)))


# ------------------------------------------------------ range decode


@pytest.mark.parametrize("impl", ["hash", "circ"])
def test_decode_range_matches_full_decode(impl):
    jcs, cs, jt, t, full = jax_table(impl)
    d = D_RANGE
    assert np.array_equal(cs.decode(t).numpy(), full)
    for start, length in ((0, d), (100, 300), (437, 129), (999, 1)):
        got = cs.decode_range(t, start, length).numpy()
        assert np.array_equal(got, full[start:start + length]), (
            impl, start, length)


@pytest.mark.parametrize("impl", ["hash", "circ"])
def test_decode_range_zero_beyond_d(impl):
    jcs, cs, jt, t, full = jax_table(impl)
    d = D_RANGE
    got = cs.decode_range(t, d - 8, 40).numpy()
    assert np.array_equal(got[:8], full[-8:])
    assert (got[8:] == 0).all() and not np.signbit(got[8:]).any()
    # a range wholly past d
    assert (cs.decode_range(t, d + 3, 5).numpy() == 0).all()


@pytest.mark.parametrize("impl", ["hash", "circ"])
def test_decode_range_shards_cover_the_full_decode(impl):
    jcs, cs, jt, t, full = jax_table(impl)
    n = 16                        # d_pad = 1008: 8 padding coordinates
    d_pad = -(-D_RANGE // n) * n
    blk = d_pad // n
    got = np.concatenate([cs.decode_range(t, i * blk, blk).numpy()
                          for i in range(n)])
    assert got.shape == (d_pad,)
    assert np.array_equal(got[:D_RANGE], full)
    assert (got[D_RANGE:] == 0).all()


@pytest.mark.parametrize("impl", ["hash", "circ"])
def test_decode_range_bf16_wire_table(impl):
    jcs, cs, jt, _, _ = jax_table(impl)
    jt = jt.astype(jnp.bfloat16).astype(jnp.float32)
    t = torch.tensor(np.asarray(jt))
    full = np.asarray(jcs.decode(jt))
    assert np.array_equal(cs.decode_range(t, 64, 400).numpy(),
                          full[64:464])


# ------------------------------------------------------- top-k merge


def check_merge(x, k, n):
    """The JAX and the port's candidate stages and merges over n
    contiguous shards of the numpy vector ``x``: bitwise each other, and
    the unsharded top-k."""
    blk = x.shape[0] // n
    parts = [x[i * blk:(i + 1) * blk] for i in range(n)]
    jc = [j_local(jnp.asarray(p), k, i * blk) for i, p in enumerate(parts)]
    tc = [local_topk_candidates(torch.tensor(p), k, i * blk)
          for i, p in enumerate(parts)]
    jcv, jci = (np.stack([np.asarray(c[j]) for c in jc]) for j in (0, 1))
    tcv, tci = (torch.stack([c[j] for c in tc]) for j in (0, 1))
    assert np.array_equal(tcv.numpy(), jcv)
    assert np.array_equal(tci.numpy(), jci)
    jmv, jmi = j_merge(jnp.asarray(jcv), jnp.asarray(jci), k)
    tmv, tmi = merge_topk_candidates(tcv, tci, k)
    assert np.array_equal(tmi.numpy(), np.asarray(jmi))
    assert np.array_equal(tmv.numpy(), np.asarray(jmv))
    _, ref_idx = j_topk(jnp.asarray(x), k)
    _, port_idx = topk_with_idx(torch.tensor(x), k)
    assert np.array_equal(tmi.numpy(), np.asarray(ref_idx))
    assert np.array_equal(tmi, port_idx)


@pytest.mark.parametrize("k,n", [(7, 4), (8, 8), (13, 8), (1, 8)])
def test_merge_matches_jax_and_unsharded_topk(k, n):
    x = np.random.RandomState(k * 31 + n).randn(128).astype(np.float32)
    check_merge(x, k, n)


def test_merge_ties_straddling_shard_boundaries():
    x = np.zeros(128, np.float32)
    x[15], x[16] = 2.0, 2.0          # straddles the 0|1 boundary
    x[31], x[32] = -2.0, 2.0         # a sign flip straddling 1|2
    x[64], x[127] = 2.0, 2.0         # far shards
    x[40] = 5.0                      # one clear winner
    check_merge(x, 6, 8)


def test_merge_k_exceeds_shard_length():
    x = np.random.RandomState(7).randn(64).astype(np.float32)
    check_merge(x, 24, 8)


def test_merge_rejects_insufficient_candidates():
    with pytest.raises(ValueError, match="cannot cover k=8"):
        merge_topk_candidates(torch.zeros(2, 3),
                              torch.zeros(2, 3, dtype=torch.int64), 8)


# ------------------------------------------------- round-level parity

VARIANTS = [({}, {}), ({"sketch_impl": "hash"}, {"sketch_impl": "hash"}),
            ({"sketch_ef": "subtract"}, {"sketch_ef": "subtract"}),
            ({"wire_dtype": "bfloat16"}, {"sketch_dtype": "bfloat16"})]
VARIANT_IDS = ["circ", "hash", "subtract", "bf16"]
N_ROUNDS = 4


def inputs():
    params, _, batch_for = _params_and_loss()
    rounds = []
    for g in range(1, N_ROUNDS + 1):
        b = batch_for(8, 4, g)
        rounds.append((np.arange(8), {"x": np.asarray(b["x"]),
                                      "target": np.asarray(b["target"])},
                       np.ones((8, 4), bool)))
    return np.asarray(params["w"]), rounds


LR_VEC = np.linspace(0.01, 0.2, 240).astype(np.float32)


def sharded_part():
    """The round-level cases' part of a mesh file's rank group
    (``torch_mesh_ranks.group_body``)."""
    params, rounds = inputs()
    return ranks.sharded_body, ([port for port, _ in VARIANTS], params,
                                rounds, LR_VEC)


def jax_replicated(n, jax_kw):
    params, loss_fn, batch_for = _params_and_loss()
    cfg = _sketch_cfg(sketch_sharded_server="off", telemetry=False,
                      **jax_kw)
    rt = JRuntime(cfg, params, loss_fn, num_clients=cfg.num_clients,
                  mesh=j_make_mesh((n,), ("clients",)))
    assert not rt._sharded_server
    st = rt.init_state()
    losses = []
    for g in range(1, N_ROUNDS + 1):
        st, m = rt.round(st, jnp.arange(8, dtype=jnp.int32),
                         batch_for(8, 4, g), jnp.ones((8, 4), bool), 0.1)
        losses.append(np.asarray(m["results"][0]))
    return np.stack(losses), np.asarray(rt.flat_weights(st))


def check_variant(res, v, jax_ref):
    """Variant ``v`` on every rank: the sharded tail bitwise the
    replicated one, against ``jax_ref``, the JAX replicated mesh tail on
    as many devices (``jax_replicated``)."""
    losses_j, w_j = jax_ref
    wide = VARIANT_IDS[v] == "bf16"
    for r in res:
        shard, repl, on, off = r["variants"][v]
        assert on and not off
        assert np.isfinite(shard["losses"]).all()
        assert np.array_equal(shard["losses"], repl["losses"])
        assert np.array_equal(shard["weights"], repl["weights"])
        assert np.array_equal(shard["download"], repl["download"])
        np.testing.assert_allclose(shard["weights"], w_j,
                                   rtol=2e-2 if wide else 1e-4,
                                   atol=1e-3 if wide else 1e-6)
        np.testing.assert_allclose(shard["losses"], losses_j,
                                   rtol=2e-2 if wide else 1e-5)
    # every rank holds the same weights
    for r in res[1:]:
        assert np.array_equal(r["variants"][v][0]["weights"],
                              res[0]["variants"][v][0]["weights"])


def check_lr_vec_and_refusals(res):
    for r in res:
        w_auto, w_off = r["lr_vec"]
        assert np.array_equal(w_auto, w_off)
        assert "--sketch_sharded_server on" in r["on_cols"]
        assert "num_cols=61" in r["on_cols"]
        assert r["auto_fallback"] is False


def test_sharded_server_on_requires_mesh_and_sketch_mode():
    params, _ = inputs()
    with pytest.raises(ValueError, match="no mesh"):
        FedRuntime(ranks.sketch_cfg(sketch_sharded_server="on",
                                    num_workers=2, num_clients=4),
                   ranks.Flat(params), ranks.nll_loss, device="cpu")
    with pytest.raises(ValueError, match="mode sketch"):
        FedConfig(mode="uncompressed", error_type="none",
                  sketch_sharded_server="on")
