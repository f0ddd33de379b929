"""The int8 wire on a mesh (``commefficient_torch/ops/wire.py
int8_reduce_scatter`` and its three sites in ``core/runtime.py``), against
the JAX package's (``ops/wire.py:164``, ``runtime.py:999,1033,1272,1781``).

The rank groups of ``test_torch_mesh.py`` (2 ranks) and
``test_torch_mesh4.py`` (4 ranks) run these cases (``a9b_part``), with
the sharded checkpoint's and the ledger's (``test_torch_checkpoint_
sharded.py``, ``test_torch_collectives.py``); the JAX references are
computed while they run. Held here:

- the reduce bitwise the JAX package's ``int8_reduce_scatter`` under
  ``shard_map`` on as many virtual devices, for the same partial (3, 512)
  tables, block 8; each rank's payload ``(q, scale)`` bitwise the JAX
  ``quantize_table`` with salt ``REDUCE_SALT + rank``; the ledger sees its
  two all-to-alls and nothing else;
- the int8 sharded sketch round (r = 3, c = 64, block 8, 4 rounds),
  monolithic and split (``--decode_overlap``, the reduce in the decode),
  bitwise each other on 2 and 4 ranks, and on 4 against the JAX
  package's int8 mesh round of the same configuration on 4 virtual
  devices at the float32 mesh
  round's tolerance (weights rtol 1e-4 / atol 1e-6, losses rtol 1e-5):
  the clients' float32 gradients add in another order in the two
  packages, and the weights come out 1 to 2 ulps apart (1.5e-8 on
  weights of 0.1); no quantized cell flips, which would move a weight by
  a whole wire step;
- the JAX refusal of int8 on a mesh without the sharded tail, naming the
  tail's blockers (``runtime.py:356-372``), and the wire block cut to the
  per-rank column shard.
"""

import numpy as np

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.ops import wire as jwire  # noqa: E402
from commefficient_tpu.parallel import make_mesh as j_make_mesh  # noqa
from commefficient_tpu.utils.jax_compat import shard_map  # noqa: E402
from test_sharded_server import _params_and_loss, _sketch_cfg  # noqa

import test_torch_sharded_server as sharded  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

R, C, BLOCK = 3, 512, 8


def partials(n):
    return np.random.RandomState(11).randn(n, R, C).astype(np.float32)


def a9b_part(n, ckpt_dir, jax_ckpt):
    """The A9b cases' part of a mesh file's rank group."""
    import test_torch_mesh as base
    ss_params, ss_rounds = sharded.inputs()
    return ranks.a9b_body, (base.PARAMS, base.inputs(), ss_params,
                            ss_rounds, partials(n), ckpt_dir, jax_ckpt)


def jax_int8_reduce(n):
    """The JAX package's reduce on n virtual devices, and each device's
    payload."""
    import jax
    parts = partials(n)
    mesh = JMesh(np.array(jax.devices()[:n]), ("clients",))

    def blk(part, step):
        return jwire.int8_reduce_scatter(part[0], axis="clients",
                                         n_shards=n, block=BLOCK, seed=21,
                                         round_idx=step)

    out = shard_map(blk, mesh=mesh, in_specs=(P("clients", None, None), P()),
                    out_specs=P(None, "clients"), check_vma=False)(
                        jnp.asarray(parts), jnp.int32(5))
    payload = [tuple(np.asarray(a) for a in jwire.quantize_table(
        jnp.asarray(parts[i]), BLOCK, seed=21, round_idx=5,
        salt=jwire.REDUCE_SALT + i)) for i in range(n)]
    return np.asarray(out), payload


def jax_int8_round(n):
    """The JAX package's int8 sharded sketch round on n virtual devices."""
    params, loss_fn, batch_for = _params_and_loss()
    cfg = _sketch_cfg(telemetry=False, **ranks.INT8_KW)
    rt = JRuntime(cfg, params, loss_fn, num_clients=cfg.num_clients,
                  mesh=j_make_mesh((n,), ("clients",)))
    assert rt._sharded_server and rt._int8_wire
    st, losses = rt.init_state(), []
    for g in range(1, sharded.N_ROUNDS + 1):
        st, m = rt.round(st, jnp.arange(8, dtype=jnp.int32),
                         batch_for(8, 4, g), jnp.ones((8, 4), bool), 0.1)
        losses.append(np.asarray(m["results"][0]))
    return np.stack(losses), np.asarray(rt.flat_weights(st))


def jax_refs(n, with_round: bool = True):
    """The reduce on n virtual devices, and (``with_round``) the int8
    round: the round's JAX reference runs at 4 devices alone (its compile
    is most of a rank group's reference time)."""
    out = {"reduce": jax_int8_reduce(n)}
    if with_round:
        out["round"] = jax_int8_round(n)
    return out


def check_reduce(res, ref):
    out, payload = ref
    n = len(res)
    shard = C // n
    for rank, r in enumerate(res):
        q, s, red, led = r["a9b"]["int8_reduce"]
        assert np.array_equal(q, payload[rank][0])
        assert np.array_equal(s.view(np.int32),
                              payload[rank][1].view(np.int32))
        assert np.array_equal(red.view(np.int32),
                              out[:, rank * shard:(rank + 1) * shard]
                              .view(np.int32))
        kinds = [(e["kind"], e["dtype"], e["n_elements"]) for e in led]
        assert kinds == [("all-to-all", "s8", R * C),
                         ("all-to-all", "f32", R * C // BLOCK)]


def check_rounds(res, ref=None):
    """The monolithic and split int8 rounds bitwise each other, and
    against the JAX package's round ``ref`` when given."""
    for r in res:
        mono, split, sharded_on, in_decode, block = r["a9b"]["int8_rounds"]
        assert sharded_on and in_decode and block == BLOCK
        assert np.isfinite(mono["losses"]).all()
        assert np.array_equal(mono["losses"], split["losses"])
        assert np.array_equal(mono["weights"], split["weights"])
        if ref is not None:
            losses_j, w_j = ref
            np.testing.assert_allclose(mono["losses"], losses_j, rtol=1e-5)
            np.testing.assert_allclose(mono["weights"], w_j, rtol=1e-4,
                                       atol=1e-6)


def check_refusal(res):
    for r in res:
        msg = r["a9b"]["int8_refusal"]
        assert msg is not None
        assert "a mesh without the sharded server tail" in msg
        assert "(disabled by flag)" in msg


class _OneRank:
    """A mesh of one rank (its all_to_all hands the blocks back)."""
    size, rank = 1, 0

    @staticmethod
    def all_to_all(x):
        return x


def test_int8_reduce_on_one_rank_bitwise_jax():
    """At n = 1 the reduce is the rank's own table quantized with its
    reduce salt and dequantize-accumulated: bitwise the JAX package's
    ``quantize_table`` and ``dequantize_accum`` (what its
    ``int8_reduce_scatter`` runs on one device)."""
    import torch
    from commefficient_torch.ops.wire import int8_reduce_scatter
    part = partials(1)[0]
    q, s = jwire.quantize_table(jnp.asarray(part), BLOCK, seed=21,
                                round_idx=5, salt=jwire.REDUCE_SALT)
    out = np.asarray(jwire.dequantize_accum(q[None], s[None], BLOCK))
    got = int8_reduce_scatter(torch.as_tensor(part), _OneRank(), BLOCK,
                              seed=21, round_idx=5).numpy()
    assert np.array_equal(got.view(np.int32), out.view(np.int32))
