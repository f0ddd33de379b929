"""The seq mesh axis of the port (``parallel/ring.py``, the seq fields of
``models/gpt2.py`` and ``losses.py``, the runtime's seq round), against
the JAX package's ``tests/test_ring.py`` and ``tests/test_seqparallel.py``.

- Ring attention against dense causal attention at the JAX ring test's
  shapes, (2, 32, 4, 8) and (1, 64, 2, 16), output and dq, dk, dv at its
  tolerance (rtol and atol 2e-5): the single-process form (a rotating
  list of 2, 4 and 8 shards) here, and one shard a rank on 4 gloo ranks;
- on a (2, 2) (clients, seq) mesh of 4 gloo ranks (one rank group, the
  JAX references computed while it runs): the seq-sharded
  ``GPT2Config.small`` round (float32, weight decay 0.01, the JAX seq
  test's configuration and weights) in uncompressed, true_topk and
  sketch modes against the JAX package's dense single-device round,
  losses to rtol 2e-4 / atol 1e-5 and weights to rtol 2e-3 / atol 2e-5
  (the JAX seq test's tolerances); the MC tokens pinned at every shard
  boundary at S = 128 (``:89``), losses and accuracies; one client's
  gradient from its seq shards, summed over the axis, against the dense
  model's (the port writes each seq collective's backward, so no
  over-count is probed); the mesh's layout;
- the JAX package's refusals of a seq axis (``runtime.py:112-139``,
  ``server.py:121-130``, ``losses.py:76-82``);
- under ``slow``, the port's seq round against the JAX package's own seq
  round on a (2, 2) virtual mesh.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.losses import make_gpt2_train_loss as j_loss  # noqa
from commefficient_tpu.models import gpt2 as jgpt2  # noqa: E402
from test_seqparallel import _batch as j_batch  # noqa: E402

from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import validate_seq_combo  # noqa
from commefficient_torch.core.server import validate_defense_combo  # noqa
from commefficient_torch.gpt2_train import PERSONA_SEQ_SPEC  # noqa: E402
from commefficient_torch.losses import make_gpt2_train_loss  # noqa: E402
from commefficient_torch.models import gpt2 as tgpt2  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.parallel import spawn_ranks  # noqa: E402
from commefficient_torch.parallel.ring import ring_attention_shards  # noqa
import torch_mesh_ranks as ranks  # noqa: E402

N = 4
RING_SHAPES = [(2, 32, 4, 8), (1, 64, 2, 16)]
SEQ_CASES = [("uncompressed", {}),
             ("sketch", {"k": 20, "num_rows": 3, "num_cols": 64,
                         "num_blocks": 2}),
             ("true_topk", {"k": 20})]
SEQ_IDS = [m for m, _ in SEQ_CASES]
S_ROUNDS = 32
S_EDGE = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with ranks.one_thread():
        yield


def jax_params():
    """The JAX seq test's weights (its ``_runtimes``)."""
    gcfg = jgpt2.GPT2Config.small(compute_dtype=jnp.float32,
                                  n_positions=128)
    model = jgpt2.GPT2DoubleHeads(gcfg)
    ids = jnp.zeros((1, ranks.GPT2_C, 32), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids,
                        jnp.zeros((1, ranks.GPT2_C), jnp.int32), ids)
    flat = params_from_jax(jax.tree.map(np.asarray, params),
                           tgpt2.GPT2DoubleHeads(ranks.gpt2_small()))
    return model, params, flat.numpy()


def numpy_batch(S, seed):
    return {k: np.asarray(v) for k, v in j_batch(S, seed=seed).items()}


def edge_batch():
    """Each MC token at a first or last position of a shard of 4
    (``tests/test_seqparallel.py:101-106``): every edge of the port's 2
    shards, 0, 63, 64 and 127, among them."""
    b = numpy_batch(S_EDGE, 7)
    edges = np.array([0, 31, 32, 63, 64, 95, 96, 127], np.int32)
    b["mc_token_ids"] = np.resize(edges, b["mc_token_ids"].shape)
    return b


def jax_dense(model, params, mode, extra, batches):
    """The JAX package's dense single-device round of the seq test. Its
    sketch round encodes the clients' summed gradient once
    (``sketch_fused_encode off``: the same sum as the fused encode's, in
    another order; the fused form of this 1,954-block table compiles for
    about 16 s on the CPU, the unfused one for 3)."""
    if mode == "sketch":
        extra = dict(extra, sketch_fused_encode="off")
    cfg = JConfig(mode=mode, local_momentum=0.0, virtual_momentum=0.9,
                  weight_decay=0.01, num_workers=ranks.GPT2_W,
                  local_batch_size=ranks.GPT2_B, num_clients=4,
                  track_bytes=False, num_results_train=2, telemetry=False,
                  error_type=("virtual" if mode in ("sketch", "true_topk")
                              else "none"), **extra)
    rt = JRuntime(cfg, params, j_loss(model), num_clients=4)
    st, res = rt.init_state(), []
    for b in batches:
        st, m = rt.round(st, jnp.arange(ranks.GPT2_W, dtype=jnp.int32),
                         {k: jnp.asarray(v) for k, v in b.items()},
                         jnp.ones((ranks.GPT2_W, ranks.GPT2_B), bool), 0.05)
        res.append((np.asarray(m["results"][0]),
                    np.asarray(m["results"][1])))
    return {"results": res, "weights": np.asarray(rt.flat_weights(st))}


@pytest.fixture(scope="module")
def run():
    model, params, flat = jax_params()
    batches = [numpy_batch(S_ROUNDS, step) for step in range(2)]
    boundary = edge_batch()
    refs = {}

    def references():
        # the four JAX rounds compile side by side (XLA's compiles release
        # the interpreter)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(4) as pool:
            rounds = [pool.submit(jax_dense, model, params, m, e, batches)
                      for m, e in SEQ_CASES]
            edge = pool.submit(jax_dense, model, params, "uncompressed", {},
                               [boundary])
            refs["rounds"] = [f.result() for f in rounds]
            refs["boundary"] = edge.result()

    res = spawn_ranks(ranks.seq_body, N, flat, SEQ_CASES, batches, boundary,
                      RING_SHAPES, meanwhile=references)
    return res, refs


def check_rounds(got, ref):
    for (l_got, a_got), (l_ref, a_ref) in zip(got["results"],
                                              ref["results"]):
        np.testing.assert_allclose(l_got, l_ref, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(a_got, a_ref, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got["weights"], ref["weights"], rtol=2e-3,
                               atol=2e-5)


@pytest.mark.parametrize("i", range(len(SEQ_CASES)), ids=SEQ_IDS)
def test_seq_round_matches_jax_dense_round(run, i):
    res, refs = run
    for r in res:
        check_rounds(r["rounds"][i], refs["rounds"][i])
    for r in res[1:]:
        np.testing.assert_array_equal(r["rounds"][i]["weights"],
                                      res[0]["rounds"][i]["weights"])


def test_seq_shard_boundary_mc_tokens(run):
    res, refs = run
    for r in res:
        check_rounds(r["boundary"], refs["boundary"])


def test_seq_gradient_is_the_dense_gradient(run):
    res, _ = run
    for r in res:
        diff, scale, seq_loss, dense_loss = r["grad"]
        assert scale > 0 and diff <= 1e-5 * scale, (diff, scale)
        np.testing.assert_allclose(seq_loss, dense_loss, rtol=1e-6)


def test_seq_axis_refuses_the_sharded_tail_and_its_int8_wire(run):
    """``runtime.py:298-303``: the table's column shards live on the
    clients axis; so the int8 wire, which needs them, is refused too."""
    res, _ = run
    for r in res:
        on, int8 = r["refusals"]
        assert on is not None and "a seq mesh axis" in on
        assert int8 is not None and "without the sharded server tail" \
            in int8 and "a seq mesh axis" in int8


def test_seq_mesh_layout(run):
    res, _ = run
    for rank, r in enumerate(res):
        shape, c, s, n_c, n_s = r["layout"]
        assert shape == (2, 2) and (n_c, n_s) == (2, 2)
        assert (c, s) == divmod(rank, 2)


@pytest.mark.parametrize("j", range(len(RING_SHAPES)))
def test_ring_on_4_ranks_matches_dense(run, j):
    res, _ = run
    for r in res:
        assert max(r["ring"][j]) <= 2e-5, r["ring"][j]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("shape", RING_SHAPES)
def test_single_process_ring_matches_dense(shape, n):
    B, S, H, D = shape
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4))
    ref = np.asarray(jgpt2.dense_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    full = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    g_ref = torch.autograd.grad(tgpt2.dense_causal_attention(*full), full,
                                torch.tensor(do))
    shards = [[c.clone().requires_grad_() for c in torch.tensor(t).chunk(n, 1)]
              for t in (q, k, v)]
    outs = ring_attention_shards(*shards)
    g = torch.autograd.grad(outs, sum(shards, []),
                            list(torch.tensor(do).chunk(n, 1)))
    np.testing.assert_allclose(torch.cat(outs, 1).detach().numpy(), ref,
                               rtol=2e-5,
                               atol=2e-5)
    for x, gr in enumerate(g_ref):
        got = torch.cat(g[x * n:(x + 1) * n], 1)
        np.testing.assert_allclose(got.numpy(), gr.numpy(), rtol=2e-5,
                                   atol=2e-5)


REFUSALS = [
    (dict(mode="local_topk", error_type="local", local_momentum=0.9),
     "incompatible with a seq mesh axis"),
    (dict(mode="fedavg", error_type="none", local_batch_size=-1),
     "incompatible with a seq mesh axis"),
    (dict(mode="uncompressed", error_type="none", local_momentum=0.0,
          do_topk_down=True, k=5),
     "topk_down / DP / local client state"),
    (dict(mode="uncompressed", error_type="none", local_momentum=0.0,
          do_dp=True),
     "topk_down / DP / local client state"),
    (dict(mode="uncompressed", error_type="none", local_momentum=0.9),
     "topk_down / DP / local client state"),
    (dict(mode="uncompressed", error_type="none", local_momentum=0.0,
          max_grad_norm=1.0),
     "max_grad_norm is unsupported with a seq mesh axis"),
]


@pytest.mark.parametrize("kw,match", REFUSALS)
def test_seq_axis_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        validate_seq_combo(FedConfig(**kw), PERSONA_SEQ_SPEC)


def test_seq_axis_needs_a_seq_spec_and_refuses_the_services():
    with pytest.raises(ValueError, match="no seq_spec was given"):
        validate_seq_combo(FedConfig(mode="uncompressed",
                                     error_type="none",
                                     local_momentum=0.0), {})
    with pytest.raises(ValueError, match="unsupported with a seq mesh"):
        validate_defense_combo(FedConfig(mode="uncompressed",
                                         error_type="none",
                                         defense="normclip"),
                               seq_axis="seq")


def test_lm_chunk_with_a_seq_axis_is_refused():
    class SeqModel:
        seq_axis = object()
    with pytest.raises(ValueError, match="lm_chunk is not supported"):
        make_gpt2_train_loss(SeqModel(), lm_chunk=16)


@pytest.mark.slow
@pytest.mark.parametrize("i", range(len(SEQ_CASES)), ids=SEQ_IDS)
def test_seq_round_matches_jax_seq_round(run, i):
    """The JAX package's own seq round on a (2, 2) virtual mesh."""
    from commefficient_tpu.gpt2_train import PERSONA_SEQ_SPEC as J_SPEC
    from commefficient_tpu.parallel import make_mesh as j_make_mesh
    res, _ = run
    model, params, _ = jax_params()
    mode, extra = SEQ_CASES[i]
    gcfg = jgpt2.GPT2Config.small(compute_dtype=jnp.float32,
                                  n_positions=128)
    seq_model = jgpt2.GPT2DoubleHeads(gcfg, seq_axis="seq", seq_shards=2)
    cfg = JConfig(mode=mode, local_momentum=0.0, virtual_momentum=0.9,
                  weight_decay=0.01, num_workers=ranks.GPT2_W,
                  local_batch_size=ranks.GPT2_B, num_clients=4,
                  track_bytes=False, num_results_train=2, telemetry=False,
                  error_type=("virtual" if mode in ("sketch", "true_topk")
                              else "none"), **extra)
    rt = JRuntime(cfg, params, j_loss(seq_model, seq_axis="seq",
                                      seq_shards=2), num_clients=4,
                  mesh=j_make_mesh((2, 2), ("clients", "seq")),
                  seq_spec=J_SPEC)
    st, out = rt.init_state(), []
    for step in range(2):
        st, m = rt.round(st, jnp.arange(ranks.GPT2_W, dtype=jnp.int32),
                         j_batch(S_ROUNDS, seed=step),
                         jnp.ones((ranks.GPT2_W, ranks.GPT2_B), bool), 0.05)
        out.append((np.asarray(m["results"][0]),
                    np.asarray(m["results"][1])))
    d = rt.cfg.grad_size
    check_rounds(res[0]["rounds"][i],
                 {"results": out,
                  "weights": np.asarray(rt.flat_weights(st))[:d]})
