"""StreamMLP and the streaming encode (models/stream_mlp.py, the fused
client step's ``streaming_grad`` hook, K1's range form) against the JAX
package, on the CPU.

- StreamMLP's parameters from the JAX package's tree bit for bit, its
  loss and accuracy to rtol 1e-6.
- ``streaming_grad``'s table against the JAX package's ``streaming_grad``
  and against ``encode(scale * autograd gradient)``: within 1e-5 of the
  table's largest cell (the same sums in another float order: sketch
  linearity).
- The range ``encode_accum`` against the JAX package's at unaligned
  starts: within 1e-6 of the largest cell; the whole range bitwise the
  whole-vector call.
- The port's fused table (one K1 over the flat gradient) against the JAX
  package's chunked ``encode_grad_tree`` over several ranges: within
  1e-5 of the largest cell.
- A StreamMLP FedRuntime round against the JAX package's: losses rtol
  1e-5, weights atol 1e-6, and 2L + 2 range encodes a microbatch.
- K1's range form bitwise its plain version on the card (``cuda``; it
  skips here).

The JAX package is imported by the ``J`` fixture, so the ``cuda`` test
also runs where only PyTorch is installed.
"""

import types

import numpy as np
import pytest
import torch

from commefficient_torch.config import FedConfig
from commefficient_torch.core import client as client_lib
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.models.stream_mlp import (StreamMLP,
                                                   init_stream_mlp,
                                                   make_stream_mlp_loss)
from commefficient_torch.ops import circulant_kernels as kernels
from commefficient_torch.ops.circulant import make_circulant_sketch
from commefficient_torch.ops.sketch import make_sketch

D_IN, H, L, C = 16, 32, 3, 5
B = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules, imported on first use (the test skips
    where they do not import)."""
    try:
        import jax
        import jax.numpy as jnp
        from jax.flatten_util import ravel_pytree

        from commefficient_tpu.config import FedConfig as JConfig
        from commefficient_tpu.core import FedRuntime as JRuntime
        from commefficient_tpu.core import client as jclient
        from commefficient_tpu.models import stream_mlp as jstream
        from commefficient_tpu.ops import circulant as jcirc
        from commefficient_tpu.ops import sketch as jsketch
    except ImportError as e:
        pytest.skip(f"the JAX package does not import here: {e}")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ravel=ravel_pytree, JConfig=JConfig,
        JRuntime=JRuntime, client=jclient, stream=jstream, circ=jcirc,
        sketch=jsketch)


def _models(J, seed=0):
    tree = J.stream.init_stream_mlp(J.jax.random.PRNGKey(seed), d_in=D_IN,
                                    hidden=H, n_layers=L, n_classes=C)
    model = StreamMLP.from_jax(J.jax.tree.map(np.asarray, tree))
    return tree, model


def _batch(seed=0, n=B):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, D_IN).astype(np.float32)
    t = rng.randint(0, C, n)
    mask = np.ones(n, bool)
    mask[-1] = False
    return x, t, mask


def _close_to_max(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_parameters_forward_and_loss_match_reference(J):
    tree, model = _models(J)
    flat, _ = J.ravel(tree)
    assert np.array_equal(np.asarray(flat).view(np.int32),
                          model.flat.numpy().view(np.int32))
    assert model.num_params == flat.size == L * H + L * H * H + D_IN * H \
        + H * C
    assert [p for p, _ in model.layout] == ["blocks_b", "blocks_w", "inp",
                                            "out"]
    x, t, mask = _batch()
    lj, (aj,) = J.stream.make_stream_mlp_loss(tree)(
        tree, {"x": J.jnp.asarray(x), "target": J.jnp.asarray(t)},
        J.jnp.asarray(mask))
    lt, (at,) = make_stream_mlp_loss(model)(
        model.flat, {"x": torch.from_numpy(x), "target": torch.from_numpy(t)},
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert float(at) == float(aj)


def test_converter_checks_the_layout_and_init_draws_the_jax_scales(J):
    tree, _ = _models(J)
    bad = dict(J.jax.tree.map(np.asarray, tree), zz=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="layout"):
        StreamMLP.from_jax(bad)
    with pytest.raises(ValueError, match="want"):
        StreamMLP(torch.zeros(7), D_IN, H, L, C)
    m = init_stream_mlp(64, 256, 2, 10,
                        generator=torch.Generator().manual_seed(0))
    views = dict(zip([p for p, _ in m.layout],
                     torch.split(m.flat, [int(np.prod(s))
                                          for _, s in m.layout])))
    assert not views["blocks_b"].any()
    for name, fan_in in (("blocks_w", 256), ("inp", 64), ("out", 256)):
        np.testing.assert_allclose(float(views[name].std()),
                                   0.3 / np.sqrt(fan_in), rtol=0.1)


@pytest.mark.parametrize("scale", [None, 3.0])
@pytest.mark.parametrize("impl", ["circ", "hash"])
def test_streaming_grad_matches_reference_and_autograd(J, impl, scale):
    tree, model = _models(J)
    flat, _ = J.ravel(tree)
    d = model.num_params
    if impl == "circ":
        jcs = J.circ.make_circulant_sketch(d, 97, 3, seed=1)
        tcs = make_circulant_sketch(d, 97, 3, seed=1, device="cpu")
    else:
        jcs = J.sketch.make_sketch(d, 97, 3, 2, seed=1)
        tcs = make_sketch(d, 97, 3, 2, seed=1, device="cpu")
    x, t, mask = _batch(1)
    loss_fn = make_stream_mlp_loss(model)
    batch = {"x": torch.from_numpy(x), "target": torch.from_numpy(t)}
    jbatch = {"x": J.jnp.asarray(x), "target": J.jnp.asarray(t)}
    jstream = J.stream.make_stream_mlp_loss(tree).streaming_grad
    w = model.flat.clone().requires_grad_(True)
    loss, _ = loss_fn(w, batch, torch.from_numpy(mask))
    (g,) = torch.autograd.grad(loss, w)
    dense = tcs.encode(g * (1.0 if scale is None else scale))
    t0 = np.random.RandomState(2).randn(3, 97).astype(np.float32)
    # a fresh table, and one accumulated into (held to its own size)
    for table, tol in ((np.zeros_like(t0), 1e-5), (t0, 1e-6)):
        got, lt, (at,) = loss_fn.streaming_grad(
            model.flat, batch, torch.from_numpy(mask), tcs,
            torch.from_numpy(table.copy()), scale=scale)
        want, lj, _ = jstream(flat, jbatch, J.jnp.asarray(mask), jcs,
                              J.jnp.asarray(table), scale=scale)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
        _close_to_max(got.numpy(), want, tol)
        _close_to_max(got.numpy(), dense.numpy() + table, tol)


RANGES = [(0, 1000), (97, 300), (150, 40), (3 * 97 - 5, 10), (999, 1),
          (1000 - 333, 333), (5, 1)]


@pytest.mark.parametrize("start,n", RANGES)
def test_range_encode_accum_matches_reference(J, start, n):
    """Ranges on a block boundary, straddling one, inside one, ending at
    d, of one value; fresh and accumulating, with and without a
    scale."""
    d, c, r = 1000, 97, 4
    jcs = J.circ.make_circulant_sketch(d, c, r, seed=3)
    tcs = make_circulant_sketch(d, c, r, seed=3, device="cpu")
    rng = np.random.RandomState(start + n)
    vals = rng.randn(n).astype(np.float32)
    t0 = rng.randn(r, c).astype(np.float32)
    for table, scale in ((np.zeros((r, c), np.float32), None), (t0, 2.5)):
        got = tcs.encode_accum(torch.from_numpy(table.copy()),
                               torch.from_numpy(vals), start, scale=scale)
        want = jcs.encode_accum(J.jnp.asarray(table), J.jnp.asarray(vals),
                                start, scale=scale)
        _close_to_max(got.numpy(), want, 1e-6)
    # the vector holding vals at its range, encoded whole
    v = np.zeros(d, np.float32)
    v[start:start + n] = vals
    _close_to_max(tcs.encode_accum(tcs.empty_table(),
                                   torch.from_numpy(vals), start).numpy(),
                  tcs.encode(torch.from_numpy(v)).numpy(), 1e-6)


def test_range_encode_whole_range_and_refusals():
    d, c, r = 1000, 97, 4
    tcs = make_circulant_sketch(d, c, r, seed=3, device="cpu")
    v = torch.from_numpy(np.random.RandomState(0).randn(d).astype(
        np.float32))
    args = (tcs.shifts, tcs.sign_keys, c, r, tcs.m)
    whole = kernels.encode_plain(v, *args, scale=1.5)
    assert torch.equal(kernels.encode_plain(v, *args, scale=1.5, start=0),
                       whole)
    assert torch.equal(tcs.encode_accum(tcs.empty_table(), v, 0, 1.5),
                       kernels.encode_plain(v, *args, scale=1.5,
                                            table=tcs.empty_table()))
    # the range may reach into the padding past d, not past m c
    tcs.encode_accum(tcs.empty_table(), v[:30], tcs.m * c - 30)
    with pytest.raises(ValueError, match="outside"):
        tcs.encode_accum(tcs.empty_table(), v[:30], tcs.m * c - 29)
    with pytest.raises(ValueError, match="outside"):
        tcs.encode_accum(tcs.empty_table(), v[:30], -1)


def test_fused_table_matches_chunked_encode_grad_tree(J, monkeypatch):
    """The port's fused step encodes a client's flat gradient in one K1
    (the JAX package's accelerator route); the JAX package's chunked
    ``encode_grad_tree`` encodes the same gradient range by range. Their
    tables agree, here over 5 ranges."""
    tree, model = _models(J)
    d = model.num_params
    x, t, mask = _batch(3)
    jloss = J.stream.make_stream_mlp_loss(tree)
    gtree = J.jax.grad(lambda p: jloss(
        p, {"x": J.jnp.asarray(x), "target": J.jnp.asarray(t)},
        J.jnp.asarray(mask))[0])(tree)
    jcs = J.circ.make_circulant_sketch(d, 211, 3, seed=5)
    calls = []
    orig = J.circ.CirculantSketch.encode_accum

    def counted(self, table, vals, start=0, **kw):
        calls.append((int(start), int(vals.shape[0])))
        return orig(self, table, vals, start, **kw)

    monkeypatch.setattr(J.circ.CirculantSketch, "encode_accum", counted)
    n_c = float(mask.sum())
    want = J.client.encode_grad_tree(jcs, jcs.empty_table()
                                     if hasattr(jcs, "empty_table")
                                     else J.jnp.zeros((3, 211)), gtree,
                                     scale=n_c, min_chunk=200,
                                     max_chunk=1024)
    assert len(calls) == 5 and sum(n for _, n in calls) == d
    cfg = FedConfig(mode="sketch", error_type="virtual", local_momentum=0.0,
                    weight_decay=0.0, num_rows=3, num_cols=211,
                    local_batch_size=B, num_workers=1)
    plain = make_stream_mlp_loss(model)
    fused = client_lib.make_fused_grad(
        cfg, lambda f, b, m: plain(f, b, m), B)
    tcs = make_circulant_sketch(d, 211, 3, seed=5, device="cpu")
    got, _, n = fused(model.flat, {"x": torch.from_numpy(x)[None],
                                   "target": torch.from_numpy(t)[None]},
                      torch.from_numpy(mask)[None], mask[None], tcs)
    assert float(n[0]) == n_c
    _close_to_max(got.numpy(), want, 1e-5)


class CountingSketch:
    """Delegates to a sketch and counts its ``encode_accum`` calls by
    range length."""

    def __init__(self, cs):
        self.cs, self.ranges = cs, []

    def __getattr__(self, name):
        return getattr(self.cs, name)

    def encode_accum(self, table, vals, start=0, scale=None):
        self.ranges.append(int(vals.shape[0]))
        return self.cs.encode_accum(table, vals, start, scale)


ROUND_CASES = {
    "fused": dict(),
    "fused_microbatched": dict(microbatch_size=3, weight_decay=5e-4),
    "table_clip": dict(max_grad_norm=0.5),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_stream_mlp_round_matches_reference(J, case):
    kw = dict(dict(mode="sketch", error_type="virtual", local_momentum=0.0,
                   virtual_momentum=0.9, weight_decay=0.0, k=50, num_rows=3,
                   num_cols=211, local_batch_size=B, num_workers=2,
                   num_clients=4), **ROUND_CASES[case])
    tree, model = _models(J)
    jrt = J.JRuntime(J.JConfig(**kw, num_results_train=2, telemetry=False),
                     tree, J.stream.make_stream_mlp_loss(tree),
                     num_clients=4)
    loss_fn = make_stream_mlp_loss(model)
    # the reference's route without telemetry: its per-client gradient
    # statistics would take the table clip off the streaming encode
    trt = FedRuntime(FedConfig(**kw, telemetry=False), model, loss_fn,
                     device="cpu")
    counting = CountingSketch(trt.cs)
    trt.cs = counting
    js, ts = jrt.init_state(), trt.init_state()
    rng = np.random.RandomState(7)
    for _ in range(3):
        ids = rng.choice(4, 2, replace=False)
        x = rng.randn(2, B, D_IN).astype(np.float32)
        t = rng.randint(0, C, (2, B))
        mask = np.ones((2, B), bool)
        mask[1, 4:] = False
        counting.ranges.clear()
        js, jm = jrt.round(js, J.jnp.asarray(ids.astype(np.int32)),
                           {"x": J.jnp.asarray(x), "target": J.jnp.asarray(t)},
                           J.jnp.asarray(mask), 0.1)
        ts, tm = trt.round(ts, ids, {"x": x, "target": t}, mask, 0.1)
        for got, want in zip(tm["results"], jm["results"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
        iters = 2 if case == "fused_microbatched" else 1
        wd = (1 if case == "fused" or case == "fused_microbatched" else 2) \
            if kw["weight_decay"] else 0
        streamed = [n for n in counting.ranges if n != model.num_params]
        assert len(streamed) == 2 * iters * (2 * L + 2)
        assert len(counting.ranges) - len(streamed) == wd
    np.testing.assert_allclose(ts.ps_weights.numpy(),
                               np.asarray(js.ps_weights), rtol=0, atol=1e-6)
    assert (ts.ps_weights != model.flat).any()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,c,r", [(20_000, 4000, 5), (1_000_003, 65_536, 5),
                                   (300_000, 7_777, 3)])
def test_k1_range_form_bitwise_on_card(cuda, d, c, r):
    """K1 over ranges on a block boundary, straddling one, inside one,
    ending at d, of one value, and the whole vector, fresh and
    accumulating: bitwise its plain version; the whole range bitwise the
    whole-vector call."""
    cs = make_circulant_sketch(d, c, r, device=cuda)
    args = (cs.shifts, cs.sign_keys, c, r, cs.m)
    rng = np.random.RandomState(d)
    v = torch.from_numpy(rng.randn(d).astype(np.float32)).to(cuda)
    t0 = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(cuda)
    ranges = [(c, 2 * c), (c // 2, c), (c + 3, c // 3), (d - c - 5, c + 5),
              (d // 2, 1), (0, d)]
    kernels.reset_launches()
    for start, n in ranges:
        vals = v[start:start + n]
        got = kernels.encode(vals, *args, start=start)
        got_acc = kernels.encode(vals, *args, scale=0.37, table=t0.clone(),
                                 start=start)
        want = kernels.encode_plain(vals, *args, start=start)
        want_acc = kernels.encode_plain(vals, *args, scale=0.37, table=t0,
                                        start=start)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_acc, want_acc), \
            (start, n)
    assert kernels.launches["circ_encode"] == 2 * len(ranges)
    assert torch.equal(kernels.encode(v, *args, start=0),
                       kernels.encode(v, *args))
