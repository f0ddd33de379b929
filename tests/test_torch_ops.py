"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to the JAX function and to
its port. Bitwise where the arithmetic is the same (shifts, sign keys, the
mixer, the decode median, the sampler, the synthetic data); a stated
tolerance where only the order of float additions differs.

The kernels themselves (csrc/circulant.cu) are held against these plain
versions on the card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch


from commefficient_tpu import config as jconfig  # noqa: E402
from commefficient_tpu.data import fed_cifar as jcifar  # noqa: E402
from commefficient_tpu.data import fed_sampler as jsampler  # noqa: E402
from commefficient_tpu.data import transforms as jtransforms  # noqa: E402
from commefficient_tpu.ops import circulant as jcirc  # noqa: E402
from commefficient_tpu.ops import circulant_pallas as jpallas  # noqa: E402
from commefficient_tpu.ops import sketch as jsketch  # noqa: E402
# commefficient_tpu.ops re-exports a function named topk over the module
jtopk = importlib.import_module("commefficient_tpu.ops.topk")

from chip_smoke import zeroed_table  # noqa: E402
from commefficient_torch import config as tconfig  # noqa: E402
from commefficient_torch.data import fed_cifar as tcifar  # noqa: E402
from commefficient_torch.data import fed_sampler as tsampler  # noqa: E402
from commefficient_torch.data import transforms as ttransforms  # noqa: E402
from commefficient_torch.ops import circulant as tcirc  # noqa: E402
from commefficient_torch.ops import hashing, topk as ttopk  # noqa: E402

D, R = 20_000, 5


def _pair(c, d=D, r=R, seed=42):
    return (jcirc.make_circulant_sketch(d, c, r, seed=seed, pallas="off"),
            tcirc.make_circulant_sketch(d, c, r, seed=seed,
                                        device="cpu"))


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _bits(t):
    """The uint32 bits of a float32 result: -0 and +0 differ here, and
    NaN equals NaN of the same bits (np.array_equal on values does
    neither)."""
    return np.ascontiguousarray(_np(t), np.float32).view(np.uint32)


# every r-row column over {+0, -0, 1, -1, NaN}: ties, signed zeros, NaN
_SPECIALS = np.array([0.0, -0.0, 1.0, -1.0, np.nan], np.float32)


def _all_columns(r):
    idx = np.indices((len(_SPECIALS),) * r).reshape(r, -1)
    return _SPECIALS[idx]


# ----------------------------------------------------------- hashing


@pytest.mark.parametrize("c,seed", [(4096, 42), (4000, 42), (500_736, 7)])
def test_shifts_and_keys_bitwise(c, seed):
    d = 6_568_640 if c == 500_736 else D
    js, ts = _pair(c, d=d, seed=seed)
    assert np.array_equal(np.asarray(js.shifts, np.int32), _np(ts.shifts))
    assert np.array_equal(np.asarray(js.sign_keys),
                          _np(ts.sign_keys).view(np.uint32))
    if c % 1024 == 0:
        assert (_np(ts.shifts) % 1024 == 0).all()


def test_mix32_and_signs_bitwise():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2**32, size=50_000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    ref = np.asarray(jsketch._mix32(jnp.asarray(x)))
    got = hashing.mix32(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(_np(got).astype(np.uint32), ref)
    js, ts = _pair(4000)
    idx = rng.randint(0, D, size=5000)
    for j in range(R):
        assert np.array_equal(
            np.asarray(js._sign_of(j, jnp.asarray(idx))),
            _np(ts._sign_of(j, torch.from_numpy(idx))))


# ------------------------------------------------------------ encode


def test_encode_matches_pallas_interpret_bitwise():
    """c = 4096 (aligned shifts): the port's plain K1 equals the Pallas
    kernel run in interpret mode bit for bit (both sum the blocks in
    ascending order)."""
    js, ts = _pair(4096)
    v = np.random.RandomState(1).randn(D).astype(np.float32)
    m = js.m
    ref = jpallas.pallas_encode(
        jnp.pad(jnp.asarray(v), (0, m * 4096 - D)),
        jnp.asarray(js.shifts, jnp.int32), js.sign_keys, c=4096, r=R, m=m,
        interpret=True)
    got = ts.encode(torch.from_numpy(v))
    assert np.array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("c", [4096, 4000])
def test_encode_and_encode_accum_match_roll_path(c):
    """Against ``CirculantSketch.encode`` / ``encode_accum`` with the Pallas
    kernels off (the roll path; XLA's reduction order differs, so the
    tolerance is float32 summation error over m blocks:
    rtol 1e-5, atol 1e-5 x max|v|)."""
    js, ts = _pair(c)
    rng = np.random.RandomState(2)
    v = rng.randn(D).astype(np.float32)
    t0 = rng.randn(R, c).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5 * np.abs(v).max())
    np.testing.assert_allclose(_np(ts.encode(torch.from_numpy(v))),
                               np.asarray(js.encode(jnp.asarray(v))), **tol)
    ref = js.encode_accum(jnp.asarray(t0), jnp.asarray(v), 0,
                          scale=jnp.float32(3.0))
    table = torch.from_numpy(t0.copy())
    got = ts.encode_accum(table, torch.from_numpy(v), 0, scale=3.0)
    assert got is table
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=3e-5 * np.abs(v).max())
    # a range of the vector at an unaligned start, as the reference
    # encodes it; a range past the m c coordinates is refused
    ref = js.encode_accum(jnp.asarray(t0), jnp.asarray(v[:100]), 333,
                          scale=jnp.float32(3.0))
    got = ts.encode_accum(torch.from_numpy(t0.copy()),
                          torch.from_numpy(v[:100]), 333, scale=3.0)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=3e-5 * np.abs(v).max())
    with pytest.raises(ValueError, match="outside"):
        ts.encode_accum(table, torch.from_numpy(v[:100]), ts.m * c - 99)


def test_encode_vals_at_matches_reference():
    """Sparse encode and ``encode_at`` against the reference (rtol 1e-6,
    atol 1e-6; test_encode_vals_at_sums_in_reference_order holds the
    bits)."""
    for c in (4096, 4000):
        js, ts = _pair(c)
        rng = np.random.RandomState(3)
        idx = np.sort(rng.choice(D, 3000, replace=False))
        vals = rng.randn(3000).astype(np.float32)
        ref = js.encode_vals_at(jnp.asarray(vals), jnp.asarray(idx))
        got = ts.encode_vals_at(torch.from_numpy(vals), torch.from_numpy(idx))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
        dense = np.zeros(D, np.float32)
        dense[idx] = vals
        np.testing.assert_allclose(
            _np(ts.encode_at(torch.from_numpy(dense), torch.from_numpy(idx))),
            np.asarray(ref), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ decode


def test_decode_matches_pallas_interpret_bitwise():
    js, ts = _pair(4096)
    table = np.random.RandomState(4).randn(R, 4096).astype(np.float32)
    ref = jpallas.pallas_decode(jnp.asarray(table),
                                jnp.asarray(js.shifts, jnp.int32),
                                js.sign_keys, c=4096, r=R, m=js.m,
                                interpret=True)[:D]
    got = ts.decode(torch.from_numpy(table))
    assert np.array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("c,r", [(4000, 5), (4096, 4)])
def test_decode_and_decode_at_match_roll_path_bitwise(c, r):
    """Unaligned shifts and an even r (mean of the two middle values):
    the same gathers, signs and comparator network as the roll path."""
    js, ts = _pair(c, r=r)
    rng = np.random.RandomState(5)
    table = rng.randn(r, c).astype(np.float32)
    ref = _bits(js.decode(jnp.asarray(table)))
    got = _bits(ts.decode(torch.from_numpy(table)))
    assert np.array_equal(got, ref)
    idx = rng.choice(D, 2000, replace=False)
    ref_at = _bits(js.decode_at(jnp.asarray(table), jnp.asarray(idx)))
    got_at = _bits(ts.decode_at(torch.from_numpy(table),
                                torch.from_numpy(idx)))
    assert np.array_equal(got_at, ref_at)
    assert np.array_equal(got_at, got[idx])


@pytest.mark.parametrize("c,r", [(4000, 5), (4096, 4), (4000, 3), (777, 8)])
def test_decode_and_decode_at_of_zeroed_table_bitwise(c, r):
    """A table with zeroed cells: the signs make -0 and +0 estimates that
    tie in the median, where the JAX package's jnp.minimum takes -0 and
    jnp.maximum +0 in either order. Decode and decode_at give the JAX
    package's bits, NaN included."""
    js, ts = _pair(c, r=r)
    table = zeroed_table(r, c, seed=c + r)
    ref = _bits(js.decode(jnp.asarray(table)))
    got = _bits(ts.decode(torch.from_numpy(table)))
    assert np.array_equal(got, ref)
    idx = np.random.RandomState(c).choice(D, 4000, replace=False)
    ref_at = _bits(js.decode_at(jnp.asarray(table), jnp.asarray(idx)))
    got_at = _bits(ts.decode_at(torch.from_numpy(table),
                                torch.from_numpy(idx)))
    assert np.array_equal(got_at, ref_at)
    assert np.array_equal(got_at, got[idx])


def test_decode_of_zeroed_table_matches_pallas_interpret_bitwise():
    js, ts = _pair(4096)
    table = zeroed_table(R, 4096, seed=11)
    ref = jpallas.pallas_decode(jnp.asarray(table),
                                jnp.asarray(js.shifts, jnp.int32),
                                js.sign_keys, c=4096, r=R, m=js.m,
                                interpret=True)[:D]
    got = ts.decode(torch.from_numpy(table))
    assert np.array_equal(_bits(got), _bits(ref))


def test_l2estimate_and_clip_match_reference():
    js, ts = _pair(4000)
    table = np.random.RandomState(6).randn(R, 4000).astype(np.float32)
    np.testing.assert_allclose(
        float(ts.l2estimate(torch.from_numpy(table))),
        float(js.l2estimate(jnp.asarray(table))), rtol=1e-6)
    for clip in (1.0, 1e6):
        np.testing.assert_allclose(
            _np(ts.clip(torch.from_numpy(table), clip)),
            np.asarray(js.clip(jnp.asarray(table), clip)), rtol=1e-6,
            atol=1e-7)


def test_unsketch_with_idx_matches_reference():
    js, ts = _pair(4000)
    table = np.random.RandomState(7).randn(R, 4000).astype(np.float32)
    ref_u, ref_i = js.unsketch_with_idx(jnp.asarray(table), 300)
    got_u, got_i = ts.unsketch_with_idx(torch.from_numpy(table), 300)
    assert np.array_equal(_np(got_i), np.asarray(ref_i))
    assert np.array_equal(_np(got_u), np.asarray(ref_u))


# -------------------------------------------------------------- top-k


def test_topk_untied_support_and_order_identical():
    v = np.random.RandomState(8).randn(10_000).astype(np.float32)
    for k in (1, 37, 1000):
        ref_v, ref_i = jtopk.topk_with_idx(jnp.asarray(v), k)
        got_v, got_i = ttopk.topk_with_idx(torch.from_numpy(v), k)
        assert np.array_equal(_np(got_i), np.asarray(ref_i))
        assert np.array_equal(_np(got_v), np.asarray(ref_v))


def test_topk_ties_lower_index_wins():
    """Eight entries share the k-th magnitude (signs mixed): the lower
    indices win, as with ``lax.top_k``."""
    v = np.zeros(64, np.float32)
    v[[3, 9, 20, 21, 40, 50, 55, 60]] = [2, -2, 2, -2, 2, 2, -2, 2]
    v[[30, 31]] = [5, -7]
    k = 5
    ref_v, ref_i = jtopk.topk_with_idx(jnp.asarray(v), k)
    got_v, got_i = ttopk.topk_with_idx(torch.from_numpy(v), k)
    assert np.array_equal(_np(got_i), np.asarray(ref_i))
    assert sorted(_np(got_i).tolist()) == [3, 9, 20, 30, 31]
    assert np.array_equal(_np(got_v), np.asarray(ref_v))


def _special_vector():
    """+-NaN with two payloads each, +-inf, +-0, and ties of equal
    magnitude and mixed sign among finite values."""
    bits = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0xFFC00005,
                     0x7F800000, 0xFF800000, 0x00000000, 0x80000000],
                    np.uint32)
    special = bits.view(np.float32)
    finite = np.array([1, -2, 3, -3, 2, 0.5, -1, 3, 2e-30, -2e-30],
                      np.float32)
    v = np.concatenate([finite[:4], special[:3], finite[4:7], special[3:],
                        finite[7:]])
    return v


@pytest.mark.parametrize("k", range(1, 19))
def test_topk_nan_inf_signed_zero_and_ties_match_lax_top_k(k):
    """With NaN in the vector the top-k still returns k indices, in
    ``lax.top_k``'s order of ``vec * vec`` (the total order of float32:
    +NaN above +inf, a NaN with its sign bit set below -inf, payloads by
    their bits, -0 below +0, ties to the lower index), and the values'
    bits are the reference's."""
    from jax import lax
    v = _special_vector()
    assert len(v) == 18
    _, ref_sq_idx = lax.top_k(jnp.asarray(v) * jnp.asarray(v), k)
    ref_v, ref_i = jtopk.topk_with_idx(jnp.asarray(v), k)
    got_v, got_i = ttopk.topk_with_idx(torch.from_numpy(v), k)
    assert got_i.shape == (k,)
    assert np.array_equal(_np(got_i), np.asarray(ref_i))
    assert np.array_equal(_np(got_i), np.asarray(ref_sq_idx))
    assert np.array_equal(_bits(got_v), _bits(ref_v))


def test_topk_rowwise_matches_reference():
    x = np.random.RandomState(4).randn(6, 300).astype(np.float32)
    x[2, 7] = np.nan
    x[4, :] = 1.0                          # a row of ties
    got = ttopk.topk(torch.from_numpy(x), 11)
    ref = jtopk.topk(jnp.asarray(x), 11)
    assert np.array_equal(_bits(got), _bits(ref))
    assert np.array_equal(_bits(ttopk.topk(torch.from_numpy(x[0]), 11)),
                          _bits(jtopk.topk(jnp.asarray(x[0]), 11)))


@pytest.mark.parametrize("c,k", [(64, 500), (4096, 2000), (997, 300)])
def test_encode_vals_at_sums_in_reference_order(c, k):
    """Many addends a cell (k up to 8x c): the sparse encode adds a
    cell's addends in the order of ``idx``, so its table has the bits of
    the reference's ``segment_sum`` and of a plain sequential loop."""
    d, r = 20_000, 5
    js, ts = _pair(c, d=d, r=r)
    rng = np.random.RandomState(c)
    idx = rng.permutation(d)[:k]
    vals = rng.randn(k).astype(np.float32)
    got = ts.encode_vals_at(torch.from_numpy(vals), torch.from_numpy(idx))
    ref = js.encode_vals_at(jnp.asarray(vals), jnp.asarray(idx))
    assert np.array_equal(_bits(got), _bits(ref))
    loop = np.zeros((r, c), np.float32)
    tidx = torch.from_numpy(idx)
    for j in range(r):
        buckets = _np(ts._buckets_of(j, tidx))
        signed = _np(ts._sign_of(j, tidx)) * vals
        for b, x in zip(buckets, signed):
            loop[j, b] = np.float32(loop[j, b] + x)
    assert np.array_equal(_bits(got), _bits(loop))


@pytest.mark.parametrize("r", [1, 2, 4, 5])
def test_median_axis0_bitwise(r):
    x = np.random.RandomState(r).randn(r, 4096).astype(np.float32)
    assert np.array_equal(_bits(ttopk.median_axis0(torch.from_numpy(x))),
                          _bits(jtopk.median_axis0(jnp.asarray(x))))


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 6])
def test_median_axis0_signed_zeros_nan_and_ties_bitwise(r):
    """Every r-row column over {+0, -0, 1, -1, NaN}: the port's min/max
    take -0 below +0 and propagate NaN as jnp.minimum / jnp.maximum do,
    so the bubble network gives the JAX package's bits."""
    x = _all_columns(r)
    assert np.array_equal(_bits(ttopk.median_axis0(torch.from_numpy(x))),
                          _bits(jtopk.median_axis0(jnp.asarray(x))))
    a, b = x[0], x[-1]
    for name in ("minimum", "maximum"):
        for p, q in ((a, b), (b, a)):
            assert np.array_equal(
                _bits(getattr(ttopk, name)(torch.from_numpy(p),
                                           torch.from_numpy(q))),
                _bits(getattr(jnp, name)(jnp.asarray(p), jnp.asarray(q))))


# ------------------------------------------------- config, data, sampler


@pytest.mark.parametrize("n", [320, 4000, 4096, 500_000, 1_000_001])
def test_auto_num_cols_matches_reference(n):
    assert tconfig.auto_num_cols(n) == jconfig.auto_num_cols(n)


def test_flags_outside_the_slice_raise_naming_them():
    import argparse
    p = argparse.ArgumentParser()
    tconfig.add_args(p)
    with pytest.raises(ValueError, match="--compile_cache"):
        tconfig.parse_known(p, ["--k", "10", "--compile_cache"])
    with pytest.raises(ValueError, match="--mode"):
        tconfig.FedConfig(mode="dense_sketch")
    with pytest.raises(ValueError, match="--mesh_axes"):
        tconfig.config_from_args(
            tconfig.parse_known(p, ["--mesh_axes", "clients,model"]))
    # the runtime services' flags are the port's: they parse, and a value
    # outside their choices names the flag
    for argv in (["--defense", "trimmed_mean"], ["--scenario", "dropout",
                                                 "--async_agg"]):
        with pytest.raises(ValueError, match=argv[0]):
            tconfig.config_from_args(tconfig.parse_known(p, argv))
    # the wire's flags are the port's: they parse, and a value outside
    # what the wire serves names the flag
    ns = tconfig.parse_known(p, ["--sketch_scan_rows", "1", "--wire_dtype",
                                 "int8"])
    assert (ns.sketch_scan_rows, ns.wire_dtype) == (1, "int8")
    with pytest.raises(ValueError, match="--wire_dtype"):
        tconfig.FedConfig(mode="true_topk", wire_dtype="int8")
    # a legal flag in an illegal combination names itself when the
    # runtime validates it, as in the JAX package
    from commefficient_torch.core.server import validate_mode_combo
    with pytest.raises(ValueError, match="--local_momentum"):
        validate_mode_combo(tconfig.config_from_args(
            p.parse_args(["--error_type", "virtual"])))


@pytest.mark.parametrize("seed,epoch", [(21, 0), (5, 3)])
def test_sampler_rounds_identical(seed, epoch):
    per_client = np.array([64, 17, 40, 64, 3, 64, 64, 30, 64, 9])
    kw = dict(num_workers=4, local_batch_size=16,
              seed=seed + 7919 * epoch)
    ref = list(jsampler.FedSampler(per_client, **kw))
    got = list(tsampler.FedSampler(per_client, **kw))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert tsampler.FedSampler(per_client, **kw).epoch_rounds() == \
        jsampler.FedSampler(per_client, **kw).epoch_rounds()
    vref = list(jsampler.ValSampler(50, 16))
    vgot = list(tsampler.ValSampler(50, 16))
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(vgot, vref))


@pytest.mark.parametrize("max_client_batch, rounds", [(64, 2), (32, 4)])
def test_sampler_whole_client_batches_identical(max_client_batch, rounds):
    """``local_batch_size -1``: each client's whole dataset padded to
    ``max_client_batch``; a client larger than that gives a chunk a
    round."""
    per_client = np.array([64, 17, 40, 64, 3, 64, 64, 30, 64, 9])
    kw = dict(num_workers=4, local_batch_size=-1,
              max_client_batch=max_client_batch, seed=11)
    ref = list(jsampler.FedSampler(per_client, **kw))
    got = list(tsampler.FedSampler(per_client, **kw))
    assert len(got) == len(ref) == rounds
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert got[0].mask.shape == (4, max_client_batch)


def test_synthetic_cifar_and_transforms_identical(tmp_path):
    ref = jcifar._synthetic_cifar(10, 8)
    got = tcifar.synthetic_cifar(10, 8)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    ds = tcifar.FedCIFAR10(str(tmp_path), train=True, synthetic=True,
                           synthetic_per_class=8, num_clients=20)
    assert ds.data_per_client.tolist() == [4] * 20
    batch = {"image": got[0][:12].reshape(3, 4, 32, 32, 3),
             "target": got[1][:12].reshape(3, 4)}
    a = jtransforms.CifarTrain(seed=3)(batch)
    b = ttransforms.CifarTrain(seed=3)(batch)
    assert np.array_equal(a["image"], b["image"])
    assert np.array_equal(jtransforms.CifarEval()(batch)["image"],
                          ttransforms.CifarEval()(batch)["image"])
