"""The port's hash Count Sketch (ops/sketch.py), SRHT (ops/rht.py) and
parameter ravel (ops/pytree.py) against the JAX package's, on the CPU.

Seeded numpy inputs go to both. Keys, buckets, signs, the SRHT's sign
table, offsets and scales are held bit for bit; so are the decodes of a
given table (``decode``, ``decode_at``, ``decode_range``) on tables that
hold +-0, ties, +-inf and NaN, the top-k support of ``unsketch_with_idx``,
and the ordered sparse re-encode ``encode_vals_at``. The hash encode
scatters in another order than the JAX package's block-wise
``segment_sum``: its tables are held to rtol 1e-6, plus 1e-6 of the row's
norm where a cell's addends cancel. The SRHT's transform is three float32
matrix products whose summation order differs between the two BLAS:
tables and estimates are held to 1e-5 of the largest magnitude; the same
bound holds the row-scanned form against the batched one. The bf16
transform rounds every product to bf16 in both packages: its tables and
estimates are held to 1e-2 of the largest magnitude (a few bf16 ulps;
the two CPU backends agree bit for bit on these inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import tie_heavy_sparse, zeroed_table  # noqa: E402
from commefficient_tpu.ops import rht as jrht  # noqa: E402
from commefficient_tpu.ops import sketch as jsketch  # noqa: E402
from commefficient_tpu.ops.pytree import ravel_params as j_ravel  # noqa

from commefficient_torch.ops import rht as trht  # noqa: E402
from commefficient_torch.ops import sketch as tsketch  # noqa: E402
from commefficient_torch.ops.pytree import (make_unraveler,  # noqa: E402
                                            ravel_params)

D = 20_011      # not a multiple of the block length


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def _pair(d=D, c=3001, r=5, num_blocks=7, seed=42):
    return (jsketch.make_sketch(d, c, r, num_blocks, seed=seed),
            tsketch.make_sketch(d, c, r, num_blocks, seed=seed,
                                device="cpu"))


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _special_table(r, c, seed):
    """``zeroed_table`` with +-inf and ties of equal magnitude and mixed
    sign."""
    table = zeroed_table(r, c, seed)
    rng = np.random.RandomState(seed + 1)
    table[rng.rand(r, c) < 0.003] = np.inf
    table[rng.rand(r, c) < 0.003] = -np.inf
    ties = rng.rand(r, c) < 0.05
    table[ties] = np.where(rng.rand(int(ties.sum())) < 0.5, 1.5, -1.5)
    return table


def _close_to_rows(got, want, rtol=1e-6):
    """Each cell within ``rtol`` of the reference's, or of its row's
    norm where addends cancel."""
    want = np.asarray(want)
    row = np.linalg.norm(want, axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * (np.abs(want) + row)), \
        np.abs(got - want).max()


# ------------------------------------------------------------- hash


@pytest.mark.parametrize("seed", [42, 7])
def test_hash_keys_buckets_and_signs_bitwise(seed):
    js, ts = _pair(seed=seed)
    assert np.array_equal(ts.bucket_keys.numpy(),
                          np.asarray(js.bucket_keys).astype(np.int64))
    assert np.array_equal(ts.sign_keys.numpy(),
                          np.asarray(js.sign_keys).astype(np.int64))
    rng = np.random.RandomState(seed)
    idx = np.concatenate([np.arange(64), [D - 1, 2**31, 2**32 - 1],
                          rng.randint(0, 2**32, 5000, dtype=np.uint64)]
                         ).astype(np.uint32)
    jb, jsg = jsketch._buckets_signs(js, jnp.asarray(idx))
    tb, tsg = ts.buckets_signs(torch.from_numpy(idx.astype(np.int64)))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(_bits(tsg), _bits(jsg))


@pytest.mark.parametrize("num_blocks", [1, 7])
def test_hash_encode_and_encode_accum_match_reference(num_blocks):
    js, ts = _pair(num_blocks=num_blocks)
    rng = np.random.RandomState(num_blocks)
    v = rng.randn(D).astype(np.float32)
    _close_to_rows(ts.encode(torch.from_numpy(v)).numpy(),
                   js.encode(jnp.asarray(v)))
    # a range at an offset, scaled, onto a carry table
    table = rng.randn(5, 3001).astype(np.float32)
    vals = rng.randn(9000).astype(np.float32)
    want = js.encode_accum(jnp.asarray(table), jnp.asarray(vals),
                           start=4321, scale=3.0)
    got = ts.encode_accum(torch.from_numpy(table.copy()),
                          torch.from_numpy(vals), start=4321, scale=3.0)
    _close_to_rows(got.numpy(), want)


def test_hash_encode_vals_at_matches_reference_bitwise():
    """The sparse re-encode sums each cell's addends in the order of
    ``idx`` (many collide in 101 columns)."""
    js, ts = _pair(c=101)
    rng = np.random.RandomState(3)
    idx = rng.choice(D, 4000, replace=False)
    vals = rng.randn(4000).astype(np.float32)
    want = js.encode_vals_at(jnp.asarray(vals), jnp.asarray(idx))
    got = ts.encode_vals_at(torch.from_numpy(vals), torch.from_numpy(idx))
    assert np.array_equal(_bits(got), _bits(want))
    dense = np.zeros(D, np.float32)
    dense[idx] = vals
    assert np.array_equal(
        _bits(ts.encode_at(torch.from_numpy(dense), torch.from_numpy(idx))),
        _bits(want))


def test_hash_encode_vals_at_tie_heavy_bitwise():
    """The hash sketch's re-encode on ``chip_smoke.tie_heavy_sparse``
    inputs (32 addends on one cell a row, cancelling pairs, -0.0 first,
    inf and NaN): the reference's bits."""
    js, ts = _pair(c=101)
    idx, vals = tie_heavy_sparse(D, 600, seed=7, one=32)
    want = js.encode_vals_at(jnp.asarray(vals), jnp.asarray(idx))
    got = ts.encode_vals_at(torch.from_numpy(vals), torch.from_numpy(idx))
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("c,r", [(3001, 5), (4096, 4), (777, 3)])
def test_hash_decodes_of_a_given_table_bitwise(c, r):
    """+-0, ties, +-inf and NaN in the table: decode, decode_at,
    decode_range (past d: exactly 0) and the top-k support of
    unsketch_with_idx give the JAX package's bits."""
    js, ts = _pair(c=c, r=r)
    table = _special_table(r, c, seed=c + r)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    want = _bits(js.decode(jt))
    got = _bits(ts.decode(tt))
    assert np.array_equal(got, want)
    idx = np.random.RandomState(c).choice(D, 3000, replace=False)
    assert np.array_equal(
        _bits(ts.decode_at(tt, torch.from_numpy(idx))),
        _bits(js.decode_at(jt, jnp.asarray(idx))))
    assert np.array_equal(
        _bits(ts.decode_range(tt, D - 500, 800)),
        _bits(js.decode_range(jt, D - 500, 800)))
    finite = np.nan_to_num(table, nan=0.0, posinf=2.0, neginf=-2.0)
    jv, jidx = js.unsketch_with_idx(jnp.asarray(finite), 200)
    tv, tidx = ts.unsketch_with_idx(torch.from_numpy(finite), 200)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    assert np.array_equal(_bits(tv), _bits(jv))


def test_hash_l2estimate_and_clip_match_reference():
    js, ts = _pair()
    table = np.random.RandomState(5).randn(5, 3001).astype(np.float32)
    np.testing.assert_allclose(
        float(ts.l2estimate(torch.from_numpy(table))),
        float(js.l2estimate(jnp.asarray(table))), rtol=1e-6)
    np.testing.assert_allclose(
        ts.clip(torch.from_numpy(table), 1.0).numpy(),
        np.asarray(js.clip(jnp.asarray(table), 1.0)), rtol=1e-6)


def test_make_sketch_impl_builds_each_sketch():
    for impl, cls in (("circ", "CirculantSketch"), ("hash", "CountSketch"),
                      ("rht", "RHTSketch")):
        cs = tsketch.make_sketch_impl(impl, 100, 64, 3, device="cpu")
        assert type(cs).__name__ == cls and cs.table_shape == (3, 64)
    with pytest.raises(ValueError, match="sketch_impl"):
        tsketch.make_sketch_impl("dense", 100, 64, 3, device="cpu")


# ------------------------------------------------------------- SRHT


def _rht_pair(d, c, r, seed=42):
    return (jrht.make_rht_sketch(d, c, r, seed=seed),
            trht.make_rht_sketch(d, c, r, seed=seed, device="cpu"))


def _close_to_max(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("d,c,r", [(1000, 1024, 3), (3000, 700, 5),
                                   (5000, 64, 4)])
def test_rht_construction_bitwise(d, c, r):
    js, ts = _rht_pair(d, c, r)
    assert (ts.dp, ts.m) == (js.dp, js.m)
    assert trht.kron_dims(ts.dp) == jrht._kron_dims(js.dp)
    assert np.array_equal(ts.sign_keys.numpy(),
                          np.asarray(js.sign_keys).astype(np.int64))
    assert np.array_equal(ts.signs_i8.numpy(), np.asarray(js.signs_i8))
    assert np.array_equal(ts.offsets.numpy(), np.asarray(js.offsets))
    assert np.array_equal(_bits(ts.scales), _bits(js.scales))
    for a, b in zip(ts.hadamards, js.hadamards):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_rht_signs_derived_past_the_limit_bitwise(monkeypatch):
    """Above the precompute limit both packages derive the signs from
    mix32."""
    monkeypatch.setattr(jrht, "_PRECOMPUTE_SIGN_LIMIT", 0)
    monkeypatch.setattr(trht, "PRECOMPUTE_SIGN_LIMIT", 0)
    js, ts = _rht_pair(3000, 700, 5)
    assert js.signs_i8 is None and ts.signs_i8 is None
    assert np.array_equal(_bits(ts._signs()), _bits(js._signs()))


def test_rht_lossless_round_trip():
    """c >= d': one member a stratum, so decode(encode(v)) is v to
    float32 rounding, in both packages, batched and not."""
    d, c = 1000, 1024
    js, ts = _rht_pair(d, c, 3)
    v = np.random.RandomState(0).randn(2, d).astype(np.float32)
    got = ts.decode(ts.encode(torch.from_numpy(v)))
    np.testing.assert_allclose(got.numpy(), v, rtol=0, atol=1e-5)
    _close_to_max(ts.encode(torch.from_numpy(v[0])).numpy(),
                  js.encode(jnp.asarray(v[0])))
    _close_to_max(got.numpy(), js.decode(js.encode(jnp.asarray(v))))


@pytest.mark.parametrize("d,c,r", [(3000, 700, 5), (5000, 64, 4)])
def test_rht_encode_linear_and_decode_of_a_given_table(d, c, r):
    js, ts = _rht_pair(d, c, r)
    rng = np.random.RandomState(d)
    x, y = rng.randn(2, d).astype(np.float32)
    enc = lambda v: ts.encode(torch.from_numpy(v)).numpy()  # noqa: E731
    _close_to_max(enc(2 * x - 3 * y), 2 * enc(x) - 3 * enc(y))
    _close_to_max(enc(x), js.encode(jnp.asarray(x)))
    table = rng.randn(r, c).astype(np.float32)
    want = js.decode(jnp.asarray(table))
    _close_to_max(ts.decode(torch.from_numpy(table)).numpy(), want)
    batched = ts.decode(torch.from_numpy(np.stack([table, 2 * table])))
    _close_to_max(batched[1].numpy(), 2 * np.asarray(want))
    np.testing.assert_allclose(
        float(ts.l2estimate(torch.from_numpy(table))),
        float(js.l2estimate(jnp.asarray(table))), rtol=1e-6)
    _close_to_max(ts.clip(torch.from_numpy(table), 1.0).numpy(),
                  js.clip(jnp.asarray(table), 1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,r", [(3000, 256, 3), (5000, 64, 4)])
def test_rht_row_scan_and_bf16_transform_match_reference(d, c, r, dtype):
    """``scan_rows`` against the batched form in the port, and each form
    and transform dtype against the JAX package's: the encode of a
    vector and the decode of a given table (the scan keeps its per-row
    estimates in the transform dtype, as the JAX package's does)."""
    rng = np.random.RandomState(d + r)
    x = rng.randn(d).astype(np.float32)
    table = rng.randn(r, c).astype(np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2
    out = {}
    for scan in (False, True):
        js = jrht.make_rht_sketch(d, c, r, seed=3, dtype=dtype,
                                  scan_rows=scan)
        ts = trht.make_rht_sketch(d, c, r, seed=3, device="cpu",
                                  dtype=dtype, scan_rows=scan)
        assert ts.scan_rows is scan and ts.dtype == dtype
        enc = ts.encode(torch.from_numpy(x)).numpy()
        dec = ts.decode(torch.from_numpy(table)).numpy()
        assert enc.dtype == dec.dtype == np.float32
        _close_to_max(enc, js.encode(jnp.asarray(x)), tol)
        _close_to_max(dec, js.decode(jnp.asarray(table)), tol)
        batched = ts.decode(torch.from_numpy(np.stack([table, -table])))
        _close_to_max(batched[1].numpy(), -dec, 0)
        out[scan] = (enc, dec)
    _close_to_max(out[True][0], out[False][0], tol)
    _close_to_max(out[True][1], out[False][1], tol)


def test_rht_bf16_transform_differs_from_float32():
    """The bf16 transform is not the float32 one: at d' = 4096 its round
    trip at c >= d' misses v by bf16 rounding, where float32's is exact
    to 1e-5."""
    d = 4096
    v = torch.from_numpy(np.random.RandomState(1).randn(d).astype(
        np.float32))
    errs = {}
    for dtype in ("float32", "bfloat16"):
        ts = trht.make_rht_sketch(d, d, 1, device="cpu", dtype=dtype)
        errs[dtype] = float((ts.decode(ts.encode(v)) - v).abs().max())
    assert errs["float32"] < 1e-5 < 1e-3 < errs["bfloat16"] < 0.2


@pytest.mark.parametrize("d,want", [(1 << 24, False), ((1 << 24) + 1, True),
                                    ((1 << 25) - 5, True)])
def test_rht_row_scan_switches_on_at_two_to_the_25(d, want):
    """``scan_rows`` None (``--sketch_scan_rows -1``) turns the scan on
    once d' reaches 2^25, as the JAX package does; 0 and 1 force it
    (``make_sketch_impl`` passes the flag through). r = 1, a small table:
    the int8 sign table is d' bytes."""
    ts = tsketch.make_sketch_impl("rht", d, 64, 1, device="cpu")
    js = jsketch.make_sketch_impl("rht", d, 64, 1)
    assert ts.scan_rows is want and js.scan_rows is want
    assert ts.dp == js.dp == max(trht.next_pow2(d), 64)
    for flag in (0, 1):
        ts = tsketch.make_sketch_impl("rht", 100, 64, 1, device="cpu",
                                      scan_rows=flag, dtype="bfloat16")
        assert ts.scan_rows is bool(flag) and ts.dtype == "bfloat16"


# ------------------------------------------------------------- pytree


def test_ravel_params_matches_ravel_pytree():
    rng = np.random.RandomState(0)
    tree = {"b": {"kernel": rng.randn(3, 4).astype(np.float32),
                  "bias": rng.randn(4).astype(np.float32)},
            "a": rng.randn(2, 2, 2).astype(np.float32),
            "c": {"z": {"w": rng.randn(5).astype(np.float32)}}}
    jflat, _ = j_ravel(tree)
    flat, unravel = ravel_params(tree)
    assert np.array_equal(_bits(flat), _bits(jflat))
    d, unravel2 = make_unraveler(tree)
    assert d == flat.numel() == 3 * 4 + 4 + 8 + 5
    back = unravel2(flat)
    for path in (("a",), ("b", "kernel"), ("b", "bias"), ("c", "z", "w")):
        want, got = tree, back
        for key in path:
            want, got = want[key], got[key]
        assert np.array_equal(got.numpy(), want)
    # views: unravel writes through to the flat vector
    unravel(flat)["a"].zero_()
    assert not flat[:8].any()
