"""The kernel wrappers of the PyTorch port: the circulant sketch
(ops/circulant_kernels.py) and causal flash attention
(ops/flash_attention.py).

On the CPU a wrapper takes its kernel's plain version and launches
nothing. The tests marked ``cuda`` hold the CUDA kernels K1 and K2
(csrc/circulant.cu) and K3 (csrc/flash_attention.cu) against those plain
versions on the card; they skip without one. K3 is held to
``chip_smoke.py``'s rule, each output row against its own norm, and the
CPU tests here show that the rule admits the kernels' bf16 rounding and
rejects a kernel that skips one tile. This file imports neither JAX nor
the JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import importlib
import math
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from commefficient_torch.ops import circulant_kernels as kernels
from commefficient_torch.ops import flash_attention as flash
from commefficient_torch.ops.circulant import make_circulant_sketch

D = 20_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def _inputs(c, r, seed=10, device="cpu"):
    rng = np.random.RandomState(seed)
    v = torch.from_numpy(rng.randn(D).astype(np.float32)).to(device)
    t0 = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(device)
    return v, t0


def test_wrappers_take_plain_version_on_cpu_without_launching():
    ts = make_circulant_sketch(D, 4000, 5, device="cpu")
    v, t0 = _inputs(4000, 5)
    args = (ts.shifts, ts.sign_keys, 4000, 5, ts.m)
    kernels.reset_launches()
    table = ts.encode(v)
    assert torch.equal(table, kernels.encode_plain(v, *args))
    acc = t0.clone()
    assert kernels.encode(v, *args, scale=2.0, table=acc) is acc
    assert torch.equal(acc, kernels.encode_plain(v, *args, scale=2.0,
                                                 table=t0))
    assert torch.equal(ts.decode(table),
                       kernels.decode_plain(table, *args, D))
    assert kernels.launches == {"circ_encode": 0, "circ_decode": 0,
                                "cell_sum": 0}
    with pytest.raises(ValueError, match="not ceil"):
        kernels.encode(v, ts.shifts, ts.sign_keys, 4000, 5, ts.m + 1)


def test_make_circulant_sketch_defaults_to_the_card():
    """The sketch's public constructor runs on the card unless the caller
    names another device, as the port's entry points do."""
    import inspect
    sig = inspect.signature(make_circulant_sketch)
    assert sig.parameters["device"].default == "cuda"
    ts = make_circulant_sketch(D, 4000, 5, device="cpu")
    assert ts.device == torch.device("cpu") and ts.shifts.shape == (5, 5)


def test_plain_encode_is_linear_and_decode_inverts_at_m1():
    """With c >= d (one block) a roll is invertible: decode(encode(v)) is
    v exactly, in every row, so the median is v too."""
    ts = make_circulant_sketch(1000, 1024, 3, seed=3, device="cpu")
    v = torch.from_numpy(np.random.RandomState(1).randn(1000)
                         .astype(np.float32))
    assert torch.equal(ts.decode(ts.encode(v)), v)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1/K2 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,r", [(4096, 5), (4000, 5), (1000, 4), (777, 8),
                                 (30_000, 1)])
def test_kernels_match_plain_on_card(cuda, c, r):
    """Aligned and unaligned shifts, even and odd r, c above d: K1 sums in
    the plain version's order with unfused float operations and K2 takes
    the same gathers and median, so both must match bitwise."""
    ts = make_circulant_sketch(D, c, r, device=cuda)
    v, t0 = _inputs(c, r, device=cuda)
    args = (ts.shifts, ts.sign_keys, c, r, ts.m)
    kernels.reset_launches()
    got = kernels.encode(v, *args)
    got_acc = kernels.encode(v, *args, scale=3.0, table=t0.clone())
    dec = kernels.decode(t0, *args, D)
    torch.cuda.synchronize()
    assert kernels.launches == {"circ_encode": 2, "circ_decode": 1,
                                "cell_sum": 0}
    assert chip_smoke.same_bits(got, kernels.encode_plain(v, *args))
    assert chip_smoke.same_bits(got_acc, kernels.encode_plain(
        v, *args, scale=3.0, table=t0))
    assert chip_smoke.same_bits(dec, kernels.decode_plain(t0, *args, D))


# (d, c, r) for K2, r = 1 .. 8: c not a multiple of the tile (2,048
# columns for r <= 5, 1,024 above), so each block ends in a partial tile;
# d that ends inside a tile; m = 1 with d < c (tiles past d); c below the
# tile (every tile tests its coordinates); random unaligned shifts, whose
# tiles cross the seam (a row's run wraps from column c - 1 to 0), and
# shifts aligned to 1,024; m = 70,000, more blocks than the grid's 65,535
# in y.
K2_CASES = [(20_000, 4000, 1), (19_999, 4096, 2), (3_000, 4096, 3),
            (20_000, 500_000, 4), (1_200_000, 500_000, 5),
            (1_100_000, 524_288, 5), (600_000, 131_072, 6),
            (50_000, 777, 7), (2_000_000, 300_007, 8),
            (20_000, 150, 5), (1_120_000, 16, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,c,r", K2_CASES)
@pytest.mark.parametrize("kind", ["randn", "zeroed"])
def test_decode_matches_plain_on_card(cuda, d, c, r, kind):
    """K2 gives its plain version's bits (``chip_smoke.same_bits``: -0 is
    not +0) on a randn table and on one with zeroed cells, -0 and NaN,
    whatever the tile, seam, block and grid geometry."""
    ts = make_circulant_sketch(d, c, r, device=cuda)
    rng = np.random.RandomState(d + c + r)
    table = (rng.randn(r, c).astype(np.float32) if kind == "randn"
             else chip_smoke.zeroed_table(r, c, seed=c + r))
    table = torch.from_numpy(table).to(cuda)
    args = (ts.shifts, ts.sign_keys, c, r, ts.m)
    kernels.reset_launches()
    got = kernels.decode(table, *args, d)
    torch.cuda.synchronize()
    assert kernels.launches["circ_decode"] == 1
    assert chip_smoke.same_bits(got, kernels.decode_plain(table, *args, d))


def test_decode_range_plain_is_the_slice_of_the_whole_decode():
    """K2's range form on the CPU (the gather form): the whole decode's
    slice below d, +0.0 at and past d (also past the m c coordinates),
    no launch."""
    for d, c, r in ((20_000, 4000, 5), (19_999, 4096, 2), (1_000, 64, 3)):
        ts = make_circulant_sketch(d, c, r, device="cpu")
        table = torch.from_numpy(np.random.RandomState(d).randn(
            r, c).astype(np.float32))
        args = (ts.shifts, ts.sign_keys, c, r, ts.m)
        whole = kernels.decode_plain(table, *args, d)
        kernels.reset_launches()
        for start, n in ((0, d), (7, 1234), (d - 5, 40), (d + 3, 9),
                         (ts.m * c - 2, 6)):
            got = kernels.decode(table, *args, d, start=start, n=n)
            live = max(0, min(n, d - start))
            assert chip_smoke.same_bits(got[:live], whole[start:start + live])
            assert chip_smoke.same_bits(got[live:],
                                        torch.zeros(n - live))
        assert kernels.launches["circ_decode"] == 0


# shards of d_pad = ceil(d / n) n for n = 4 and 8 (the sharded server
# tail's ranges), on K2_CASES geometries: a shard inside a block, one
# across the blocks' seams, the last shard past d
K2_RANGE_CASES = [(20_000, 4000, 1), (19_999, 4096, 2),
                  (1_200_000, 500_000, 5), (1_100_000, 524_288, 5),
                  (50_000, 777, 7), (2_000_000, 300_007, 8),
                  (1_120_000, 16, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,c,r", K2_RANGE_CASES)
@pytest.mark.parametrize("n", [1, 4, 8])
def test_decode_range_matches_plain_on_card(cuda, d, c, r, n):
    """K2's range form: each shard bitwise its plain version (the whole
    decode's slice, +0.0 past d), one launch a shard counted in
    ``range_launches``, and the shards together bitwise the whole
    decode (n = 1: the range form over [0, d_pad), a sharded tail on
    one rank)."""
    ts = make_circulant_sketch(d, c, r, device=cuda)
    table = torch.from_numpy(chip_smoke.zeroed_table(r, c, seed=c + r)
                             ).to(cuda)
    args = (ts.shifts, ts.sign_keys, c, r, ts.m)
    blk = -(-d // n)
    kernels.reset_launches()
    shards = [kernels.decode(table, *args, d, start=i * blk, n=blk)
              for i in range(n)]
    whole = kernels.decode(table, *args, d)
    torch.cuda.synchronize()
    assert kernels.launches["circ_decode"] == n + 1
    assert kernels.range_launches["circ_decode"] == n
    cat = torch.cat(shards)
    assert chip_smoke.same_bits(cat[:d], whole)
    assert chip_smoke.same_bits(cat[d:], torch.zeros(n * blk - d,
                                                     device=cuda))
    plain = kernels.decode_range_plain(table.cpu(), ts.shifts.cpu(),
                                       ts.sign_keys.cpu(), c, r, ts.m, d,
                                       (n > 1) * blk, blk)
    assert chip_smoke.same_bits(shards[n > 1].cpu(), plain)


# (d, c, r): m = 1 (c = d and c above d), m above and not a multiple of
# the 128 blocks whose shifts K1 stages at a time (m = 134 and 129), the
# unaligned c = 500,000 (m = 3), and c = 2,000,000, whose column tiles
# outnumber the CTAs of K1's persistent grid (a CTA takes a second tile);
# r = 1, 5 (4 columns a thread) and 8 (2 columns a thread)
K1_WALKS = [(20_000, 20_000, 5), (20_000, 30_000, 1), (20_000, 150, 5),
            (20_000, 156, 8), (1_200_000, 500_000, 1),
            (1_200_000, 500_000, 5), (1_200_000, 500_000, 8),
            (4_000_000, 2_000_000, 5), (4_000_000, 2_000_000, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,c,r", K1_WALKS)
@pytest.mark.parametrize("accumulate", [False, True])
def test_encode_walk_is_bitwise_on_card(cuda, d, c, r, accumulate):
    """K1 walks the blocks in ascending order for every cell, whatever the
    number of blocks, rows and column tiles: bitwise equal to its plain
    version, fresh and accumulating into a table."""
    ts = make_circulant_sketch(d, c, r, device=cuda)
    rng = np.random.RandomState(d + c + r)
    v = torch.from_numpy(rng.randn(d).astype(np.float32)).to(cuda)
    t0 = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(cuda)
    args = (ts.shifts, ts.sign_keys, c, r, ts.m)
    kernels.reset_launches()
    if accumulate:
        got = kernels.encode(v, *args, scale=0.37, table=t0.clone())
        want = kernels.encode_plain(v, *args, scale=0.37, table=t0)
    else:
        got = kernels.encode(v, *args)
        want = kernels.encode_plain(v, *args)
    torch.cuda.synchronize()
    assert kernels.launches["circ_encode"] == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    ts = make_circulant_sketch(D, 4000, 5, device=cuda)
    v, t0 = _inputs(4000, 5, device=cuda)
    args = (ts.shifts, ts.sign_keys, 4000, 5, ts.m)
    with pytest.raises(ValueError, match="float32"):
        kernels.encode(v.double(), *args)
    with pytest.raises(ValueError, match="table"):
        kernels.encode(v, *args, table=t0[:, :100])
    ts9 = make_circulant_sketch(D, 4000, 9, device=cuda)
    with pytest.raises(ValueError, match="r <= 8"):
        kernels.decode(torch.zeros(9, 4000, device=cuda), ts9.shifts,
                       ts9.sign_keys, 4000, 9, ts9.m, D)
    with pytest.raises(ValueError, match="r <= 8"):
        kernels.encode(v, ts9.shifts, ts9.sign_keys, 4000, 9, ts9.m)


def test_sign_hash_instructions_compute_the_sign_stream():
    """The instructions that K1's and K2's bound counts for a term's sign
    (chip_smoke.SIGN_HASH) compute the port's sign stream, bit for bit,
    over the whole uint32 range of coordinates and keys."""
    from commefficient_torch.ops.hashing import signs
    rng = np.random.RandomState(7)
    x = rng.randint(0, 2**32, 4096, dtype=np.uint64)
    value = rng.randn(4096).astype(np.float32)
    for key in rng.randint(0, 2**32, 8, dtype=np.uint64):
        want = signs(torch.from_numpy(x.astype(np.int64)), int(key))
        got = chip_smoke.sign_hash(x, int(key), value)
        assert np.array_equal(got, value * want.numpy())


@pytest.mark.parametrize("left_out", range(len(chip_smoke.SIGN_HASH)))
def test_each_sign_hash_instruction_is_needed(left_out):
    """No instruction counted for a term's sign can be left out: without
    any one of them some signs change."""
    rng = np.random.RandomState(8)
    x = rng.randint(0, 2**32, 4096, dtype=np.uint64)
    value = np.ones(4096, np.float32)
    ops = chip_smoke.SIGN_HASH
    fewer = ops[:left_out] + ops[left_out + 1:]
    key = 0x2545F491
    assert not np.array_equal(chip_smoke.sign_hash(x, key, value, fewer),
                              chip_smoke.sign_hash(x, key, value, ops))


@pytest.mark.parametrize("shape,m,kind", [
    ((6_568_640, 500_736, 5), 14, "bytes"),
    ((92_138_496, 524_288, 5), 176, "instruction issue")])
def test_sketch_bound_counts_integer_issue(shape, m, kind):
    """K1's and K2's bound in chip_smoke.py counts what every (row,
    coordinate) term needs by pipe: the sign's instructions of SIGN_HASH
    (5 ALU, 2 IMAD, 1 on either pipe), for K1 one index step (either),
    for K2 its share of the median network (MEDIAN_NETS[5], 10 min/max on
    the ALU: 2 a term), plus the term's share of loads, stores and float
    adds. K1 (``kind``): at m = 176 the 128 instructions an SM issues a
    clock bound it, above the bytes and above the ALU's own 64 lanes; at
    m = 14 the bytes do. K2: its 7 ALU instructions a term bound it at
    both, 0.193 ms at m = 176 and 0.0137 ms at m = 14."""
    d, c, r = shape
    assert -(-d // c) == m
    per_clock = chip_smoke.H100_SMS * chip_smoke.H100_CLOCK_HZ
    assert 256 * per_clock == pytest.approx(67e12)
    need = chip_smoke.term_instructions(0)
    assert (need["alu"], need["imad"], need["either"]) == (5, 2, 2)
    work = chip_smoke.sketch_work(d, c, r)
    nbytes, ops, instr = work["circ_encode"]
    other = 1 + 2 / r
    assert instr == pytest.approx(
        {p: n * r * d for p, n in
         chip_smoke.term_instructions(other).items()})
    ms, got = chip_smoke.bound(nbytes, ops, chip_smoke.H100_FP32_PER_S,
                               instr)
    assert got == kind
    issue_ms = 1e3 * (9 + other) * r * d / (128 * per_clock)
    assert ms == pytest.approx(max(
        issue_ms, 1e3 * nbytes / chip_smoke.H100_BYTES_PER_S))
    assert issue_ms > 1e3 * 5 * r * d / (64 * per_clock)

    nbytes, ops, instr = work["circ_decode"]
    assert len(chip_smoke.MEDIAN_NETS[r]) == 10 and ops == 0
    assert instr == pytest.approx({"alu": 7 * r * d, "imad": 2 * r * d,
                                   "either": r * d,
                                   "other": (1 + 1 / r) * r * d})
    ms, got = chip_smoke.bound(nbytes, ops, chip_smoke.H100_FP32_PER_S,
                               instr)
    assert got == "ALU issue"
    assert ms == pytest.approx(1e3 * 7 * r * d / (64 * per_clock))
    assert ms == pytest.approx({14: 0.0137, 176: 0.193}[m], rel=5e-3)
    assert ms > 1e3 * nbytes / chip_smoke.H100_BYTES_PER_S


def test_bound_names_what_bounds_it():
    """The bound is the largest of bytes, float operations and, where
    instructions are given, the ALU's, the IMAD pipe's and the issue's
    time, named by kind; the kernel line's bound_by folds every kind but
    bytes into "operations"."""
    fp32, bf16 = chip_smoke.H100_FP32_PER_S, chip_smoke.H100_BF16_PER_S
    per_clock = chip_smoke.H100_SMS * chip_smoke.H100_CLOCK_HZ
    assert chip_smoke.bound(3.35e9, 1e9, bf16) == pytest.approx(
        (1.0, "bytes"))
    assert chip_smoke.bound(1e6, 989e9, bf16) == pytest.approx(
        (1.0, "bf16 operations"))
    assert chip_smoke.bound(1e6, 67e9, fp32)[1] == "fp32 operations"
    alu = {"alu": 64 * per_clock, "imad": 0, "either": 0, "other": 0}
    assert chip_smoke.bound(1e6, 1e6, fp32, alu) == pytest.approx(
        (1e3, "ALU issue"))
    imad = {"alu": 0, "imad": 64 * per_clock, "either": 0, "other": 0}
    assert chip_smoke.bound(1e6, 1e6, fp32, imad)[1] == "IMAD issue"
    spread = {"alu": 0, "imad": 0, "either": 64 * per_clock,
              "other": 64 * per_clock}
    assert chip_smoke.bound(1e6, 1e6, fp32, spread) == pytest.approx(
        (1e3, "instruction issue"))
    assert [chip_smoke.bound_by(k) for k in ("bytes", "ALU issue")] == [
        "bytes", "operations"]


_SPECIALS = np.array([0.0, -0.0, 1.0, -1.0, np.nan], np.float32)


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def _jax_median_axis0():
    """The JAX package's median_axis0, imported here (this file runs
    without JAX too; the test skips where the JAX package cannot be
    imported)."""
    pytest.importorskip("jax")
    try:
        topk = importlib.import_module("commefficient_tpu.ops.topk")
    except ImportError as e:
        pytest.skip(f"the JAX package does not import here: {e}")
    return topk.median_axis0


@pytest.mark.parametrize("r", range(1, 9))
def test_median_nets_match_the_jax_median_bitwise(r):
    """Each K2 median network (chip_smoke.MEDIAN_NETS) gives the bits of
    the JAX package's median_axis0, and of the port's, on every r-row
    column over {+0, -0, 1, -1, NaN}: signed zeros, ties and NaN. JAX runs
    on its CPU device, as the JAX package's tests do (a card's float units
    return another NaN payload)."""
    jax_median = _jax_median_axis0()
    import jax
    from commefficient_torch.ops.topk import median_axis0
    x = _SPECIALS[np.indices((len(_SPECIALS),) * r).reshape(r, -1)]
    got = _bits(chip_smoke.median_net(x, chip_smoke.MEDIAN_NETS[r]))
    with jax.default_device(jax.devices("cpu")[0]):
        want = _bits(jax_median(jax.numpy.asarray(x)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _bits(median_axis0(torch.from_numpy(x))))


@pytest.mark.parametrize("r", range(3, 9))
def test_each_median_net_operation_is_needed(r):
    """No min/max of a median network can go: with any one of them left
    out (its value taken as either operand), some 0/1 column gets a wrong
    median. A network of min/max is a median on every input if it is one
    on every 0/1 input, so these columns decide it."""
    x = ((np.arange(2 ** r)[None, :] >> np.arange(r)[:, None]) & 1).astype(
        np.float32)
    ops = chip_smoke.MEDIAN_NETS[r]
    want = np.sort(x, axis=0)
    want = want[r // 2] if r % 2 else 0.5 * (want[r // 2 - 1] + want[r // 2])
    assert np.array_equal(chip_smoke.median_net(x, ops), want)
    for k, (_, a, b) in enumerate(ops):
        for keep in (a, b):
            fewer = ops[:k] + (("max", keep, keep),) + ops[k + 1:]
            assert not np.array_equal(chip_smoke.median_net(x, fewer),
                                      want), (k, keep)


def test_kernel_holds_the_median_nets():
    """csrc/circulant.cu MedianNet<R> holds the operations of
    chip_smoke.MEDIAN_NETS[R], in order, for R = 1 .. 8: the bound counts
    the network the kernel runs."""
    src = open(os.path.join(os.path.dirname(kernels.__file__), os.pardir,
                            "csrc", kernels.SOURCE)).read()
    for r, ops in chip_smoke.MEDIAN_NETS.items():
        body = re.search(r"struct MedianNet<%d> \{\s*using type = "
                         r"Net<(.*?)>;\s*\};" % r, src, re.S)
        assert body, r
        got = tuple((kind.lower(), int(a), int(b)) for kind, a, b in
                    re.findall(r"MinMax<k(Min|Max), (\d+), (\d+)>",
                               body.group(1)))
        assert got == ops, r


# a SASS excerpt in cuobjdump's layout: a loop of two sign hashes
# (0x85ebca6b printed as -0x7a143595) behind a branch
_SASS = """\
        /*0000*/                   ISETP.GE.AND P0, PT, R0, R1, PT ;  /* 0x0 */
                                                                      /* 0x0 */
        /*0010*/               @P0 BRA 0x90 ;                         /* 0x0 */
        /*0020*/                   IMAD R2, R3, R4, -0x61c88647 ;     /* 0x0 */
        /*0030*/                   SHF.R.U32.HI R5, RZ, 0x10, R2 ;    /* 0x0 */
        /*0040*/                   LOP3.LUT R2, R5, R2, RZ, 0x3c, !PT ;
        /*0050*/                   IMAD R2, R2, -0x7a143595, RZ ;     /* 0x0 */
        /*0060*/                   IMAD R6, R6, -0x7a143595, RZ ;     /* 0x0 */
        /*0070*/                   LDG.E.CONSTANT R7, desc[UR8][R8.64] ;
        /*0080*/                   FADD R9, R9, R7 ;                  /* 0x0 */
        /*0090*/                   IADD3 R0, R0, 0x1, RZ ;            /* 0x0 */
        /*00a0*/              @!P0 BRA 0x20 ;                         /* 0x0 */
        /*00b0*/                   EXIT ;                             /* 0x0 */
"""


def test_sass_reading_splits_blocks_and_counts_by_pipe():
    """chip_smoke's SASS reading: blocks end at each branch and start at
    each branch target; the block with the most hashes is counted by pipe
    per hash."""
    lines = _SASS.splitlines()
    blocks = chip_smoke.sass_blocks(lines)
    assert [[op.split(".")[0] for op, _ in b] for b in blocks] == [
        ["ISETP", "BRA"], ["IMAD", "SHF", "LOP3", "IMAD", "IMAD", "LDG",
                           "FADD"], ["IADD3", "BRA"], ["EXIT"]]
    per, hashes = chip_smoke.sass_per_term(lines)
    assert hashes == 2
    assert per == {"alu": 1.0, "imad": 1.5, "fp32": 0.5, "memory": 0.5,
                   "other": 0.0}


# ------------------------------------------------------------------ K3


def _qkv(N, S, H, D=64, seed=0, device="cpu", dtype=torch.bfloat16):
    """q, k, v as the three (N, S, H, D) slices of one (N, S, 3 H D)
    buffer, the layout the model hands the kernels, and an output
    gradient."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(N, S, 3 * H * D).astype(np.float32))
    do = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32))
    qkv, do = qkv.to(device, dtype), do.to(device, dtype)
    q, k, v = (t.view(N, S, H, D) for t in qkv.split(H * D, dim=-1))
    return q, k, v, do


def _worst_row_error(got, ref) -> float:
    return float(chip_smoke.row_errors(got, ref).max())


def _kernel_rounding(q, k, v, do):
    """The plain versions with the kernels' bf16 rounding: p (before
    ``p v`` and ``p^T dO``) and ds (before ``ds k`` and ``ds^T q``) round
    to bf16, every product accumulates in float32, and the outputs round
    to bf16. Returns ``(o, dq, dk, dv)``."""
    bf = lambda t: t.bfloat16().float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    o_ref, lse = flash.forward_plain(q, k, v)
    p = torch.exp(flash._causal_scores(q, k) - lse[..., None])
    o = torch.einsum("nhqk,nkhd->nqhd", bf(p), v.float()).bfloat16()
    delta = chip_smoke.plain_delta(o, do)
    dp = torch.einsum("nqhd,nkhd->nhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("nhqk,nkhd->nqhd", bf(ds), k.float()) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", bf(ds), q.float()) * scale
    dv = torch.einsum("nhqk,nqhd->nkhd", bf(p), do.float())
    return o, dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("S", [128, 256])
def test_planted_fault_helper_is_the_plain_attention_without_drops(S):
    """``chip_smoke.attention_skipping`` with nothing dropped computes what
    the plain versions compute, so a planted fault differs from them only
    by the pairs it drops."""
    q, k, v, do = _qkv(2, S, 2, D=64, dtype=torch.float32)
    none = torch.zeros(S, S, dtype=torch.bool)
    o, lse = chip_smoke.attention_skipping(q, k, v, none)
    o_ref, lse_ref = flash.forward_plain(q, k, v)
    torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-6, atol=1e-6)
    got = chip_smoke.attention_skipping(q, k, v, none, do, lse_ref,
                                        chip_smoke.plain_delta(o_ref, do))
    for g, want in zip(got, flash.backward_plain(q, k, v, o_ref, lse_ref,
                                                 do)):
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)


# (S, D): GPT-2's head width under the ids the cases had before other
# widths joined them, and the widths of the other wgmma backward kernels
ROW_CHECK_CASES = [pytest.param(S, D, id=str(S) if D == 64 else f"{S}-d{D}")
                   for D in (64, 16, 32, 128) for S in (128, 256)]


@pytest.mark.parametrize("S,D", ROW_CHECK_CASES)
def test_row_check_admits_kernel_rounding_and_rejects_planted_faults(S, D):
    """The K3 check of chip_smoke.py and of the cuda tests, at each head
    width of flash_attention.cu's bf16 backward: the kernels' bf16
    rounding stays within FLASH_ROW_RTOL of each row's norm (about a third
    of it), while each planted fault (the forward or dq kernel skipping
    key tile 0 for the second half's rows, the dk/dv kernel skipping the
    last query tile) exceeds it in some row."""
    q, k, v, do = _qkv(2, S, 2, D=D)
    o_ref, lse_ref = flash.forward_plain(q, k, v)
    o, dq, dk, dv = _kernel_rounding(q, k, v, do)
    refs = flash.backward_plain(q, k, v, o, lse_ref, do)
    rounding = [_worst_row_error(o, o_ref)] + [
        _worst_row_error(g, want) for g, want in zip((dq, dk, dv), refs)]
    assert max(rounding) <= chip_smoke.FLASH_ROW_RTOL / 2, rounding

    drops = chip_smoke.planted_drops(S, "cpu")
    o_f, lse_f = chip_smoke.attention_skipping(q, k, v, drops["flash_fwd"])
    assert _worst_row_error(o_f, o_ref) > 10 * chip_smoke.FLASH_ROW_RTOL
    assert float((lse_f - lse_ref).abs().max()) > \
        100 * chip_smoke.FLASH_LSE_ATOL
    faults = chip_smoke.planted_backward(q, k, v, do, o, lse_ref, drops)
    for name, want in zip(("dq", "dk", "dv"), refs):
        got = faults["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"]
        assert _worst_row_error(got[name], want) > \
            10 * chip_smoke.FLASH_ROW_RTOL


def test_flash_wrappers_take_plain_version_on_cpu_without_launching():
    q, k, v, do = _qkv(2, 128, 2, D=16, dtype=torch.float32)
    flash.reset_launches()
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = flash.flash_attention(qg, kg, vg)
    o.backward(do)
    o_ref, lse = flash.forward_plain(q, k, v)
    assert torch.equal(o.detach(), o_ref)
    grads = flash.backward_plain(q, k, v, o_ref, lse, do)
    for got, want in zip((qg.grad, kg.grad, vg.grad), grads):
        assert torch.equal(got, want)
    assert set(flash.launches) >= {"flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "flash_fwd_f32_d16"}
    assert not any(flash.launches.values())


# (N, S, H): S = 64 and 192 end in a partial 128-row tile of the forward
# and dk/dv kernels; N H = 144 work items (S = 128) exceed the H100's 132
# SMs, so a CTA of the persistent kernels takes a second item; the last is
# the GPT-2 main path's shape.
FLASH_CARD_SHAPES = [(2, 128, 3), (1, 256, 2), (3, 64, 1), (2, 192, 3),
                     (12, 128, 12), (8, 1024, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,H", FLASH_CARD_SHAPES)
def test_flash_kernels_match_plain_on_card(cuda, N, S, H):
    """bf16 in, float32 accumulation: each row of o, dq, dk and dv within
    ``chip_smoke.FLASH_ROW_RTOL`` of its own norm (the kernels round p and
    ds to bf16 as product operands, the plain version does not); lse
    within ``chip_smoke.FLASH_LSE_ATOL``."""
    q, k, v, do = _qkv(N, S, H, device=cuda)
    flash.reset_launches()
    o, lse = flash.forward(q, k, v)
    dq, dk, dv = flash.backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert chip_smoke.nonzero(flash.launches) == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    o_ref, lse_ref = flash.forward_plain(q, k, v)
    assert float((lse - lse_ref).abs().max()) <= chip_smoke.FLASH_LSE_ATOL
    assert _worst_row_error(o, o_ref) <= chip_smoke.FLASH_ROW_RTOL
    for got, want in zip((dq, dk, dv),
                         flash.backward_plain(q, k, v, o, lse_ref, do)):
        assert _worst_row_error(got, want) <= chip_smoke.FLASH_ROW_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,H", [(2, 192, 3), (12, 128, 12)])
def test_flash_redesigned_kernels_are_deterministic_on_card(cuda, N, S, H):
    """The forward, dq and dk/dv kernels write each output element once,
    with no atomics: two calls give the same bits, delta included."""
    q, k, v, do = _qkv(N, S, H, device=cuda)
    o, lse = flash.forward(q, k, v)
    dq, delta = flash.backward_dq(q, k, v, o, lse, do)
    dk, dv = flash.backward_dkv(q, k, v, do, lse, delta)
    o2, lse2 = flash.forward(q, k, v)
    dq2, delta2 = flash.backward_dq(q, k, v, o, lse, do)
    dk2, dv2 = flash.backward_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for a, b in ((o, o2), (lse, lse2), (dq, dq2), (delta, delta2),
                 (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 192, 256])
def test_flash_dkv_matches_plain_from_the_delta_dq_wrote(cuda, S):
    """flash_bwd_dq writes delta = rowsum(dO o) for flash_bwd_dkv, which
    runs after it on the same stream: that delta matches the plain one,
    and dk and dv computed from it match the plain backward."""
    q, k, v, do = _qkv(2, S, 3, device=cuda)
    o, lse = flash.forward(q, k, v)
    dq, delta = flash.backward_dq(q, k, v, o, lse, do)
    dk, dv = flash.backward_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, chip_smoke.plain_delta(o, do),
                               rtol=1e-5, atol=1e-4)
    _, dk_ref, dv_ref = flash.backward_plain(q, k, v, o, lse, do)
    assert _worst_row_error(dk, dk_ref) <= chip_smoke.FLASH_ROW_RTOL
    assert _worst_row_error(dv, dv_ref) <= chip_smoke.FLASH_ROW_RTOL


@pytest.mark.cuda
def test_flash_wrappers_reject_bad_inputs(cuda):
    """A form outside the route table raises by name, and nothing falls
    back; float32 and D = 32, once refused, run their own routes."""
    q, k, v, _ = _qkv(1, 128, 2, device=cuda)
    with pytest.raises(ValueError, match="dtype torch.float16"):
        flash.forward(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head width D = 8"):
        flash.forward(*(t[..., :8] for t in (q, k, v)))
    with pytest.raises(ValueError, match="multiple of 64"):
        flash.forward(*(t[:, :100] for t in (q, k, v)))
    flash.reset_launches()
    flash.forward(q.float(), k.float(), v.float())
    flash.forward(*(t[..., :32] for t in (q, k, v)))
    assert chip_smoke.nonzero(flash.launches) == {"flash_fwd_f32_d64": 1,
                                                  "flash_fwd_bf16_d32": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "tie_heavy", "one_cell"])
def test_cell_sum_on_card_is_the_plain_version(cuda, kind):
    """The ordered cell sum's kernel against its plain version on the CPU,
    by int32 views with NaN by position (``chip_smoke.same_bits``): k =
    5,000 random coordinates, ``chip_smoke.tie_heavy_sparse`` (cancelling
    pairs, -0.0 first, inf, NaN), and every addend of a row in one cell;
    one launch a call, two calls the same bits, no host sync."""
    from commefficient_torch.ops.circulant import ordered_cell_sum
    c, r, k = 4000, 5, 5000
    ts = make_circulant_sketch(D, c, r, device=cuda)
    cpu = make_circulant_sketch(D, c, r, device="cpu")
    rng = np.random.RandomState(11)
    if kind == "one_cell":
        buckets = torch.zeros((r, k), dtype=torch.int64)
        addends = torch.from_numpy(rng.randn(r, k).astype(np.float32))
        want = ordered_cell_sum(buckets, addends, c)
        gb, ga = buckets.to(cuda), addends.to(cuda)
        run = lambda: ordered_cell_sum(gb, ga, c)
    else:
        if kind == "random":
            idx = rng.permutation(D)[:k]
            vals = rng.randn(k).astype(np.float32)
        else:
            idx, vals = chip_smoke.tie_heavy_sparse(D, k, seed=3)
        idx, vals = torch.from_numpy(idx), torch.from_numpy(vals)
        want = cpu.encode_vals_at(vals, idx)
        gv, gi = vals.to(cuda), idx.to(cuda)
        run = lambda: ts.encode_vals_at(gv, gi)
    kernels.reset_launches()
    got = run()
    assert chip_smoke.host_syncs(run) == []
    again = run()
    torch.cuda.synchronize()
    assert kernels.launches == {"circ_encode": 0, "circ_decode": 0,
                                "cell_sum": 3}
    assert chip_smoke.same_bits(got.cpu(), want)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
