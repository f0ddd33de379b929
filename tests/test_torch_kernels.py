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

import math

import numpy as np
import pytest
import torch

import chip_smoke
from commefficient_torch.ops import circulant_kernels as kernels
from commefficient_torch.ops import flash_attention as flash
from commefficient_torch.ops.circulant import make_circulant_sketch

D = 20_000


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
    assert kernels.launches == {"circ_encode": 0, "circ_decode": 0}
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
    assert kernels.launches == {"circ_encode": 2, "circ_decode": 1}
    assert torch.equal(got, kernels.encode_plain(v, *args))
    assert torch.equal(got_acc, kernels.encode_plain(v, *args, scale=3.0,
                                                     table=t0))
    assert torch.equal(dec, kernels.decode_plain(t0, *args, D))


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    ts = make_circulant_sketch(D, 4000, 5, device=cuda)
    v, t0 = _inputs(4000, 5, device=cuda)
    args = (ts.shifts, ts.sign_keys, 4000, 5, ts.m)
    with pytest.raises(ValueError, match="float32"):
        kernels.encode(v.double(), *args)
    with pytest.raises(ValueError, match="table"):
        kernels.encode(v, *args, table=t0[:, :100])
    with pytest.raises(ValueError, match="r <= 8"):
        ts9 = make_circulant_sketch(D, 4000, 9, device=cuda)
        kernels.decode(torch.zeros(9, 4000, device=cuda), ts9.shifts,
                       ts9.sign_keys, 4000, 9, ts9.m, D)


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


@pytest.mark.parametrize("S", [128, 256])
def test_row_check_admits_kernel_rounding_and_rejects_planted_faults(S):
    """The K3 check of chip_smoke.py and of the cuda tests: the kernels'
    bf16 rounding stays within FLASH_ROW_RTOL of each row's norm (about a
    third of it), while each planted fault (the forward or dq kernel
    skipping key tile 0 for the second half's rows, the dk/dv kernel
    skipping the last query tile) exceeds it in some row."""
    q, k, v, do = _qkv(2, S, 2)
    o_ref, lse_ref = flash.forward_plain(q, k, v)
    o, dq, dk, dv = _kernel_rounding(q, k, v, do)
    refs = flash.backward_plain(q, k, v, o, lse_ref, do)
    rounding = [_worst_row_error(o, o_ref)] + [
        _worst_row_error(g, want) for g, want in zip((dq, dk, dv), refs)]
    assert max(rounding) <= chip_smoke.FLASH_ROW_RTOL / 2, rounding

    drops = chip_smoke.planted_drops(S, "cpu")
    delta = chip_smoke.plain_delta(o, do)
    o_f, lse_f = chip_smoke.attention_skipping(q, k, v, drops["flash_fwd"])
    assert _worst_row_error(o_f, o_ref) > 10 * chip_smoke.FLASH_ROW_RTOL
    assert float((lse_f - lse_ref).abs().max()) > \
        100 * chip_smoke.FLASH_LSE_ATOL
    dq_f = chip_smoke.attention_skipping(q, k, v, drops["flash_bwd_dq"], do,
                                         lse_ref, delta)[0]
    assert _worst_row_error(dq_f, refs[0]) > 10 * chip_smoke.FLASH_ROW_RTOL
    _, dk_f, dv_f = chip_smoke.attention_skipping(
        q, k, v, drops["flash_bwd_dkv"], do, lse_ref, delta)
    assert _worst_row_error(dk_f, refs[1]) > 10 * chip_smoke.FLASH_ROW_RTOL
    assert _worst_row_error(dv_f, refs[2]) > 10 * chip_smoke.FLASH_ROW_RTOL


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
    assert flash.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                              "flash_bwd_dkv": 0}


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
    assert flash.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                              "flash_bwd_dkv": 1}
    o_ref, lse_ref = flash.forward_plain(q, k, v)
    assert float((lse - lse_ref).abs().max()) <= chip_smoke.FLASH_LSE_ATOL
    assert _worst_row_error(o, o_ref) <= chip_smoke.FLASH_ROW_RTOL
    for got, want in zip((dq, dk, dv),
                         flash.backward_plain(q, k, v, o, lse_ref, do)):
        assert _worst_row_error(got, want) <= chip_smoke.FLASH_ROW_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("N,S,H", [(2, 192, 3), (12, 128, 12)])
def test_flash_redesigned_kernels_are_deterministic_on_card(cuda, N, S, H):
    """The forward and dk/dv kernels write each output element once, with
    no atomics: two calls give the same bits."""
    q, k, v, do = _qkv(N, S, H, device=cuda)
    o, lse = flash.forward(q, k, v)
    _, delta = flash.backward_dq(q, k, v, o, lse, do)
    dk, dv = flash.backward_dkv(q, k, v, do, lse, delta)
    o2, lse2 = flash.forward(q, k, v)
    dk2, dv2 = flash.backward_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    for a, b in ((o, o2), (lse, lse2), (dk, dk2), (dv, dv2)):
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
    q, k, v, _ = _qkv(1, 128, 2, device=cuda)
    with pytest.raises(ValueError, match="compute_dtype float32"):
        flash.forward(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head width"):
        flash.forward(*(t[..., :32] for t in (q, k, v)))
    with pytest.raises(ValueError, match="multiple of 64"):
        flash.forward(*(t[:, :100] for t in (q, k, v)))
