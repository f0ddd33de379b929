"""K3, the causal flash attention of the PyTorch port
(ops/flash_attention.py), against the JAX package on the CPU.

The JAX package's ``flash_causal_attention`` runs
``dense_causal_attention`` off a TPU (models/gpt2.py:118-128), so that is
the reference: the port's plain forward must equal it, and the gradients
through the port's ``torch.autograd.Function`` (on the CPU: the plain,
explicit backward from the saved log-sum-exp) must equal ``jax.grad`` of
it. float32 to 1e-5 relative (only the order of float additions differs);
bf16 inputs to 4 bf16 ulps of the output's largest element (the JAX
function rounds the scores and the probabilities to bf16, the plain
version keeps both in float32). The tests marked ``cuda`` hold the
kernels behind the same Function against the plain versions on the card,
each output row against its own norm (``chip_smoke.py``'s rule); the JAX
package is imported inside a fixture, so they also run where it does not
import:

    python -m pytest --noconftest tests/test_torch_attention.py
"""

import math
import warnings

import numpy as np
import pytest
import torch

from commefficient_torch.models import gpt2 as tgpt2
from commefficient_torch.ops import flash_attention as flash

import torch_mesh_ranks as ranks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: the emulations of the
    tensor cores' sums below loop over many small float64 operations,
    which more threads only spin on while the run's other workers share
    the machine's cores."""
    with ranks.one_thread():
        yield


@pytest.fixture(scope="module")
def ref():
    """``(jax, jax.numpy, the JAX package's models.gpt2)``."""
    jax = pytest.importorskip("jax")
    try:
        from commefficient_tpu.models import gpt2 as jgpt2
    except ImportError as e:
        pytest.skip(f"the JAX package does not import here ({e})")
    return jax, jax.numpy, jgpt2


SHAPES = [(2, 128, 2, 16), (1, 256, 3, 32), (2, 128, 1, 64), (1, 128, 1, 128)]


def _inputs(N, S, H, D, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(N, S, H, D).astype(np.float32) for _ in range(4)]


# bf16 gradients against the JAX package's bf16 backward: the largest
# error read on the CPU at D = 16 and 128 was 0.29% to 0.62% of each
# gradient's largest element (about one bf16 ulp there, 2^-8 = 0.39%):
# four ulps
BF16_GRAD_RTOL = 4 * 2.0 ** -8


def _ulps(ref: np.ndarray, n: int) -> float:
    """``n`` bf16 units in the last place at ref's largest magnitude."""
    return n * 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("N,S,H,D", SHAPES)
def test_plain_forward_matches_jax_dense_f32(ref, N, S, H, D):
    _, jnp, jgpt2 = ref
    q, k, v, _ = _inputs(N, S, H, D)
    want = np.asarray(jgpt2.dense_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    o, lse = flash.forward_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), want, rtol=1e-5, atol=1e-6)
    # lse is the log normaliser of each row: logsumexp of the masked
    # scaled scores, computed here by numpy in float64
    s = np.einsum("nqhd,nkhd->nhqk", q.astype(np.float64), k) / math.sqrt(D)
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    top = s.max(-1)
    lse_ref = top + np.log(np.exp(s - top[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,S,H,D", SHAPES)
def test_plain_forward_tracks_jax_dense_bf16(ref, N, S, H, D):
    _, jnp, jgpt2 = ref
    q, k, v, _ = _inputs(N, S, H, D, seed=1)
    want = np.asarray(jgpt2.dense_causal_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))).astype(
            np.float32)
    o, _ = flash.forward_plain(*(torch.from_numpy(t).bfloat16()
                                 for t in (q, k, v)))
    assert o.dtype == torch.bfloat16
    assert np.abs(o.float().numpy() - want).max() <= _ulps(want, 4)


@pytest.mark.parametrize("N,S,H,D", SHAPES)
def test_gradients_match_jax_grad(ref, N, S, H, D):
    """dq, dk, dv through the autograd.Function (plain backward on the
    CPU) against jax.grad of <dense_causal_attention(q, k, v), dO>."""
    jax, jnp, jgpt2 = ref
    q, k, v, do = _inputs(N, S, H, D, seed=2)

    def objective(q, k, v):
        return (jgpt2.dense_causal_attention(q, k, v) * jnp.asarray(do)).sum()

    refs = jax.grad(objective, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = flash.flash_attention(*ts)
    o.backward(torch.from_numpy(do))
    for t, want in zip(ts, refs):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("N,S,H,D", [SHAPES[3]])
def test_gradients_track_jax_grad_bf16(ref, N, S, H, D):
    """bf16 q, k, v, dO: dq, dk, dv through the autograd.Function (plain
    backward, float32 inside, outputs rounded to bf16) against jax.grad of
    the JAX package's bf16 ``dense_causal_attention``, each gradient
    within BF16_GRAD_RTOL of its largest element (the JAX function rounds
    the scores, the probabilities and every product of its backward to
    bf16; the plain version rounds only its outputs)."""
    jax, jnp, jgpt2 = ref
    q, k, v, do = (t.astype(np.float32) for t in _inputs(N, S, H, D, seed=5))
    jb = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, do)]

    def objective(q, k, v):
        o = jgpt2.dense_causal_attention(q, k, v)
        return (o.astype(jnp.float32) * jb[3].astype(jnp.float32)).sum()

    refs = jax.grad(objective, argnums=(0, 1, 2))(*jb[:3])
    ts = [torch.from_numpy(t).bfloat16().requires_grad_(True)
          for t in (q, k, v)]
    o = flash.flash_attention(*ts)
    o.backward(torch.from_numpy(do).bfloat16())
    for t, want in zip(ts, refs):
        want = np.asarray(want).astype(np.float32)
        assert t.grad.dtype == torch.bfloat16
        err = np.abs(t.grad.float().numpy() - want).max()
        assert err <= BF16_GRAD_RTOL * np.abs(want).max()


@pytest.mark.parametrize("dtype,D,names", [
    (torch.bfloat16, 64, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    *[(torch.bfloat16, D, tuple(f"flash_{k}_bf16_d{D}"
                                for k in ("fwd", "bwd_dq", "bwd_dkv")))
      for D in (16, 32, 128)],
    *[(torch.float32, D, tuple(f"flash_{k}_f32_d{D}"
                               for k in ("fwd", "bwd_dq", "bwd_dkv")))
      for D in (16, 32, 64, 128)]])
def test_route_table_names_each_form(dtype, D, names):
    """Each (dtype, D) the card takes maps to its kernels, the names
    ``launches`` counts them under and the library of each: bf16 at D =
    32, 64 and 128 all three to flash_attention.cu's wgmma kernels; bf16
    at D = 16 (``GPT2Config.small``'s) the forward to flash_tiled.cu, dq
    and dk/dv to flash_attention.cu; every float32 form all three to
    flash_tiled.cu."""
    r = flash.route(dtype, D)
    assert r.names == names
    fa, tiled = "flash_attention.cu", "flash_tiled.cu"
    if dtype == torch.bfloat16 and D != 16:
        want = (fa, fa, fa)
    elif dtype == torch.bfloat16:
        want = (tiled, fa, fa)
    else:
        want = (tiled, tiled, tiled)
    assert r.sources == want
    assert [r.source_of(n) for n in names] == list(want)
    assert set(names) <= set(flash.launches)


def _entry_points(source: str) -> set:
    """The ``extern "C"`` functions a ``csrc/`` source defines: those
    written out and those its macros define where the file invokes them
    (parameters substituted, ``##`` pasted, macros inside macros
    expanded), read from the text without a compiler."""
    import os
    import re
    with open(os.path.join(flash._build.CSRC_DIR, source)) as f:
        text = f.read().replace("\\\n", " ")
    macros, body_lines = {}, []
    for line in text.splitlines():
        m = re.match(r"#define (\w+)\(([^)]*)\)(.*)", line)
        if m:
            params = [p.strip() for p in m.group(2).split(",")]
            macros[m.group(1)] = (params, m.group(3))
        else:
            body_lines.append(line)

    def expand(code: str, depth: int = 0) -> str:
        assert depth < 8, "macros nested too deeply"

        def one(m):
            params, body = macros[m.group(1)]
            args = dict(zip(params, (a.strip()
                                     for a in m.group(2).split(","))))
            out = re.sub(r"\b(" + "|".join(params) + r")\b",
                         lambda p: args[p.group(1)], body)
            return expand(re.sub(r"\s*##\s*", "", out), depth + 1)

        if not macros:
            return code
        return re.sub(r"\b(" + "|".join(macros) + r")\(([^()]*)\)", one,
                      code)

    return set(re.findall(r'extern "C" int (\w+)\(',
                          expand("\n".join(body_lines))))


def test_route_table_names_kernels_of_their_libraries():
    """Each kernel the route table names is defined in the library it
    names for it, and in no other: read from the sources' ``extern "C"``
    definitions and the macros that write them, so a kernel routed to
    the wrong library fails here, without nvcc (on the card ctypes would
    find no such symbol)."""
    libs = {src: _entry_points(src)
            for src in (flash.SOURCE, flash.TILED_SOURCE)}
    assert {"flash_fwd", "flash_bwd_dq_bf16_d32",
            "flash_fwd_f32_d16"} <= libs[flash.SOURCE] | \
        libs[flash.TILED_SOURCE]
    for (dtype, D), r in flash.ROUTES.items():
        for name, src in zip(r.names, r.sources):
            where = {s for s, names in libs.items() if name in names}
            assert where == {src}, (dtype, D, name, where)
    routed = {n for r in flash.ROUTES.values() for n in r.names}
    kernels = {n for names in libs.values() for n in names
               if not n.endswith("_smem_bytes")}
    assert kernels == routed, kernels ^ routed


def test_sass_checks_mark_each_instantiation_apart():
    """``chip_smoke.py``'s SASS phases check every kernel the route table
    gives each library under a mark of its own: each kernel of
    flash_attention.cu has an entry in ``WGMMA_KERNELS`` naming its own
    instantiation (``ILi<D>E``) and exports its launch's shared memory
    (``<name>_smem_bytes``, which the phase reads); the bf16 forwards of
    flash_tiled.cu are ``ASYNC_KERNELS``'; and no mark is part of
    another, or one instantiation's HGMMA, UTMALDG, registers and spills
    would be counted under another's name."""
    import chip_smoke
    exported = _entry_points(flash.SOURCE)
    by_source = {flash.SOURCE: {}, flash.TILED_SOURCE: {}}
    for (dtype, D), r in flash.ROUTES.items():
        for name, src in zip(r.names, r.sources):
            if src == flash.SOURCE or (dtype, name) == (torch.bfloat16,
                                                         r.fwd):
                by_source[src][name] = D
    assert set(chip_smoke.WGMMA_KERNELS) == set(by_source[flash.SOURCE])
    assert set(chip_smoke.ASYNC_KERNELS) == set(
        by_source[flash.TILED_SOURCE])
    for marks, kernels in ((chip_smoke.WGMMA_KERNELS,
                            by_source[flash.SOURCE]),
                           (chip_smoke.ASYNC_KERNELS,
                            by_source[flash.TILED_SOURCE])):
        for name, D in kernels.items():
            assert marks[name].endswith(f"ILi{D}E"), (name, marks[name])
    for name in by_source[flash.SOURCE]:
        assert f"{name}_smem_bytes" in exported
    marks = [*chip_smoke.WGMMA_KERNELS.values(),
             *chip_smoke.ASYNC_KERNELS.values()]
    assert not [(a, b) for a in marks for b in marks if a != b and a in b]


@pytest.mark.parametrize("dtype,D,match", [
    (torch.float16, 64, "dtype torch.float16"),
    (torch.float64, 32, "dtype torch.float64"),
    (torch.bfloat16, 8, "head width D = 8"),
    (torch.float32, 96, "head width D = 96"),
    (torch.bfloat16, 256, "head width D = 256")])
def test_route_table_refuses_other_forms_by_name(dtype, D, match):
    """A form outside the table raises, naming it (no fallback to SDPA,
    dense attention or the plain version on the card)."""
    with pytest.raises(ValueError, match=match):
        flash.route(dtype, D)


@pytest.mark.parametrize("N,S,H,D", SHAPES[:2])
def test_plain_backward_matches_autograd_of_plain_forward(N, S, H, D):
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(N, S, H, D, seed=3))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash.forward_plain(*ts)
    o.backward(do)
    got = flash.backward_plain(q, k, v, o.detach(), lse.detach(), do)
    for t, g in zip(ts, got):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-6)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as csrc/flash_tiled.cu splits its operands (and
    as ``cvt.rna.tf32.f32`` rounds)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tc_add(c: torch.Tensor, prods: torch.Tensor) -> torch.Tensor:
    """``c`` plus the sum of the exact products ``prods`` (..., n) as a
    model of one tensor-core step, after what Fasi, Higham, Mikaitis and
    Pranesh measured on the A100 ("Numerical behavior of NVIDIA tensor
    cores", 2021): the terms aligned to the largest of them, every bit
    below its 24th truncated, the sum rounded toward zero to float32."""
    terms = torch.cat([c.double()[..., None], prods], -1)
    _, ex = torch.frexp(terms.abs().amax(-1, keepdim=True))
    quantum = torch.exp2((ex - 24).double())
    r = (torch.trunc(terms / quantum) * quantum).sum(-1)
    r32 = r.float()
    up = r32.double().abs() > r.abs()
    return torch.where(up, torch.nextafter(r32, torch.zeros_like(r32)), r32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, terms: int,
             stage: int = 0, reorder: bool = False) -> torch.Tensor:
    """``a @ b`` in float32 from TF32 operands: one product of the rounded
    operands (``terms`` 1), or the 3xTF32 split of the float32 backward
    kernels (``terms`` 3): a_lo b_hi + a_hi b_lo + a_hi b_hi. With
    ``stage`` 0 the products are summed in float32. Otherwise they are
    summed as the kernels sum them: k-steps of 8 (``reorder``: a step's
    even k first, then its odd k, as a C fragment taken as the A operand
    lies), each term's step 4 products at a time by ``_tc_add``, from zero
    for every ``stage`` of k, each stage then added in float32."""
    ah, bh = _tf32(a), _tf32(b)
    pairs = [(ah, bh)]
    if terms == 3:
        pairs = [(_tf32(a - ah), bh), (ah, _tf32(b - bh)), (ah, bh)]
    if not stage:
        return sum(x @ y for x, y in pairs[:-1]) + ah @ bh
    K = a.shape[-1]
    order = torch.arange(K)
    if reorder:
        order = order.view(-1, 4, 2).transpose(1, 2).reshape(-1)
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for s0 in range(0, K, stage):
        c = torch.zeros_like(out)
        for k0 in range(s0, s0 + stage, 8):
            for x, y in pairs:
                for j in (k0, k0 + 4):
                    ks = order[j:j + 4]
                    c = _tc_add(c, x[..., ks].double().unsqueeze(-2)
                                * y[..., ks, :].double().transpose(-1, -2)
                                .unsqueeze(-3))
        out = out + c
    return out


def _backward_tf32(q, k, v, o, lse, do, terms: int, tensor_cores: bool):
    """``(dq, dk, dv)`` of the float32 backward kernels' formulas with
    every product emulated by ``_mm_tf32``: the dq kernel's q k^T, dO v^T
    and ds k, and the dk/dv kernel's own k q^T, v dO^T, ds^T q and p^T dO;
    with ``tensor_cores``, summed as the kernels do (over D in one stage,
    keys in stages of 64, queries of 64 or, at D = 128, 32)."""
    S, D = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    log2e = 1.4426950408889634
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    ls = lse * log2e
    delta = (do * o).sum(-1).transpose(1, 2)

    def mm(a, b, stage):
        return _mm_tf32(a, b, terms, stage if tensor_cores else 0,
                        reorder=stage < a.shape[-1])

    s = mm(qh, kh.transpose(-1, -2), D)
    p = torch.exp2(s * (scale * log2e) - ls[..., None]).masked_fill(~keep,
                                                                    0.0)
    ds = p * (mm(doh, vh.transpose(-1, -2), D) - delta[..., None])
    st = mm(kh, qh.transpose(-1, -2), D)
    pt = torch.exp2(st * (scale * log2e) - ls[..., None, :]).masked_fill(
        ~keep.T, 0.0)
    dst = pt * (mm(vh, doh.transpose(-1, -2), D) - delta[..., None, :])
    cols = 32 if D > 64 else 64
    grads = (mm(ds, kh, 64) * scale, mm(dst, qh, cols) * scale,
             mm(pt, doh, cols))
    return tuple(t.transpose(1, 2) for t in grads)


def _forward_tf32(q, k, v, terms: int, tensor_cores: bool):
    """``(o, lse)`` of the float32 forward kernel's formulas with every
    product emulated by ``_mm_tf32``: s = q k^T over D, then for each tile
    of 64 keys the online softmax in the log2 domain and o = alpha o + p v;
    with ``tensor_cores``, summed as the kernel sums them (s over D from
    zero in one stage; a tile's p v over its 64 keys from zero, each k-step
    reordered as the C fragment of s is taken as the A operand, then added
    to o in float32)."""
    S, D = q.shape[1], q.shape[-1]
    log2e = 1.4426950408889634
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    x = _mm_tf32(qh, kh.transpose(-1, -2), terms, D if tensor_cores else 0)
    x = (x * (log2e / math.sqrt(D))).masked_fill(~keep, float("-inf"))
    m = torch.full(x.shape[:-1], float("-inf"))
    l = torch.zeros(x.shape[:-1])
    acc = torch.zeros(*x.shape[:-1], D)
    for t0 in range(0, S, 64):
        xt = x[..., t0:t0 + 64]
        m_new = torch.maximum(m, xt.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _mm_tf32(
            p, vh[..., t0:t0 + 64, :], terms, 64 if tensor_cores else 0,
            reorder=True)
        m = m_new
    o = (acc / l[..., None]).transpose(1, 2)
    return o, (m + torch.log2(l)) * math.log(2.0)


@pytest.mark.parametrize("D", [16, 64, 128])
def test_f32_forward_check_tells_3xtf32_from_1xtf32_and_a_skipped_tile(D):
    """``chip_smoke.flash_route_errors``'s float32 check (FLASH_F32_RTOL of
    each output's largest value) against the products the float32 forward
    kernel runs: o and lse from 3xTF32 products pass with room, within an
    eighth of the limit summed as the tensor cores sum (truncating, each
    key tile's p v from zero; read: 6.6e-7 to 1.1e-6) and within a
    sixteenth summed in float32 (3.6e-7 to 6.6e-7); from single TF32
    products o misses by more than ten times (2.7e-4 to 4.8e-4); and a
    forward that skips key tile 0 for the second half's rows
    (``attention_skipping``) fails."""
    import chip_smoke
    N, S, H = 1, 256, 2
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(N, S, H, D, seed=6))
    limit = chip_smoke.FLASH_F32_RTOL
    for terms, tensor_cores in ((3, False), (3, True), (1, False)):
        o, lse = _forward_tf32(q, k, v, terms, tensor_cores)
        errs, ok = chip_smoke.flash_route_errors(q, k, v, do,
                                                 {"o": o, "lse": lse})
        if terms == 3:
            room = 8 if tensor_cores else 16
            assert ok and max(errs.values()) <= limit / room, errs
        else:
            assert not ok and errs["o"] > 10 * limit, errs
    o, lse = chip_smoke.attention_skipping(
        q, k, v, chip_smoke.planted_drops(S, q.device)["flash_fwd"])
    errs, ok = chip_smoke.flash_route_errors(q, k, v, do,
                                             {"o": o, "lse": lse})
    assert not ok, errs


@pytest.mark.parametrize("D", [16, 64, 128])
def test_f32_route_check_tells_3xtf32_from_1xtf32_and_a_skipped_tile(D):
    """``chip_smoke.flash_route_errors``'s float32 check (FLASH_F32_RTOL of
    each output's largest value) against the products the float32
    backward kernels run: dq, dk and dv from 3xTF32 products pass with
    room, within an eighth of the limit summed in float32 and within a
    third summed as the tensor cores sum (truncating, stage by stage);
    from single TF32 products each misses by more than ten times; and one
    tile skipped by the dq or the dk/dv kernel (``attention_skipping``)
    fails."""
    import chip_smoke
    N, S, H = 1, 256, 2
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(N, S, H, D, seed=5))
    o, lse = flash.forward_plain(q, k, v)
    limit = chip_smoke.FLASH_F32_RTOL
    for terms, tensor_cores in ((3, False), (3, True), (1, False)):
        got = dict(zip(("dq", "dk", "dv"), _backward_tf32(
            q, k, v, o, lse, do, terms, tensor_cores)))
        errs, ok = chip_smoke.flash_route_errors(q, k, v, do,
                                                 {"o": o, **got})
        if terms == 3:
            room = 3 if tensor_cores else 8
            assert ok and max(errs.values()) <= limit / room, errs
        else:
            assert not ok and min(errs[n] for n in got) > 10 * limit, errs
    drops = chip_smoke.planted_drops(S, q.device)
    delta = chip_smoke.plain_delta(o, do)
    for kernel, names in (("flash_bwd_dq", ("dq",)),
                          ("flash_bwd_dkv", ("dk", "dv"))):
        grads = dict(zip(("dq", "dk", "dv"), chip_smoke.attention_skipping(
            q, k, v, drops[kernel], do, lse, delta)))
        errs, ok = chip_smoke.flash_route_errors(
            q, k, v, do, {"o": o, **{n: grads[n] for n in names}})
        assert not ok, (kernel, errs)


def test_dispatch_follows_the_jax_rules(monkeypatch):
    """auto: K3 from S = 1024 up, dense below; flash: K3 when S % 128 ==
    0, else dense with the JAX package's warning. K3 is the only other
    route: the dispatch never falls back on a failure."""
    calls = []
    monkeypatch.setattr(tgpt2, "flash_attention",
                        lambda q, k, v: calls.append(q.shape[-3]) or q)
    q = torch.zeros(1, 1024, 1, 16)
    tgpt2.resolve_attn("auto")(q, q, q)
    tgpt2.resolve_attn("auto")(q[:, :512], q[:, :512], q[:, :512])
    tgpt2.resolve_attn("flash")(q[:, :256], q[:, :256], q[:, :256])
    with pytest.warns(UserWarning, match="ineligible"):
        tgpt2.resolve_attn("flash")(q[:, :200], q[:, :200], q[:, :200])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tgpt2.resolve_attn("dense")(q[:, :256], q[:, :256], q[:, :256])
    tgpt2.resolve_attn("auto")(q[:, :1000], q[:, :1000], q[:, :1000])
    assert calls == [1024, 256]
    with pytest.raises(ValueError, match="attn_impl"):
        tgpt2.resolve_attn("ring")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [192, 256, 1024])
def test_function_on_card_matches_plain(cuda, S):
    """The autograd.Function on the card at GPT-2's head width: q, k, v
    are the slices of one c_attn-shaped buffer, and the kernels' gradients
    land in that buffer through the split's backward. Tolerances as in
    tests/test_torch_kernels.py: each row of o, dq, dk and dv within
    ``chip_smoke.FLASH_ROW_RTOL`` of its own norm."""
    import chip_smoke
    N, H, D = 2, 12, 64
    rng = np.random.RandomState(4)
    qkv_np = rng.randn(N, S, 3 * H * D).astype(np.float32)
    do = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32)).to(
        cuda, torch.bfloat16)
    flash.reset_launches()
    qkv = torch.from_numpy(qkv_np).to(cuda, torch.bfloat16).requires_grad_()
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    o = flash.flash_attention(q, k, v)
    o.backward(do)
    torch.cuda.synchronize()
    assert chip_smoke.nonzero(flash.launches) == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    qp, kp, vp = (t.detach() for t in (q, k, v))
    o_ref, lse = flash.forward_plain(qp, kp, vp)
    assert float(chip_smoke.row_errors(o.detach(), o_ref).max()) <= \
        chip_smoke.FLASH_ROW_RTOL
    grads = flash.backward_plain(qp, kp, vp, o.detach(), lse, do)
    got = qkv.grad.unflatten(-1, (3, H, D))
    for j, want in enumerate(grads):
        assert float(chip_smoke.row_errors(got[:, :, j], want).max()) <= \
            chip_smoke.FLASH_ROW_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 192])
@pytest.mark.parametrize("dtype,D", [(dt, D) for dt, D in flash.ROUTES
                                     if (dt, D) != (torch.bfloat16, 64)])
def test_other_routes_on_card_match_plain(cuda, dtype, D, S):
    """Each route but bf16 D = 64's (float32 in flash_tiled.cu; bf16 at D
    = 32 and 128 in flash_attention.cu, at D = 16 the forward in
    flash_tiled.cu) through the autograd.Function on q, k, v slices
    of one c_attn-shaped buffer, at S = 192 (a partial last 128-row block
    of the JAX rule's tiles and of the wgmma kernels' items, three of the
    tiled kernels' 64 keys, an odd count for the forwards' two-stage
    copies) and S = 64 (one key tile, nothing to prefetch; the 128-row
    items cut to half): one launch of each of the route's kernels and no
    other, and o, dq, dk, dv against the plain versions
    (``chip_smoke.flash_route_errors``'s limits: bf16 each row within
    FLASH_ROW_RTOL of its norm, float32 within FLASH_F32_RTOL of the
    largest value)."""
    import chip_smoke
    N, H = 2, 2
    rng = np.random.RandomState(D)
    qkv = torch.from_numpy(rng.randn(N, S, 3 * H * D).astype(
        np.float32)).to(cuda, dtype).requires_grad_()
    do = torch.from_numpy(rng.randn(N, S, H, D).astype(np.float32)).to(
        cuda, dtype)
    flash.reset_launches()
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    o = flash.flash_attention(q, k, v)
    o.backward(do)
    torch.cuda.synchronize()
    assert chip_smoke.nonzero(flash.launches) == dict.fromkeys(
        flash.route(dtype, D).names, 1)
    qp, kp, vp = (t.detach() for t in (q, k, v))
    got = dict(zip(("dq", "dk", "dv"),
                   qkv.grad.unflatten(-1, (3, H, D)).unbind(2)))
    got["o"] = o.detach()
    errs, ok = chip_smoke.flash_route_errors(qp, kp, vp, do, got)
    assert ok, errs
