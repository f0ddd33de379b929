"""The circulant-sketch kernel wrappers of the PyTorch port
(ops/circulant_kernels.py).

On the CPU a wrapper takes its kernel's plain version and launches
nothing. The tests marked ``cuda`` hold the CUDA kernels K1 and K2
(csrc/circulant.cu) against those plain versions on the card; they skip
without one. This file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from commefficient_torch.ops import circulant_kernels as kernels
from commefficient_torch.ops.circulant import make_circulant_sketch

D = 20_000


def _inputs(c, r, seed=10, device="cpu"):
    rng = np.random.RandomState(seed)
    v = torch.from_numpy(rng.randn(D).astype(np.float32)).to(device)
    t0 = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(device)
    return v, t0


def test_wrappers_take_plain_version_on_cpu_without_launching():
    ts = make_circulant_sketch(D, 4000, 5)
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


def test_plain_encode_is_linear_and_decode_inverts_at_m1():
    """With c >= d (one block) a roll is invertible: decode(encode(v)) is
    v exactly, in every row, so the median is v too."""
    ts = make_circulant_sketch(1000, 1024, 3, seed=3)
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
