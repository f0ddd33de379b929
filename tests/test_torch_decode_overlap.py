"""The split round (``--decode_overlap``, core/pipeline.py
``DecodeOverlapRound``, ``FedRuntime.cohort`` + ``FedRuntime.decode``),
on the CPU:

- on one device, bitwise ``FedRuntime.round`` (weights, losses, byte
  vectors, the full state) for the circulant and the hash sketch,
  true_topk and uncompressed, with telemetry on and off (the port keys
  every draw by the round, so the split changes none); the metrics'
  ``signals`` and ``layer_signals`` None, the NOTE printed once;
- against the JAX package's ``DecodeOverlapRound`` on the same inputs
  (the sketch and a dense mode): weights to rtol 1e-4 and atol 1e-6,
  losses to rtol 1e-5;
- on 2 gloo ranks (in ``test_torch_mesh.py``'s rank group, which holds
  these checks): the reduce moved into the decode under the sharded tail
  (tests/test_sharded_server.py:301) bitwise the monolithic sharded
  round, and the async cohort's mesh form (one cohort merged first and
  committed) bitwise the synchronous mesh round;
- the refusals: with --async_agg, with per-client rows, the adapter or
  the halves on a runtime built without the flag.
"""

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.core import DecodeOverlapRound as JOverlap  # noqa
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from test_sharded_server import _params_and_loss, _sketch_cfg  # noqa

from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.pipeline import DecodeOverlapRound  # noqa
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.core.state import FedState  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

N_ROUNDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread for this file's toy sizes: more only spin on
    a shared CPU."""
    with ranks.one_thread():
        yield
MODES = {
    "circ": {},
    "hash": {"sketch_impl": "hash"},
    "true_topk": {"mode": "true_topk"},
    "uncompressed": {"mode": "uncompressed", "error_type": "none"},
}


def inputs():
    params, _, batch_for = _params_and_loss()
    rounds = []
    for g in range(1, N_ROUNDS + 1):
        b = batch_for(8, 4, g)
        mask = np.ones((8, 4), bool)
        mask[3, 2:] = False
        rounds.append((np.arange(8) * 2, {"x": np.asarray(b["x"]),
                                          "target": np.asarray(b["target"])},
                       mask))
    return np.asarray(params["w"]), rounds


def run(kw, split, telemetry):
    params, rounds = inputs()
    cfg = ranks.sketch_cfg(decode_overlap=split, telemetry=telemetry, **kw)
    rt = FedRuntime(cfg, ranks.Flat(params), ranks.nll_loss, device="cpu")
    obj = DecodeOverlapRound(rt) if split else rt
    st = obj.init_state()
    hist = []
    for ids, batch, mask in rounds:
        st, m = obj.round(st, ids, batch, mask, 0.1)
        hist.append(m)
    return rt, st, hist


def same(a, b) -> bool:
    """Nested dicts of tensors equal bit for bit (NaN equal to NaN)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def state_arrays(st):
    return {f: getattr(st, f) for f in FedState.__dataclass_fields__
            if getattr(st, f) is not None}


@pytest.mark.parametrize("telemetry", [False, True], ids=["tel_off",
                                                           "tel_on"])
@pytest.mark.parametrize("mode", list(MODES))
def test_split_round_bitwise_the_round(mode, telemetry, capsys):
    _, st_m, hist_m = run(MODES[mode], False, telemetry)
    capsys.readouterr()
    rt, st_s, hist_s = run(MODES[mode], True, telemetry)
    err = capsys.readouterr().err
    assert err.count("NOTE: --decode_overlap disables") == int(telemetry)
    for name, val in state_arrays(st_m).items():
        other = getattr(st_s, name)
        if name == "step":
            assert other == val
        else:
            assert other.dtype == val.dtype and np.array_equal(
                other.numpy(), val.numpy()), name
    for mm, ms in zip(hist_m, hist_s):
        for key in ("results", "n_valid", "download_bytes",
                    "upload_bytes"):
            a, b = mm[key], ms[key]
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert np.array_equal(x.numpy(), y.numpy()), key
        assert ms["signals"] is None and ms["layer_signals"] is None
        if telemetry:
            assert mm["signals"] is not None
            assert same(mm["client_stats"], ms["client_stats"])


def jax_split(kw):
    params, loss_fn, batch_for = _params_and_loss()
    jkw = dict(kw)
    cfg = _sketch_cfg(decode_overlap=True, telemetry=False, **jkw)
    rt = JRuntime(cfg, params, loss_fn, num_clients=cfg.num_clients)
    obj = JOverlap(rt)
    st = obj.init_state()
    losses = []
    for ids, batch, mask in inputs()[1]:
        st, m = obj.round(st, jnp.asarray(ids, jnp.int32),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jnp.asarray(mask), 0.1)
        losses.append(np.asarray(m["results"][0]))
    return np.stack(losses), np.asarray(rt.flat_weights(st))


@pytest.mark.parametrize("mode", ["circ", "true_topk"])
def test_split_round_matches_jax_split_round(mode):
    losses_j, w_j = jax_split(MODES[mode])
    rt, st, hist = run(MODES[mode], True, False)
    np.testing.assert_allclose(rt.flat_weights(st).numpy(), w_j,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        np.stack([m["results"][0].numpy() for m in hist]), losses_j,
        rtol=1e-5)


def overlap_part():
    """The 2-rank cases' part of ``test_torch_mesh.py``'s rank group."""
    params, rounds = inputs()
    return ranks.overlap_body, (params, rounds)


def check_reduce_in_decode(res_ranks):
    for res in res_ranks:
        mono, split, moved = res["reduce_in_decode"]
        assert moved
        assert np.array_equal(split["losses"], mono["losses"])
        assert np.array_equal(split["weights"], mono["weights"])
        assert np.array_equal(split["download"], mono["download"])


def check_async_cohort(res_ranks):
    for res in res_ranks:
        mono, got = res["async"]
        assert np.array_equal(got["losses"], mono["losses"])
        assert np.array_equal(got["weights"], mono["weights"])


def test_split_round_refusals():
    params, _ = inputs()
    with pytest.raises(ValueError, match="mutually exclusive"):
        FedConfig(decode_overlap=True, async_agg=True)
    with pytest.raises(ValueError, match="--decode_overlap: splitting"):
        FedRuntime(ranks.sketch_cfg(mode="true_topk", local_momentum=0.9,
                                    decode_overlap=True),
                   ranks.Flat(params), ranks.nll_loss, device="cpu")
    rt = FedRuntime(ranks.sketch_cfg(), ranks.Flat(params), ranks.nll_loss,
                    device="cpu")
    with pytest.raises(ValueError, match="decode_overlap=True"):
        DecodeOverlapRound(rt)
    with pytest.raises(ValueError, match="cohort: the runtime"):
        rt.cohort(rt.init_state(), np.arange(8), {}, np.ones((8, 4), bool),
                  0.1)
    with pytest.raises(ValueError, match="decode: the runtime"):
        rt.decode(rt.init_state(), None, 1.0, 0.1)
