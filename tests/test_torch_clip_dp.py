"""Whole rounds of the port's clipping, DP, top-k download, dense server
state and the hash and SRHT sketches against the JAX package's
``FedRuntime``, on the CPU, with the toy model of tests/test_torch_modes.py;
the refusals the JAX package makes for these flags; DP noise by its
moments and its determinism; and one command line giving one
configuration in both packages.

Rounds are held to test_torch_modes.py's tolerances: per-round losses
rtol 1e-5, final weights atol 1e-6, byte vectors and the round counters
exactly; the per-client download weights rtol 1e-5 (with atol 1e-6 of
their largest entry). DP with noise cannot be matched draw for draw (the
port keys torch generators by seed, round and slot where the JAX package
splits threefry keys): the noise is held to its standard deviation within
3% over 200,000 draws, and two runs from one seed, or a round replayed
from a saved state, to the same bits.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modes import (B, NUM_CLIENTS, SKETCH, Toy,  # noqa: E402
                              base_kw, init_params, j_loss, port_runtime,
                              ref_runtime, round_inputs, t_loss)

from commefficient_tpu import config as jconfig  # noqa: E402
from commefficient_tpu.config import FedConfig as JConfig  # noqa: E402
from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.core.server import \
    validate_mode_combo as j_validate  # noqa: E402

from commefficient_torch import config as tconfig  # noqa: E402
from commefficient_torch import cv_train, gpt2_train  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import (FedRuntime,  # noqa: E402
                                              noise_generator)
from commefficient_torch.core.server import \
    validate_mode_combo  # noqa: E402

CLIP = dict(max_grad_norm=0.5)
CASES = {
    "sketch_table_clip": dict(SKETCH, **CLIP),
    "sketch_table_clip_unfused": dict(SKETCH, sketch_fused_encode="off",
                                      **CLIP),
    "sketch_table_clip_microbatched": dict(SKETCH, microbatch_size=3,
                                           weight_decay=5e-4, **CLIP),
    "sketch_dense_clip": dict(SKETCH, sketch_dense_clip=True, **CLIP),
    "uncompressed_clip": dict(virtual_momentum=0.9, microbatch_size=4,
                              **CLIP),
    "true_topk_clip": dict(mode="true_topk", error_type="virtual", k=2,
                           **CLIP),
    "fedavg_clip": dict(mode="fedavg", local_batch_size=-1,
                        max_client_batch=B, fedavg_batch_size=3, **CLIP),
    "sketch_dense_state": dict(SKETCH, sketch_server_state="dense"),
    "sketch_dense_state_clip": dict(SKETCH, sketch_server_state="dense",
                                    sketch_dense_clip=True, **CLIP),
    "hash_zero": dict(SKETCH, sketch_impl="hash", num_blocks=3,
                      weight_decay=5e-4),
    "hash_subtract": dict(SKETCH, sketch_impl="hash", sketch_ef="subtract"),
    "hash_table_clip": dict(SKETCH, sketch_impl="hash", **CLIP),
    "hash_dense_state": dict(SKETCH, sketch_impl="hash",
                             sketch_server_state="dense"),
    "topk_down_sketch": dict(SKETCH, do_topk_down=True, k=2,
                             weight_decay=5e-4),
    "topk_down_uncompressed": dict(do_topk_down=True, k=3),
    "rht_dense_preimage": dict(SKETCH, sketch_impl="rht", num_rows=2,
                               num_cols=4, k=2),
    "rht_table_clip": dict(SKETCH, sketch_impl="rht", num_rows=1,
                           num_cols=8, k=2, **CLIP),
    "dp_worker_no_noise": dict(do_dp=True, l2_norm_clip=0.5),
    "dp_sketch_no_noise": dict(SKETCH, do_dp=True, l2_norm_clip=0.5),
    "dp_server_no_noise": dict(do_dp=True, dp_mode="server",
                               l2_norm_clip=0.5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_matches_reference(case):
    kw = CASES[case]
    jrt, trt = ref_runtime(**kw), port_runtime(**kw)
    assert (trt.cfg.num_cols, trt.dense_preimage) == \
        (jrt.cfg.num_cols, jrt._dense_preimage)
    js, ts = jrt.init_state(), trt.init_state()
    for ids, batch, mask in round_inputs(5, ragged=True):
        js, jm = jrt.round(js, jnp.asarray(ids.astype(np.int32)),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(mask), 0.05)
        ts, tm = trt.round(ts, ids, batch, mask, 0.05)
        for got, want in zip(tm["results"], jm["results"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
        for key in ("download_bytes", "upload_bytes"):
            assert np.array_equal(tm[key].numpy(), np.asarray(jm[key])), key
    np.testing.assert_allclose(ts.ps_weights.numpy(),
                               np.asarray(js.ps_weights), rtol=0, atol=1e-6)
    assert (ts.ps_weights.numpy() != init_params()[1]).any()
    assert tuple(ts.Vvelocity.shape) == tuple(js.Vvelocity.shape)
    for key in ("coord_last_update", "client_last_round", "nan_round"):
        assert np.array_equal(getattr(ts, key).numpy(),
                              np.asarray(getattr(js, key))), key
    want = js.client_weights
    assert (ts.client_weights is None) == (want is None)
    if want is not None:
        want = np.asarray(want)
        np.testing.assert_allclose(ts.client_weights.numpy(), want,
                                   rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_table_clip_binds():
    """The clip changes the trajectory (the cases above clip for real)."""
    _, a, _ = _run(dict(SKETCH))
    _, b, _ = _run(dict(SKETCH, **CLIP))
    assert not torch.equal(a.ps_weights, b.ps_weights)


# ------------------------------------------------------------- refusals


REFUSALS = {
    "rht_below_lossless": (dict(SKETCH, sketch_impl="rht", num_rows=2,
                                num_cols=3), "allow_divergent_rht"),
    "subtract_dense_state": (dict(SKETCH, sketch_ef="subtract",
                                  sketch_server_state="dense"),
                             "sketch_ef subtract"),
    "subtract_rht": (dict(SKETCH, sketch_ef="subtract", sketch_impl="rht",
                          num_rows=1, num_cols=8), "sketch_ef subtract"),
    "dense_state_table_clip": (dict(SKETCH, sketch_server_state="dense",
                                    **CLIP), "deferred encode"),
    "fused_on_dp": (dict(SKETCH, do_dp=True, sketch_fused_encode="on"),
                    "--dp"),
    "fused_on_dense_clip": (dict(SKETCH, sketch_dense_clip=True,
                                 sketch_fused_encode="on", **CLIP),
                            "--sketch_dense_clip"),
    "fused_on_dense_state": (dict(SKETCH, sketch_server_state="dense",
                                  sketch_fused_encode="on"),
                             "dense server state"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_as_in_reference(case):
    kw, words = REFUSALS[case]
    with pytest.raises(ValueError):
        ref_runtime(**kw)
    with pytest.raises(ValueError, match=words):
        port_runtime(**kw)


def test_divergent_rht_proceeds_when_allowed(capsys):
    kw = dict(SKETCH, sketch_impl="rht", num_rows=2, num_cols=3,
              allow_divergent_rht=True)
    j_validate(jconfig.FedConfig(**base_kw(**kw), grad_size=7))
    validate_mode_combo(FedConfig(**base_kw(**kw), grad_size=7))
    assert "WARNING: --sketch_impl rht" in capsys.readouterr().err


def test_sketch_dense_clip_requires_max_grad_norm():
    with pytest.raises(AssertionError, match="--max_grad_norm"):
        jconfig.FedConfig(**base_kw(**SKETCH), sketch_dense_clip=True)
    with pytest.raises(ValueError, match="--max_grad_norm"):
        FedConfig(**base_kw(**SKETCH), sketch_dense_clip=True)
    with pytest.raises(ValueError, match="--mode sketch"):
        FedConfig(**base_kw(), sketch_dense_clip=True, max_grad_norm=1.0)


def test_client_rows_that_do_not_fit_are_refused(monkeypatch):
    """The per-client rows are checked against the card's free memory
    before they are allocated, and the refusal names the bytes."""
    rt = port_runtime(do_topk_down=True, k=3)
    rt.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (100, 10**9))
    with pytest.raises(ValueError, match=f"take {NUM_CLIENTS * 7 * 4} "
                                         "bytes"):
        rt.init_state()


# ------------------------------------------------------------- DP noise


def _zero_loss(flat, batch, mask):
    """A loss with zero gradient: the round moves the weights by its DP
    noise alone."""
    zero = (flat * 0.0).sum()
    return zero, (zero,)


def _run(kw, n_rounds=2, loss=t_loss, d=7, lr=0.05):
    flat = init_params()[1] if d == 7 else np.zeros(d, np.float32)
    rt = FedRuntime(FedConfig(**base_kw(**kw)), Toy(flat), loss,
                    device="cpu")
    state, states = rt.init_state(), []
    for ids, batch, mask in round_inputs(n_rounds):
        state, _ = rt.round(state, ids, batch, mask, lr)
        states.append(state)
    return rt, state, states


@pytest.mark.parametrize("dp_mode", ["worker", "server"])
def test_dp_noise_moments_and_determinism(dp_mode):
    """Zero gradients, lr 1, equal clients: the update is the noise,
    N(0, sigma^2) a coordinate in both modes (worker: W draws of sigma
    sqrt(W), averaged). Same seed, same bits; another seed, other bits;
    a round replayed from the previous round's state, the same bits."""
    sigma, d = 0.1, 200_000
    kw = dict(do_dp=True, dp_mode=dp_mode, noise_multiplier=sigma,
              track_bytes=False)
    _, a, states = _run(kw, loss=_zero_loss, d=d, lr=1.0)
    step = a.ps_weights.numpy().astype(np.float64)  # two rounds of noise
    std = step.std() / np.sqrt(2)
    assert abs(std / sigma - 1) < 0.03, std
    assert abs(step.mean()) < 4 * sigma * np.sqrt(2 / d)
    _, b, _ = _run(kw, loss=_zero_loss, d=d, lr=1.0)
    assert torch.equal(a.ps_weights, b.ps_weights)
    _, c, _ = _run(dict(kw, seed=22), loss=_zero_loss, d=d, lr=1.0)
    assert not torch.equal(a.ps_weights, c.ps_weights)
    rt, _, _ = _run(kw, n_rounds=0, loss=_zero_loss, d=d, lr=1.0)
    ids, batch, mask = round_inputs(2)[1]
    replay, _ = rt.round(states[0], ids, batch, mask, 1.0)
    assert torch.equal(replay.ps_weights, a.ps_weights)


def test_noise_generator_keyed_by_seed_round_and_slot():
    draw = lambda *key: torch.randn(  # noqa: E731
        4, generator=noise_generator(*key, device="cpu"))
    assert torch.equal(draw(21, 3, 1), draw(21, 3, 1))
    for other in ((22, 3, 1), (21, 4, 1), (21, 3, 2)):
        assert not torch.equal(draw(21, 3, 1), draw(*other))


# ------------------------------------------------------------- config


ARGVS = [
    [],
    ["--mode", "sketch", "--error_type", "virtual", "--local_momentum",
     "0", "--max_grad_norm", "1", "--sketch_dense_clip", "--sketch_impl",
     "hash", "--num_blocks", "5", "--sketch_server_state", "dense"],
    ["--mode", "uncompressed", "--dp", "--dp_mode", "server",
     "--l2_norm_clip", "2", "--noise_multiplier", "0.3", "--topk_down",
     "--k", "100"],
    ["--mode", "sketch", "--error_type", "virtual", "--local_momentum",
     "0", "--sketch_impl", "rht", "--allow_divergent_rht", "--num_rows",
     "3", "--num_cols", "1000"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "hash_clip",
                                             "dp_topk_down", "rht"])
def test_one_command_line_one_configuration(argv):
    """The same argv parsed by each package's CV entry point gives equal
    values in every field that both configurations have."""
    ref = jconfig.parse_args(argv, default_lr=0.4)
    got = tconfig.config_from_args(
        tconfig.parse_known(cv_train.build_parser(), argv))
    shared = sorted(set(vars(ref)) & set(vars(got)))
    assert len(shared) > 60
    diff = {k: (getattr(got, k), getattr(ref, k)) for k in shared
            if getattr(got, k) != getattr(ref, k)}
    assert not diff


def test_gpt2_command_line_defaults_as_in_reference():
    p = argparse.ArgumentParser()
    jconfig.add_args(p, default_lr=0.16)
    ref = vars(p.parse_args([]))
    got = vars(gpt2_train.build_parser().parse_args([]))
    for key in ("lr_scale", "local_momentum", "error_type", "max_grad_norm",
                "do_dp", "do_topk_down", "sketch_impl", "num_blocks"):
        assert got[key] == ref[key], key


def test_topk_down_clients_train_on_their_stale_weights():
    """Under --topk_down a participant's row advances by the top-k of its
    lag; a client outside every round keeps the initial weights."""
    rt, state, _ = _run(dict(SKETCH, do_topk_down=True, k=2), n_rounds=3)
    w0 = torch.from_numpy(init_params()[1])
    seen = {int(i) for ids, _, _ in round_inputs(3) for i in ids}
    assert len(seen) < NUM_CLIENTS
    moved = [not torch.equal(state.client_weights[c], w0)
             for c in range(NUM_CLIENTS)]
    assert any(moved)
    assert not any(moved[c] for c in range(NUM_CLIENTS) if c not in seen)
    assert all((row != w0).sum() <= 2 * 2 for row, m in
               zip(state.client_weights, moved) if m)


# the default-path --topk_down round on inputs without ties: with c >= d
# the circulant sketch recovers the lag exactly, so no two coordinates of
# the download's ranking are equal in exact arithmetic and the k support
# cannot hinge on the last ulp (the 5-column case of CASES has a tie
# after round 3)
UNTIED_TOPK_DOWN = {
    "c8_k2": dict(SKETCH, do_topk_down=True, k=2, num_cols=8,
                  weight_decay=5e-4),
    "c16_r1_k3": dict(SKETCH, do_topk_down=True, k=3, num_rows=1,
                      num_cols=16),
}


@pytest.mark.parametrize("case", sorted(UNTIED_TOPK_DOWN))
def test_topk_down_default_path_matches_reference(case):
    """Both runtimes with their default telemetry: weights round by
    round over 8 rounds at test_torch_modes.py's tolerances."""
    kw = base_kw(**UNTIED_TOPK_DOWN[case])
    trt = FedRuntime(FedConfig(**kw), Toy(init_params()[1]), t_loss,
                     device="cpu")
    jrt = JRuntime(JConfig(**kw, num_results_train=2), init_params()[0],
                   j_loss, num_clients=NUM_CLIENTS)
    assert trt.cfg.telemetry and jrt.cfg.telemetry
    js, ts = jrt.init_state(), trt.init_state()
    for ids, batch, mask in round_inputs(8, ragged=True):
        js, jm = jrt.round(js, jnp.asarray(ids.astype(np.int32)),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.asarray(mask), 0.05)
        ts, tm = trt.round(ts, ids, batch, mask, 0.05)
        for got, want in zip(tm["results"], jm["results"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
        np.testing.assert_allclose(ts.ps_weights.numpy(),
                                   np.asarray(js.ps_weights), rtol=0,
                                   atol=1e-6)
        want = np.asarray(js.client_weights)
        np.testing.assert_allclose(ts.client_weights.numpy(), want,
                                   rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
        for key in ("download_bytes", "upload_bytes"):
            assert np.array_equal(tm[key].numpy(), np.asarray(jm[key])), key
    assert (ts.ps_weights.numpy() != init_params()[1]).any()
