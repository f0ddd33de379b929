"""The port's epoch loop (core/driver.py) against the JAX package's
``cv_train.train``, on the CPU, with the toy model of tests/test_core.py
on a toy federated dataset that both drivers sample with the same seeds.

Epoch rows are held to rtol 1e-5 (losses) and exactly (bytes, the epoch
count); a client whose data holds a NaN must stop both drivers at the
same epoch boundary with the same ``nan_round``, and the port must run no
validation after it.
"""

import numpy as np
import pytest

from test_torch_modes import (B, D_FEAT, NUM_CLIENTS, W,  # noqa: E402
                              base_kw, make_data, port_runtime, ref_runtime)

from commefficient_tpu.cv_train import train as j_train  # noqa: E402

from commefficient_torch.core import driver  # noqa: E402
from commefficient_torch.utils.logging import (TableLogger,  # noqa: E402
                                               TSVLogger, make_logdir)
from commefficient_torch.utils.schedules import lr_schedule_for  # noqa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


@pytest.fixture(autouse=True)
def _runs_under_tmp(tmp_path, monkeypatch):
    """The entry points' default run directory (``runs/<stamp>_...``, the
    telemetry stream) lands under the test's tmp dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


EPOCHS = 3


class ToyDataset:
    """``NUM_CLIENTS`` clients of ``B`` items each, client by client;
    ``nan_client``'s first item holds a NaN feature."""

    def __init__(self, nan_client=None):
        xs, ys = make_data()
        xs = xs.copy()
        if nan_client is not None:
            xs[nan_client, 0, 0] = np.nan
        self.arrays = {"x": xs.reshape(-1, D_FEAT), "y": ys.reshape(-1)}
        self.data_per_client = np.full(NUM_CLIENTS, B)
        self.num_clients = NUM_CLIENTS

    def __len__(self):
        return NUM_CLIENTS * B

    def gather(self, idx):
        return {k: v[idx] for k, v in self.arrays.items()}


def _run_both(train_ds, val_ds, loggers=(), **kw):
    kw = dict(num_epochs=float(EPOCHS), lr_scale=0.05, pivot_epoch=1.0,
              **kw)
    jrt, trt = ref_runtime(dataset_name="PERSONA", **kw), port_runtime(**kw)
    j_state, j_summary = j_train(jrt.cfg, jrt, jrt.init_state(), train_ds,
                                 val_ds)
    t_state, t_summary, log = driver.train(
        trt, trt.init_state(), train_ds, val_ds, lr_schedule_for(trt.cfg),
        loggers=loggers)
    return (j_state, j_summary), (t_state, t_summary, log)


@pytest.mark.parametrize("kw", [{}, dict(mode="true_topk",
                                         error_type="virtual", k=2)],
                         ids=["uncompressed", "true_topk"])
def test_epoch_rows_match_reference(kw, capsys):
    (js, jsum), (ts, tsum, log) = _run_both(ToyDataset(), ToyDataset(),
                                            loggers=(TableLogger(),), **kw)
    assert len(log.epochs) == EPOCHS and tsum["epoch"] == jsum["epoch"]
    for key in ("train_loss", "train_acc", "test_loss", "test_acc", "lr"):
        np.testing.assert_allclose(tsum[key], jsum[key], rtol=1e-5)
    assert tsum["down (MiB)"] == jsum["down (MiB)"]
    assert tsum["up (MiB)"] == jsum["up (MiB)"]
    np.testing.assert_allclose(ts.ps_weights.numpy(),
                               np.asarray(js.ps_weights), atol=1e-6)
    assert np.array_equal(ts.coord_last_update.numpy(),
                          np.asarray(js.coord_last_update))
    # 2 rounds an epoch (10 clients of 8 items, 4 clients of 8 a round)
    assert len(log.round_s) == len(log.losses) == 2 * EPOCHS
    assert np.isfinite(log.losses).all()
    text = capsys.readouterr().out
    assert "down (MiB)" in text
    # the run's byte totals, as each driver prints them
    for what in ("Download", "Upload"):
        ref, port = [ln for ln in text.splitlines()
                     if ln.startswith(f"Total {what} (MiB)")]
        assert ref == port


def _first_epoch_of(client):
    cfg = port_runtime().cfg
    for epoch in range(EPOCHS):
        for rnd in driver.epoch_sampler(cfg, ToyDataset(), epoch):
            if client in rnd.client_ids:
                return epoch
    return None


def test_nan_client_aborts_at_the_epoch_boundary_as_reference(capsys):
    """A client first sampled in epoch 1 uploads a NaN gradient: epoch 0
    validates, epoch 1 ends in the abort, with the reference's nan_round,
    and nothing is validated after it."""
    client = next(c for c in range(NUM_CLIENTS) if _first_epoch_of(c) == 1)
    (js, jsum), (ts, tsum, log) = _run_both(ToyDataset(client),
                                            ToyDataset())
    assert jsum is None and tsum is None
    assert int(ts.nan_round) == int(js.nan_round) >= 2
    assert [row["epoch"] for row in log.epochs] == [1]
    assert log.val_batches == len(ToyDataset()) // 8
    assert len(log.round_s) == 4
    out = capsys.readouterr().out
    assert f"TRAINING DIVERGED (first non-finite update at round " \
           f"{int(ts.nan_round)}), TERMINATING" in out


def test_num_rounds_stops_inside_an_epoch_and_still_validates():
    trt = port_runtime(num_epochs=float(EPOCHS))
    state, summary, log = driver.train(
        trt, trt.init_state(), ToyDataset(), ToyDataset(),
        lr_schedule_for(trt.cfg), num_rounds=3, val_max_batches=2)
    assert len(log.round_s) == 3 and [r["epoch"] for r in log.epochs] == \
        [1, 2]
    assert log.val_batches == 4 and state.step == 3
    assert summary is log.epochs[-1]


def test_loggers_and_logdir(capsys):
    table, tsv = TableLogger(), TSVLogger()
    row = {"epoch": 1, "train_loss": 0.5, "down (MiB)": 3,
           "test_acc": 0.25, "total_time": 36.0}
    table.append(row)
    table.append(dict(row, epoch=2))
    tsv.append(row)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["epoch", "train_loss", "down", "(MiB)",
                                "test_acc", "total_time"]
    assert lines[2].split()[0] == "2" and "0.5000" in lines[1]
    assert str(tsv).splitlines() == ["epoch,hours,top1Accuracy",
                                     "1,0.01000000,25.00"]
    from commefficient_tpu.config import FedConfig as JConfig
    from commefficient_tpu.utils.logging import make_logdir as j_make_logdir

    from commefficient_torch.config import FedConfig
    for kw in (dict(mode="sketch", error_type="virtual", k=7), {}):
        got = make_logdir(FedConfig(**base_kw(**kw)))
        ref = j_make_logdir(JConfig(**base_kw(**kw)))
        # the names differ only in the timestamp, "runs/<date>_<time>_"
        assert got.split("_", 2)[2] == ref.split("_", 2)[2]
    assert got.endswith(f"_{W}/{NUM_CLIENTS}_uncompressed_")


CV_MODES = {
    "uncompressed": ["--mode", "uncompressed", "--error_type", "none",
                     "--local_momentum", "0"],
    "true_topk": ["--mode", "true_topk", "--error_type", "virtual",
                  "--local_momentum", "0"],
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0.9", "--lr_scale", "0.01"],
    "fedavg": ["--mode", "fedavg", "--error_type", "none",
               "--local_momentum", "0", "--local_batch_size", "-1", "--fedavg_batch_size", "4",
               "--max_client_batch", "16"],
    # one client a round: the plain sketch at full width is the slow part
    "sketch_subtract": ["--mode", "sketch", "--error_type", "virtual",
                        "--local_momentum", "0", "--sketch_ef", "subtract",
                        "--microbatch_size", "2", "--num_cols", "262144",
                        "--num_workers", "1"],
    "sketch_unfused": ["--mode", "sketch", "--error_type", "virtual",
                       "--local_momentum", "0", "--sketch_fused_encode", "off",
                       "--num_cols", "262144", "--num_workers", "1"],
}


@pytest.mark.parametrize("mode", sorted(CV_MODES))
def test_cv_train_runs_every_mode_on_cpu(tmp_path, mode):
    """The entry point at ResNet-9's full width, two rounds: finite
    losses, an epoch row, upload bytes 4 x upload_floats a participant,
    and download counts that a plain recount of the final state gives."""
    from commefficient_torch import cv_train
    out = cv_train.main([
        "--device", "cpu", "--dataset_dir", str(tmp_path),
        "--virtual_momentum", "0.9", "--num_workers",
        "2", "--local_batch_size", "4", "--k", "500", "--num_rounds", "2",
        "--synthetic_per_class", "4", "--valid_batch_size", "20",
        *CV_MODES[mode]])
    assert out["rounds"] == 2 and np.isfinite(out["losses"]).all()
    assert out["summary"] is not None and out["summary"]["epoch"] == 1
    cfg, state = out["runtime"].cfg, out["state"]
    assert out["total_upload_mib"] == \
        2 * cfg.num_workers * 4 * cfg.upload_floats / 2**20
    assert int(state.nan_round) == -1
    cul = state.coord_last_update
    assert int((cul == 1).sum()) > 0 and int((cul > 1).sum()) == 0
    thr = state.client_last_round
    import torch
    from commefficient_torch.core.runtime import download_coord_counts
    assert torch.equal(download_coord_counts(cul, thr),
                       torch.stack([(cul >= t).sum() for t in thr]))
