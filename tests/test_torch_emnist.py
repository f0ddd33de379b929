"""LEAF FEMNIST in the PyTorch port against the JAX package, on the CPU:
the LEAF json ingest, the synthetic fallback (bitwise), one prepared
directory read by both packages, the refusals and the stale-marker
re-prepare, the FEMNIST host transforms (bitwise), and the device store's
``emnist_train`` crop against a numpy crop at the store's own offsets.
"""

import json
import os

import numpy as np
import pytest
import torch

import test_torch_round  # noqa: F401,E402 (installs the import fix)

from commefficient_tpu.data import transforms as JT  # noqa: E402
from commefficient_tpu.data.fed_emnist import FedEMNIST as JFedEMNIST  # noqa

from commefficient_torch.data import transforms as T  # noqa: E402
from commefficient_torch.data.device_store import (  # noqa: E402
    DeviceStore, make_device_store)
from commefficient_torch.data.fed_emnist import FedEMNIST  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def write_leaf_femnist(root, seed=3):
    """A tiny LEAF FEMNIST tree in the reference's on-disk format: train/
    and test/ directories of ``all_data_*.json`` files, each ``{"users",
    "num_samples", "user_data": {user: {"x": [784-float lists], "y":
    [ints]}}}``, the train split over two files."""
    rng = np.random.RandomState(seed)

    def blob(users, per):
        user_data = {u: {"x": rng.rand(n, 784).round(4).tolist(),
                         "y": [int(t) for t in rng.randint(0, 62, n)]}
                     for u, n in zip(users, per)}
        return {"users": users, "num_samples": per, "user_data": user_data}

    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
    for i, b in enumerate([blob(["f0000_01", "f0001_02"], [6, 4]),
                           blob(["f0002_03"], [5])]):
        with open(os.path.join(root, "train", f"all_data_{i}.json"),
                  "w") as f:
            json.dump(b, f)
    with open(os.path.join(root, "test", "all_data_0.json"), "w") as f:
        json.dump(blob(["f0000_01", "f0002_03"], [3, 2]), f)


def _same(a, b):
    assert a.images_per_client.tolist() == b.images_per_client.tolist()
    assert len(a) == len(b)
    for key in ("image", "target"):
        assert a.arrays[key].dtype == b.arrays[key].dtype
        assert np.array_equal(a.arrays[key], b.arrays[key])


@pytest.mark.parametrize("train", [True, False])
def test_leaf_ingest_matches_reference(tmp_path, train):
    write_leaf_femnist(str(tmp_path / "a"))
    write_leaf_femnist(str(tmp_path / "b"))
    got = FedEMNIST(str(tmp_path / "a"), train=train)
    ref = JFedEMNIST(str(tmp_path / "b"), train=train)
    _same(got, ref)
    if train:
        assert got.images_per_client.tolist() == [6, 4, 5]
        assert got.arrays["image"].shape == (15, 28, 28, 1)
        assert got.arrays["image"].dtype == np.float32
    else:
        assert len(got) == 5


def test_synthetic_fallback_is_bitwise_the_reference(tmp_path, capsys):
    got = FedEMNIST(str(tmp_path / "a"))
    ref = JFedEMNIST(str(tmp_path / "b"))
    assert "WARNING: no LEAF json" in capsys.readouterr().out
    _same(got, ref)
    assert got.num_clients == 20
    _same(FedEMNIST(str(tmp_path / "a"), train=False),
          JFedEMNIST(str(tmp_path / "b"), train=False))
    with open(tmp_path / "a" / "stats_FedEMNIST.json") as f:
        mine = json.load(f)
    with open(tmp_path / "b" / "stats_FedEMNIST.json") as f:
        theirs = json.load(f)
    assert mine == theirs and mine["synthetic"] == {"protos": "shared-v1"}


@pytest.mark.parametrize("first", ["port", "reference"])
def test_one_prepared_directory_serves_both(tmp_path, first):
    root = str(tmp_path)
    write_leaf_femnist(root)
    prep, other = ((FedEMNIST, JFedEMNIST) if first == "port"
                   else (JFedEMNIST, FedEMNIST))
    a = prep(root)
    names = sorted(os.listdir(root))
    assert {"FedEMNIST_train.npz", "FedEMNIST_val.npz",
            "stats_FedEMNIST.json"} <= set(names)
    b = other(root)
    assert sorted(os.listdir(root)) == names      # read, not prepared again
    _same(a, b)


def test_missing_test_split_raises(tmp_path):
    write_leaf_femnist(str(tmp_path))
    for fn in os.listdir(tmp_path / "test"):
        os.unlink(tmp_path / "test" / fn)
    with pytest.raises(FileNotFoundError, match="test split is missing"):
        FedEMNIST(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="synthetic=False"):
        FedEMNIST(str(tmp_path / "empty"), synthetic=False)


def test_stale_synthetic_marker_reprepares(tmp_path):
    root = str(tmp_path)
    fresh = FedEMNIST(root, synthetic=True)
    stats = tmp_path / "stats_FedEMNIST.json"
    meta = json.loads(stats.read_text())
    meta["synthetic"] = {"protos": "shared-v0"}
    stats.write_text(json.dumps(meta))
    np.savez(tmp_path / "FedEMNIST_train.npz",
             images=np.zeros((3, 28, 28), np.float32),
             targets=np.zeros(3, np.int64))
    again = FedEMNIST(root, synthetic=True)
    _same(again, fresh)
    assert json.loads(stats.read_text())["synthetic"] == \
        {"protos": "shared-v1"}


def test_host_transforms_are_bitwise_the_reference():
    rng = np.random.RandomState(0)
    batch = {"image": rng.rand(2, 5, 28, 28, 1).astype(np.float32),
             "target": rng.randint(0, 62, (2, 5))}
    got = T.transforms_for("EMNIST", False)(batch)["image"]
    ref = JT.FemnistEval()(batch)["image"]
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    got = T.transforms_for("EMNIST", True, seed=5)(batch)["image"]
    ref = JT.transforms_for("EMNIST", True, seed=5)(batch)["image"]
    assert got.shape == (2, 5, 28, 28, 1)
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_store_emnist_crop_equals_numpy_crop(tmp_path):
    """The draws are torch's: the store's crop is held to a numpy edge-pad
    crop at the offsets the store drew for the round, then normalised as
    the host does (bitwise), with no flip."""
    ds = FedEMNIST(str(tmp_path), synthetic=True)
    store = make_device_store(ds, "EMNIST", True, "cpu", seed=21)
    assert store.augment == "emnist_train"
    assert store.arrays["image"].dtype == torch.float32
    idx = np.arange(40).reshape(4, 10)[:, ::-1]
    out = store.round_batch(idx, 7)["image"].reshape(-1, 28, 28, 1)
    offs, flips = store.draw_offsets(idx.size, 7)
    assert flips is None and int(offs.max()) <= 4
    src = np.pad(ds.arrays["image"][idx.reshape(-1)],
                 [(0, 0), (2, 2), (2, 2), (0, 0)], mode="edge")
    want = np.stack([src[i, dy:dy + 28, dx:dx + 28]
                     for i, (dy, dx) in enumerate(offs.numpy().T)])
    want = (want - T.FEMNIST_MEAN) / T.FEMNIST_STD
    assert np.array_equal(out.numpy().view(np.int32), want.view(np.int32))
    assert len({tuple(o) for o in offs.numpy().T}) > 1
    assert not torch.equal(store.round_batch(idx, 8)["image"],
                           store.round_batch(idx, 7)["image"])
    val = make_device_store(FedEMNIST(str(tmp_path), train=False,
                                      synthetic=True), "EMNIST", False, "cpu")
    assert val.augment == "normalize"
    # above the byte limit the split goes to the host path
    assert make_device_store(ds, "EMNIST", True, "cpu", max_bytes=1) is None
    with pytest.raises(ValueError, match="augment"):
        DeviceStore(ds.arrays, "cpu", "emnist_flip", T.FEMNIST_MEAN,
                    T.FEMNIST_STD)
