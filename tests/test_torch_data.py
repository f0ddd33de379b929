"""The port's data layer (data/fed_dataset.py, fed_cifar.py,
device_store.py) against the JAX package's, on the CPU, on tiny CIFAR
pickle directories written here in the CIFAR python-pickle schema (as
tests/test_fixtures.py writes them).

A directory prepared by either package is read by the other into equal
arrays; partitions, the iid permutation and ``gather`` are equal; the
device store's normalise path is the host ``CifarEval`` bit for bit, its
train path is a reflect-pad-4 crop (flipped or not) of each source image,
drawn by (seed, round). The JAX package's store multiplies by reciprocals
where the host divides (XLA rewrites a division by a constant), so it is
held to the port's within 1e-6 (the normalised values are at most 2.1).
The slice test runs ``cv_train.main`` of both packages on a CIFAR10
directory at a narrow width and holds the epoch rows to rtol 1e-5 and
the final weights to atol 1e-6, the tolerances of
tests/test_torch_driver.py.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_round import CH  # noqa: E402 (installs the import fix)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import commefficient_tpu.cv_train as j_cv  # noqa: E402
from commefficient_tpu.data import fed_cifar as j_cifar  # noqa: E402
from commefficient_tpu.data import transforms as j_transforms  # noqa: E402
from commefficient_tpu.data.device_store import \
    DeviceStore as JDeviceStore  # noqa: E402
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9  # noqa

from commefficient_torch import cv_train  # noqa: E402
from commefficient_torch.data import fed_cifar  # noqa: E402
from commefficient_torch.data import transforms as T  # noqa: E402
from commefficient_torch.data.device_store import (  # noqa: E402
    CROP_PAD, DeviceStore, make_device_store)
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.resnet9 import ResNet9  # noqa: E402


@pytest.fixture(autouse=True)
def _runs_under_tmp(tmp_path, monkeypatch):
    """The entry points' default run directory (``runs/<stamp>_...``, the
    telemetry stream) lands under the test's tmp dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


PER_BATCH = 20
NAMES = ("CIFAR10", "CIFAR100")


def write_cifar_pickles(root, name="CIFAR10", per_batch=PER_BATCH):
    """A tiny ``cifar-10-batches-py`` (5 train batches and a test batch of
    ``per_batch`` images, ``b"labels"``) or ``cifar-100-python`` (``train``
    of 5 x ``per_batch`` images, ``test``, ``b"fine_labels"``): dicts with
    ``b"data"`` (N, 3072) uint8 rows, channel-major."""
    cls = fed_cifar.DATASETS[name]
    d = os.path.join(root, cls.pickle_dir)
    os.makedirs(d, exist_ok=True)

    def batch(seed, n):
        r = np.random.RandomState(seed)
        return {b"data": r.randint(0, 256, (n, 3072), dtype=np.uint8),
                cls.label_key: [int(x) for x in
                                r.randint(0, cls.num_classes, n)]}

    files = {f: batch(i + 1, per_batch * 5 // len(cls.train_files))
             for i, f in enumerate(cls.train_files)}
    files[cls.test_file] = batch(99, per_batch)
    for fn, content in files.items():
        with open(os.path.join(d, fn), "wb") as f:
            pickle.dump(content, f)
    return root


def _pair(name):
    return getattr(j_cifar, "Fed" + name), fed_cifar.DATASETS[name]


def _same_arrays(a, b):
    assert a.arrays.keys() == b.arrays.keys()
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype
        assert np.array_equal(a.arrays[k], b.arrays[k]), k
    assert np.array_equal(a.images_per_client, b.images_per_client)
    assert a.num_val_images == b.num_val_images and len(a) == len(b)


@pytest.mark.parametrize("source", ["pickles", "synthetic"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", NAMES)
def test_prepared_directory_reads_across_packages(tmp_path, capsys, name,
                                                  writer, source):
    """One package prepares the directory (from the pickles, or its
    synthetic set); the other reads it without preparing again, into equal
    arrays, train and test."""
    j_cls, t_cls = _pair(name)
    root = str(tmp_path)
    kw = {}
    if source == "pickles":
        write_cifar_pickles(root, name)
    else:
        kw = dict(synthetic=True, synthetic_per_class=3)
    first, second = (j_cls, t_cls) if writer == "jax" else (t_cls, j_cls)
    for train in (True, False):
        a = first(root, train=train, **kw)
        stamp = {fn: os.stat(os.path.join(root, fn)).st_mtime_ns
                 for fn in os.listdir(root)}
        b = second(root, train=train, **kw)
        assert {fn: os.stat(os.path.join(root, fn)).st_mtime_ns
                for fn in os.listdir(root)} == stamp
        _same_arrays(a, b)
    if source == "pickles":
        raw = pickle.load(open(os.path.join(
            root, t_cls.pickle_dir, t_cls.test_file), "rb"),
            encoding="bytes")
        assert np.array_equal(b.arrays["image"], raw[b"data"].reshape(
            -1, 3, 32, 32).transpose(0, 2, 3, 1))
    assert "WARNING" not in capsys.readouterr().out


def test_legacy_layout_is_read_by_both(tmp_path):
    """A directory in the reference's unprefixed layout (``stats.json``,
    ``client{i}.npy``, ``test.npz``) is read as it is by both packages."""
    root = str(tmp_path)
    write_cifar_pickles(root)
    src = fed_cifar.FedCIFAR10(root)
    for c in range(10):
        os.replace(src.client_fn(c), os.path.join(root, f"client{c}.npy"))
    os.replace(src.test_fn(), os.path.join(root, "test.npz"))
    os.replace(src.stats_fn(), os.path.join(root, "stats.json"))
    for train in (True, False):
        _same_arrays(j_cifar.FedCIFAR10(root, train=train),
                     fed_cifar.FedCIFAR10(root, train=train))
    assert not any(fn.startswith("FedCIFAR10") for fn in os.listdir(root))


@pytest.mark.parametrize("do_iid,num_clients",
                         [(False, None), (False, 20), (True, 7),
                          (True, None)],
                         ids=["natural", "split", "iid7", "iid_natural"])
def test_partitions_shuffle_and_gather_match_reference(tmp_path, monkeypatch,
                                                       do_iid, num_clients):
    """``data_per_client``, ``iid_shuffle`` and ``gather`` (raw, and through
    the seeded host transform) equal the JAX package's, both on the numpy
    stream of the host transform, selected on each side (the native host
    gather draws another stream: tests/test_torch_native.py holds it)."""
    from commefficient_tpu.data import native
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("COMMEFFICIENT_NATIVE", "0")
    root = write_cifar_pickles(str(tmp_path))
    kw = dict(do_iid=do_iid, num_clients=num_clients)
    j = j_cifar.FedCIFAR10(root, transform=j_transforms.CifarTrain(seed=5),
                           **kw)
    t = fed_cifar.FedCIFAR10(root, transform=T.CifarTrain(seed=5), **kw)
    assert np.array_equal(j.data_per_client, t.data_per_client)
    assert j.num_clients == t.num_clients
    if do_iid:
        assert np.array_equal(j.iid_shuffle, t.iid_shuffle)
    idx = np.random.RandomState(0).randint(0, len(t), (3, 4))
    j.transform = t.transform = None
    raw_j, raw_t = j.gather(idx), t.gather(idx)
    assert all(np.array_equal(raw_j[k], raw_t[k]) for k in raw_j)
    j.transform = j_transforms.CifarTrain(seed=5)
    t.transform = T.CifarTrain(seed=5)
    for _ in range(2):          # the host transform's draws advance alike
        a, b = j.gather(idx), t.gather(idx)
        assert np.array_equal(a["target"], b["target"])
        assert np.array_equal(a["image"].view(np.int32),
                              b["image"].view(np.int32))


def test_partition_refusals_match_reference(tmp_path):
    root = write_cifar_pickles(str(tmp_path))
    for cls in (j_cifar.FedCIFAR10, fed_cifar.FedCIFAR10):
        with pytest.raises(ValueError, match="1 client when non-iid"):
            cls(root, num_clients=1)
        with pytest.raises(ValueError, match="multiple of the natural"):
            _ = cls(root, num_clients=15).data_per_client
        assert cls(root, do_iid=True, num_clients=1).data_per_client \
            .tolist() == [100]


def test_synthetic_switch(tmp_path, capsys):
    """No pickles: None falls back with the JAX package's warning, False
    raises; True forces the synthetic set beside real pickles; another
    ``synthetic_per_class`` prepares again."""
    root = str(tmp_path / "none")
    for cls in (j_cifar.FedCIFAR10, fed_cifar.FedCIFAR10):
        with pytest.raises(FileNotFoundError, match="synthetic=False"):
            cls(str(tmp_path / cls.__module__), synthetic=False)
    ds = fed_cifar.FedCIFAR10(root, synthetic_per_class=3)
    out = capsys.readouterr().out
    assert (f"WARNING: no cifar-10-batches-py under {root}; generating "
            "synthetic data") in out
    assert len(ds) == 30
    ref = fed_cifar.synthetic_cifar(10, 3)
    assert np.array_equal(ds.arrays["image"], ref[0])
    assert len(fed_cifar.FedCIFAR10(root, synthetic_per_class=5)) == 50
    real = write_cifar_pickles(str(tmp_path / "real"))
    assert len(fed_cifar.FedCIFAR10(real, synthetic=True,
                                    synthetic_per_class=2)) == 20


def _arrays(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8),
            "target": rng.randint(0, 10, n).astype(np.int64)}


@pytest.mark.parametrize("name", NAMES)
def test_store_normalise_path_is_the_host_path(name):
    arrays, (mean, std) = _arrays(), T.NORMALIZE[name]
    idx = np.random.RandomState(1).randint(0, 40, (3, 8))
    got = DeviceStore(arrays, "cpu", augment="normalize", mean=mean,
                      std=std).round_batch(idx)
    host = T.transforms_for(name, False)(
        {k: v[idx] for k, v in arrays.items()})
    assert got["image"].dtype == torch.float32
    assert np.array_equal(got["image"].numpy().view(np.int32),
                          host["image"].view(np.int32))
    assert np.array_equal(got["target"].numpy(), arrays["target"][idx])
    ref = JDeviceStore(arrays, augment="normalize", mean=mean, std=std)
    np.testing.assert_allclose(
        np.asarray(ref.round_batch(idx, None)["image"]),
        got["image"].numpy(), rtol=0, atol=1e-6)


def _candidates(src: np.ndarray, mean, std) -> np.ndarray:
    """Every reflect-pad-4 crop of ``src`` and its mirror, normalised as
    the host does: (2 x 81, 32, 32, 3)."""
    p = CROP_PAD
    x = src.astype(np.float32) / 255.0
    padded = np.pad(x, [(p, p), (p, p), (0, 0)], mode="reflect")
    crops = [padded[dy:dy + 32, dx:dx + 32]
             for dy in range(2 * p + 1) for dx in range(2 * p + 1)]
    crops += [c[:, ::-1] for c in crops]
    return (np.stack(crops) - mean) / std


def test_store_train_path_crops_and_flips_by_round():
    arrays = _arrays()
    mean, std = T.NORMALIZE["CIFAR10"]
    store = DeviceStore(arrays, "cpu", augment="cifar_train", mean=mean,
                        std=std, seed=21)
    idx = np.arange(24).reshape(3, 8)
    out = store.round_batch(idx, 5)["image"]
    assert out.shape == (3, 8, 32, 32, 3)
    flat = out.reshape(-1, 32, 32, 3).numpy()
    kinds = set()
    for i, src in enumerate(idx.reshape(-1)):
        cands = _candidates(arrays["image"][src], mean, std)
        hit = np.flatnonzero([np.array_equal(c, flat[i]) for c in cands])
        assert len(hit) >= 1, f"image {i} is no crop of its source"
        kinds.add(int(hit[0]) >= 81)
    assert kinds == {False, True}          # some flipped, some not
    assert torch.equal(store.round_batch(idx, 5)["image"], out)
    assert not torch.equal(store.round_batch(idx, 6)["image"], out)
    again = DeviceStore(arrays, "cpu", augment="cifar_train", mean=mean,
                        std=std, seed=21)
    assert torch.equal(again.round_batch(idx, 5)["image"], out)
    with pytest.raises(ValueError, match="round_index"):
        store.round_batch(idx)


def test_store_iid_path_and_gate(tmp_path, monkeypatch):
    # the host path's numpy stream, which the store's normalise equals bit
    # for bit (the native gather fuses a multiply-add)
    monkeypatch.setenv("COMMEFFICIENT_NATIVE", "0")
    root = write_cifar_pickles(str(tmp_path))
    ds = fed_cifar.FedCIFAR10(root, do_iid=True, num_clients=7,
                              transform=T.CifarEval())
    store = make_device_store(ds, "CIFAR10", True, "cpu", no_augment=True)
    assert store.augment == "normalize"
    idx = np.arange(14).reshape(2, 7)
    got = store.round_batch(idx, 1)
    host = ds.gather(idx)
    assert np.array_equal(got["target"].numpy(), host["target"])
    assert np.array_equal(got["image"].numpy(), host["image"])
    assert not np.array_equal(host["target"],
                              ds.arrays["target"][idx])
    assert make_device_store(ds, "CIFAR10", True, "cpu").augment == \
        "cifar_train"
    val = make_device_store(ds, "CIFAR10", False, "cpu")
    assert val.augment == "normalize" and val.iid_shuffle is None
    assert store.nbytes == ds.arrays["image"].nbytes + \
        ds.arrays["target"].nbytes
    assert make_device_store(ds, "CIFAR10", True, "cpu",
                             max_bytes=1000) is None
    assert make_device_store(ds, "PERSONA", True, "cpu") is None


def _jax_init(seed, num_classes):
    jm = JResNet9(num_classes=num_classes, channels=CH)
    return jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))


def narrow_port_model(cfg, num_classes):
    """The port's ResNet-9 at the test's narrow width, with the weights the
    JAX package's driver draws for ``--seed``."""
    tm = ResNet9(num_classes=num_classes, channels=CH)
    params = jax.tree.map(np.asarray, _jax_init(cfg.seed, num_classes))
    with torch.no_grad():
        tm.flat.copy_(params_from_jax(params, tm))
    return tm


SLICE_ARGV = ["--dataset_name", "CIFAR10", "--model", "ResNet9",
              "--mode", "sketch", "--error_type", "virtual",
              "--virtual_momentum", "0.9", "--local_momentum", "0",
              "--num_workers", "4", "--local_batch_size", "8", "--k", "200",
              "--num_rows", "5", "--num_cols", "4096", "--num_epochs", "2",
              "--compute_dtype", "float32", "--no_augment",
              "--valid_batch_size", "20", "--lr_scale", "0.1"]


@pytest.mark.parametrize("port_path", ["store", "host"])
def test_cv_train_slice_matches_reference(tmp_path, monkeypatch, capsys,
                                          port_path):
    """``cv_train.main`` of both packages on a CIFAR10 pickle directory,
    narrow ResNet-9, the sketch round, 2 epochs: each epoch row within the
    driver tests' tolerances, the final weights within atol 1e-6, and the
    port's rounds fed by its device store, or by its host path where the
    store's gate refuses (an oversize set). The JAX run takes its host
    path (numpy gather and ``CifarEval``), whose images the port's store
    gives bit for bit; the JAX store's differ from them in the last bits,
    which the network carries past rtol 1e-5. Both host paths take the
    numpy stream, selected on each side (the native gather normalises
    with a fused multiply-add, whose last bits differ from numpy's)."""
    from commefficient_tpu.data import native
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("COMMEFFICIENT_NATIVE", "0")
    monkeypatch.setattr(j_cv, "make_device_store", lambda *a, **k: None)
    if port_path == "host":
        monkeypatch.setattr(cv_train, "make_device_store",
                            lambda *a, **k: None)
    root = write_cifar_pickles(str(tmp_path))
    argv = SLICE_ARGV + ["--dataset_dir", root]
    monkeypatch.setattr(
        j_cv, "build_model",
        lambda cfg, n: JResNet9(num_classes=n, channels=CH))
    monkeypatch.setattr(cv_train, "build_model", narrow_port_model)
    rows, j_out = [], {}

    class Rows(j_cv.TableLogger):
        def append(self, output):
            rows.append(dict(output))
            super().append(output)

    def j_train(*args, **kw):
        j_out["state"], summary = train(*args, **kw)
        return j_out["state"], summary

    train = j_cv.train
    monkeypatch.setattr(j_cv, "TableLogger", Rows)
    monkeypatch.setattr(j_cv, "train", j_train)
    j_cv.main(argv + ["--no_telemetry"])
    out = cv_train.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    if port_path == "store":
        assert "data: device store on cpu: train 0.3 MiB (normalize" in \
            printed
    else:
        assert "data: host path" in printed
    assert [r["epoch"] for r in out["epochs"]] == [r["epoch"] for r in rows]
    for got, ref in zip(out["epochs"], rows):
        for key in ("train_loss", "train_acc", "test_loss", "test_acc",
                    "lr"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
        assert got["down (MiB)"] == ref["down (MiB)"]
        assert got["up (MiB)"] == ref["up (MiB)"]
    np.testing.assert_allclose(out["state"].ps_weights.numpy(),
                               np.asarray(j_out["state"].ps_weights),
                               atol=1e-6)
    assert out["state"].step == int(j_out["state"].step) == 8
