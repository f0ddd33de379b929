"""The port's native host gather (``commefficient_torch/csrc/fedloader.cpp``
through ``data/native.py``) against the JAX package's (``native/
fedloader.cpp`` through its ``data/native.py``), on the CPU with g++.

Both libraries are built from the same arithmetic with the same flags, so
they are held bit for bit (int32 views); so is the port's default
host-path CIFAR batch (``FedDataset.gather`` through ``CifarTrain`` and
``CifarEval``) against the JAX package's default. The numpy twins
(``chip_smoke.native_gather_augment_plain`` and
``native_gather_normalize_plain``, which the card's run uses too) draw
the same splitmix64 stream and index the same pixels, but GCC may fuse the
normalisation's multiply and subtract under ``-march=native``, so their
values are held within ``NATIVE_PLAIN_ATOL`` (2^-21) with every
element's source pixel checked exactly. ``COMMEFFICIENT_NATIVE=0``
selects the numpy stream of the host transforms, and a failed build
raises with the compiler's output.
"""

import os

import numpy as np
import pytest

from test_torch_round import CH  # noqa: F401,E402 (installs the import fix)

from commefficient_tpu.data import fed_cifar as j_cifar  # noqa: E402
from commefficient_tpu.data import native as j_native  # noqa: E402
from commefficient_tpu.data import transforms as j_transforms  # noqa: E402

from commefficient_torch.data import fed_cifar, native  # noqa: E402
from commefficient_torch.data import transforms as T  # noqa: E402
from chip_smoke import (NATIVE_PLAIN_ATOL,  # noqa: E402
                        native_gather_augment_plain,
                        native_gather_normalize_plain)

MEAN, STD = T.CIFAR10_MEAN, T.CIFAR10_STD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one intra-op thread in this file: at these sizes more
    threads only spin while the test run's other workers share the
    machine's cores."""
    import torch_mesh_ranks as ranks
    with ranks.one_thread():
        yield


def _images(n=40, hw=32, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.fixture(scope="module")
def jax_native():
    if not j_native.available():
        pytest.fail("the JAX package's native gather did not build")
    return j_native


@pytest.mark.parametrize("pad,flip,seed", [(4, True, (5 << 20) + 1),
                                           (4, True, (21 << 20) + 7),
                                           (2, False, 3), (0, True, 11)])
def test_library_bitwise_the_reference_library(jax_native, pad, flip, seed):
    images = _images()
    idx = np.random.RandomState(1).randint(0, len(images), (3, 70))
    got = native.gather_augment(images, idx, MEAN, STD, pad, flip, seed)
    ref = jax_native.gather_augment(images, idx, MEAN, STD, pad, flip,
                                    seed)
    assert got.shape == (3, 70, 32, 32, 3) and got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(ref))
    got = native.gather_normalize(images, idx, MEAN, STD)
    ref = jax_native.gather_normalize(images, idx, MEAN, STD)
    assert np.array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("threads", [1, 2, 3, 7, 16])
def test_any_thread_count_gives_the_same_bits(threads):
    images = _images()
    idx = np.random.RandomState(2).randint(0, len(images), 200)
    one = native.gather_augment(images, idx, MEAN, STD, 4, True, 99,
                                num_threads=1)
    got = native.gather_augment(images, idx, MEAN, STD, 4, True, 99,
                                num_threads=threads)
    assert np.array_equal(_bits(one), _bits(got))


def test_plain_twin_draws_the_same_pixels():
    """The twin against the library: within NATIVE_PLAIN_ATOL everywhere,
    and each output element the normalisation of the same source pixel
    (the value that the unfused arithmetic gives for the library's pixel
    is the twin's, exactly)."""
    images = _images(hw=12)
    idx = np.random.RandomState(3).randint(0, len(images), (2, 50))
    for pad, flip in ((4, True), (2, False), (0, True)):
        got = native.gather_augment(images, idx, MEAN, STD, pad, flip, 1234)
        twin = native_gather_augment_plain(images, idx, MEAN, STD, pad,
                                           flip, 1234)
        assert np.abs(got - twin).max() <= NATIVE_PLAIN_ATOL
        # invert the library's values to pixels: each is the twin's pixel
        px = np.rint((got * STD + MEAN) * 255).astype(np.int64)
        px_twin = np.rint((twin * STD + MEAN) * 255).astype(np.int64)
        assert np.array_equal(px, px_twin)
    got = native.gather_normalize(images, idx, MEAN, STD)
    twin = native_gather_normalize_plain(images, idx, MEAN, STD)
    assert np.abs(got - twin).max() <= NATIVE_PLAIN_ATOL


@pytest.mark.parametrize("do_iid", [False, True], ids=["natural", "iid"])
def test_default_host_batches_bitwise_the_reference(tmp_path, jax_native,
                                                    do_iid):
    """The repair: with g++ present both packages' default host path takes
    the native gather, so the port's CIFAR train batches (two rounds: the
    seed's call counter advances) and eval batches are the JAX package's
    bit for bit."""
    root = str(tmp_path)
    kw = dict(do_iid=do_iid, num_clients=5 if do_iid else None,
              synthetic=True, synthetic_per_class=6)
    j = j_cifar.FedCIFAR10(root, transform=j_transforms.CifarTrain(seed=5),
                           **kw)
    t = fed_cifar.FedCIFAR10(root, transform=T.CifarTrain(seed=5), **kw)
    idx = np.random.RandomState(0).randint(0, len(t), (3, 4))
    for _ in range(2):
        a, b = j.gather(idx), t.gather(idx)
        assert np.array_equal(a["target"], b["target"])
        assert np.array_equal(_bits(a["image"]), _bits(b["image"]))
    # and not the numpy stream's crops
    numpy_crops = T.CifarTrain(seed=5)(
        {"image": t.arrays["image"][t.iid_shuffle[idx] if do_iid else idx]})
    assert not np.array_equal(numpy_crops["image"], b["image"])
    j.transform, t.transform = j_transforms.CifarEval(), T.CifarEval()
    assert np.array_equal(_bits(j.gather(idx)["image"]),
                          _bits(t.gather(idx)["image"]))


def test_native_off_selects_the_numpy_stream(tmp_path, monkeypatch):
    root = str(tmp_path)
    t = fed_cifar.FedCIFAR10(root, transform=T.CifarTrain(seed=5),
                             synthetic=True, synthetic_per_class=6)
    idx = np.arange(12).reshape(3, 4)
    monkeypatch.setenv("COMMEFFICIENT_NATIVE", "0")
    assert not native.enabled()
    got = t.gather(idx)["image"]
    ref = T.CifarTrain(seed=5)({"image": t.arrays["image"][idx]})["image"]
    assert np.array_equal(_bits(got), _bits(ref))
    # transforms without a native form keep their numpy path
    assert not hasattr(T.ImagenetTrain(), "gather_fused")
    assert not hasattr(T.ImagenetEval(), "gather_fused")
    assert not hasattr(T.FemnistEval(), "gather_fused")


def test_bad_inputs_and_a_failed_build_raise(tmp_path, monkeypatch):
    images = _images(n=4)
    with pytest.raises(IndexError):
        native.gather_normalize(images, np.array([4]), MEAN, STD)
    with pytest.raises(ValueError, match="uint8"):
        native.gather_normalize(images.astype(np.float32), np.array([0]),
                                MEAN, STD)
    with pytest.raises(ValueError, match="mean"):
        native.gather_normalize(images, np.array([0]), MEAN[:2], STD)
    broken = tmp_path / "fedloader.cpp"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed") as err:
        native.load()
    assert "fedloader.cpp" in str(err.value) and "error" in str(err.value)
    assert not any(f.endswith(".so")
                   for f in os.listdir(tmp_path / "build"))
