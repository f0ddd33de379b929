"""The ImageNet slice of the port against the JAX package, on the CPU:
``FedImageNet``'s synthetic arrays (bitwise) and its PIL tree ingest (on a
small tree written here, resized to 32 x 32, bitwise), one prepared
directory read by both packages, ``ImagenetTrain``/``ImagenetEval``
(bitwise), the device store's ``imagenet_train`` (each image its
normalised self or its mirror, drawn by round; the evaluation store
bitwise the host ``ImagenetEval``), CIFAR's hard synthetic regime and
label noise (bitwise), the FixupResNet50 layout at 224 x 224 x 3 and
1,000 classes against ``jax.eval_shape`` (d = 25,504,026), a narrow
ResNet-9 sketch round on a synthetic ImageNet at 32 x 32 against the JAX
runtime (rtol 1e-5 on the losses, atol 1e-6 on the weights: the
tolerances of tests/test_torch_round.py), the recipe's command line, and
the entry point on a synthetic ImageNet at 224 x 224.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_round import CH, SLICE, _jcfg  # noqa: E402 (import fix)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.core import FedRuntime as JRuntime  # noqa: E402
from commefficient_tpu.data import fed_cifar as j_cifar  # noqa: E402
from commefficient_tpu.data import transforms as JT  # noqa: E402
from commefficient_tpu.data.fed_imagenet import \
    FedImageNet as JFedImageNet  # noqa: E402
from commefficient_tpu.losses import make_cv_loss as j_cv_loss  # noqa
from commefficient_tpu.models import fixup_resnet as j_fixup  # noqa: E402
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9  # noqa

from commefficient_torch import cv_train  # noqa: E402
from commefficient_torch.config import FedConfig  # noqa: E402
from commefficient_torch.core.runtime import FedRuntime  # noqa: E402
from commefficient_torch.data import fed_cifar  # noqa: E402
from commefficient_torch.data import transforms as T  # noqa: E402
from commefficient_torch.data.device_store import \
    make_device_store  # noqa: E402
from commefficient_torch.data.fed_imagenet import FedImageNet  # noqa
from commefficient_torch.data.fed_sampler import FedSampler  # noqa: E402
from commefficient_torch.losses import make_cv_loss  # noqa: E402
from commefficient_torch.models.convert import params_from_jax  # noqa
from commefficient_torch.models.fixup_resnet import (  # noqa: E402
    FixupResNet50, FixupResNetImageNet)
from commefficient_torch.models.resnet9 import ResNet9  # noqa: E402


@pytest.fixture(autouse=True)
def _runs_under_tmp(tmp_path, monkeypatch):
    """The entry points' default run directory (``runs/<stamp>_...``, the
    telemetry stream) lands under the test's tmp dir, not the checkout."""
    monkeypatch.chdir(tmp_path)


SYN = dict(synthetic=True, image_size=32, synthetic_num_classes=4,
           synthetic_per_class=8)
IMAGENET_D = 25_504_026


def _same_arrays(a, b):
    assert a.arrays.keys() == b.arrays.keys()
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype
        assert np.array_equal(a.arrays[k], b.arrays[k]), k
    assert np.array_equal(a.images_per_client, b.images_per_client)


def _stats(root, cls="FedImageNet"):
    with open(os.path.join(root, f"stats_{cls}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_synthetic_sets_are_shared_and_bitwise(tmp_path, first):
    """Either package prepares the synthetic set; the other reads the
    same directory without preparing again, into equal arrays."""
    root = str(tmp_path)
    order = ((JFedImageNet, FedImageNet) if first == "jax"
             else (FedImageNet, JFedImageNet))
    for train in (True, False):
        a = order[0](root, train=train, **SYN)
        stamp = os.path.getmtime(os.path.join(root,
                                              "stats_FedImageNet.json"))
        b = order[1](root, train=train, **SYN)
        assert os.path.getmtime(os.path.join(
            root, "stats_FedImageNet.json")) == stamp
        _same_arrays(a, b)
        assert a.num_classes == b.num_classes == 4
    assert _stats(root)["synthetic"] == dict(
        per_class=8, protos="shared-v3", hard=False, label_noise=0.0,
        num_classes=4, image_size=32)
    t = FedImageNet(root, **SYN)
    assert t.arrays["image"].shape == (32, 32, 32, 3)
    assert t.arrays["image"].dtype == np.uint8
    assert list(t.images_per_client) == [8] * 4


def test_synthetic_at_224_is_bitwise(tmp_path):
    kw = dict(synthetic=True, synthetic_num_classes=2, synthetic_per_class=2)
    a = JFedImageNet(str(tmp_path / "j"), **kw)
    b = FedImageNet(str(tmp_path / "t"), **kw)
    _same_arrays(a, b)
    assert b.arrays["image"].shape == (4, 224, 224, 3)


def _write_tree(root):
    """train/<wnid>/ and val/<wnid>/ of PNG and JPEG images of assorted
    sizes and modes, from a seed."""
    from PIL import Image
    rng = np.random.RandomState(0)
    for split, per in (("train", 3), ("val", 2)):
        for c, wnid in enumerate(("n01440764", "n01443537", "n01484850")):
            d = os.path.join(root, split, wnid)
            os.makedirs(d)
            for i in range(per):
                h, w = rng.randint(20, 90, 2)
                px = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                im = Image.fromarray(px)
                if i == 1:
                    im = im.convert("L")
                ext = "png" if (i + c) % 2 else "jpg"
                im.save(os.path.join(d, f"img{i}.{ext}"))


def test_tree_ingest_is_bitwise_and_shared(tmp_path):
    root = str(tmp_path)
    _write_tree(root)
    t_train = FedImageNet(root, image_size=32)
    t_val = FedImageNet(root, train=False, image_size=32)
    assert list(t_train.images_per_client) == [3, 3, 3]
    assert t_train.arrays["image"].shape == (9, 32, 32, 3)
    assert list(t_val.arrays["target"]) == [0, 0, 1, 1, 2, 2]
    assert "synthetic" not in _stats(root)
    # the JAX package reads the port's prep, and prepares the same bits
    _same_arrays(JFedImageNet(root, image_size=32), t_train)
    other = str(tmp_path / "other")
    os.makedirs(other)
    os.rename(os.path.join(root, "train"), os.path.join(other, "train"))
    os.rename(os.path.join(root, "val"), os.path.join(other, "val"))
    _same_arrays(JFedImageNet(other, image_size=32), t_train)
    _same_arrays(JFedImageNet(other, train=False, image_size=32), t_val)
    for synthetic in (False, None):
        with pytest.raises(FileNotFoundError, match="no train/ image tree"):
            FedImageNet(str(tmp_path / "empty"), synthetic=synthetic)


def test_host_transforms_are_bitwise_the_reference():
    rng = np.random.RandomState(0)
    batch = {"image": rng.randint(0, 256, (2, 3, 16, 16, 3)).astype(
        np.uint8), "target": rng.randint(0, 10, (2, 3))}
    for train in (False, True):
        got = T.transforms_for("ImageNet", train, seed=5)(batch)["image"]
        ref = JT.transforms_for("ImageNet", train, seed=5)(batch)["image"]
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    assert np.array_equal(T.IMAGENET_MEAN, JT.IMAGENET_MEAN)
    assert np.array_equal(T.IMAGENET_STD, JT.IMAGENET_STD)


def test_store_flips_by_round_and_normalises_as_the_host(tmp_path):
    root = str(tmp_path)
    ds = FedImageNet(root, do_iid=True, num_clients=3, **SYN)
    store = make_device_store(ds, "ImageNet", True, "cpu", seed=21)
    assert store.augment == "imagenet_train"
    idx = np.arange(24).reshape(3, 8)
    got = store.round_batch(idx, 4)["image"].numpy()
    host = T.ImagenetEval()({"image": ds.arrays["image"][
        ds.iid_shuffle[idx]]})["image"]
    same = (got == host).all(axis=(2, 3, 4))
    mirror = (got == host[:, :, :, ::-1]).all(axis=(2, 3, 4))
    assert (same | mirror).all() and same.any() and mirror.any()
    assert np.array_equal(store.round_batch(idx, 4)["image"].numpy(), got)
    assert not np.array_equal(store.round_batch(idx, 5)["image"].numpy(),
                              got)
    val_ds = FedImageNet(root, train=False, **SYN)
    val = make_device_store(val_ds, "ImageNet", False, "cpu")
    assert val.augment == "normalize"
    vidx = np.arange(len(val_ds))
    ref = T.ImagenetEval()({"image": val_ds.arrays["image"][vidx]})["image"]
    assert np.array_equal(val.round_batch(vidx)["image"].numpy().view(
        np.int32), ref.view(np.int32))
    assert make_device_store(ds, "ImageNet", True, "cpu",
                             no_augment=True).augment == "normalize"
    assert make_device_store(ds, "ImageNet", True, "cpu",
                             max_bytes=1000) is None


@pytest.mark.parametrize("hard,noise", [(True, 0.0), (True, 0.3),
                                        (False, 0.25)])
def test_cifar_hard_regime_and_label_noise_are_bitwise(tmp_path, hard,
                                                       noise):
    kw = dict(synthetic=True, synthetic_per_class=6, synthetic_hard=hard,
              synthetic_label_noise=noise)
    for train in (True, False):
        j = j_cifar.FedCIFAR10(str(tmp_path / "j"), train=train, **kw)
        t = fed_cifar.FedCIFAR10(str(tmp_path / "t"), train=train, **kw)
        _same_arrays(j, t)
    assert _stats(str(tmp_path / "t"), "FedCIFAR10") == \
        _stats(str(tmp_path / "j"), "FedCIFAR10")


def test_fixup_resnet50_imagenet_layout_matches_jax_eval_shape():
    ref = jax.eval_shape(
        lambda: j_fixup.FixupResNet50(num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    m = FixupResNet50(num_classes=1000, input_shape=(224, 224, 3),
                      device="meta")
    assert m.num_params == IMAGENET_D
    assert cv_train.build_model(
        FedConfig(dataset_name="ImageNet", model="FixupResNet50"), 1000,
        device="meta").num_params == IMAGENET_D
    want = [(p, s) for p, s in m.layout]
    got = [("/".join(str(getattr(k, "key", k)) for k in path),
            tuple(leaf.shape))
           for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert want == got
    # the weight converter accepts the JAX tree at this layout
    tree = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), ref)
    assert params_from_jax(tree, m).numel() == IMAGENET_D


def test_narrow_sketch_round_on_imagenet_matches_reference(tmp_path):
    root = str(tmp_path)
    j_ds = JFedImageNet(root, transform=JT.ImagenetEval(), **SYN)
    t_ds = FedImageNet(root, transform=T.ImagenetEval(), **SYN)
    W, B, c, r, k = 2, 4, 4096, 5, 200
    jm = JResNet9(num_classes=4, channels=CH)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)))
    jrt = JRuntime(_jcfg(k=k, num_rows=r, num_cols=c, num_workers=W,
                         local_batch_size=B, compute_dtype="float32"),
                   params, j_cv_loss(jm, "float32"), num_clients=4)
    tm = ResNet9(num_classes=4, channels=CH)
    with torch.no_grad():
        tm.flat.copy_(params_from_jax(jax.tree.map(np.asarray, params), tm))
    trt = FedRuntime(FedConfig(**SLICE, k=k, num_rows=r, num_cols=c,
                               num_workers=W, local_batch_size=B,
                               num_clients=4, compute_dtype="float32"),
                     tm, make_cv_loss(tm, "float32"), device="cpu")
    jst, tst = jrt.init_state(), trt.init_state()
    sampler = FedSampler(t_ds.data_per_client, W, B, seed=0)
    for i, rnd in zip(range(2), sampler):
        jb, tb = j_ds.gather(rnd.idx), t_ds.gather(rnd.idx)
        assert np.array_equal(jb["image"], tb["image"])
        jst, jmet = jrt.round(jst, jnp.asarray(rnd.client_ids),
                              {k: jnp.asarray(v) for k, v in jb.items()},
                              jnp.asarray(rnd.mask), 0.05)
        tst, tmet = trt.round(tst, rnd.client_ids, tb, rnd.mask, 0.05)
        np.testing.assert_allclose(tmet["results"][0].numpy(),
                                   np.asarray(jmet["results"][0]),
                                   rtol=1e-5)
    w = tst.ps_weights.numpy()
    assert (w != tm.flat.detach().numpy()).sum() > 0
    np.testing.assert_allclose(w, np.asarray(jrt.flat_weights(jst)),
                               rtol=0, atol=1e-6)


RECIPE = ["--dataset_name", "ImageNet", "--model", "FixupResNet50",
          "--mode", "uncompressed", "--error_type", "virtual",
          "--virtual_momentum", "0.9", "--local_momentum", "0",
          "--weight_decay", "1e-4", "--lr_scale", "0.4", "--pivot_epoch",
          "2", "--num_workers", "7", "--num_clients", "7", "--iid",
          "--local_batch_size", "64", "--valid_batch_size", "64",
          "--mesh_shape", "", "--checkpoint"]


def test_recipe_command_line_parses_and_meshes_refuse():
    cfg = cv_train.config_from_args(
        cv_train.parse_known(cv_train.build_parser(), RECIPE))
    assert (cfg.dataset_name, cfg.model, cfg.num_classes, cfg.input_shape,
            cfg.num_workers, cfg.do_iid, cfg.do_checkpoint) == (
        "ImageNet", "FixupResNet50", 1000, (224, 224, 3), 7, True, True)
    assert cfg.pipeline and cfg.prefetch_depth == 2
    with pytest.raises(ValueError, match="A9"):
        cv_train.config_from_args(cv_train.parse_known(
            cv_train.build_parser(), RECIPE[:-3] + ["--mesh_shape", "4"]))
    with pytest.raises(ValueError, match="--finetuned_from"):
        FedConfig(do_finetune=True)


def test_synthetic_hard_guards(tmp_path):
    with pytest.raises(ValueError, match="CIFAR synthetic-generator"):
        cv_train.build_datasets(FedConfig(dataset_name="ImageNet",
                                          synthetic_hard=True))
    os.makedirs(tmp_path / "cifar-10-batches-py")
    with pytest.raises(ValueError, match="real data exists"):
        cv_train.build_datasets(FedConfig(dataset_dir=str(tmp_path),
                                          synthetic_hard=True))
    assert FedConfig(synthetic_hard=True).no_augment


def test_entry_point_on_a_synthetic_imagenet(tmp_path, monkeypatch, capsys):
    """``cv_train`` on a synthetic ImageNet at 224 x 224 with the recipe's
    flags (the model cut to one bottleneck a stage for the CPU): the
    store serves it, the rounds are finite, the model sees 224 x 224."""
    seen = []

    def shallow(cfg, num_classes, device=None):
        seen.append((cfg.input_shape, num_classes))
        return FixupResNetImageNet((1, 1, 1, 1), num_classes,
                                   cfg.input_shape, device=device,
                                   generator=torch.Generator().manual_seed(0))

    monkeypatch.setattr(cv_train, "build_model", shallow)
    argv = RECIPE[:-1] + ["--device", "cpu", "--dataset_dir",
                          str(tmp_path), "--num_workers", "2",
                          "--num_clients", "2", "--local_batch_size", "2",
                          "--valid_batch_size", "8",
                          "--synthetic_per_class", "4", "--num_rounds", "2"]
    # without a tree the recipe refuses, as the JAX package's does; a
    # directory prepared with the synthetic set is read as it is
    with pytest.raises(FileNotFoundError, match="no train/ image tree"):
        cv_train.main(argv)
    FedImageNet(str(tmp_path), synthetic=True, synthetic_per_class=4)
    capsys.readouterr()
    out = cv_train.main(argv)
    text = capsys.readouterr().out
    assert seen == [((224, 224, 3), 1000)]
    assert "WARNING" not in text
    assert "data: device store on cpu" in text and "imagenet_train" in text
    assert out["rounds"] == 2 and np.isfinite(out["losses"]).all()
    assert np.isfinite(out["val_loss"])
