"""Federated ImageNet with one natural client per wnid class, counterpart
of the JAX package's ``data/fed_imagenet.py``.

``prepare`` reads a ``train/<wnid>/*`` image tree under ``dataset_dir``
(and ``val/<wnid>/*`` when present) through PIL, imported only then,
resizes every image to ``image_size`` square, and writes one uint8 client
file a class, a test file and the stats json, in the layout of
``data/fed_cifar.py``: one prepared directory serves both packages.
Without a tree it raises, as the JAX package's does, unless
``synthetic=True`` (``--test``) asks for the synthetic set:
``synthetic_cifar`` at ``img_hw = image_size`` gives
``synthetic_num_classes`` classes (the class count and the image size are
in the synthetic marker, so changing either prepares again). A directory
prepared so is read by a later run without ``--test``. The arrays stay
uint8: the device store flips and normalises on the device,
the host path through ``ImagenetTrain``.
"""

from __future__ import annotations

import os

import numpy as np

from commefficient_torch.data.fed_cifar import FedCIFAR10, synthetic_cifar


class FedImageNet(FedCIFAR10):
    # a legacy stats.json is adopted only at ImageNet's class count
    expected_natural_clients = 1000
    num_classes = 1000

    def __init__(self, *args, image_size: int = 224,
                 synthetic_num_classes: int = 8, **kw):
        self.image_size = image_size
        self._synthetic_num_classes = synthetic_num_classes
        super().__init__(*args, **kw)

    @classmethod
    def _has_real_source(cls, dataset_dir: str) -> bool:
        return os.path.isdir(os.path.join(dataset_dir, "train"))

    def _synth_marker(self) -> dict:
        return dict(super()._synth_marker(),
                    num_classes=self._synthetic_num_classes,
                    image_size=self.image_size)

    def _prepare(self) -> None:
        train_root = os.path.join(self.dataset_dir, "train")
        if os.path.isdir(train_root):
            self._prepare_from_tree(train_root)
            return
        if not self._synthetic:
            raise FileNotFoundError(
                f"no train/ image tree under {self.dataset_dir}; "
                "synthetic=True (--test) generates a synthetic set")
        n = self._synthetic_num_classes
        self.num_classes = n
        train_images, train_targets = synthetic_cifar(
            n, self._synthetic_per_class, img_hw=self.image_size)
        test_images, test_targets = synthetic_cifar(
            n, max(self._synthetic_per_class // 4, 2),
            img_hw=self.image_size, seed=4321)
        os.makedirs(self.dataset_dir, exist_ok=True)
        images_per_client = []
        for c in range(n):
            sel = np.where(train_targets == c)[0]
            images_per_client.append(len(sel))
            np.save(self.client_fn(c), train_images[sel])
        np.savez(self.test_fn(), test_images=test_images,
                 test_targets=test_targets)
        self.write_stats(images_per_client, len(test_targets),
                         synthetic=self._synth_marker())

    def _read_image(self, path: str) -> np.ndarray:
        from PIL import Image  # only a real tree needs PIL

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB").resize(
                (self.image_size, self.image_size)))

    def _prepare_from_tree(self, train_root: str) -> None:
        sz = self.image_size
        images_per_client = []
        for c, wnid in enumerate(sorted(os.listdir(train_root))):
            files = sorted(os.listdir(os.path.join(train_root, wnid)))
            imgs = np.zeros((len(files), sz, sz, 3), np.uint8)
            for i, f in enumerate(files):
                imgs[i] = self._read_image(os.path.join(train_root, wnid, f))
            np.save(self.client_fn(c), imgs)
            images_per_client.append(len(files))
        val_root = os.path.join(self.dataset_dir, "val")
        test_images, test_targets = [], []
        if os.path.isdir(val_root):
            for c, wnid in enumerate(sorted(os.listdir(val_root))):
                for f in sorted(os.listdir(os.path.join(val_root, wnid))):
                    test_images.append(
                        self._read_image(os.path.join(val_root, wnid, f)))
                    test_targets.append(c)
        test_images = (np.stack(test_images) if test_images
                       else np.zeros((0, sz, sz, 3), np.uint8))
        np.savez(self.test_fn(), test_images=test_images,
                 test_targets=np.asarray(test_targets, np.int64))
        self.write_stats(images_per_client, len(test_targets))

    def _load_arrays(self) -> None:
        # a synthetic or partial tree has fewer classes than ImageNet's
        self.num_classes = len(self.images_per_client)
        super()._load_arrays()
