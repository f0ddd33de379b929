"""CIFAR, FEMNIST and ImageNet batch transforms (numpy), copied from the
JAX package's ``data/transforms.py``: for CIFAR training a reflect-pad-4
random crop, a horizontal flip and normalization; for FEMNIST training an
edge-pad-2 random crop and normalization, no flip; for ImageNet training
(images sized at prepare time) a horizontal flip and normalization; for
evaluation normalization alone. A transform maps a whole batch dict at
once and returns NHWC float32 images. They serve the host path;
``data/device_store.py`` does the same on the device.

CIFAR's two transforms also have ``gather_fused``: the gather, crop, flip
and normalisation of uint8 images in one pass of the native host gather
(``data/native.py``), which ``FedDataset.gather`` takes whenever it is
enabled, as the JAX package's does. Its draws are a splitmix64 stream
keyed by ``(seed << 20) + calls``, not the numpy generator's."""

from __future__ import annotations

from typing import Dict

import numpy as np

from commefficient_torch.data import native

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2471, 0.2435, 0.2616], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4867, 0.4408], np.float32)
CIFAR100_STD = np.array([0.2675, 0.2565, 0.2761], np.float32)
FEMNIST_MEAN = np.array([0.9637], np.float32)
FEMNIST_STD = np.array([0.1597], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
NORMALIZE = {"CIFAR10": (CIFAR10_MEAN, CIFAR10_STD),
             "CIFAR100": (CIFAR100_MEAN, CIFAR100_STD),
             "EMNIST": (FEMNIST_MEAN, FEMNIST_STD),
             "ImageNet": (IMAGENET_MEAN, IMAGENET_STD)}


def _normalize(images: np.ndarray, mean, std) -> np.ndarray:
    x = images.astype(np.float32)
    if np.issubdtype(images.dtype, np.integer):  # uint8-range sources
        x = x / 255.0
    return (x - mean) / std


def _random_crop_flip(images: np.ndarray, pad: int,
                      rng: np.random.Generator, flip: bool = True,
                      pad_mode: str = "reflect") -> np.ndarray:
    """Per-image random shift crop (pad, then crop back) and, with
    ``flip``, horizontal flip, by one gather."""
    n, h, w = images.shape[:3]
    padded = np.pad(images,
                    [(0, 0), (pad, pad), (pad, pad)] +
                    [(0, 0)] * (images.ndim - 3),
                    mode=pad_mode)
    dy = rng.integers(0, 2 * pad + 1, size=n)
    dx = rng.integers(0, 2 * pad + 1, size=n)
    rows = dy[:, None] + np.arange(h)[None, :]
    cols = dx[:, None] + np.arange(w)[None, :]
    out = padded[np.arange(n)[:, None, None], rows[:, :, None],
                 cols[:, None, :]]
    if flip:
        do_flip = rng.random(n) < 0.5
        out[do_flip] = out[do_flip, :, ::-1]
    return out


class CifarTrain:
    def __init__(self, mean=CIFAR10_MEAN, std=CIFAR10_STD, seed: int = 0):
        self.mean, self.std = mean, std
        self.rng = np.random.default_rng(seed)
        self._seed = seed
        self._calls = 0

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        img = batch["image"]
        shape = img.shape
        flat = _random_crop_flip(img.reshape((-1,) + shape[-3:]), pad=4,
                                 rng=self.rng)
        out = dict(batch)
        out["image"] = _normalize(flat.reshape(shape), self.mean, self.std)
        return out

    def gather_fused(self, images: np.ndarray, idx: np.ndarray):
        """The images at ``idx`` gathered, cropped, flipped and normalised
        by the native host gather, or None where it does not serve
        (images other than uint8, or ``COMMEFFICIENT_NATIVE=0``)."""
        if images.dtype != np.uint8 or not native.enabled():
            return None
        self._calls += 1
        return native.gather_augment(images, idx, self.mean, self.std,
                                     pad=4, flip=True,
                                     seed=(self._seed << 20) + self._calls)


class Normalize:
    def __init__(self, mean, std):
        self.mean, self.std = mean, std

    def __call__(self, batch):
        out = dict(batch)
        out["image"] = _normalize(batch["image"], self.mean, self.std)
        return out


class CifarEval(Normalize):
    def __init__(self, mean=CIFAR10_MEAN, std=CIFAR10_STD):
        super().__init__(mean, std)

    def gather_fused(self, images: np.ndarray, idx: np.ndarray):
        """The images at ``idx`` gathered and normalised by the native host
        gather, or None where it does not serve."""
        if images.dtype != np.uint8 or not native.enabled():
            return None
        return native.gather_normalize(images, idx, self.mean, self.std)


class FemnistTrain:
    """Edge-pad-2 random crop (no flip) and normalization."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch):
        img = batch["image"]
        shape = img.shape
        flat = _random_crop_flip(img.reshape((-1,) + shape[-3:]), pad=2,
                                 rng=self.rng, flip=False, pad_mode="edge")
        out = dict(batch)
        out["image"] = _normalize(flat.reshape(shape), FEMNIST_MEAN,
                                  FEMNIST_STD)
        return out


class FemnistEval(Normalize):
    def __init__(self):
        super().__init__(FEMNIST_MEAN, FEMNIST_STD)


class ImagenetTrain:
    """A random horizontal flip and normalization of images sized at
    prepare time (``data/fed_imagenet.py``)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch):
        img = batch["image"]
        shape = img.shape
        flat = img.reshape((-1,) + shape[-3:]).copy()
        do_flip = self.rng.random(flat.shape[0]) < 0.5
        flat[do_flip] = flat[do_flip, :, ::-1]
        out = dict(batch)
        out["image"] = _normalize(flat.reshape(shape), IMAGENET_MEAN,
                                  IMAGENET_STD)
        return out


class ImagenetEval(Normalize):
    def __init__(self):
        super().__init__(IMAGENET_MEAN, IMAGENET_STD)


def transforms_for(dataset_name: str, train: bool, seed: int = 0):
    """The host transform of a split: the dataset's train transform
    (seeded) for training, its evaluation transform otherwise."""
    if dataset_name == "EMNIST":
        return FemnistTrain(seed=seed) if train else FemnistEval()
    if dataset_name == "ImageNet":
        return ImagenetTrain(seed=seed) if train else ImagenetEval()
    mean, std = NORMALIZE[dataset_name]
    return (CifarTrain(mean, std, seed=seed) if train
            else CifarEval(mean, std))
