"""Federated CIFAR10/100 with one natural client per class, counterpart of
the JAX package's ``data/fed_cifar.py``.

``prepare`` reads the CIFAR python pickles under ``dataset_dir``
(``cifar-10-batches-py``: ``data_batch_1..5``, ``test_batch``,
``b"labels"``; ``cifar-100-python``: ``train``, ``test``,
``b"fine_labels"``), converts NCHW rows to NHWC and writes one file per
class, a test file and the stats json (``data/fed_dataset.py``). The
train target of an item is its natural client. Without the pickles, the
``synthetic`` switch decides, as in the JAX package: None falls back to
the synthetic set with a ``WARNING:`` line, False raises, True forces
the synthetic set. ``synthetic_cifar`` is a copy of the JAX package's
``_synthetic_cifar`` (the default low-frequency branch, the ``hard``
branch and the train-only label noise), with the same seeds, so both
packages prepare the same images.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from commefficient_torch.data.fed_dataset import FedDataset

# the JAX package's version tag of the synthetic generator
SYNTH_PROTOS = "shared-v3"
# the hard regime: a HARD_FRAC share of a class's pixels carries a
# +-HARD_DELTA offset from one shared base, under +-HARD_NOISE noise (the
# JAX package's constants, which its marker records)
HARD_FRAC = 0.10
HARD_DELTA = 45
HARD_NOISE = 85


def synthetic_cifar(num_classes: int, per_class: int, img_hw: int = 32,
                    seed: int = 1234, proto_seed: int = 777,
                    hard: bool = False, label_noise: float = 0.0):
    """Class-structured uint8 images: a prototype per class (from
    ``proto_seed``) plus per-image uniform noise (from ``seed``). The
    default prototypes are low-frequency (coarse 8x8 patterns upsampled);
    ``hard`` gives every class one shared base and sparse per-pixel
    evidence under heavier noise, so accuracy climbs slowly;
    ``label_noise`` redraws that share of the labels uniformly. Returns
    ``(images (N, H, W, 3) uint8, targets (N,) int64)`` in class order
    (before the label noise)."""
    prng = np.random.RandomState(proto_seed)
    if hard:
        base = prng.randint(70, 185, size=(1, img_hw, img_hw, 3))
        where = prng.rand(num_classes, img_hw, img_hw, 1) < HARD_FRAC
        signs = prng.choice([-1, 1], size=(num_classes, img_hw, img_hw, 3))
        protos = np.clip(base + where * signs * HARD_DELTA, 0, 255)
        noise_amp = HARD_NOISE
    else:
        coarse = prng.randint(0, 255, size=(num_classes, 8, 8, 3))
        reps = -(-img_hw // 8)
        protos = np.kron(coarse, np.ones((1, reps, reps, 1), int))
        protos = protos[:, :img_hw, :img_hw]
        noise_amp = 60
    rng = np.random.RandomState(seed)
    images, targets = [], []
    for c in range(num_classes):
        noise = rng.randint(-noise_amp, noise_amp,
                            size=(per_class, img_hw, img_hw, 3))
        images.append(np.clip(protos[c][None] + noise, 0, 255)
                      .astype(np.uint8))
        targets.append(np.full(per_class, c, dtype=np.int64))
    images, targets = np.concatenate(images), np.concatenate(targets)
    if label_noise > 0:
        flip = rng.rand(len(targets)) < label_noise
        targets = np.where(flip, rng.randint(0, num_classes, len(targets)),
                           targets)
    return images, targets


class FedCIFAR10(FedDataset):
    expected_natural_clients = 10
    num_classes = 10
    pickle_dir = "cifar-10-batches-py"
    train_files = [f"data_batch_{i}" for i in range(1, 6)]
    test_file = "test_batch"
    label_key = b"labels"

    def __init__(self, dataset_dir: str, train: bool = True,
                 do_iid: bool = False, num_clients: Optional[int] = None,
                 transform=None, synthetic: Optional[bool] = None,
                 synthetic_per_class: int = 64, synthetic_hard: bool = False,
                 synthetic_label_noise: float = 0.0):
        self._synthetic = synthetic
        self._synthetic_per_class = synthetic_per_class
        self._synthetic_hard = synthetic_hard
        self._synthetic_label_noise = synthetic_label_noise
        self._invalidate_stale_synth_prep(dataset_dir, synthetic)
        super().__init__(dataset_dir, train=train, do_iid=do_iid,
                         num_clients=num_clients, transform=transform)

    @classmethod
    def _has_real_source(cls, dataset_dir: str) -> bool:
        return os.path.isdir(os.path.join(dataset_dir, cls.pickle_dir))

    def _synth_marker(self) -> dict:
        """What a synthetic prep bakes into its arrays; equal to the JAX
        package's marker for the same flags."""
        return {"per_class": self._synthetic_per_class,
                "protos": SYNTH_PROTOS,
                "hard": ([HARD_FRAC, HARD_DELTA, HARD_NOISE]
                         if self._synthetic_hard else False),
                "label_noise": self._synthetic_label_noise}

    def _load_pickles(self, files):
        images, labels = [], []
        for fn in files:
            with open(os.path.join(self.dataset_dir, self.pickle_dir, fn),
                      "rb") as f:
                d = pickle.load(f, encoding="bytes")
            images.append(d[b"data"].reshape(-1, 3, 32, 32)
                          .transpose(0, 2, 3, 1))
            labels.append(np.asarray(d[self.label_key], dtype=np.int64))
        return np.concatenate(images), np.concatenate(labels)

    def _prepare(self) -> None:
        marker = None
        if self._has_real_source(self.dataset_dir) and not self._synthetic:
            train_images, train_targets = self._load_pickles(
                self.train_files)
            test_images, test_targets = self._load_pickles([self.test_file])
        elif self._synthetic is False:
            raise FileNotFoundError(
                f"no {self.pickle_dir} under {self.dataset_dir} and "
                "synthetic=False; place the CIFAR python pickles there or "
                "pass synthetic=True")
        else:
            if self._synthetic is None:
                print(f"WARNING: no {self.pickle_dir} under "
                      f"{self.dataset_dir}; generating synthetic data")
            train_images, train_targets = synthetic_cifar(
                self.num_classes, self._synthetic_per_class,
                hard=self._synthetic_hard,
                label_noise=self._synthetic_label_noise)
            # the same prototypes, fresh noise and clean labels
            test_images, test_targets = synthetic_cifar(
                self.num_classes, max(self._synthetic_per_class // 4, 2),
                seed=4321, hard=self._synthetic_hard)
            marker = self._synth_marker()
        os.makedirs(self.dataset_dir, exist_ok=True)
        images_per_client = []
        for c in range(self.num_classes):
            sel = np.where(train_targets == c)[0]
            images_per_client.append(len(sel))
            np.save(self.client_fn(c), train_images[sel])
        np.savez(self.test_fn(), test_images=test_images,
                 test_targets=test_targets)
        self.write_stats(images_per_client, len(test_targets),
                         **({"synthetic": marker} if marker else {}))

    def _load_arrays(self) -> None:
        if self.train:
            imgs = [np.load(self.client_fn(c))
                    for c in range(len(self.images_per_client))]
            images = np.concatenate(imgs)
            targets = np.repeat(np.arange(len(imgs), dtype=np.int64),
                                self.images_per_client)
        else:
            with np.load(self.test_fn()) as t:
                images = t["test_images"]
                targets = t["test_targets"].astype(np.int64)
        self.arrays = {"image": images, "target": targets}

    def client_fn(self, client_id: int) -> str:
        return self.data_fn(f"client{client_id}.npy")

    def test_fn(self) -> str:
        return self.data_fn("test.npz")


class FedCIFAR100(FedCIFAR10):
    expected_natural_clients = 100
    num_classes = 100
    pickle_dir = "cifar-100-python"
    train_files = ["train"]
    test_file = "test"
    label_key = b"fine_labels"


DATASETS = {"CIFAR10": FedCIFAR10, "CIFAR100": FedCIFAR100}
