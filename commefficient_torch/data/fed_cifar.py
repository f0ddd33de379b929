"""Federated CIFAR10 with one natural client per class, held in memory.

Real CIFAR10 is not in the repository, so the port's data is the JAX
package's synthetic set: ``synthetic_cifar`` is a copy of
the JAX package's ``data/fed_cifar.py _synthetic_cifar`` (its default,
low-frequency branch), and the train/val splits are drawn with the same
seeds, so both packages see the same images. Train items are sorted by
client (= class), as the JAX package stores them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def synthetic_cifar(num_classes: int, per_class: int, img_hw: int = 32,
                    seed: int = 1234, proto_seed: int = 777):
    """Class-structured uint8 images: a low-frequency prototype per class
    (coarse 8x8 patterns upsampled, from ``proto_seed``) plus per-image
    uniform noise (from ``seed``). Returns ``(images (N, H, W, 3) uint8,
    targets (N,) int64)`` sorted by class."""
    prng = np.random.RandomState(proto_seed)
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
    return np.concatenate(images), np.concatenate(targets)


class FedCIFAR10:
    """``train=True``: ``synthetic_per_class`` images per class, seed 1234;
    ``train=False``: ``max(per_class // 4, 2)`` per class, seed 4321, the
    same prototypes. ``num_clients`` (a multiple of 10) splits each class
    across ``num_clients // 10`` clients, the last taking the remainder."""

    num_classes = 10

    def __init__(self, train: bool = True, synthetic_per_class: int = 64,
                 num_clients: Optional[int] = None, transform=None):
        if train:
            images, targets = synthetic_cifar(self.num_classes,
                                              synthetic_per_class)
        else:
            images, targets = synthetic_cifar(
                self.num_classes, max(synthetic_per_class // 4, 2),
                seed=4321)
        self.arrays = {"image": images, "target": targets}
        self.images_per_client = np.bincount(targets,
                                             minlength=self.num_classes)
        self.num_clients = (num_clients if num_clients is not None
                            else self.num_classes)
        if self.num_clients % self.num_classes:
            raise ValueError(
                f"num_clients ({self.num_clients}) must be a multiple of "
                f"the {self.num_classes} natural clients (iid splits are "
                "outside the port's slice)")
        self.transform = transform

    @property
    def data_per_client(self) -> np.ndarray:
        shards = self.num_clients // self.num_classes
        out = []
        for num_images in self.images_per_client:
            counts = [num_images // shards] * shards
            counts[-1] += num_images % shards
            out.extend(counts)
        return np.array(out, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.arrays["target"])

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """The items at ``idx`` (any shape), transformed."""
        batch = {k: v[idx] for k, v in self.arrays.items()}
        return self.transform(batch) if self.transform else batch
