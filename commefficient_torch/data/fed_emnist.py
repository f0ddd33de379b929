"""Federated EMNIST (LEAF FEMNIST): one natural client per writer (3,500
in the real set), counterpart of the JAX package's ``data/fed_emnist.py``.

``prepare`` reads the LEAF ``all_data*.json`` files of the ``train/`` and
``test/`` splits under ``dataset_dir`` (``{"users": [...], "user_data":
{user: {"x": [784-float lists], "y": [int]}}}``, pixels floats in [0,
1]) and writes ``FedEMNIST_train.npz`` and ``FedEMNIST_val.npz`` (flat
arrays sorted by writer) and ``stats_FedEMNIST.json``: the JAX package's
layout, so one prepared directory serves both packages. A train split
without its test split raises. Without LEAF files, ``synthetic`` decides
as for CIFAR (None: a ``WARNING:`` and the synthetic set; False: raise;
True: synthetic). ``synthetic_emnist`` is a copy of the JAX package's
writer-structured generator, with the same seeds, so both packages
prepare the same arrays. ``arrays`` holds NHWC one-channel float32
images.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from commefficient_torch.data.fed_dataset import FedDataset

NUM_CLASSES = 62
IMG = 28
# the JAX package's version tag of the synthetic generator
SYNTH_PROTOS = "shared-v1"


def synthetic_emnist(num_clients: int = 20, per_client: int = 24,
                     seed: int = 99, proto_seed: int = 777):
    """Writer-structured float32 images in [0, 1]: one prototype a class
    (from ``proto_seed``, shared by the splits) plus per-image noise and
    labels (from ``seed``). Returns ``(images (N, 28, 28), targets (N,)
    int64, images per writer)``."""
    prng = np.random.RandomState(proto_seed)
    protos = prng.rand(NUM_CLASSES, IMG, IMG).astype(np.float32)
    rng = np.random.RandomState(seed)
    images, targets, per = [], [], []
    for _ in range(num_clients):
        ys = rng.randint(0, NUM_CLASSES, size=per_client)
        xs = np.clip(protos[ys] + rng.randn(per_client, IMG, IMG) * 0.1,
                     0, 1).astype(np.float32)
        images.append(xs)
        targets.append(ys.astype(np.int64))
        per.append(per_client)
    return np.concatenate(images), np.concatenate(targets), per


class FedEMNIST(FedDataset):
    num_classes = NUM_CLASSES

    def __init__(self, dataset_dir: str, train: bool = True,
                 do_iid: bool = False, num_clients: Optional[int] = None,
                 transform=None, synthetic: Optional[bool] = None):
        self._synthetic = synthetic
        self._invalidate_stale_synth_prep(dataset_dir, synthetic)
        super().__init__(dataset_dir, train=train, do_iid=do_iid,
                         num_clients=num_clients, transform=transform)

    @classmethod
    def _has_real_source(cls, dataset_dir: str) -> bool:
        return bool(glob.glob(
            os.path.join(dataset_dir, "train", "all_data*.json")))

    def _synth_marker(self) -> dict:
        return {"protos": SYNTH_PROTOS}

    def _read_leaf(self, split: str):
        """``(images (N, 28, 28) float32, targets, images per writer)`` of
        a split's files in name order, writers in each file's order; None
        without files."""
        files = sorted(glob.glob(
            os.path.join(self.dataset_dir, split, "all_data*.json")))
        if not files:
            return None
        images, targets, per_client = [], [], []
        for fn in files:
            with open(fn) as f:
                blob = json.load(f)
            for user in blob["users"]:
                ud = blob["user_data"][user]
                images.append(np.asarray(ud["x"], np.float32)
                              .reshape(-1, IMG, IMG))
                targets.append(np.asarray(ud["y"], np.int64))
                per_client.append(len(targets[-1]))
        return np.concatenate(images), np.concatenate(targets), per_client

    def _prepare(self) -> None:
        marker = None
        train = None if self._synthetic else self._read_leaf("train")
        val = None if self._synthetic else self._read_leaf("test")
        if train is None:
            if self._synthetic is False:
                raise FileNotFoundError(
                    f"no LEAF json under {self.dataset_dir}/train and "
                    "synthetic=False")
            if self._synthetic is None:
                print(f"WARNING: no LEAF json under {self.dataset_dir}; "
                      "generating synthetic data")
            train = synthetic_emnist()
            val = synthetic_emnist(num_clients=4, seed=7)
            marker = self._synth_marker()
        if val is None:
            raise FileNotFoundError(
                f"LEAF train split found under {self.dataset_dir} but the "
                "test split is missing (expected test/all_data*.json)")
        os.makedirs(self.dataset_dir, exist_ok=True)
        np.savez(self.data_fn("train.npz"), images=train[0],
                 targets=train[1])
        np.savez(self.data_fn("val.npz"), images=val[0], targets=val[1])
        self.write_stats(train[2], len(val[1]), synthetic=marker)

    def _load_arrays(self) -> None:
        fn = self.data_fn("train.npz" if self.train else "val.npz")
        with np.load(fn) as d:
            images = d["images"].astype(np.float32)
            targets = d["targets"].astype(np.int64)
        self.arrays = {"image": images[..., None], "target": targets}
