"""Device-resident dataset store, counterpart of the JAX package's
``data/device_store.py``: the dataset's arrays are uploaded once as they
are (CIFAR's uint8 stays uint8, LEAF FEMNIST's float32 pixels in [0, 1]
stay float32), and each round's batch is gathered and augmented on the
device from the round's (W, B) index array, the only upload a round
makes.

``cifar_train`` is the host ``CifarTrain`` in kind: reflect-pad 4, a
random crop back to the image's size, a random horizontal flip, then the
per-channel normalisation; ``emnist_train`` is ``FemnistTrain``'s:
edge-pad 2 and a random crop, no flip; ``imagenet_train`` is
``ImagenetTrain``'s: a random horizontal flip alone (a crop of pad 0) of
the uint8 images sized at prepare time. The pad, crop and flip are one
gather: the source rows of each vertical offset and the source columns
of each horizontal offset, mirrored or not (a reflection or a clamp of
the shifted index), are tabled once; a round draws an offset pair (and a
flip) an image, looks its rows and columns up, and reads the pixels
straight from the store. Padding only copies pixels, so the floats equal
those of the JAX package's order (float, and /255 for uint8, pad, crop,
flip, normalise), and the ``normalize`` path equals the host
``CifarEval`` or ``FemnistEval`` bit for bit. The draws come from a
``torch.Generator`` on the device seeded from ``(seed ^ 0xDA7A,
round)``: a resumed run draws what the uninterrupted run drew at the same
round, whatever ran before it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from commefficient_torch.data import transforms as T
from commefficient_torch.telemetry import tracing

# augment -> (crop pad, pad mode, horizontal flip), as the host
# transforms crop
SHIFT_CROP = {"cifar_train": (4, "reflect", True),
              "emnist_train": (2, "edge", False),
              "imagenet_train": (0, "reflect", True)}
CROP_PAD = SHIFT_CROP["cifar_train"][0]
TRAIN_AUGMENT = {"CIFAR10": "cifar_train", "CIFAR100": "cifar_train",
                 "EMNIST": "emnist_train", "ImageNet": "imagenet_train"}
DATA_KEY = 0xDA7A
MAX_STORE_BYTES = 2 << 30


def arrays_nbytes(arrays: Dict[str, np.ndarray]) -> int:
    return sum(int(a.nbytes) for a in arrays.values())


def round_seed(seed: int, round_index: int) -> int:
    """The generator seed of one round: (seed ^ 0xDA7A, round) hashed by
    numpy's ``SeedSequence``, so every round draws its own stream (the
    CPU generator keeps only 32 bits of a seed, so the two are mixed
    rather than packed)."""
    ss = np.random.SeedSequence((seed ^ DATA_KEY, int(round_index)))
    return int(ss.generate_state(1, np.uint32)[0])


class DeviceStore:
    """``arrays``: numpy arrays with one leading flat-index axis (a
    ``FedDataset.arrays``), uploaded to ``device`` as they are.
    ``iid_shuffle``: the dataset's global permutation, applied on the
    device so the round's indices stay the sampler's. ``augment``:
    ``cifar_train``, ``emnist_train``, ``imagenet_train`` or
    ``normalize``; ``mean``/``std``: the image leaf's per-channel
    constants."""

    def __init__(self, arrays: Dict[str, np.ndarray], device,
                 augment: str, mean, std,
                 iid_shuffle: Optional[np.ndarray] = None, seed: int = 0):
        if augment not in (*SHIFT_CROP, "normalize"):
            raise ValueError(f"augment {augment!r}: want one of "
                             f"{(*SHIFT_CROP, 'normalize')}")
        self.device = torch.device(device)
        self.arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                       .to(self.device) for k, v in arrays.items()}
        self.iid_shuffle = (torch.as_tensor(iid_shuffle, dtype=torch.int64,
                                            device=self.device)
                            if iid_shuffle is not None else None)
        self.augment = augment
        self.mean = torch.as_tensor(mean, dtype=torch.float32,
                                    device=self.device)
        self.std = torch.as_tensor(std, dtype=torch.float32,
                                   device=self.device)
        # a device tensor, not a Python number: CUDA divides by a host
        # scalar as a multiply by its reciprocal, which is not the host
        # path's division
        self._255 = torch.full((), 255.0, device=self.device)
        self.seed = seed
        self._gen = torch.Generator(device=self.device)
        if augment in SHIFT_CROP:
            pad, mode, flip = SHIFT_CROP[augment]
            source = _reflect if mode == "reflect" else _edge
            h, w = arrays["image"].shape[1:3]
            shift = torch.arange(2 * pad + 1)[:, None] - pad
            self._rows = source(shift + torch.arange(h), h).to(self.device)
            cols = source(shift + torch.arange(w), w)
            # row (2 pad + 1) * flip + offset: a flipped crop's column j
            # is the crop's column w - 1 - j
            self._cols = (torch.cat([cols, cols.flip(1)]) if flip
                          else cols).to(self.device)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values())

    def upload_index(self, flat_idx) -> torch.Tensor:
        """The round's index array on the device: from pinned memory,
        without blocking, on the card."""
        idx = torch.from_numpy(np.ascontiguousarray(flat_idx,
                                                    dtype=np.int64))
        if self.device.type == "cuda":
            return idx.pin_memory().to(self.device, non_blocking=True)
        return idx

    def draw_offsets(self, n: int, round_index: int):
        """The draws of ``round_index`` for ``n`` images: the (row, column)
        offsets into the padded image (2, n), and the flips (n,) or None
        where the augment does not flip."""
        pad, _, flip = SHIFT_CROP[self.augment]
        gen = self._gen
        gen.manual_seed(round_seed(self.seed, round_index))
        offs = torch.randint(0, 2 * pad + 1, (2, n), generator=gen,
                             device=self.device)
        flips = (torch.randint(0, 2, (n,), generator=gen,
                               device=self.device) if flip else None)
        return offs, flips

    def crop_flip_index(self, n: int, round_index: int):
        """Source rows (n, h) and columns (n, w) of the padded crop (and
        flip) of each of ``n`` images, drawn for ``round_index``."""
        offs, flips = self.draw_offsets(n, round_index)
        cols = offs[1]
        if flips is not None:
            cols = cols + self._rows.shape[0] * flips
        return self._rows[offs[0]], self._cols[cols]

    def round_batch(self, flat_idx, round_index: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
        """The batch at ``flat_idx`` (any shape; numpy) on the device, the
        image leaf augmented (``round_index`` seeds the train draws); the
        ``data_gather`` span."""
        with tracing.span("data_gather"):
            idx = self.upload_index(flat_idx)
            if self.iid_shuffle is not None:
                idx = self.iid_shuffle[idx]
            return {key: (self._images(arr, idx, round_index)
                          if key == "image" else arr[idx])
                    for key, arr in self.arrays.items()}

    def _images(self, arr: torch.Tensor, idx: torch.Tensor,
                round_index: Optional[int]) -> torch.Tensor:
        flat = idx.reshape(-1)
        if self.augment in SHIFT_CROP:
            if round_index is None:
                raise ValueError(f"the {self.augment} store draws its "
                                 "crops by round: pass round_index")
            rows, cols = self.crop_flip_index(flat.numel(), round_index)
            img = arr[flat[:, None, None], rows[:, :, None],
                      cols[:, None, :]]
        else:
            img = arr[flat]
        x = img.to(torch.float32)
        if arr.dtype == torch.uint8:
            x = x / self._255
        x = (x - self.mean) / self.std
        return x.reshape(idx.shape + x.shape[1:])


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """Index ``i`` in [-n + 1, 2n - 2] reflected into [0, n - 1] without
    repeating the edge (``np.pad(mode="reflect")``)."""
    i = i.abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _edge(i: torch.Tensor, n: int) -> torch.Tensor:
    """Index ``i`` clamped into [0, n - 1] (``np.pad(mode="edge")``)."""
    return i.clamp(0, n - 1)


def make_device_store(dataset, dataset_name: str, train: bool, device,
                      no_augment: bool = False, seed: int = 0,
                      max_bytes: int = MAX_STORE_BYTES
                      ) -> Optional[DeviceStore]:
    """A store for a CIFAR10/100, EMNIST or ImageNet ``FedDataset`` whose
    arrays fit in ``max_bytes`` (2 GiB), else None (the host path: a real
    FEMNIST, about 805k float32 images, 2.5 GB, or a real ImageNet).
    Train stores augment (``TRAIN_AUGMENT``; normalise only under
    ``no_augment``) and route through the dataset's ``iid_shuffle``;
    evaluation stores normalise."""
    if dataset_name not in T.NORMALIZE:
        return None
    if arrays_nbytes(dataset.arrays) > max_bytes:
        return None
    mean, std = T.NORMALIZE[dataset_name]
    augment = (TRAIN_AUGMENT[dataset_name] if train and not no_augment
               else "normalize")
    iid = (dataset.iid_shuffle if train and dataset.do_iid else None)
    return DeviceStore(dataset.arrays, device, augment, mean, std,
                       iid_shuffle=iid, seed=seed)
