"""Client-partitioned array store, counterpart of the JAX package's
``data/fed_dataset.py FedDataset`` (numpy only).

Training data lives as flat numpy arrays sorted by natural client
(``images_per_client``). ``data_per_client`` re-partitions them: iid, a
fixed global permutation (``iid_shuffle``, drawn from ``RandomState(0)``
as the JAX package's drivers draw it) dealt evenly, or each natural
client split across ``num_clients // natural`` clients. ``gather``
fancy-indexes any index array at once.

Preparation follows the JAX package's protocol, so a directory prepared
by either package is read by the other: per-client files and a stats json
under class-prefixed names (``<Class>_client{i}.npy``,
``stats_<Class>.json``); a directory that holds only the reference's
unprefixed ``stats.json`` (with this dataset's natural client count) is
read as it is; a synthetic prep records a marker of the generator's
settings, and a prep whose marker does not match the run's is prepared
again.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import numpy as np

from commefficient_torch.telemetry import tracing


class FedDataset:
    # natural clients this dataset always has, or None when data-dependent;
    # a legacy stats.json is adopted only when its count matches
    expected_natural_clients: Optional[int] = None

    def __init__(self, dataset_dir: str, train: bool = True,
                 do_iid: bool = False, num_clients: Optional[int] = None,
                 transform=None):
        if not do_iid and num_clients == 1:
            raise ValueError("can't have 1 client when non-iid")
        self.dataset_dir = dataset_dir
        self.train = train
        self.do_iid = do_iid
        self._num_clients = num_clients
        self.transform = transform
        self._legacy_layout = (
            not os.path.exists(self._prefixed_stats_fn())
            and os.path.exists(os.path.join(dataset_dir, "stats.json")))
        if self._legacy_layout and self.expected_natural_clients is not None:
            try:
                with open(os.path.join(dataset_dir, "stats.json")) as f:
                    n_legacy = len(json.load(f)["images_per_client"])
            except (json.JSONDecodeError, KeyError, TypeError, OSError):
                n_legacy = -1
            if n_legacy != self.expected_natural_clients:
                self._legacy_layout = False
        if not os.path.exists(self.stats_fn()):
            self.prepare_datasets()
        try:
            self._load_meta()
            self._load_arrays()
        except FileNotFoundError as e:
            print(f"WARNING: prepared arrays missing ({e}); re-preparing "
                  f"{type(self).__name__} under {self.dataset_dir}")
            self.prepare_datasets()
            self._load_meta()
            self._load_arrays()
        if do_iid:
            self.iid_shuffle = np.random.RandomState(0).permutation(
                len(self))

    def _invalidate_stale_synth_prep(self, dataset_dir: str,
                                     synthetic) -> None:
        """Called by a subclass with a synthetic fallback before
        ``__init__``. A prepared stats file of this class whose synthetic
        marker differs from the run's is removed, so the run prepares
        again. A marker-less prep (real data, or a synthetic prep older
        than markers) is kept with a warning while a real source is
        present; without one, when the run wants synthetic data, its files
        are renamed aside to ``*.pre-marker.bak`` (never overwriting an
        earlier backup) and the set is prepared again."""
        pref = os.path.join(dataset_dir, f"stats_{type(self).__name__}.json")
        if not os.path.exists(pref):
            return
        try:
            with open(pref) as f:
                marker = json.load(f).get("synthetic")
        except (OSError, ValueError, AttributeError):
            marker = None
        has_real = self._has_real_source(dataset_dir)
        want_syn = synthetic is True or (synthetic is None and not has_real)
        expected = self._synth_marker() if want_syn else None
        if marker is not None and marker != expected:
            os.unlink(pref)
        elif marker is None and want_syn:
            legacy = os.path.exists(os.path.join(dataset_dir, "stats.json"))
            if has_real or legacy:
                print(f"WARNING: reusing prepared data under {dataset_dir} "
                      "that predates synthetic-prep markers; delete "
                      f"{pref} to regenerate with the current synthetic "
                      "settings")
                return
            print(f"WARNING: prepared data under {dataset_dir} predates "
                  "synthetic-prep markers and no real raw source is "
                  "present: treating it as a stale synthetic cache and "
                  "re-preparing (the old files are kept as "
                  "*.pre-marker.bak)")
            prefix = type(self).__name__
            for fn in glob.glob(os.path.join(dataset_dir,
                                             f"{prefix}_*")) + [pref]:
                if ".pre-marker.bak" in fn:
                    continue
                dst, n = fn + ".pre-marker.bak", 1
                while os.path.exists(dst):
                    dst, n = fn + f".pre-marker.bak.{n}", n + 1
                os.replace(fn, dst)

    # ---------------------------------------------------------------- meta

    def _prefixed_stats_fn(self) -> str:
        return os.path.join(self.dataset_dir,
                            f"stats_{type(self).__name__}.json")

    def stats_fn(self) -> str:
        if getattr(self, "_legacy_layout", False):
            return os.path.join(self.dataset_dir, "stats.json")
        return self._prefixed_stats_fn()

    def data_fn(self, name: str) -> str:
        """A prepared file's path: class-prefixed, or the reference's
        unprefixed name in a legacy layout (read only: preparation always
        writes prefixed names; before ``__init__`` has decided the
        layout, the prefixed name)."""
        if getattr(self, "_legacy_layout", False):
            return os.path.join(self.dataset_dir, name)
        return os.path.join(self.dataset_dir,
                            f"{type(self).__name__}_{name}")

    def _load_meta(self) -> None:
        with open(self.stats_fn()) as f:
            stats = json.load(f)
        self.images_per_client = np.array(stats["images_per_client"],
                                          dtype=np.int64)
        self.num_val_images = int(stats["num_val_images"])

    @property
    def num_clients(self) -> int:
        return (self._num_clients if self._num_clients is not None
                else len(self.images_per_client))

    @property
    def data_per_client(self) -> np.ndarray:
        if self.do_iid:
            n = len(self)
            per = np.full(self.num_clients, n // self.num_clients,
                          dtype=np.int64)
            per[self.num_clients - n % self.num_clients:] += 1
            return per
        if self._num_clients is None:
            return self.images_per_client
        natural = len(self.images_per_client)
        if self.num_clients % natural != 0:
            raise ValueError(
                f"non-iid num_clients ({self.num_clients}) must be a "
                f"multiple of the natural client count ({natural}); "
                "use --iid for arbitrary client counts")
        shards = self.num_clients // natural
        out = []
        for num_images in self.images_per_client:
            counts = [num_images // shards] * shards
            counts[-1] += num_images % shards
            out.extend(counts)
        return np.array(out, dtype=np.int64)

    def __len__(self) -> int:
        if self.train:
            return int(self.images_per_client.sum())
        return self.num_val_images

    # -------------------------------------------------------------- arrays

    def _load_arrays(self) -> None:
        """Sets ``self.arrays``: numpy arrays with one leading flat-index
        axis (train: sorted by natural client)."""
        raise NotImplementedError

    def prepare_datasets(self) -> None:
        self._legacy_layout = False
        self._prepare()

    def _prepare(self) -> None:
        raise NotImplementedError

    def gather(self, flat_idx: np.ndarray) -> Dict[str, np.ndarray]:
        """The items at ``flat_idx`` (any shape; under iid routed through
        ``iid_shuffle`` first), transformed: the image leaf by the
        transform's ``gather_fused`` (the native host gather) when it
        serves them, as in the JAX package. The round pipeline calls it
        from one thread, in round order, so the transform's draws advance
        as they do inline. The ``host_gather`` span."""
        with tracing.span("host_gather"):
            return self._gather(flat_idx)

    def _gather(self, flat_idx: np.ndarray) -> Dict[str, np.ndarray]:
        idx = np.asarray(flat_idx)
        if self.train and self.do_iid:
            idx = self.iid_shuffle[idx]
        # the image leaf through the transform's native host gather, where
        # it has one that serves these images
        fused = (self.transform.gather_fused(self.arrays["image"], idx)
                 if hasattr(self.transform, "gather_fused")
                 and "image" in self.arrays else None)
        if fused is not None:
            out = {k: v[idx] for k, v in self.arrays.items()
                   if k != "image"}
            out["image"] = fused
            return out
        out = {k: v[idx] for k, v in self.arrays.items()}
        return self.transform(out) if self.transform is not None else out

    def write_stats(self, images_per_client, num_val_images: int,
                    **extra) -> None:
        os.makedirs(self.dataset_dir, exist_ok=True)
        stats = {"images_per_client": [int(x) for x in images_per_client],
                 "num_val_images": int(num_val_images), **extra}
        with open(self._prefixed_stats_fn(), "w") as f:
            json.dump(stats, f)
