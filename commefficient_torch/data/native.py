"""The host gather of CIFAR's uint8 transforms (``csrc/fedloader.cpp``),
built with ``g++`` and bound with ``ctypes``; counterpart of the JAX
package's ``data/native.py``.

The library is built at first use into ``commefficient_torch/build/``
(listed in ``.gitignore``) under a name that carries a hash of its source
and flags, so an edited source is rebuilt and an unchanged one reused. The
flags are the JAX package's (``-O3 -march=native``), so the two libraries
compute the same bits on one machine. A failed build raises with the
compiler's output; ``COMMEFFICIENT_NATIVE=0`` selects the numpy stream of
the host transforms instead (``enabled``), as in the JAX package.

Under ``-march=native`` GCC may fuse the pixel's ``x / 255 - mean`` into
one multiply-add, which rounds once where numpy rounds twice: the numpy
stream (``transforms.CifarTrain``/``CifarEval``) agrees with the library
within an ulp or two, not bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "csrc", "fedloader.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "build")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """False when ``COMMEFFICIENT_NATIVE=0`` selects the numpy stream."""
    return os.environ.get("COMMEFFICIENT_NATIVE") != "0"


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libfedloader-{digest.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *GXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the host gather's build failed: {' '.join(cmd)}"
                           f": {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"the host gather's build failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    # the rename makes the library appear whole or not at all
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.fedloader_gather_augment.argtypes = [
                u8p, i64p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p,
                ctypes.c_uint64, ctypes.c_int]
            lib.fedloader_gather_augment.restype = None
            lib.fedloader_gather_normalize.argtypes = [
                u8p, i64p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, f32p, f32p, ctypes.c_int]
            lib.fedloader_gather_normalize.restype = None
            _lib = lib
        return _lib


def _checked(images: np.ndarray, idx: np.ndarray, mean, std):
    """The library's inputs, checked: uint8 NHWC images, int64 indices
    inside them, one mean and std a channel."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"images {images.dtype} {images.shape}: want uint8 "
                         "(N, H, W, C)")
    flat = np.ascontiguousarray(np.asarray(idx).reshape(-1), np.int64)
    if flat.size and (flat.min() < 0 or flat.max() >= len(images)):
        raise IndexError(f"index outside the {len(images)} images")
    c = images.shape[3]
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"mean {mean.shape} and std {std.shape}: want "
                         f"({c},)")
    return np.ascontiguousarray(images), flat, mean, std


def _threads(num_threads: int) -> int:
    return num_threads or min(8, os.cpu_count() or 1)


def gather_augment(images: np.ndarray, idx: np.ndarray, mean, std,
                   pad: int, flip: bool, seed: int,
                   num_threads: int = 0) -> np.ndarray:
    """Gather, reflect-pad ``pad`` random crop, random horizontal flip
    (``flip``) and normalisation in one pass. ``images`` (N, H, W, C)
    uint8, ``idx`` any int shape; returns float32 ``idx.shape + (H, W,
    C)``. The draws of item i come from splitmix64 of (``seed``, i)."""
    images, flat, mean, std = _checked(images, idx, mean, std)
    h, w, c = images.shape[1:]
    out = np.empty((flat.size, h, w, c), np.float32)
    load().fedloader_gather_augment(
        images, flat, out, flat.size, h, w, c, int(pad), int(flip), mean,
        std, ctypes.c_uint64(seed), _threads(num_threads))
    return out.reshape(np.shape(idx) + (h, w, c))


def gather_normalize(images: np.ndarray, idx: np.ndarray, mean, std,
                     num_threads: int = 0) -> np.ndarray:
    """Gather and normalise: float32 ``idx.shape + (H, W, C)``."""
    images, flat, mean, std = _checked(images, idx, mean, std)
    h, w, c = images.shape[1:]
    out = np.empty((flat.size, h, w, c), np.float32)
    load().fedloader_gather_normalize(images, flat, out, flat.size, h, w, c,
                                      mean, std, _threads(num_threads))
    return out.reshape(np.shape(idx) + (h, w, c))

