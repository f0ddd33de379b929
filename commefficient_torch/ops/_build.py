"""Build and load the port's CUDA kernels.

Each source under ``commefficient_torch/csrc/`` is compiled by ``nvcc``
into a shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``) and loaded with ``ctypes``.
The library lands in ``commefficient_torch/build/`` (listed in
``.gitignore``) under a name that carries a hash of its source, so an
edited source is rebuilt and an unchanged one is reused. Nothing is
fetched: the build needs only the CUDA toolkit.

Nothing here runs at import time; the first kernel launch builds what it
needs, and ``build_all`` builds every source at once (one ``nvcc`` per
source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("circulant.cu", "flash_attention.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return path


def library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def _start(source: str, nvcc: str):
    """Start compiling ``source`` unless its library exists; returns
    ``(process, tmp path, library path, command)`` or None."""
    out = library_path(source)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def build_all(sources=SOURCES) -> Dict[str, str]:
    """Compile every source that has no current library, all ``nvcc``
    processes at once. Returns ``{source: compiler output}`` for the
    sources compiled now (``-Xptxas -v`` reports registers and spills)."""
    nvcc = find_nvcc()
    with _lock:
        started = [(s, _start(s, nvcc)) for s in sources]
        logs, errors = {}, []
        for source, job in started:
            if job is None:
                continue
            proc, tmp, out, cmd = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                errors.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{log}")
                continue
            # the rename makes a library appear whole or not at all
            os.replace(tmp, out)
            logs[source] = log
        if errors:
            raise RuntimeError("\n".join(errors))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    path = library_path(source)
    if not os.path.exists(path):
        build_all((source,))
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(path)
            _loaded[source] = lib
    return lib
