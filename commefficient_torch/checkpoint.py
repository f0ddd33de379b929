"""Whole-state checkpoints and resume, counterpart of the JAX package's
``checkpoint.py``, in its file format.

A checkpoint is ``<path>.npz``, one entry a ``FedState`` field under the
JAX package's field name (float32, or int32 for ``step``, the byte
accounting and ``nan_round``, as on the device), and ``<path>.meta.json``
with the run's meta and a sha256 digest of every entry over (dtype,
shape, bytes), the JAX package's digest. The meta is written first, then
the npz, each to a ``.tmp`` file, synced and renamed; a generation whose
npz has no meta beside it counts as damaged. A file written by the JAX
package loads here, ``client_weights`` (``--topk_down``) and the dense
server state's (d,) momentum and error included: its ``rng`` (a PRNG key
the port does not draw from; its noise generators are keyed by seed,
round and slot) is skipped, a missing ``nan_round`` becomes -1, and a
field the port has no counterpart for is refused by name.

``CheckpointManager`` keeps ``ckpt_<epoch:06d>`` generations (the newest
``keep_last``), removes ``.tmp`` litter from an interrupted write, and
restores the newest generation that reads back intact, falling back past
damaged ones and naming each (``restore_fallbacks``). The preemption
drain writes out-of-cadence ``ckpt_<epoch>_r<round>_preempt``
generations inside an epoch (the JAX package's names); all generations
share one rotation ordered by (epoch, round in epoch), and a resume from
one continues at its round. A round-granular meta carries the host
ledgers (``ledgers``, core/preempt.py) and an async run's marker
``async_gen`` (``v1-{discount}-a{alpha}-M{goal}-K{inflight}``). A resume
is refused, unless ``--resume_unverified``, when the checkpoint was written
under another parameter layout (the port's ``torch_layout`` fingerprint;
a JAX-written file has none and is held to the run's d and field shapes
instead) or another sketch (``sketch_gen``, the JAX package's
``{impl}-{aligned1024|v1}-{r}x{c}-{seed}[-densestate]``); an unverified
resume under another sketch keeps the weights and zeroes the momentum
and error, as the JAX package does, and a dense state never crosses to
a table state.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from commefficient_torch.core.state import FedState
from commefficient_torch.faults import maybe_fault

FIELDS = tuple(f.name for f in dataclasses.fields(FedState))
INT_FIELDS = ("step", "coord_last_update", "client_last_round", "nan_round")
# the JAX package's PRNG key: the port's round draws no random numbers
SKIPPED = ("rng",)
# fields that a resume fits to the run (``fit_services``) instead of
# refusing their shape: the async buffer, the normclip ring and the
# --signals_exact shadow pair
FITTED = ("async_buffer", "async_buffer_n", "defense_ref",
          "sig_Vvelocity", "sig_Verror")
# a plain save refuses above this many bytes of host copies (the JAX
# package's guard and its environment override)
DEFAULT_MAX_HOST_BYTES = int(os.environ.get(
    "COMMEFFICIENT_CKPT_MAX_HOST_BYTES", 8 << 30))
_DAMAGE_ERRORS = (zipfile.BadZipFile, OSError, EOFError, KeyError)


class CheckpointIntegrityError(ValueError):
    """A checkpoint file is unreadable or fails its digests (a truncated
    write, a flipped bit). ``restore_latest`` falls back past exactly
    these; a refusal of the run's configuration is a plain ValueError."""


def entry_digest(arr: np.ndarray) -> str:
    """sha256 over (dtype, shape, raw bytes) of one stored array."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(tuple(arr.shape)).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def layout_fingerprint(layout) -> Optional[str]:
    """Fingerprint of a port model's flat-parameter layout (``model.layout``:
    (path, shape) in ravel order): the meaning of ``ps_weights``."""
    if layout is None:
        return None
    desc = ";".join(f"{path}:{tuple(shape)}" for path, shape in layout)
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def params_fingerprint_jax(layout) -> str:
    """The JAX package's ``params_fingerprint`` of the Flax tree whose
    ravel layout is ``layout`` ((path, shape) in ravel order, paths such
    as ``params/mc_head/kernel``), without jax: sha256[:16] of the tree's
    ``PyTreeDef`` string (nested dicts, keys sorted, ``*`` a leaf), ``|``,
    and ``shape:float32`` of each leaf joined by ``;``. It marks a
    ``save_pretrained`` directory, which either package reads."""
    tree: Dict = {}
    for path, _ in layout:
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = None

    def spec(node) -> str:
        if node is None:
            return "*"
        return "{" + ", ".join(f"{k!r}: {spec(node[k])}"
                               for k in sorted(node)) + "}"

    desc = f"PyTreeDef({spec(tree)})|" + ";".join(
        f"{tuple(shape)}:float32" for _, shape in layout)
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def sketch_generation(cfg) -> Optional[str]:
    """The JAX package's marker of the sketch that encoded a run's
    momentum and error, ``{impl}-{aligned1024|v1}-{r}x{c}-{seed}``
    (``circ-aligned1024-5x500736-42`` on the main path; aligned1024 only
    for a circulant sketch of 1024-aligned width), with ``-densestate``
    under ``--sketch_server_state dense``; None outside the sketch
    mode."""
    if cfg.mode != "sketch":
        return None
    kind = ("aligned1024" if cfg.sketch_impl == "circ"
            and cfg.num_cols % 1024 == 0 else "v1")
    return (f"{cfg.sketch_impl}-{kind}-{cfg.num_rows}x{cfg.num_cols}-"
            f"{cfg.sketch_seed}"
            + ("-densestate" if cfg.sketch_server_state == "dense" else ""))


def state_nbytes(state: FedState) -> int:
    return sum(t.numel() * t.element_size() for t in
               (getattr(state, n) for n in FIELDS)
               if isinstance(t, torch.Tensor))


def state_arrays(state: FedState) -> Dict[str, np.ndarray]:
    """The state's fields as host arrays under the JAX package's names."""
    out = {}
    for name in FIELDS:
        val = getattr(state, name)
        if val is None:
            continue
        if name == "step":
            out[name] = np.asarray(val, dtype=np.int32)
        else:
            out[name] = val.detach().cpu().numpy()
    return out


def _atomic_write(path: str, write) -> None:
    """``write(f)`` into a ``.tmp`` file beside ``path``, fsync, rename."""
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def check_host_bytes(total: int,
                     max_host_bytes: int = DEFAULT_MAX_HOST_BYTES) -> None:
    """Refuse a plain save of ``total`` bytes above the guard."""
    if total > max_host_bytes:
        raise ValueError(
            f"checkpoint state is {total / 2**30:.1f} GiB, above the "
            f"{max_host_bytes / 2**30:.1f} GiB host-copy guard: a plain "
            "save copies the whole state to one host at once. Pass "
            "--checkpoint_sharded (per-shard streaming writes, peak host "
            "memory = one shard), or raise "
            "COMMEFFICIENT_CKPT_MAX_HOST_BYTES explicitly.")


def save_state(path: str, state: FedState, meta: Optional[Dict] = None,
               max_host_bytes: int = DEFAULT_MAX_HOST_BYTES) -> str:
    """Writes ``<path>.meta.json`` and then ``<path>.npz``, each
    atomically; returns the npz path. The meta goes first: generations are
    listed by their npz, so a write cut between the two leaves no npz
    without its digests. Refuses a state above ``max_host_bytes`` of host
    copies."""
    check_host_bytes(state_nbytes(state), max_host_bytes)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = state_arrays(state)
    digests = {k: entry_digest(v) for k, v in arrays.items()}
    text = json.dumps(dict(meta or {}, digests=digests)).encode()
    _atomic_write(path + ".meta.json", lambda f: f.write(text))

    def write_npz(f):
        np.savez(f, **arrays)
        f.flush()
        # the tmp file is written, its rename pending: a death here leaves
        # the previous generation intact and only .tmp litter (removed
        # before the next save)
        maybe_fault("mid_checkpoint_write")

    _atomic_write(path + ".npz", write_npz)
    return path + ".npz"


def save_postmortem(path: str, state: FedState,
                    meta: Optional[Dict] = None) -> str:
    """``save_state`` that degrades instead of refusing: a state above
    the host-copy guard is written as its ``ps_weights`` alone, and the
    meta says so (``degraded``). A postmortem happens when the run is in
    trouble, and the weights are what a replay needs first."""
    meta = dict(meta or {})
    try:
        return save_state(path, state, meta)
    except ValueError as e:
        meta["degraded"] = f"weights-only postmortem: {e}"
        print(f"WARNING: postmortem degraded to weights-only ({e})",
              file=sys.stderr)
        arrays = {"ps_weights": state.ps_weights.detach().cpu().numpy()}
        text = json.dumps(dict(meta, digests={
            "ps_weights": entry_digest(arrays["ps_weights"])})).encode()
        _atomic_write(path + ".meta.json", lambda f: f.write(text))
        _atomic_write(path + ".npz", lambda f: np.savez(f, **arrays))
        return path + ".npz"


def load_meta(path: str) -> Dict:
    fn = path + ".meta.json"
    if not os.path.exists(fn):
        return {}
    try:
        with open(fn) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(
            f"checkpoint file {fn} is unreadable ({e})") from e


def load_arrays(path: str, digests: Optional[Dict[str, str]] = None
                ) -> Dict[str, np.ndarray]:
    """The file's fields as host arrays, each checked against its digest
    when ``digests`` has one; a file in the sharded layout assembled on
    the host (``assemble_sharded``, with its ``__sharded__`` marker).
    Refuses the JAX package's fields that the port does not run, by
    name."""
    try:
        z = np.load(path + ".npz")
    except Exception as e:
        raise CheckpointIntegrityError(
            f"checkpoint file {path}.npz is unreadable ({e})") from e
    with z:
        names = [n for n in z.files if n not in SKIPPED]
        if "__sharded__" in names:
            return assemble_sharded(z, path, digests)
        for name in names:
            if name not in FIELDS:
                raise ValueError(f"checkpoint {path}.npz holds an unknown "
                                 f"field '{name}'")
        out = {}
        for name in names:
            out[name] = read_entry(z, name, path, digests)
    return out


def read_entry(z, key: str, path: str,
               digests: Optional[Dict[str, str]] = None) -> np.ndarray:
    """One entry of an open npz, checked against its digest when
    ``digests`` has one."""
    try:
        arr = z[key]
    except Exception as e:
        raise CheckpointIntegrityError(
            f"checkpoint file {path}.npz entry '{key}' is corrupt "
            f"({e})") from e
    if digests and key in digests:
        got = entry_digest(arr)
        if got != digests[key]:
            raise CheckpointIntegrityError(
                f"checkpoint file {path}.npz entry '{key}' fails "
                f"its sha256 digest (stored {digests[key][:12]}..."
                f", read {got[:12]}...)")
    return arr


# ------------------------------------------------- the sharded layout


def _sharded_fields(z) -> List[str]:
    """The fields a sharded file holds (``name__shape`` entries), the
    JAX package's PRNG key skipped; an unknown one is refused."""
    names = [k[:-len("__shape")] for k in z.files if k.endswith("__shape")]
    for name in names:
        if name not in FIELDS and name not in SKIPPED:
            raise ValueError(f"sharded checkpoint holds an unknown field "
                             f"'{name}'")
    return [n for n in FIELDS if n in names]


def _shard_offsets(z, name: str, path: str, digests) -> List[Tuple]:
    """``[(i, offset tuple)]`` of a field's shards."""
    out, i = [], 0
    while f"{name}__shard{i}" in z.files:
        off = tuple(int(o) for o in read_entry(z, f"{name}__off{i}", path,
                                               digests))
        out.append((i, off))
        i += 1
    return out


def assemble_sharded(z, path: str,
                     digests: Optional[Dict[str, str]] = None
                     ) -> Dict[str, np.ndarray]:
    """Every field of a sharded file (the JAX package's layout: its
    ``__sharded__`` marker and, a field, ``name__shape``,
    ``name__dtype``, ``name__shard{i}`` and ``name__off{i}``) assembled
    on the host at its stored shape; a field its shards do not cover is
    refused (the JAX package's ``_load_arrays``)."""
    out = {}
    for name in _sharded_fields(z):
        shape = tuple(int(x) for x in read_entry(z, f"{name}__shape", path,
                                                 digests))
        dtype = str(read_entry(z, f"{name}__dtype", path, digests))
        arr = np.empty(shape, dtype=dtype)
        covered = 0
        for i, off in _shard_offsets(z, name, path, digests):
            shard = read_entry(z, f"{name}__shard{i}", path, digests)
            idx = tuple(slice(o, o + n) for o, n in zip(off, shard.shape))
            arr[idx if shape else ...] = shard
            covered += int(np.prod(shard.shape))
        if covered != int(np.prod(shape)):
            raise ValueError(
                f"sharded checkpoint entry '{name}' covers only {covered} "
                f"of {int(np.prod(shape))} elements")
        out[name] = arr
    # the marker: load_state cuts a mesh's padding off these
    out["__sharded__"] = np.asarray(1)
    return out


def fit_to_shapes(arrays: Dict[str, np.ndarray],
                  shapes: Dict[str, Optional[tuple]]) -> Dict:
    """A sharded file's fields cut to a single-device run's ``shapes``:
    the padding a mesh adds (the dense vectors' d_pad, the client rows'
    padded count and columns) comes off; a cut that would drop nonzero
    velocity or error is refused (the JAX package's rule: live state, not
    padding). Other differences stay, for the shape check to refuse."""
    out = dict(arrays)
    for name, arr in arrays.items():
        want = shapes.get(name)
        if want is None or arr.ndim != len(want) or arr.shape == want:
            continue
        if any(g < w for g, w in zip(arr.shape, want)):
            continue
        keep = tuple(slice(0, w) for w in want)
        if name in ("client_velocities", "client_errors"):
            dropped = arr.copy()
            dropped[keep] = 0
            if np.any(dropped):
                raise ValueError(
                    f"cannot cut {name} from {arr.shape} to {tuple(want)}: "
                    "the dropped rows or columns carry nonzero state (live "
                    "clients, not mesh padding)")
        cut = arr[keep]
        out[name] = np.ascontiguousarray(cut)
    return out


class ShardPlan:
    """The sharded layout of a run's state: for each field it holds, its
    global shape (the mesh's padded shape) and its shards, ``[(rank,
    offset)]`` in the order they are written (a replicated field once,
    from rank 0). ``runtime`` None (one device) holds one shard a
    field."""

    def __init__(self, runtime, state: FedState):
        mesh = getattr(runtime, "mesh", None)
        n = mesh.size if mesh is not None else 1
        self.fields = []
        for name in FIELDS:
            val = getattr(state, name)
            if val is None:
                continue
            kind = (runtime.shard_of.get(name) if mesh is not None
                    else None)
            local = () if name == "step" else tuple(val.shape)
            if kind == "dense":
                shape = (local[0] * n,)
                shards = [(i, (i * local[0],)) for i in range(n)]
            elif kind == "cols":
                shape = local[:-1] + (local[-1] * n,)
                shards = [(i, (0,) * (len(local) - 1) + (i * local[-1],))
                          for i in range(n)]
            else:
                shape = local
                shards = [(0, (0,) * max(len(local), 1))]
            dtype = ("int32" if name in INT_FIELDS else "float32")
            self.fields.append((name, shape, dtype, shards))


def _local(state: FedState, name: str) -> torch.Tensor:
    val = getattr(state, name)
    if name == "step":
        return torch.tensor(int(val), dtype=torch.int32)
    return val.detach()


def save_sharded(path: str, state: FedState, runtime=None,
                 meta: Optional[Dict] = None) -> str:
    """The JAX package's sharded layout (its ``save_state(sharded=True)``)
    from the ranks: every rank calls it; rank 0 streams the entries into
    ``<path>.npz``, receiving one rank's shard at a time (a point-to-point
    ``recv``; its host holds one shard at most), each shard written once
    and a replicated field once; the per-entry digests go to
    ``<path>.meta.json``. The npz is written to a ``.tmp`` file, the meta
    beside it, then the npz renamed: a generation never lacks its meta.
    Returns the npz path (on every rank, once it is written)."""
    import zipfile as zf_mod
    mesh = getattr(runtime, "mesh", None)
    rank = mesh.rank if mesh is not None else 0
    plan = ShardPlan(runtime, state)
    if rank != 0:
        import torch.distributed as dist
        for name, _, _, shards in plan.fields:
            for owner, _ in shards:
                if owner == rank:
                    dist.send(_local(state, name).contiguous(), dst=0)
        mesh.barrier()
        return path + ".npz"

    def entries():
        yield "__sharded__", lambda: np.asarray(1)
        for name, shape, dtype, shards in plan.fields:
            yield (f"{name}__shape",
                   lambda shape=shape: np.asarray(shape, np.int64))
            yield f"{name}__dtype", lambda dtype=dtype: np.asarray(dtype)
            for i, (owner, off) in enumerate(shards):
                yield (f"{name}__shard{i}",
                       lambda name=name, owner=owner: _receive(
                           state, name, owner))
                yield (f"{name}__off{i}",
                       lambda off=off: np.asarray(off, np.int64))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".npz.",
                               suffix=".tmp")
    digests: Dict[str, str] = {}
    try:
        with os.fdopen(fd, "wb") as f:
            with zf_mod.ZipFile(f, "w", zf_mod.ZIP_STORED,
                                allowZip64=True) as zf:
                for key, thunk in entries():
                    arr = np.asarray(thunk())
                    digests[key] = entry_digest(arr)
                    with zf.open(key + ".npy", "w", force_zip64=True) as g:
                        np.lib.format.write_array(g, arr,
                                                  allow_pickle=False)
                    del arr
            f.flush()
            os.fsync(f.fileno())
        # the tmp file is written, its rename pending
        maybe_fault("mid_checkpoint_write")
        text = json.dumps(dict(meta or {}, digests=digests)).encode()
        _atomic_write(path + ".meta.json", lambda f: f.write(text))
        os.replace(tmp, path + ".npz")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if mesh is not None:
        mesh.barrier()
    return path + ".npz"


def _receive(state: FedState, name: str, owner: int) -> np.ndarray:
    """Rank 0's copy of rank ``owner``'s block of field ``name`` (its own
    without a message)."""
    local = _local(state, name)
    if owner == 0:
        return local.cpu().numpy()
    import torch.distributed as dist
    buf = torch.empty_like(local)
    dist.recv(buf, src=owner)
    return buf.cpu().numpy()


def restore_own_shards(path: str, runtime, digests=None
                       ) -> Optional[FedState]:
    """A same-topology restore of a sharded file (the JAX package's
    ``_try_streaming_restore``): this rank's slices read from their own
    shards alone, or None when the file is not sharded or its layout is
    not this run's (the caller then assembles it on the host). A run
    without a mesh reads one-shard fields."""
    try:
        z = np.load(path + ".npz")
    except Exception as e:
        raise CheckpointIntegrityError(
            f"checkpoint file {path}.npz is unreadable ({e})") from e
    mesh = getattr(runtime, "mesh", None)
    rank = mesh.rank if mesh is not None else 0
    held = runtime.state_shapes()
    plan = ShardPlan(runtime, _shape_state(runtime))
    kw = {}
    with z:
        if "__sharded__" not in z.files:
            return None
        names = set(_sharded_fields(z))
        if names - {"nan_round"} != ({f for f, _, _, _ in plan.fields}
                                     - {"nan_round"}):
            return None
        for name, shape, dtype, shards in plan.fields:
            if name not in names:
                continue
            stored = tuple(int(x) for x in read_entry(
                z, f"{name}__shape", path, digests))
            offsets = {off: i for i, off in
                       _shard_offsets(z, name, path, digests)}
            mine = [off for owner, off in shards if owner == rank]
            i = offsets.get(mine[0] if mine else shards[0][1])
            if stored != tuple(shape) or i is None:
                return None
            arr = read_entry(z, f"{name}__shard{i}", path, digests)
            local = () if name == "step" else tuple(held[name])
            if tuple(arr.shape) != local or str(arr.dtype) != dtype:
                return None
            kw[name] = arr
    if "nan_round" not in kw:
        kw["nan_round"] = np.full((), -1, np.int32)
    step = int(kw.pop("step"))
    return FedState(step=step, **{k: torch.from_numpy(np.array(v)).to(
        runtime.device) for k, v in kw.items()})


def _shape_state(runtime) -> FedState:
    """A state of empty tensors with the shapes this rank holds (the
    plan's template)."""
    shapes = runtime.state_shapes()
    kw = {name: (torch.empty(shape) if shape is not None else None)
          for name, shape in shapes.items() if name != "step"}
    return FedState(step=0, **kw)


def load_state(path: str, device="cpu",
               digests: Optional[Dict[str, str]] = None,
               expect_shapes: Optional[Dict[str, Optional[tuple]]] = None
               ) -> FedState:
    """A ``FedState`` on ``device`` from ``<path>.npz`` (digests checked
    when given). ``expect_shapes`` (``FedRuntime.state_shapes``) names
    the fields a run holds and their shapes; a checkpoint that differs in
    any of them but ``FITTED``'s, or in a field's dtype, is refused by
    field."""
    arrays = load_arrays(path, digests)
    if arrays.pop("__sharded__", None) is not None \
            and expect_shapes is not None:
        arrays = fit_to_shapes(arrays, expect_shapes)
    if "nan_round" not in arrays:
        arrays["nan_round"] = np.full((), -1, np.int32)
    for name, arr in arrays.items():
        want = np.int32 if name in INT_FIELDS else np.float32
        if arr.dtype != want:
            raise ValueError(f"checkpoint {path}.npz field '{name}' is "
                             f"{arr.dtype}, want {np.dtype(want)}")
    if expect_shapes is not None:
        for name in FIELDS:
            if name in FITTED:
                continue
            want = expect_shapes.get(name)
            got = arrays[name].shape if name in arrays else None
            if got != (tuple(want) if want is not None else None):
                raise ValueError(
                    f"checkpoint {path}.npz field '{name}' has shape "
                    f"{got}, this run holds {want}: written by another "
                    "model, mode or client count")
    kw = {name: torch.from_numpy(arr).to(device)
          for name, arr in arrays.items() if name != "step"}
    return FedState(step=int(arrays["step"]), **kw)


class CheckpointManager:
    """``ckpt_<epoch:06d>`` generations under ``directory``, the newest
    ``keep_last`` kept. ``default_meta`` joins every save's meta (the
    drivers put the layout fingerprint and the sketch marker there)."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self.default_meta: Dict = {}
        # the generations the last restore_latest skipped: [{path, error}]
        self.restore_fallbacks: List[Dict[str, str]] = []
        # set by setup_checkpointing's resume: the rounds trained inside
        # the restored epoch and the meta's host ledgers
        self.resume: Dict = {}
        # a mesh run's gather of the ranks' slices, and whether this
        # process writes (rank 0)
        self.gather = None
        self.writes = True
        # --checkpoint_sharded: every rank's shards, through rank 0; the
        # runtime whose layout the shards follow (set on a mesh and under
        # the flag), and whether the last restore read this rank's own
        # shards (no re-sharding then)
        self.sharded = False
        self.runtime = None
        self.restored_local = False

    def path(self, epoch: int, round_in_epoch: int = 0,
             tag: Optional[str] = None) -> str:
        """``ckpt_<epoch:06d>``, or ``ckpt_<epoch:06d>_r<round:06d>_<tag>``
        for a generation written ``round_in_epoch`` rounds into the epoch
        after ``epoch`` (the preemption drain's, tag ``preempt``)."""
        stem = f"ckpt_{epoch:06d}"
        if round_in_epoch or tag:
            stem += f"_r{round_in_epoch:06d}_{tag or 'preempt'}"
        return os.path.join(self.directory, stem)

    def clean_stale_tmp(self) -> List[str]:
        """Removes the ``.tmp`` files a killed write left behind."""
        removed = []
        if os.path.isdir(self.directory):
            for fn in sorted(os.listdir(self.directory)):
                if fn.endswith(".tmp"):
                    os.unlink(os.path.join(self.directory, fn))
                    removed.append(os.path.join(self.directory, fn))
        if removed:
            print(f"checkpoint: removed {len(removed)} stale .tmp file(s) "
                  "of an interrupted write", file=sys.stderr)
        return removed

    def save(self, state: FedState, epoch: int,
             meta: Optional[Dict] = None, round_in_epoch: int = 0,
             tag: Optional[str] = None) -> str:
        """Write a generation; on a mesh (``gather`` set by
        ``setup_checkpointing``) every rank calls it, the ranks' slices
        are gathered into the whole single-device state, and rank 0
        alone writes (``writes``)."""
        meta = dict(self.default_meta, **(meta or {}), epoch=epoch,
                    round_in_epoch=int(round_in_epoch))
        if tag:
            meta["tag"] = tag
        path = self.path(epoch, round_in_epoch, tag)
        if self.sharded:
            if self.writes:
                self.clean_stale_tmp()
            t0 = time.perf_counter()
            out = save_sharded(path, state, self.runtime, meta)
            if not self.writes:
                return out
        else:
            if self.gather is not None:
                # the guard before the gather: no rank copies a state the
                # plain save would refuse
                check_host_bytes(4 * sum(
                    int(np.prod(shape)) for shape in
                    self.runtime.full_state_shapes().values()
                    if shape is not None))
                state = self.gather(state)
            if not self.writes:
                return path + ".npz"
            self.clean_stale_tmp()
            t0 = time.perf_counter()
            out = save_state(path, state, meta)
        print(f"checkpoint: wrote {out} ({os.path.getsize(out) / 2**20:.1f}"
              f" MiB) in {time.perf_counter() - t0:.3f} s", flush=True)
        for _, stem in self.generations()[:-self.keep_last]:
            for suffix in (".npz", ".meta.json"):
                fn = os.path.join(self.directory, stem + suffix)
                if os.path.exists(fn):
                    os.unlink(fn)
        return out

    def generations(self) -> List[Tuple[Tuple[int, int], str]]:
        """Every generation as ``((epoch, round in epoch), stem)``, oldest
        first (the JAX package's mid-epoch ``ckpt_E_rR_tag`` included)."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for fn in os.listdir(self.directory):
            if not (fn.startswith("ckpt_") and fn.endswith(".npz")):
                continue
            stem = fn[:-len(".npz")]
            parts = stem[len("ckpt_"):].split("_")
            try:
                key = (int(parts[0]),
                       int(parts[1][1:]) if len(parts) > 1
                       and parts[1].startswith("r") else 0)
            except ValueError:
                continue
            out.append((key, stem))
        return sorted(out)

    def restore_latest(self, device="cpu", expect_layout=None,
                       expect_shapes=None, expect_sketch_gen=None,
                       unverified: bool = False, expect_async_gen=None):
        """``(state, meta)`` of the newest intact generation (a preempt
        generation inside an epoch included: its meta's
        ``round_in_epoch`` says where), or ``(None, {})`` when there is
        none. Refusals (a ValueError, never a fallback: an older file has
        the same configuration): another layout fingerprint, another
        sketch (both waived by ``unverified``; the caller then zeroes the
        tables), other field shapes, and for an async run
        (``expect_async_gen``) a checkpoint without the async marker
        (waived by ``unverified``: the buffer starts empty). A damaged
        file is skipped with a ``WARNING:`` naming it; when every
        generation is damaged the last damage is raised."""
        self.restore_fallbacks = []
        gens = self.generations()
        if not gens:
            return None, {}
        last_err: Optional[Exception] = None
        for _, stem in reversed(gens):
            path = os.path.join(self.directory, stem)
            try:
                if not os.path.exists(path + ".meta.json"):
                    # both packages write a generation's meta: without it
                    # the digests, epoch and global round are unknown
                    raise CheckpointIntegrityError(
                        f"checkpoint {path}.npz has no {stem}.meta.json")
                meta = load_meta(path)
            except CheckpointIntegrityError as err:
                self._fallback(path, err)
                last_err = err
                continue
            self._check_sketch_gen(meta.get("sketch_gen"), expect_sketch_gen,
                                   unverified, path)
            if expect_async_gen is not None:
                self._check_async_gen(meta.get("async_gen"),
                                      expect_async_gen, unverified, path)
            saved = meta.get("torch_layout")
            if (expect_layout is not None and saved is not None
                    and saved != expect_layout and not unverified):
                raise ValueError(
                    f"checkpoint {path} was written under another parameter "
                    f"layout (fingerprint {saved} != {expect_layout}): its "
                    "flat ps_weights would unravel into the wrong weights. "
                    "Pass --resume_unverified only if the model is "
                    "unchanged.")
            try:
                state = None
                if self.runtime is not None:
                    # a sharded file of this run's layout: this rank's
                    # own shards alone
                    state = restore_own_shards(path, self.runtime,
                                               meta.get("digests"))
                self.restored_local = state is not None
                if state is None:
                    state = load_state(path, device, meta.get("digests"),
                                       expect_shapes)
            except (CheckpointIntegrityError,) + _DAMAGE_ERRORS as err:
                self._fallback(path, err)
                last_err = err
                continue
            return state, meta
        raise CheckpointIntegrityError(
            f"every checkpoint generation under {self.directory} is "
            f"damaged ({len(self.restore_fallbacks)} tried); refusing to "
            f"restart from scratch. Last error: {last_err}")

    @staticmethod
    def _check_async_gen(saved, expect: str, unverified: bool,
                         path: str) -> None:
        """The JAX package's rule: an async run cannot verify a checkpoint
        without the async marker (written before buffered aggregation, or
        by a synchronous run) unless ``unverified`` (the buffer then
        starts empty: commits are atomic, nothing double-counts); a
        marker that differs only warns (the buffer is flushed at every
        epoch's end and at a drain)."""
        if saved == expect:
            return
        if saved is None:
            if unverified:
                return
            raise ValueError(
                f"checkpoint {path} predates async buffered aggregation "
                "(it carries no async_gen marker): the resume cannot "
                "verify the buffer state or commit ledger this "
                f"--async_agg run ({expect!r}) would continue. Pass "
                "--resume_unverified to resume with a FRESH, EMPTY "
                "buffer — that is safe (commits are atomic, nothing "
                "double-counts); the async commit counter restarts.")
        print(f"WARNING: async-aggregation parameters changed "
              f"({saved!r} -> {expect!r}); resuming anyway — the buffer "
              "is committed/flushed atomically, so only future merges "
              "use the new discount", file=sys.stderr)

    def _fallback(self, path: str, err: Exception) -> None:
        self.restore_fallbacks.append({"path": path, "error": str(err)})
        print(f"WARNING: checkpoint {path} is unreadable or corrupt ({err}); "
              "falling back to the previous generation", file=sys.stderr)

    @staticmethod
    def _check_sketch_gen(saved, expect, unverified: bool, path: str):
        """The JAX package's rule: the momentum and error decode only under
        the sketch that encoded them. A dense (d,) state and a table state
        never cross, even unverified; otherwise ``unverified`` lets the
        caller zero them and continue from the weights."""
        if expect is None or saved == expect:
            return
        dense_saved = (isinstance(saved, str)
                       and saved.endswith("-densestate"))
        if dense_saved != expect.endswith("-densestate"):
            layouts = {True: "dense (d,) pre-images", False: "(r, c) tables"}
            raise ValueError(
                f"checkpoint {path} stores its sketch server state as "
                f"{layouts[dense_saved]} (generation {saved!r}) but this run "
                f"holds {layouts[not dense_saved]} (generation {expect!r}): "
                "it can be neither loaded nor discarded in place. Restore "
                "under the original --sketch_server_state")
        if unverified:
            return
        if saved is None:
            raise ValueError(
                f"checkpoint {path} has no sketch-generation marker, so its "
                "momentum/error cannot be verified against the current "
                f"construction {expect!r}. Pass --resume_unverified to "
                "DISCARD the sketch state and continue from the weights.")
        raise ValueError(
            f"checkpoint sketch generation {saved!r} does not match the "
            f"current construction {expect!r}: the saved momentum/error "
            "would decode under the wrong sketch. Re-create the run, or "
            "pass --resume_unverified to DISCARD the sketch state and "
            "continue from the weights.")


def async_generation(cfg) -> Optional[str]:
    """The JAX package's marker of an async run's buffering,
    ``v1-{discount}-a{alpha}-M{goal}-K{inflight}``; None for a
    synchronous run."""
    if not cfg.async_agg:
        return None
    return (f"v1-{cfg.staleness_discount}-a{cfg.staleness_alpha}"
            f"-M{cfg.buffer_goal}-K{cfg.max_inflight}")


def fit_services(state: FedState, runtime) -> FedState:
    """A restored state fitted to the run's services, as the JAX
    package's driver fits it: a normclip ring that is missing or of
    another window restarts cold (NaN), one the run does not hold is
    dropped; the --signals_exact shadow pair restarts at zero where the
    run keeps it and the checkpoint does not (the shadow, not the run,
    restarts), and is dropped where the run does not keep it; the async
    buffer as ``reconcile_resumed_state`` decides (each change
    printed)."""
    from commefficient_torch.core.async_agg import reconcile_resumed_state
    shadow = runtime.state_shapes()["sig_Verror"]
    if shadow is not None and state.sig_Verror is None:
        state = state.replace(
            sig_Vvelocity=torch.zeros(shadow, device=runtime.device),
            sig_Verror=torch.zeros(shadow, device=runtime.device))
    elif shadow is None and state.sig_Verror is not None:
        state = state.replace(sig_Vvelocity=None, sig_Verror=None)
    want = runtime.state_shapes()["defense_ref"]
    ring = state.defense_ref
    if want is not None and (ring is None
                             or tuple(ring.shape) != tuple(want)):
        state = state.replace(defense_ref=torch.full(
            want, float("nan"), device=runtime.device))
    elif want is None and ring is not None:
        state = state.replace(defense_ref=None)
    state, msgs = reconcile_resumed_state(state, runtime)
    for m in msgs:
        print(f"WARNING: {m}", file=sys.stderr)
    return state


def setup_checkpointing(cfg, runtime, name: str):
    """The drivers' ``--checkpoint_every``/``--resume`` wiring. Returns
    ``(manager or None, start_epoch, restored state or None,
    global_round)``: a resumed run starts at the checkpoint's epoch and
    global round; the manager's ``resume`` holds the rounds already
    trained inside that epoch (``round_in_epoch``, a preempt
    generation's) and the host ``ledgers`` of its meta."""
    if not (cfg.checkpoint_every or cfg.do_resume):
        return None, 0, None, 0
    mgr = CheckpointManager(os.path.join(cfg.checkpoint_path, name))
    layout = layout_fingerprint(runtime.layout)
    sketch_gen = sketch_generation(cfg)
    async_gen = async_generation(cfg)
    mgr.default_meta = {"torch_layout": layout, "sketch_gen": sketch_gen,
                        "async_gen": async_gen}
    mesh = getattr(runtime, "mesh", None)
    mgr.sharded = cfg.checkpoint_sharded
    if mesh is not None or cfg.checkpoint_sharded:
        mgr.runtime = runtime
    if mesh is not None:
        mgr.gather = runtime.gather_state
        mgr.writes = mesh.rank == 0
    if not cfg.do_resume:
        return mgr, 0, None, 0
    t0 = time.perf_counter()
    state, meta = mgr.restore_latest(
        runtime.device, expect_layout=layout,
        expect_shapes=getattr(runtime, "full_state_shapes",
                              runtime.state_shapes)(),
        expect_sketch_gen=sketch_gen,
        unverified=cfg.resume_unverified, expect_async_gen=async_gen)
    if state is None:
        print(f"--resume: no checkpoint under {mgr.directory}; starting "
              "from scratch")
        return mgr, 0, None, 0
    if sketch_gen is not None and meta.get("sketch_gen") != sketch_gen:
        state.Vvelocity.zero_()
        state.Verror.zero_()
        print(f"WARNING: sketch generation changed "
              f"({meta.get('sketch_gen')!r} -> {sketch_gen!r}); momentum "
              "and error tables RESET, resuming from the weights only",
              file=sys.stderr)
    # a mesh rank keeps its slices of the whole state the file holds
    # (a sharded file of this layout gave it them already)
    if mesh is not None and not mgr.restored_local:
        state = runtime.shard_state(state)
    state = fit_services(state, runtime)
    epoch = int(meta.get("epoch", 0))
    in_epoch = int(meta.get("round_in_epoch", 0))
    global_round = int(meta.get("global_round", state.step))
    print(f"resumed from {mgr.path(epoch, in_epoch, meta.get('tag'))} "
          f"(epoch {epoch}"
          + (f" + {in_epoch} rounds (preempt checkpoint)" if in_epoch
             else "")
          + f", global round {global_round}; "
          f"{len(meta.get('digests', {}))} entries verified) in "
          f"{time.perf_counter() - t0:.3f} s"
          + "".join(f"; skipped damaged {fb['path']}"
                    for fb in mgr.restore_fallbacks), flush=True)
    mgr.resume = {"round_in_epoch": in_epoch,
                  "ledgers": meta.get("ledgers"), "epoch": epoch,
                  "global_round": global_round,
                  "checkpoint": mgr.path(epoch, in_epoch, meta.get("tag")),
                  "fallbacks": list(mgr.restore_fallbacks)}
    return mgr, epoch, state, global_round
