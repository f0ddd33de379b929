"""The clients mesh of the port, counterpart of the JAX package's
``parallel/mesh.py``: ``init_distributed``, ``make_mesh`` and
``FedShardings``.

The JAX package runs one program over a device mesh and lets XLA insert
the collectives. The port runs one process per rank (``torchrun``, or
``spawn_ranks`` in the tests), each driving one device, and calls
``torch.distributed`` collectives on an explicit process group: NCCL for
``cuda:{local_rank}``, gloo under ``--device cpu``; neither falls back to
the other. The mesh has a ``clients`` axis and, optionally, a ``seq``
axis (``--mesh_axes clients,seq``): rank ``c n_seq + s`` is clients
index c and seq index s, the order in which the JAX package's
``devices.reshape(mesh_shape)`` lays them out, and each axis has its own
process group (``Mesh.clients``, ``Mesh.seq``). A seq axis of size 1 is
no seq axis. On the clients axis:

- clients index i of n runs the round's positions ``[i W/n, (i+1) W/n)``
  (every seq index of it the same positions, each on its own S/n_seq
  tokens: ``parallel/ring.py``);
- the dense ``(d_pad,)`` federated vectors (weights, dense momentum and
  error, ``coord_last_update``) shard over every rank of the mesh into
  ``d_pad/n`` coordinates a rank, rank i holding
  ``[i d_pad/n, (i+1) d_pad/n)``;
- ``(r, c)`` sketch tables shard their columns when n divides c, and
  replicate otherwise;
- dense per-client rows (velocity, error, the top-k download's weights)
  shard their columns: every rank holds a ``d_pad/n`` slice of every
  client's row, so the round's gather and scatter by client id is local,
  and one ``all_to_all`` turns the W participants' slices into the
  full rows of a rank's own clients and back;
- the rest replicates (the step, ``client_last_round``, ``nan_round``,
  the normclip ring).

Every float reduction sums the ranks' partials in rank order
(``Mesh.all_reduce``, ``Mesh.reduce_scatter``): the partials travel by
an all-gather or an all-to-all, which move bits and add nothing, and
each rank then adds them as ``p_0 + p_1 + ... + p_{n-1}``. A column of
the reduce-scattered table is therefore bitwise that column of the
all-reduced one, which makes the sharded sketch server tail bitwise the
replicated one (an NCCL ``all_reduce`` adds in an order of its own
choosing, which may differ from one collective to the next).

Every launch a ``Mesh`` issues appends one entry to the collectives
ledger while one is recording (``telemetry/collectives.py``): the
logical kind the JAX package's HLO would show, the ``torch.distributed``
call that carried it, and its result's size. Recording is a list append;
it adds no sync.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS = "clients"
SEQ = "seq"
# the mesh axes the port runs, in their order
AXES = (AXIS, SEQ)
# the gather into one tensor (renamed all_gather_single in later torch)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
# how long a rank group may take before spawn_ranks kills it
SPAWN_TIMEOUT_S = 180.0
# the dtypes that travel as their bytes
_BYTES = (torch.bfloat16, torch.bool)
# the JAX package's spelling of each dtype in the collectives ledger
_XLA_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64", torch.int8: "s8",
              torch.uint8: "u8", torch.int32: "s32", torch.int64: "s64",
              torch.bool: "pred"}
# the ledger being recorded (telemetry/collectives.py recording), or None
_LEDGER = {"entries": None}


def record_ledger(entries: Optional[list]) -> Optional[list]:
    """Start recording the mesh's launches into ``entries`` (None stops);
    returns the list that was recording before."""
    before = _LEDGER["entries"]
    _LEDGER["entries"] = entries
    return before


@contextlib.contextmanager
def _unrecorded():
    """The launches inside go unrecorded (a composite collective records
    itself once, under its logical kind)."""
    before = record_ledger(None)
    try:
        yield
    finally:
        record_ledger(before)


def _note(kind: str, via: str, out: torch.Tensor, dtype=None) -> None:
    """One ledger entry for a launch whose result is ``out`` (its logical
    ``dtype``, where it travelled as bytes)."""
    entries = _LEDGER["entries"]
    if entries is None:
        return
    dtype = dtype or out.dtype
    n = out.numel()
    entries.append({"kind": kind, "via": via, "n_elements": int(n),
                    "dtype": _XLA_DTYPE.get(dtype, str(dtype)),
                    "bytes": int(n * torch.empty((), dtype=dtype)
                                 .element_size()),
                    "combined_in": (entries[-1]["combined_in"] + 1
                                    if entries else 0)})


def init_distributed(device="cuda", rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     port: Optional[int] = None) -> torch.device:
    """Join the process group once a process and return the rank's
    device. Without ``rank`` the ``env://`` variables that ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) say where (without them the process is a group of
    one); with it, a TCP store on 127.0.0.1:``port``.
    ``device`` "cuda" takes NCCL on ``cuda:{LOCAL_RANK}``, "cpu" gloo; a
    process already in a group keeps it (and must use the same backend)."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"init_distributed: no backend for {device!r}")
    backend = "nccl" if kind == "cuda" else "gloo"
    local_rank = int(os.environ.get("LOCAL_RANK", rank or 0))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for the "
                               "NCCL backend (pass --device cpu for gloo)")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"init_distributed: the process group runs "
                f"{dist.get_backend()}, and {device!r} needs {backend}")
        return dev
    if rank is None and "RANK" not in os.environ:
        # a lone process (no torchrun): a group of one
        rank, world_size, port = 0, 1, free_port()
    if rank is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if world_size is None or port is None:
            raise ValueError("init_distributed: an explicit rank needs "
                             "world_size and port")
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{int(port)}",
            rank=int(rank), world_size=int(world_size),
            **({"device_id": dev} if kind == "cuda" else {}))
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of ``size`` ranks over ``group``: this process is ``rank``
    and computes on ``device``. Its collectives run on that group (a CUDA
    tensor through NCCL, a CPU tensor through gloo). ``shape`` is the
    mesh's shape over ``axes``; on a (clients, seq) mesh ``sub`` holds the
    two axes' own meshes (``clients``, ``seq``). ``ranks`` are the
    group's members' global ranks in group order (a subgroup's
    point-to-point peers)."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = AXIS
    shape: Tuple[int, ...] = ()
    axes: Tuple[str, ...] = (AXIS,)
    ranks: Tuple[int, ...] = ()
    sub: Tuple = ()

    # ------------------------------------------------------------ axes

    @property
    def clients(self) -> "Mesh":
        """The clients axis's mesh (the mesh itself without a seq axis)."""
        return self.sub[0] if self.sub else self

    @property
    def seq(self) -> Optional["Mesh"]:
        """The seq axis's mesh, or None (no seq axis, or one of size 1)."""
        return self.sub[1] if self.sub else None

    @property
    def n_seq(self) -> int:
        return self.seq.size if self.seq is not None else 1

    def peer(self, i: int) -> int:
        """The global rank of the group's rank ``i``."""
        return self.ranks[i] if self.ranks else i

    # ---------------------------------------------------- collectives

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(n,) + x.shape``: every rank's ``x``, in rank order. A bf16
        or bool tensor travels as its bytes (gloo has neither type; a
        gather moves bits either way)."""
        shape, dtype = tuple(x.shape), x.dtype
        # the ranks' tensors concatenated on a leading axis (the form both
        # backends take), then split into the rank axis
        wire = x.contiguous().reshape(1, -1)
        if dtype in _BYTES:
            wire = wire.view(torch.uint8)
        out = wire.new_empty((self.size, wire.shape[1]))
        _all_gather(out, wire, group=self.group)
        _note("all-gather", "all_gather_into_tensor", out, dtype)
        return out.view(dtype).reshape((self.size,) + shape)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block i of ``x`` (its leading axis cut into n equal blocks) to
        rank i; returns the blocks received, stacked in rank order on the
        leading axis (the same shape as ``x``)."""
        shape, dtype = tuple(x.shape), x.dtype
        wire = x.contiguous().reshape(self.size, -1)
        if dtype in _BYTES:
            wire = wire.view(torch.uint8)
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.group)
        _note("all-to-all", "all_to_all_single", out, dtype)
        return out.view(dtype).reshape(shape)

    @staticmethod
    def ordered_sum(parts: torch.Tensor, dtype=None) -> torch.Tensor:
        """``parts[0] + parts[1] + ...`` over the leading axis, in that
        order, in ``dtype`` (default the parts')."""
        if dtype is not None:
            parts = parts.to(dtype)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_reduce(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """The sum of every rank's ``x``, added in rank order in
        ``dtype`` (default ``x``'s: a bf16 ``x`` travels in bf16 and may
        add in float32). The ledger counts an all-reduce carried by an
        all-gather."""
        with _unrecorded():
            parts = self.all_gather(x)
        _note("all-reduce", "all_gather_into_tensor", x)
        return self.ordered_sum(parts, dtype)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0,
                       dtype=None) -> torch.Tensor:
        """This rank's block (of n equal ones along ``dim``) of the sum of
        every rank's ``x``, added in rank order in ``dtype``: bitwise that
        block of ``all_reduce(x, dtype)``."""
        n = self.size
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        blocks = x.movedim(dim, 0).unflatten(0, (n, -1))
        with _unrecorded():
            got = self.all_to_all(blocks)
        out = self.ordered_sum(got, dtype).movedim(0, dim)
        _note("reduce-scatter", "all_to_all_single", out, x.dtype)
        return out

    def all_reduce_int(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of an integer tensor over the ranks (exact in any
        order)."""
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        _note("all-reduce", "all_reduce", x)
        return x

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """Whether ``flag`` (a bool scalar) holds on any rank, as a bool
        scalar on every rank."""
        return self.all_reduce_int(flag.to(torch.int32)) > 0

    def rotate(self, tensors: Sequence[torch.Tensor],
               shift: int = 1) -> list:
        """Each tensor to rank ``(rank + shift) % n``, and what rank
        ``(rank - shift) % n`` sent, in one ``batch_isend_irecv`` (the JAX
        package's ``ppermute``); the tensors themselves at n = 1."""
        n = self.size
        if n == 1:
            return list(tensors)
        dst = self.peer((self.rank + shift) % n)
        src = self.peer((self.rank - shift) % n)
        ops, outs = [], []
        for t in tensors:
            wire = t.contiguous()
            if wire.dtype in _BYTES:
                wire = wire.view(torch.uint8)
            out = torch.empty_like(wire)
            ops.append(dist.P2POp(dist.isend, wire, dst, self.group))
            ops.append(dist.P2POp(dist.irecv, out, src, self.group))
            outs.append((out, t.dtype))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        res = []
        for out, dtype in outs:
            _note("collective-permute", "batch_isend_irecv", out, dtype)
            res.append(out.view(dtype))
        return res

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The round's (W, ...) vector from the ranks' (W/n, ...) slices,
        in position order."""
        return self.all_gather(x).flatten(0, 1)

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """The whole last axis from the ranks' column blocks."""
        return self.all_gather(x).movedim(0, -2).flatten(-2)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def make_mesh(mesh_shape: Tuple[int, ...] = (),
              mesh_axes: Tuple[str, ...] = (AXIS,),
              device=None) -> Optional[Mesh]:
    """The mesh of ``--mesh_shape`` over the process group, as the JAX
    package's ``make_mesh`` builds it (its ``:37-54``): ``()`` at world
    size 1 is None (the single-device round); ``()`` over several ranks
    is a one-axis mesh of them all; a shape needing more ranks than the
    world holds raises. A two-axis shape over ``clients,seq`` makes a
    process group for each row and each column of the (n_clients, n_seq)
    grid (every rank joins every group's creation, in one order); a seq
    axis of size 1 makes none."""
    mesh_shape = tuple(int(x) for x in mesh_shape)
    mesh_axes = tuple(mesh_axes) or (AXIS,)
    check_axes(mesh_shape, mesh_axes)
    ws = world_size()
    if not mesh_shape:
        if ws == 1:
            return None
        mesh_shape = (ws,)
    n = 1
    for s in mesh_shape:
        n *= s
    if n > ws:
        raise ValueError(f"mesh {mesh_shape} needs {n} ranks, have {ws} "
                         "(start one process per rank: torchrun "
                         f"--nproc_per_node {n})")
    if n != ws:
        raise ValueError(f"mesh {mesh_shape} takes {n} of the {ws} ranks; "
                         "the port runs one mesh over the whole world")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call init_distributed first")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    rank = dist.get_rank()
    axes = mesh_axes[:len(mesh_shape)]
    sub = ()
    if len(mesh_shape) == 2 and mesh_shape[1] > 1:
        n_c, n_s = mesh_shape
        c, s = divmod(rank, n_s)
        groups = {}
        for j in range(n_s):
            members = tuple(i * n_s + j for i in range(n_c))
            groups[(AXIS, j)] = (dist.new_group(list(members)), members)
        for i in range(n_c):
            members = tuple(i * n_s + j for j in range(n_s))
            groups[(SEQ, i)] = (dist.new_group(list(members)), members)
        (cg, cm), (sg, sm) = groups[(AXIS, s)], groups[(SEQ, c)]
        sub = (Mesh(group=cg, rank=c, size=n_c, device=device, axis=AXIS,
                    shape=(n_c,), ranks=cm),
               Mesh(group=sg, rank=s, size=n_s, device=device, axis=SEQ,
                    shape=(n_s,), axes=(SEQ,), ranks=sm))
    return Mesh(group=dist.group.WORLD, rank=rank, size=n, device=device,
                axis=axes[0], shape=mesh_shape, axes=axes, sub=sub)


def check_axes(mesh_shape: Tuple[int, ...],
               mesh_axes: Tuple[str, ...]) -> None:
    """Refuse a mesh the port does not run: axes other than ``clients``
    and ``clients,seq``, or a shape with more dimensions than axes."""
    axes = tuple(mesh_axes) or (AXIS,)
    if axes not in (AXES[:1], AXES) or len(mesh_shape) > len(axes):
        raise ValueError(
            f"--mesh_axes {','.join(axes)} --mesh_shape "
            f"{','.join(map(str, mesh_shape))}: the port runs the clients "
            "axis, or clients,seq (ring attention over the seq axis, "
            "parallel/ring.py), one size each")


class FedShardings:
    """Which slice of each ``FedState`` family rank ``mesh.rank`` holds,
    the counterpart of the JAX package's ``FedShardings`` (its
    ``:64-158``). ``for_state`` maps each field to ``"replicated"``,
    ``"dense"`` (a ``d_pad/n`` block of a (d_pad,) vector), ``"cols"``
    (a block of the last axis: table columns, or the columns of every
    dense client row) or None (a field the run does not hold).

    Where the port departs from the JAX layout, it is because a process
    holds what it computes on: the sketch tables shard their columns
    under the sharded server tail (which needs n | c) and stay whole on
    every rank under the replicated tail, which holds the whole table
    the all-reduce hands every rank (the JAX package stores them
    column-sharded whenever n | c and lets XLA gather them); the top-k
    download's client weights shard their columns like the other dense
    rows (the JAX package shards their rows); ``client_last_round``
    replicates, since each rank counts the download bytes of its own
    coordinates for all W participants."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def for_state(self, cfg, shapes: Dict[str, Optional[Tuple[int, ...]]],
                  sharded_server: bool = False
                  ) -> Dict[str, Optional[str]]:
        """``shapes`` are the single-device shapes of the fields
        (``FedRuntime.full_state_shapes``)."""
        out: Dict[str, Optional[str]] = {}
        for name, shape in shapes.items():
            if shape is None:
                out[name] = None
            elif name in ("client_velocities", "client_errors",
                          "client_weights"):
                # dense rows (the sketch rule forbids local state, so
                # there are no table rows)
                out[name] = "cols"
            elif name in ("ps_weights", "coord_last_update", "Vvelocity",
                          "Verror", "async_buffer"):
                if len(shape) == 2:
                    out[name] = ("cols" if sharded_server
                                 and shape[1] % self.mesh.size == 0
                                 else "replicated")
                else:
                    out[name] = "dense"
            else:
                out[name] = "replicated"
        return out


def setup_mesh(cfg, device: torch.device):
    """``(device, mesh or None)`` for ``--mesh_shape``: each process of
    ``torchrun --nproc_per_node N`` joins the group (NCCL on
    ``cuda:{LOCAL_RANK}``, gloo under ``--device cpu``) and becomes a rank
    of the mesh; rank 0 alone prints (the others' stdout is closed),
    writes telemetry and checkpoints (all ranks write under
    ``--checkpoint_sharded``, through rank 0). The JAX package's checks
    (its ``cv_train.py:84-97``): the world is the mesh, and its clients
    axis divides ``--num_workers``. The entry points' helper."""
    if not cfg.mesh_shape:
        return device, None
    n = 1
    for dim in cfg.mesh_shape:
        n *= dim
    world = int(os.environ.get("WORLD_SIZE", world_size()))
    if n != world:
        raise ValueError(
            f"--mesh_shape {','.join(map(str, cfg.mesh_shape))} needs {n} "
            f"ranks, the world has {world}: start one process per rank "
            f"(torchrun --nproc_per_node {n} -m ...)")
    device = init_distributed(device.type)
    mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes, device)
    if mesh is None:
        return device, None
    if cfg.num_workers % mesh.clients.size:
        raise ValueError(f"--num_workers {cfg.num_workers} must be divisible "
                         f"by the mesh axis size {mesh.clients.size}")
    if mesh.rank != 0:
        sys.stdout = open(os.devnull, "w")
    return device, mesh


# ------------------------------------------------------------ launching


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a rank group's store."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, fn: Callable, args: Sequence,
               out_dir: str) -> None:
    import pickle
    import traceback
    # one thread a rank: the groups share the CPU with other processes
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        init_distributed("cpu", rank=rank, world_size=n, port=port)
        result = ("ok", fn(rank, n, *args))
    except Exception:            # the parent raises it with the traceback
        result = ("err", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(path, "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn: Callable, n: int, *args,
                meanwhile: Optional[Callable[[], None]] = None) -> list:
    """Run ``fn(rank, n, *args)`` in n fresh processes joined in one gloo
    group on 127.0.0.1 (the tests' CPU ranks); returns the n results in
    rank order, and raises with a rank's traceback if any failed (or took
    longer than SPAWN_TIMEOUT_S). ``meanwhile()``, if given, runs in this
    process while the ranks run (a test's references), and the ranks are
    killed if it raises. ``fn`` and its results must pickle; every
    process ends before it returns."""
    import multiprocessing
    import pickle
    import tempfile
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, port, fn, args, out_dir))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            if meanwhile is not None:
                meanwhile()
            for p in procs:
                p.join(SPAWN_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} of {n} died (exit code "
                                   f"{p.exitcode}) without a result")
            with open(path, "rb") as f:
                status, val = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} of {n} failed:\n{val}")
            results.append(val)
    return results
