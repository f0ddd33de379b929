"""Wrappers of the circulant-sketch CUDA kernels, and their plain versions.

K1 ``encode`` replaces the JAX package's ``ops/circulant_pallas.py
pallas_encode``; K2 ``decode`` replaces ``pallas_decode`` (its range form,
a ``start``, decodes one rank's coordinates for the sharded server tail).
The kernels are in ``csrc/circulant.cu`` (design and bounds in its header
note). ``cell_sum``, the sparse re-encode's ordered sum of each table
cell's addends, replaces no Pallas kernel (its counterpart is XLA's
``segment_sum``); its kernel is in ``csrc/cellsum.cu``.

Each wrapper takes the plain PyTorch version only for tensors that lie on
the CPU. For a CUDA tensor it launches the kernel on the current stream or
raises; nothing falls back. ``launches`` counts, per wrapper, the times it
launched its kernel.

Arguments shared by both: ``shifts`` (r, m) int32 in [0, c), and ``keys``
(r,) int32 holding the bits of the uint32 sign keys, both on the data's
device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from commefficient_torch.ops import _build
from commefficient_torch.ops.hashing import MASK32, signs
from commefficient_torch.ops.topk import median_axis0

SOURCE = "circulant.cu"
CELL_SUM_SOURCE = "cellsum.cu"
# the most rows K1 and K2 take (csrc/circulant.cu kMaxRows): each r up to
# it has its own instantiation and median network; both entry points
# refuse a larger --num_rows for the circulant sketch at parse time
MAX_ROWS = 16

# launches of each kernel since the last reset_launches(); the range
# forms (a ``start``) are also counted apart
launches = {"circ_encode": 0, "circ_decode": 0, "cell_sum": 0}
range_launches = {"circ_encode": 0, "circ_decode": 0}


def reset_launches() -> None:
    for counts in (launches, range_launches):
        for name in counts:
            counts[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.circ_encode.argtypes = [p, ll, ll, p, p, i, i, i,
                                    ctypes.c_float, i, p, p]
        lib.circ_encode.restype = i
        lib.circ_decode.argtypes = [p, p, p, i, i, i, ll, ll, ll, i, p, p]
        lib.circ_decode.restype = i
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous={t.is_contiguous()})")


def _check_geometry(d: int, c: int, r: int, m: int) -> None:
    if m != -(-d // c):
        raise ValueError(f"m={m} is not ceil(d/c) for d={d}, c={c}")
    if m * c >= 2 ** 32:
        raise ValueError(f"m*c={m * c} coordinates exceed the uint32 "
                         "sign-stream index range")
    if r < 1:
        raise ValueError(f"r={r}")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ------------------------------------------------------------------ K1


def _range_geometry(n: int, c: int, r: int, m: int,
                    start: Optional[int]) -> int:
    """The first coordinate of ``n`` values: 0 for the whole vector
    (``start`` None; then m must be ceil(n / c)), else ``start`` with the
    range inside the m c coordinates."""
    if start is None:
        _check_geometry(n, c, r, m)
        return 0
    start = int(start)
    if start < 0 or n < 1 or start + n > m * c:
        raise ValueError(f"range [{start}, {start + n}) outside the "
                         f"{m} x {c} coordinates")
    _check_geometry(m * c, c, r, m)
    return start


def encode_plain(v: torch.Tensor, shifts: torch.Tensor, keys: torch.Tensor,
                 c: int, r: int, m: int, scale: Optional[float] = None,
                 table: Optional[torch.Tensor] = None,
                 start: Optional[int] = None) -> torch.Tensor:
    """Plain version of K1: ``[table +] encode(scale * v)`` of the vector
    holding ``v`` at the coordinates ``[start, start + len(v))`` (the
    whole vector without ``start``) and zeros elsewhere, by a loop over
    rows and the range's blocks with ``torch.roll``, summing the blocks
    in ascending order as the kernel does, then adding the sum to
    ``table``."""
    n = v.shape[0]
    start = _range_geometry(n, c, r, m, start)
    vals = v.to(torch.float32)
    if scale is not None:
        vals = vals * scale
    b0 = start // c
    o0 = start - b0 * c
    nb = -(-(o0 + n) // c)
    vp = torch.nn.functional.pad(vals, (o0, nb * c - o0 - n)).view(nb, c)
    idx = torch.arange(b0 * c, (b0 + nb) * c, dtype=torch.int64,
                       device=v.device)
    keys64 = keys.to(torch.int64) & MASK32
    sh = shifts.tolist()
    out = torch.empty((r, c), dtype=torch.float32, device=v.device)
    for j in range(r):
        sv = signs(idx, keys64[j]).view(nb, c) * vp
        row = torch.zeros(c, dtype=torch.float32, device=v.device)
        for b in range(nb):
            row += torch.roll(sv[b], sh[j][b0 + b])
        out[j] = row
    return out if table is None else table + out


def encode(v: torch.Tensor, shifts: torch.Tensor, keys: torch.Tensor,
           c: int, r: int, m: int, scale: Optional[float] = None,
           table: Optional[torch.Tensor] = None,
           start: Optional[int] = None) -> torch.Tensor:
    """K1: the (r, c) table ``encode(scale * v)`` of the float32 vector
    ``v``: the whole (d,) vector, or with ``start`` the vector holding
    ``v`` at the coordinates ``[start, start + len(v))`` and zeros
    elsewhere. With ``table`` given, ``table + encode(scale * v)`` is
    written into ``table`` in place (on the card in the same launch) and
    ``table`` is returned."""
    n = v.shape[0]
    start_given = start is not None
    start = _range_geometry(n, c, r, m, start)
    if v.device.type == "cpu":
        out = encode_plain(v, shifts, keys, c, r, m, scale, start=start)
        return out if table is None else table.add_(out)
    if v.device.type != "cuda":
        raise ValueError(f"encode: no kernel for device {v.device}")
    _check("v", v, torch.float32, (n,), v.device)
    _check("shifts", shifts, torch.int32, (r, m), v.device)
    _check("keys", keys, torch.int32, (r,), v.device)
    if r > MAX_ROWS:
        raise ValueError(f"encode kernel takes r <= {MAX_ROWS}, got r={r}")
    lib = _lib()
    if table is None:
        out, accumulate = torch.empty((r, c), dtype=torch.float32,
                                      device=v.device), 0
    else:
        _check("table", table, torch.float32, (r, c), v.device)
        out, accumulate = table, 1
    err = lib.circ_encode(
        v.data_ptr(), start, n, shifts.data_ptr(), keys.data_ptr(), c, r, m,
        1.0 if scale is None else float(scale), accumulate, out.data_ptr(),
        torch.cuda.current_stream(v.device).cuda_stream)
    _raise_on("circ_encode", err)
    launches["circ_encode"] += 1
    range_launches["circ_encode"] += start_given
    return out


# ------------------------------------------------------------------ K2


def decode_plain(table: torch.Tensor, shifts: torch.Tensor,
                 keys: torch.Tensor, c: int, r: int, m: int,
                 d: int) -> torch.Tensor:
    """Plain version of K2: per-coordinate signed gathers from every row by
    index arithmetic, then ``median_axis0``."""
    return decode_range_plain(table, shifts, keys, c, r, m, d, 0, d)


def decode_range_plain(table: torch.Tensor, shifts: torch.Tensor,
                       keys: torch.Tensor, c: int, r: int, m: int, d: int,
                       start: int, n: int) -> torch.Tensor:
    """Plain version of K2's range form: the estimates of the coordinates
    ``[start, start + n)`` by the gather form (each coordinate's signed
    cell in every row, then ``median_axis0``), exactly 0 at and beyond
    ``d``; bitwise ``decode_plain(...)[start:start + n]`` below d."""
    out = torch.zeros(n, dtype=torch.float32, device=table.device)
    live = max(0, min(n, d - start))
    if not live:
        return out
    x = torch.arange(start, start + live, dtype=torch.int64,
                     device=table.device)
    b = torch.div(x, c, rounding_mode="floor")
    i = x - b * c
    keys64 = keys.to(torch.int64) & MASK32
    sh = shifts.to(torch.int64)
    ests = torch.stack([
        signs(x, keys64[j]) * table[j][(i + sh[j][b]) % c]
        for j in range(r)])
    out[:live] = median_axis0(ests)
    return out


def decode(table: torch.Tensor, shifts: torch.Tensor, keys: torch.Tensor,
           c: int, r: int, m: int, d: int, start: Optional[int] = None,
           n: Optional[int] = None) -> torch.Tensor:
    """K2: the (d,) float32 median-of-r estimates of an (r, c) table; with
    ``start`` (and ``n``), the range form: the (n,) estimates of the
    global coordinates ``[start, start + n)``, exactly +0.0 at and past
    d, bitwise that slice of the whole decode (one launch of the range
    instantiation, even for ``start=0, n=d``, counted in
    ``range_launches`` too)."""
    _check_geometry(d, c, r, m)
    ranged = start is not None
    start = int(start) if ranged else 0
    n = int(n) if n is not None else d - start
    if start < 0 or n < 1 or start + n >= 2 ** 32:
        raise ValueError(f"decode: range [{start}, {start + n}) is empty, "
                         "negative or past the uint32 coordinates")
    if table.device.type == "cpu":
        return decode_range_plain(table, shifts, keys, c, r, m, d, start, n)
    if table.device.type != "cuda":
        raise ValueError(f"decode: no kernel for device {table.device}")
    _check("table", table, torch.float32, (r, c), table.device)
    _check("shifts", shifts, torch.int32, (r, m), table.device)
    _check("keys", keys, torch.int32, (r,), table.device)
    if r > MAX_ROWS:
        raise ValueError(f"decode kernel takes r <= {MAX_ROWS}, got r={r}")
    lib = _lib()
    out = torch.empty(n, dtype=torch.float32, device=table.device)
    err = lib.circ_decode(
        table.data_ptr(), shifts.data_ptr(), keys.data_ptr(), c, r, m, d,
        start, n, int(ranged), out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on("circ_decode", err)
    if start < d:   # a range wholly past d is a memset, no launch
        launches["circ_decode"] += 1
        range_launches["circ_decode"] += ranged
    return out


# ------------------------------------------------------------ cell sum


def _cell_sum_lib() -> ctypes.CDLL:
    lib = _build.load(CELL_SUM_SOURCE)
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.cell_sum.argtypes = [p, p, p, ctypes.c_longlong, p, p]
        lib.cell_sum.restype = ctypes.c_int
        lib._typed = True
    return lib


def cell_sum_plain(sorted_cells: torch.Tensor, order: torch.Tensor,
                   addends: torch.Tensor, size: int) -> torch.Tensor:
    """Plain version of the cell sum: each addend gets its rank among its
    cell's addends (its place in the sorted order less the place of its
    cell's first addend), and rank t is added to all cells at once for
    t = 0, 1, ...: one write a cell a rank, no two writes to a cell in one
    step, each ``table[at] + addend`` from a +0.0 table. The number of
    ranks is read back to the host."""
    n = sorted_cells.numel()
    pos = torch.arange(n, device=sorted_cells.device)
    rank = torch.empty_like(pos)
    rank[order] = pos - torch.searchsorted(sorted_cells, sorted_cells)
    cells = torch.empty_like(sorted_cells)
    cells[order] = sorted_cells
    table = torch.zeros(size + 1, dtype=torch.float32,
                        device=addends.device)
    for t in range(int(rank.max()) + 1 if n else 0):
        now = rank == t
        at = torch.where(now, cells, size)     # the other ranks: a spare
        table[at] = table[at] + torch.where(now, addends, 0.0)
    return table[:size]


def cell_sum(sorted_cells: torch.Tensor, order: torch.Tensor,
             addends: torch.Tensor, size: int) -> torch.Tensor:
    """The (size,) float32 table whose cell x sums the float32
    ``addends[t]`` of the t with cell x, in the order of t: the stable
    sort of the flat cells (``sorted_cells``, int64 in [0, size), and its
    ``order``) gives each run of equal cells in that order, and the
    kernel folds each run from +0.0 into its cell. No value is read back
    to the host on the card."""
    n = sorted_cells.numel()
    if addends.shape != (n,) or order.shape != (n,):
        raise ValueError(f"cell_sum: {n} cells, {tuple(order.shape)} order, "
                         f"{tuple(addends.shape)} addends")
    if addends.device.type == "cpu":
        return cell_sum_plain(sorted_cells, order,
                              addends.to(torch.float32), size)
    if addends.device.type != "cuda":
        raise ValueError(f"cell_sum: no kernel for device {addends.device}")
    dev = addends.device
    _check("sorted_cells", sorted_cells, torch.int64, (n,), dev)
    _check("order", order, torch.int64, (n,), dev)
    _check("addends", addends, torch.float32, (n,), dev)
    table = torch.zeros(size, dtype=torch.float32, device=dev)
    err = _cell_sum_lib().cell_sum(
        sorted_cells.data_ptr(), order.data_ptr(), addends.data_ptr(), n,
        table.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on("cell_sum", err)
    if n:
        launches["cell_sum"] += 1
    return table
