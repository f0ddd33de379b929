"""The sketch table's wire (``--wire_dtype int8``): block-quantized int8
cells with float32 scales and stochastic rounding.

Counterpart of the JAX package's ``ops/wire.py``, as plain tensor
functions that run on any device. Each ``block`` consecutive columns of
a row share one float32 scale ``absmax / 127``; a cell rounds to
``floor(x / scale + u)`` for a uniform draw ``u``, so ``E[q * scale] ==
x`` and the rounding residual is zero-mean noise that the server's error
feedback absorbs. The draws come from the murmur finalizer
(ops/hashing.py, uint32 arithmetic in int64 masked to 32 bits) keyed by
``(seed, round, salt, row, column)``, so they are the JAX package's bit
for bit, and a resumed run, whose round comes back from its checkpoint,
draws them again. ``salt`` tells apart the quantizers of one round (the
client slot on the per-client path).

On a mesh the table's reduce is :func:`int8_reduce_scatter` (the JAX
package's): each rank quantizes its partial table with its own salt, the
int8 column shards and their scales travel by ``all_to_all``, and each
rank dequantizes and adds what it received in rank order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from commefficient_torch.ops.hashing import MASK32, mix32, mul32

INT8_MAX = 127.0
# the salt namespace of a mesh's reduce quantizer, kept apart from the
# client slots' (the JAX package's constant)
REDUCE_SALT = 1 << 30
# bytes a table cell costs on the wire; the int8 wire adds 4 bytes of
# float32 scale a block of cells (FedConfig.upload_wire_bytes)
WIRE_CELL_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def wire_uniform(r: int, c: int, *, seed: int, round_idx: int, salt: int,
                 device="cpu") -> torch.Tensor:
    """(r, c) float32 draws in [0, 1) for the cells of a table, keyed by
    ``(seed, round_idx, salt, row, column)``: the cell grid is mixed with
    the seed, then with the mixed (round, salt) pair. 24 bits a draw, so
    each is exact in float32 and below 1."""
    rows = torch.arange(r, dtype=torch.int64, device=device)
    cols = torch.arange(c, dtype=torch.int64, device=device)
    base = (mul32(rows, 0x01000193)[:, None] + cols[None, :]) & MASK32
    seed_mix = (((int(seed) & MASK32) * 0x9E3779B1) + 0x7F4A7C15) & MASK32
    h = mix32(base ^ seed_mix)
    rs = ((int(round_idx) & MASK32) * 0x85EBCA77
          + (int(salt) & MASK32) * 0xC2B2AE3D) & MASK32
    # filled on the device: a host tensor's copy would sync the host
    rs = mix32(torch.full((), rs, dtype=torch.int64, device=device))
    h = mix32((h + rs) & MASK32)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def quantize_table(table: torch.Tensor, block: int, *, seed: int,
                   round_idx: int, salt: int, stochastic: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` of an (r, c) table, ``c % block == 0``: ``q`` (r, c)
    int8, ``scale`` (r, c // block) float32 = ``absmax / 127`` of each
    block. An all-zero block has scale 0 and quantizes to zeros; a NaN or
    an infinity in a block makes its scale NaN or inf, so the
    reconstruction carries it (the wire never turns a non-finite upload
    into a finite one). The NaN cells of ``x`` are set to 0 in ``q``, as
    the JAX package's float-to-int8 conversion sets them."""
    r, c = table.shape
    if c % block:
        raise ValueError(f"table {tuple(table.shape)}: block {block} does "
                         "not divide its columns")
    g = table.to(torch.float32).reshape(r, c // block, block)
    scale = g.abs().amax(dim=2) / INT8_MAX
    # zero blocks divide by 1 and stay zeros; NaN blocks divide by 1 too
    # (NaN > 0 is false) and keep their NaN scale
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    x = g / safe[:, :, None]
    if stochastic:
        u = wire_uniform(r, c, seed=seed, round_idx=round_idx, salt=salt,
                         device=table.device)
        q = torch.floor(x + u.reshape(r, c // block, block))
    else:
        q = torch.round(x)
    q = torch.nan_to_num(q, nan=0.0).clamp_(-INT8_MAX, INT8_MAX)
    return q.reshape(r, c).to(torch.int8), scale


def dequantize_table(q: torch.Tensor, scale: torch.Tensor,
                     block: int) -> torch.Tensor:
    """The float32 table ``q * scale`` of :func:`quantize_table`."""
    r, c = q.shape
    g = q.to(torch.float32).reshape(r, c // block, block)
    return (g * scale[:, :, None]).reshape(r, c)


def dequantize_accum(q: torch.Tensor, scale: torch.Tensor,
                     block: int) -> torch.Tensor:
    """The float32 sum over the leading axis of a stack of quantized
    tables, ``q`` (n, r, c) and ``scale`` (n, r, c // block): each
    dequantized, then added in source order from zero (an int8 sum would
    overflow)."""
    n, r, c = q.shape
    out = torch.zeros((r, c // block, block), dtype=torch.float32,
                      device=q.device)
    for i in range(n):
        out = out + q[i].to(torch.float32).reshape(r, c // block, block) \
            * scale[i][:, :, None]
    return out.reshape(r, c)


def wire_round_trip(table: torch.Tensor, block: int, *, seed: int,
                    round_idx: int, salt: int) -> torch.Tensor:
    """What the server reads of one table sent over the int8 wire:
    quantize, then dequantize."""
    q, scale = quantize_table(table, block, seed=seed, round_idx=round_idx,
                              salt=salt)
    return dequantize_table(q, scale, block)


def int8_reduce_scatter(agg: torch.Tensor, mesh, block: int, *, seed: int,
                        round_idx: int) -> torch.Tensor:
    """The quantized table reduce of a mesh (``--wire_dtype int8`` under
    the sharded server tail): this rank's (r, c/n) column shard of the
    sum of the ranks' (r, c) partial tables. Each rank quantizes its
    partial with salt ``REDUCE_SALT + rank`` (its rounding drawn apart
    from every other rank's and from the per-client uploads'), column
    shard j of ``q`` and of ``scale`` go to rank j by ``Mesh.all_to_all``
    (int8 cells and float32 scales on the wire), and the receiver
    dequantizes and adds the n contributions in rank order
    (:func:`dequantize_accum`)."""
    n = mesh.size
    r, c = agg.shape
    shard_c = c // n
    q, scale = quantize_table(agg, block, seed=seed, round_idx=round_idx,
                              salt=REDUCE_SALT + mesh.rank)
    q = mesh.all_to_all(q.reshape(r, n, shard_c).transpose(0, 1))
    scale = mesh.all_to_all(
        scale.reshape(r, n, shard_c // block).transpose(0, 1))
    return dequantize_accum(q, scale, block)
