"""Magnitude top-k, the comparator-network median and L2 clipping.

Counterpart of the JAX package's ``ops/topk.py``. Plain PyTorch: the JAX
package leaves these to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch


_LOW32 = 0xFFFFFFFF


def _rank_keys(sq: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is ``lax.top_k``'s order of
    ``sq`` along its last axis: the high 32 bits are the float32 bits of
    ``sq`` mapped to a signed integer of the same total order (-NaN < -inf
    < ... < -0 < +0 < ... < +inf < +NaN, NaN payloads by their bits), the
    low 32 bits ``0xFFFFFFFF - index``, so an equal value ranks the lower
    index first. The keys are unique, so no tie is left to the sort.

    Each half is written straight into the int64 keys through an int32
    view (little-endian, as the CPU and the card are: the low half comes
    first), which saves the widening casts, shifts and ors of building
    them in int64."""
    bits = sq.contiguous().view(torch.int32)
    n = sq.shape[-1]
    keys = torch.empty(sq.shape, dtype=torch.int64, device=sq.device)
    halves = keys.view(torch.int32).unflatten(-1, (n, 2))
    # a set sign bit flips the other 31: the total order as a signed int
    halves[..., 1] = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    # -1 - index has the bits of 0xFFFFFFFF - index
    halves[..., 0] = torch.arange(-1, -n - 1, -1, dtype=torch.int32,
                                  device=sq.device)
    return keys


def topk_with_idx(vec: torch.Tensor, k: int, approx: bool = False):
    """Dense vector keeping the ``k`` entries of largest ``vec * vec`` (zero
    elsewhere), and their (k,) int64 indices, as ``lax.top_k(vec * vec,
    k)`` selects and orders them: by the total order of the float32 bits
    of ``vec * vec`` (a NaN ranks above +inf, or below -inf when its sign
    bit is set), ties to the lower index. It always returns k indices.

    One ``torch.topk`` over unique int64 keys (``_rank_keys``): no
    ``nonzero`` and no value read back to the host. The card's float
    multiply may return another NaN than the CPU's for a NaN input (the
    canonical +NaN); the order is the total order of whatever ``vec *
    vec`` gave.

    ``approx`` (``lax.approx_max_k``, a TPU XLA op with recall >= 0.95)
    maps to this exact top-k: exact selection satisfies its contract.
    """
    del approx
    k = int(k)
    if vec.ndim != 1 or not 0 < k <= vec.shape[0]:
        raise ValueError(f"k={k} outside [1, {vec.shape[-1]}] or shape "
                         f"{tuple(vec.shape)} not 1-D")
    keys = torch.topk(_rank_keys(vec * vec), k).values
    idx = _LOW32 - (keys & _LOW32)
    out = torch.zeros_like(vec)
    out[idx] = vec[idx]
    return out, idx


def local_topk_candidates(vec: torch.Tensor, k: int, offset: int = 0,
                          approx: bool = False):
    """The candidate stage of a sharded top-k (the JAX package's
    ``ops/topk.py local_topk_candidates``): ``vec`` is one shard, the
    contiguous slice of the global vector starting at coordinate
    ``offset``, along its last axis (a leading axis holds rows, each
    selecting its own). Returns the shard's top ``min(k, len)`` entries
    as ``(values, global int64 indices)``, ordered as ``topk_with_idx``
    orders them: descending ``vec * vec``, ties to the lower index.
    Taking min(k, len) makes the merge exact: the global top-k has at
    most that many winners in any one shard."""
    del approx
    k_loc = min(int(k), vec.shape[-1])
    keys = torch.topk(_rank_keys(vec * vec), k_loc, dim=-1).values
    li = _LOW32 - (keys & _LOW32)
    return vec.gather(-1, li), li + int(offset)


def merge_topk_candidates(cand_vals: torch.Tensor, cand_idx: torch.Tensor,
                          k: int):
    """The global top-k from the shards' candidates (the JAX package's
    ``merge_topk_candidates``): ``cand_vals``/``cand_idx`` are ``(n,
    ..., k_loc)`` stacks of ``local_topk_candidates`` over n contiguous
    shards in index order (what an all-gather returns). Within a shard
    equal magnitudes come in ascending index order, and shard order is
    index order, so ranking the flattened candidates with ties to the
    earlier position selects, in the same order, the coordinates
    ``topk_with_idx`` selects on the whole vector, ties across shard
    edges included. Returns ``(values, indices)``, ``(..., k)`` each."""
    flat_v = cand_vals.movedim(0, -2).flatten(-2)
    flat_i = cand_idx.movedim(0, -2).flatten(-2)
    k = int(k)
    if flat_v.shape[-1] < k:
        raise ValueError(
            f"{tuple(cand_vals.shape)} candidates cannot cover k={k}: each "
            "shard must contribute min(k, shard_len) candidates")
    keys = torch.topk(_rank_keys(flat_v * flat_v), k, dim=-1).values
    sel = _LOW32 - (keys & _LOW32)
    return flat_v.gather(-1, sel), flat_i.gather(-1, sel)


def scatter_winners(win_vals: torch.Tensor, win_idx: torch.Tensor,
                    start: int, length: int) -> torch.Tensor:
    """The dense block ``[start, start + length)`` of the merged winners
    (``merge_topk_candidates``'s ``(..., k)`` values at their global
    indices), zero elsewhere: ``(..., length)``. Winners outside the
    block land in a spare slot that is cut off, so no host read decides
    which are inside (top-k indices are distinct)."""
    rel = win_idx - start
    inside = (rel >= 0) & (rel < length)
    out = win_vals.new_zeros(win_vals.shape[:-1] + (length + 1,))
    out.scatter_(-1, torch.where(inside, rel, length),
                 torch.where(inside, win_vals, 0.0))
    return out[..., :length]


def topk(vec: torch.Tensor, k: int, approx: bool = False) -> torch.Tensor:
    """The dense top-k of ``topk_with_idx``: over the whole vector for a
    1-D ``vec``, row by row (each row keeps its own k) for a 2-D one."""
    if vec.ndim == 1:
        return topk_with_idx(vec, k, approx)[0]
    if vec.ndim != 2:
        raise ValueError(f"topk takes 1-D or 2-D, got {tuple(vec.shape)}")
    k = int(k)
    if not 0 < k <= vec.shape[1]:
        raise ValueError(f"k={k} outside [1, {vec.shape[1]}]")
    keys = torch.topk(_rank_keys(vec * vec), k, dim=1).values
    idx = _LOW32 - (keys & _LOW32)
    return torch.zeros_like(vec).scatter_(1, idx, vec.gather(1, idx))


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum``: a NaN operand is returned, and -0 < +0, so
    min(-0, +0) is -0 in either order. ``torch.minimum`` returns its first
    argument on a tie of -0 and +0."""
    take_a = torch.isnan(a) | (a < b) | ((a == b) & torch.signbit(a))
    return torch.where(take_a, a, b)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``: a NaN operand is returned, and max(-0, +0) is +0
    in either order."""
    take_a = torch.isnan(a) | (a > b) | ((a == b) & ~torch.signbit(a))
    return torch.where(take_a, a, b)


def median_axis0(x: torch.Tensor) -> torch.Tensor:
    """Median over a small leading axis by the bubble min/max network of
    the JAX package's ``ops/topk.py median_axis0``: the same comparisons
    in the same order, under the same min/max (``minimum``, ``maximum``),
    and the mean of the two middle values for even r."""
    r = x.shape[0]
    if r == 1:
        return x[0]
    rows = [x[i] for i in range(r)]
    for i in range(r):
        for j in range(r - 1 - i):
            lo = minimum(rows[j], rows[j + 1])
            hi = maximum(rows[j], rows[j + 1])
            rows[j], rows[j + 1] = lo, hi
    if r % 2:
        return rows[r // 2]
    return 0.5 * (rows[r // 2 - 1] + rows[r // 2])


def clip_by_l2_norm(record: torch.Tensor, clip: float) -> torch.Tensor:
    """Scale ``record`` down to L2 norm ``clip`` if it exceeds it. A 2-D
    sketch table is clipped by the sketch's estimate of the vector norm,
    the median of its row norms."""
    if record.ndim == 2:
        l2 = median_axis0(torch.linalg.vector_norm(record, dim=1))
    else:
        l2 = torch.linalg.vector_norm(record)
    scale = torch.where(l2 > clip, clip / torch.clamp(l2, min=1e-12),
                        torch.ones_like(l2))
    return record * scale.to(record.dtype)
