"""Magnitude top-k, the comparator-network median and L2 clipping.

Counterpart of the JAX package's ``ops/topk.py``. Plain PyTorch: the JAX
package leaves these to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def topk_with_idx(vec: torch.Tensor, k: int, approx: bool = False):
    """Dense vector keeping the ``k`` entries of largest ``vec * vec`` (zero
    elsewhere), and their (k,) int64 indices.

    Ties follow ``lax.top_k``: the lower index wins. ``torch.topk`` does not
    promise that, so the rule is enforced at the k-th value: every entry
    strictly above it is kept, and the entries equal to it are taken in
    ascending index order until k are chosen. The indices come back in
    descending magnitude, ties in ascending index, as ``lax.top_k`` orders
    them.

    ``approx`` (``lax.approx_max_k``, a TPU XLA op with recall >= 0.95)
    maps to this exact top-k: exact selection satisfies its contract.
    """
    del approx
    k = int(k)
    if not 0 < k <= vec.shape[0]:
        raise ValueError(f"k={k} outside [1, {vec.shape[0]}]")
    sq = vec * vec
    kth = torch.topk(sq, k, sorted=False).values.min()
    above = torch.nonzero(sq > kth).squeeze(1)
    at = torch.nonzero(sq == kth).squeeze(1)[: k - above.numel()]
    idx = torch.sort(torch.cat((above, at))).values
    order = torch.sort(sq[idx], descending=True, stable=True).indices
    idx = idx[order]
    out = torch.zeros_like(vec)
    out[idx] = vec[idx]
    return out, idx


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
