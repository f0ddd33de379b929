"""Building blocks of the port's models: the flat-parameter layout, the
Flax kernel initializer, and the convolution layers as functions on NCHW
tensors.

Counterparts of the JAX package's ``models/layers.py``. Weights arrive in
the JAX package's layouts (conv kernels HWIO) as views into the model's
flat parameter vector, and are permuted here to what ``torch.nn.functional``
takes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# Flax's default kernel init (lecun_normal): truncated normal at +-2 std,
# rescaled so the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def ravel_layout(tree: Dict, prefix: str = "") -> List[Tuple[str, Tuple]]:
    """``(path, shape)`` of every leaf of a nested dict of shapes in
    ``ravel_pytree`` order (sorted keys, depth first)."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            out.extend(ravel_layout(val, path))
        else:
            out.append((path, tuple(val)))
    return out


def lecun_normal_(view: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """Fill ``view`` in place as Flax's ``lecun_normal`` would (the draws
    are torch's, not JAX's)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(view, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def conv3x3(x: torch.Tensor, kernel_hwio: torch.Tensor) -> torch.Tensor:
    """3x3 convolution, stride 1, padding 1, no bias (``nn.Conv(features,
    (3, 3), padding=1, use_bias=False)``)."""
    return F.conv2d(x, kernel_hwio.permute(3, 2, 0, 1), padding=1)


def max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """VALID max pooling over ``window`` x ``window``, stride ``window``."""
    return F.max_pool2d(x, window)


def batch_stat_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    epsilon: float = 1e-5) -> torch.Tensor:
    """``BatchStatNorm``: normalize by the current batch's per-channel mean
    and (biased) variance over (N, H, W), in training and evaluation
    alike, then apply the learned scale and bias. No running statistics."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    return y * scale[None, :, None, None] + bias[None, :, None, None]
