"""Building blocks of the port's models, as functions on NCHW tensors.

Counterparts of the JAX package's ``models/layers.py``. Weights arrive in
the JAX package's layouts (conv kernels HWIO) as views into the model's
flat parameter vector, and are permuted here to what ``torch.nn.functional``
takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
