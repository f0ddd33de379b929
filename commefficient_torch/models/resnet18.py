"""CIFAR ResNet-18s, BN and Fixup, counterparts of the JAX package's
``models/resnet18.py`` ``ResNet18`` and ``FixupResNet18``.

A 3x3 prep conv to 64 channels, four stages of two blocks each with
widths (64, 128, 256, 256) and strides (1, 2, 2, 2), and a head that
concatenates the global average and max pools (512 features) before a
linear classifier. ``ResNet18`` uses post-activation conv + batch-stat
norm blocks with a 1x1 projection on a change of shape; ``FixupResNet18``
the Fixup basic block of ``models/resnet9.py`` and a zero classifier.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from commefficient_torch.models.layers import (FlatModel, Params,
                                               batch_stat_norm, conv1x1,
                                               conv3x3, dense,
                                               global_avg_pool,
                                               global_max_pool,
                                               lecun_normal, zeros)
from commefficient_torch.models.resnet9 import CIFAR_SHAPE, fixup_basic_block

STAGE_WIDTHS = (64, 128, 256, 256)
STAGE_STRIDES = (1, 2, 2, 2)


def bn_block(p: Params, x: torch.Tensor, features: int,
             stride: int = 1) -> torch.Tensor:
    """``BNBlock``: conv-norm-relu twice, plus the input (projected on a
    change of shape)."""
    y = conv3x3(p, "Conv_0", x, features, stride)
    y = torch.relu(batch_stat_norm(p, "BatchStatNorm_0", y))
    y = conv3x3(p, "Conv_1", y, features)
    y = torch.relu(batch_stat_norm(p, "BatchStatNorm_1", y))
    if stride != 1 or x.shape[1] != features:
        x = conv1x1(p, "Conv_2", x, features, stride)
    return y + x


def dual_pool_head(p: Params, x: torch.Tensor, num_classes: int,
                   zero_init: bool = False) -> torch.Tensor:
    """``_DualPoolHead``: the average and max pools side by side, then the
    classifier."""
    x = torch.cat([global_avg_pool(x), global_max_pool(x)], dim=1)
    return dense(p, "classifier", x, num_classes,
                 init=zeros if zero_init else lecun_normal)


class ResNet18(FlatModel):
    fixup = False

    def __init__(self, num_classes: int = 10,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 input_shape: Sequence[int] = CIFAR_SHAPE,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_blocks = tuple(num_blocks)
        self.build(input_shape, generator, device)

    def net(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        depth = sum(self.num_blocks)
        x = torch.relu(conv3x3(p, "prep", x, 64))
        for stage, (w, s, n) in enumerate(
                zip(STAGE_WIDTHS, STAGE_STRIDES, self.num_blocks)):
            for i in range(n):
                scope = p.child(f"stage{stage}_block{i}")
                stride = s if i == 0 else 1
                x = (fixup_basic_block(scope, x, w, depth, stride)
                     if self.fixup else bn_block(scope, x, w, stride))
        return dual_pool_head(p.child("_DualPoolHead_0"), x,
                              self.num_classes, zero_init=self.fixup)


class FixupResNet18(ResNet18):
    fixup = True
