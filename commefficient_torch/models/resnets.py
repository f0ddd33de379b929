"""The torchvision-style ResNet family with a LayerNorm option,
counterpart of the JAX package's ``models/resnets.py``.

A 7x7 stride-2 stem, a norm, a 3/2 max-pool padded by 1, four stages of
``BasicBlock`` or ``Bottleneck`` (whose width is ``int(features *
base_width / 64) * groups``, its 3x3 conv grouped), a global average pool
and a biased classifier. The norm is ``batch`` (batch statistics),
``layer`` (``SpatialLayerNorm``: each example over its whole map, a scale
and bias of the map's shape, so the layout depends on the input's height
and width) or ``none``. The constructors are the reference's exported
names, ``resnet18`` to ``wide_resnet101_2``, and ``ResNet101LN``
(resnet101 with LayerNorm everywhere, 62 classes, for FEMNIST).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from commefficient_torch.models.layers import (FlatModel, Params, conv,
                                               conv1x1, conv3x3, dense,
                                               global_avg_pool, make_norm,
                                               max_pool)

EMNIST_SHAPE = (28, 28, 1)


def basic_block(p: Params, x: torch.Tensor, features: int, stride: int,
                norm: Callable, groups: int = 1,
                base_width: int = 64) -> torch.Tensor:
    y = conv3x3(p, "Conv_0", x, features, stride)
    y = torch.relu(norm(p, 0, y))
    y = norm(p, 1, conv3x3(p, "Conv_1", y, features))
    if stride != 1 or x.shape[1] != features:
        x = norm(p, 2, conv1x1(p, "downsample_conv", x, features, stride))
    return torch.relu(y + x)


def bottleneck(p: Params, x: torch.Tensor, features: int, stride: int,
               norm: Callable, groups: int = 1,
               base_width: int = 64) -> torch.Tensor:
    width = int(features * (base_width / 64.0)) * groups
    out_ch = features * 4
    y = torch.relu(norm(p, 0, conv1x1(p, "Conv_0", x, width)))
    y = torch.relu(norm(p, 1, conv3x3(p, "Conv_1", y, width, stride,
                                      groups)))
    y = norm(p, 2, conv1x1(p, "Conv_2", y, out_ch))
    if stride != 1 or x.shape[1] != out_ch:
        x = norm(p, 3, conv1x1(p, "downsample_conv", x, out_ch, stride))
    return torch.relu(y + x)


class ResNet(FlatModel):
    def __init__(self, block: Callable, layers: Sequence[int],
                 num_classes: int = 1000, norm: str = "batch",
                 groups: int = 1, width_per_group: int = 64,
                 input_shape: Sequence[int] = EMNIST_SHAPE,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.block = block
        self.layers = tuple(layers)
        self.num_classes = num_classes
        self.norm = norm
        self.groups = groups
        self.width_per_group = width_per_group
        self.build(input_shape, generator, device)

    def net(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        norm = make_norm(self.norm)
        x = conv(p, "stem", x, 64, 7, stride=2, padding=3)
        x = torch.relu(norm(p, 0, x))
        x = max_pool(x, 3, stride=2, padding=1)
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                self.layers)):
            for i in range(n):
                x = self.block(p.child(f"stage{stage}_block{i}"), x, planes,
                               2 if stage > 0 and i == 0 else 1, norm,
                               self.groups, self.width_per_group)
        return dense(p, "fc", global_avg_pool(x), self.num_classes)


def _make(block, layers, **fixed):
    def ctor(num_classes: int = 1000, norm: str = "batch", **kw) -> ResNet:
        return ResNet(block, layers, num_classes=num_classes, norm=norm,
                      **{**fixed, **kw})
    return ctor


resnet18 = _make(basic_block, (2, 2, 2, 2))
resnet34 = _make(basic_block, (3, 4, 6, 3))
resnet50 = _make(bottleneck, (3, 4, 6, 3))
resnet101 = _make(bottleneck, (3, 4, 23, 3))
resnet152 = _make(bottleneck, (3, 8, 36, 3))
resnext50_32x4d = _make(bottleneck, (3, 4, 6, 3), groups=32,
                        width_per_group=4)
resnext101_32x8d = _make(bottleneck, (3, 4, 23, 3), groups=32,
                         width_per_group=8)
wide_resnet50_2 = _make(bottleneck, (3, 4, 6, 3), width_per_group=128)
wide_resnet101_2 = _make(bottleneck, (3, 4, 23, 3), width_per_group=128)


def ResNet101LN(num_classes: int = 62, **kw) -> ResNet:
    """resnet101 with LayerNorm everywhere, 62 classes (FEMNIST)."""
    return resnet101(num_classes=num_classes, norm="layer", **kw)
