"""The Fixup ImageNet ResNet (BN-free bottleneck ResNet-50), counterpart
of the JAX package's ``models/fixup_resnet.py``.

No normalization anywhere. Each bottleneck block has scalar biases before
each conv and relu and a scalar scale on the residual branch; its last
conv starts at zero and the two before it are He ``fan_out`` draws scaled
by L^-1/4 (L blocks, 3 convs a block); its 1x1 shortcut reads ``x +
bias1a``. A 7x7 stride-2 stem with a scalar bias, a 3/2 max-pool padded by
1, four stages, a global average pool, a scalar bias and a zero
classifier.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from commefficient_torch.models.layers import (FlatModel, Params, conv,
                                               conv1x1, conv3x3, dense,
                                               global_avg_pool, max_pool,
                                               scalar, scaled_he, zeros)

IMAGENET_SHAPE = (224, 224, 3)


def fixup_bottleneck(p: Params, x: torch.Tensor, features: int,
                     num_layers: int, stride: int = 1) -> torch.Tensor:
    """``FixupBottleneck``: 1x1, 3x3 (strided), 1x1 to 4 x ``features``."""
    out_ch = features * 4
    init = scaled_he(num_layers, m=3)
    b1a = scalar(p, "bias1a")
    y = conv1x1(p, "conv1", x + b1a, features, init=init)
    y = torch.relu(y + scalar(p, "bias1b"))
    y = conv3x3(p, "conv2", y + scalar(p, "bias2a"), features, stride,
                init=init)
    y = torch.relu(y + scalar(p, "bias2b"))
    y = conv1x1(p, "conv3", y + scalar(p, "bias3a"), out_ch, init=zeros)
    y = y * scalar(p, "scale", 1.0) + scalar(p, "bias3b")
    if stride != 1 or x.shape[1] != out_ch:
        x = conv1x1(p, "shortcut", x + b1a, out_ch, stride)
    return torch.relu(y + x)


class FixupResNetImageNet(FlatModel):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000,
                 input_shape: Sequence[int] = IMAGENET_SHAPE,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layers = tuple(layers)
        self.num_classes = num_classes
        self.build(input_shape, generator, device)

    def net(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        depth = sum(self.layers)
        x = conv(p, "stem", x, 64, 7, stride=2, padding=3)
        x = torch.relu(x + scalar(p, "bias1"))
        x = max_pool(x, 3, stride=2, padding=1)
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                self.layers)):
            for i in range(n):
                x = fixup_bottleneck(p.child(f"stage{stage}_block{i}"), x,
                                     planes, depth,
                                     stride=2 if stage > 0 and i == 0
                                     else 1)
        x = global_avg_pool(x)
        return dense(p, "fc", x + scalar(p, "bias2"), self.num_classes,
                     init=zeros)


def FixupResNet50(num_classes: int = 1000, **kw) -> FixupResNetImageNet:
    return FixupResNetImageNet(layers=(3, 4, 6, 3), num_classes=num_classes,
                               **kw)
