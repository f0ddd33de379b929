"""ResNet-9 (cifar10_fast lineage) and its Fixup variant, counterparts of
the JAX package's ``models/resnet9.py`` ``ResNet9`` and ``FixupResNet9``.

``ResNet9``: prep 3x3 conv, three conv stages with 2x max-pool, residual
pairs after stages 1 and 3, global max-pool and a bias-free linear head
scaled by 0.125; batch-statistics norm after each conv under
``do_batchnorm``. ``FixupResNet9``: the norm-free version, each conv
wrapped in scalar biases and a scalar scale, Fixup basic blocks (a He
L^-1/2 first conv, a zero second conv) after stages 1 and 3, and a
biased head.

Every parameter is a view into ONE flat float32 vector laid out in the JAX
ravel order: ``ravel_pytree`` over the Flax parameter dict, keys sorted at
every level, conv kernels HWIO, the head (in, out). Autograd therefore
returns the flat gradient in the order the sketch encodes, and weights move
between the packages as one vector (models/convert.py). The public input is
NHWC as in the JAX package; the forward permutes to NCHW inside.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from commefficient_torch.models.layers import (FlatModel, Params,
                                               batch_stat_norm, conv1x1,
                                               conv3x3, dense,
                                               fixup_conv_init, max_pool,
                                               scalar, zeros)

DEFAULT_CHANNELS = {"prep": 64, "layer1": 128, "layer2": 256, "layer3": 512}
HEAD_WEIGHT = 0.125    # the reference's ``Mul`` classifier scale
POOL = 2               # max-pool window after the downsampling stages
CIFAR_SHAPE = (32, 32, 3)


class ResNet9(FlatModel):
    def __init__(self, do_batchnorm: bool = False, num_classes: int = 10,
                 channels: Optional[Dict[str, int]] = None,
                 input_shape: Sequence[int] = CIFAR_SHAPE,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.do_batchnorm = do_batchnorm
        self.num_classes = num_classes
        self.channels = channels or DEFAULT_CHANNELS
        self.build(input_shape, generator, device)

    def net(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        ch = self.channels

        def convbn(p, x, features, pool=0):
            x = conv3x3(p, "Conv_0", x, features)
            if self.do_batchnorm:
                x = batch_stat_norm(p, "BatchStatNorm_0", x)
            x = torch.relu(x)
            return max_pool(x, pool) if pool else x

        def residual(p, x, features):
            y = convbn(p.child("ConvBN_0"), x, features)
            y = convbn(p.child("ConvBN_1"), y, features)
            return x + torch.relu(y)

        x = convbn(p.child("ConvBN_0"), x, ch["prep"])
        x = convbn(p.child("ConvBN_1"), x, ch["layer1"], POOL)
        x = residual(p.child("Residual_0"), x, ch["layer1"])
        x = convbn(p.child("ConvBN_2"), x, ch["layer2"], POOL)
        x = convbn(p.child("ConvBN_3"), x, ch["layer3"], POOL)
        x = residual(p.child("Residual_1"), x, ch["layer3"])
        # global max pool (MaxPool2d(4) on the 4x4 CIFAR map)
        x = x.amax(dim=(2, 3))
        return dense(p, "head", x, self.num_classes,
                     use_bias=False) * HEAD_WEIGHT


def fixup_basic_block(p: Params, x: torch.Tensor, features: int,
                      num_layers: int, stride: int = 1) -> torch.Tensor:
    """``FixupBasicBlock``: scalar biases around each conv, a scalar scale
    before the residual add, conv1 He L^-1/2 and conv2 zero at init (so
    the block starts as the identity, or as its shortcut), and a 1x1
    shortcut on a change of shape."""
    y = conv3x3(p, "conv1", x + scalar(p, "bias1a"), features, stride,
                init=fixup_conv_init(num_layers))
    y = torch.relu(y + scalar(p, "bias1b"))
    y = conv3x3(p, "conv2", y + scalar(p, "bias2a"), features, init=zeros)
    y = y * scalar(p, "scale", 1.0) + scalar(p, "bias2b")
    if stride != 1 or x.shape[1] != features:
        x = conv1x1(p, "shortcut", x, features, stride)
    return torch.relu(y + x)


def fixup_layer(p: Params, x: torch.Tensor, features: int, num_blocks: int,
                pool: int = POOL, num_layers: int = 2) -> torch.Tensor:
    """``FixupLayer``: conv(x + bias1a) * scale + bias1b, relu, pool, then
    ``num_blocks`` Fixup basic blocks."""
    x = conv3x3(p, "Conv_0", x + scalar(p, "bias1a"), features)
    x = torch.relu(x * scalar(p, "scale", 1.0) + scalar(p, "bias1b"))
    if pool:
        x = max_pool(x, pool)
    for i in range(num_blocks):
        x = fixup_basic_block(p.child(f"block{i}"), x, features, num_layers)
    return x


class FixupResNet9(FlatModel):
    def __init__(self, num_classes: int = 10,
                 channels: Optional[Dict[str, int]] = None, pool: int = POOL,
                 input_shape: Sequence[int] = CIFAR_SHAPE,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.channels = channels or DEFAULT_CHANNELS
        self.pool = pool
        self.build(input_shape, generator, device)

    def net(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        ch = self.channels
        x = conv3x3(p, "Conv_0", x + scalar(p, "bias1a"), ch["prep"])
        x = torch.relu(x * scalar(p, "scale", 1.0) + scalar(p, "bias1b"))
        x = fixup_layer(p.child("layer1"), x, ch["layer1"], 1, self.pool)
        x = fixup_layer(p.child("layer2"), x, ch["layer2"], 0, self.pool)
        x = fixup_layer(p.child("layer3"), x, ch["layer3"], 1, self.pool)
        x = x.amax(dim=(2, 3))   # global max pool (see ResNet9)
        return dense(p, "head", x + scalar(p, "bias2"), self.num_classes)
