"""ResNet-9 (cifar10_fast lineage), counterpart of
the JAX package's ``models/resnet9.py ResNet9``.

Prep 3x3 conv, three conv stages with 2x max-pool, residual pairs after
stages 1 and 3, global max-pool and a bias-free linear head scaled by
0.125; batch-statistics norm after each conv under
``do_batchnorm``.

Every parameter is a view into ONE flat float32 vector laid out in the JAX
ravel order: ``ravel_pytree`` over the Flax parameter dict, keys sorted at
every level, conv kernels HWIO, the head (in, out). Autograd therefore
returns the flat gradient in the order the sketch encodes, and weights move
between the packages as one vector (models/convert.py). The public input is
NHWC as in the JAX package; the forward permutes to NCHW inside.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from commefficient_torch.models.layers import (batch_stat_norm, conv3x3,
                                               lecun_normal_, max_pool,
                                               ravel_layout)

DEFAULT_CHANNELS = {"prep": 64, "layer1": 128, "layer2": 256, "layer3": 512}
HEAD_WEIGHT = 0.125    # the reference's ``Mul`` classifier scale
POOL = 2               # max-pool window after the downsampling stages


def _convbn_tree(cin: int, cout: int, bn: bool) -> Dict:
    tree = {"Conv_0": {"kernel": (3, 3, cin, cout)}}
    if bn:
        tree["BatchStatNorm_0"] = {"bias": (cout,), "scale": (cout,)}
    return tree


def param_tree(do_batchnorm: bool = False, num_classes: int = 10,
               channels: Optional[Dict[str, int]] = None) -> Dict:
    """Nested dict of parameter shapes (RGB input), named as Flax names
    them."""
    ch = channels or DEFAULT_CHANNELS
    bn = do_batchnorm
    return {"params": {
        "ConvBN_0": _convbn_tree(3, ch["prep"], bn),
        "ConvBN_1": _convbn_tree(ch["prep"], ch["layer1"], bn),
        "Residual_0": {"ConvBN_0": _convbn_tree(ch["layer1"], ch["layer1"],
                                                bn),
                       "ConvBN_1": _convbn_tree(ch["layer1"], ch["layer1"],
                                                bn)},
        "ConvBN_2": _convbn_tree(ch["layer1"], ch["layer2"], bn),
        "ConvBN_3": _convbn_tree(ch["layer2"], ch["layer3"], bn),
        "Residual_1": {"ConvBN_0": _convbn_tree(ch["layer3"], ch["layer3"],
                                                bn),
                       "ConvBN_1": _convbn_tree(ch["layer3"], ch["layer3"],
                                                bn)},
        "head": {"kernel": (ch["layer3"], num_classes)},
    }}


class ResNet9(nn.Module):
    def __init__(self, do_batchnorm: bool = False, num_classes: int = 10,
                 channels: Optional[Dict[str, int]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.do_batchnorm = do_batchnorm
        self.layout = ravel_layout(param_tree(do_batchnorm, num_classes,
                                              channels))
        self.num_params = sum(math.prod(s) for _, s in self.layout)
        self.flat = nn.Parameter(torch.empty(self.num_params))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initializers: lecun_normal kernels, BatchStatNorm scale 1
        and bias 0. The draws are torch's, not JAX's; carry JAX weights
        over with ``models.convert.params_from_jax``."""
        with torch.no_grad():
            for path, view in self.views(self.flat).items():
                if path.endswith("/kernel"):
                    lecun_normal_(view, math.prod(view.shape[:-1]),
                                  generator)
                elif path.endswith("/scale"):
                    view.fill_(1.0)
                else:
                    view.zero_()

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Parameter views into ``flat``, keyed by Flax path without the
        leading ``params/``. One ``split`` rather than a slice per
        parameter: its backward writes the flat gradient with one
        concatenation, where each slice's backward would fill and add a
        whole d-sized zero vector."""
        pieces = torch.split(flat, [math.prod(s) for _, s in self.layout])
        return {path[len("params/"):]: piece.view(shape)
                for (path, shape), piece in zip(self.layout, pieces)}

    def forward(self, x_nhwc: torch.Tensor,
                flat: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Logits of the NHWC batch ``x_nhwc``, with the weights ``flat``
        (default: the module's own), computed in ``dtype``."""
        p = {k: v.to(dtype) for k, v in
             self.views(self.flat if flat is None else flat).items()}
        x = x_nhwc.to(dtype).permute(0, 3, 1, 2)

        def convbn(x, name, pool=0):
            x = conv3x3(x, p[f"{name}/Conv_0/kernel"])
            if self.do_batchnorm:
                x = batch_stat_norm(x, p[f"{name}/BatchStatNorm_0/scale"],
                                    p[f"{name}/BatchStatNorm_0/bias"])
            x = torch.relu(x)
            return max_pool(x, pool) if pool else x

        def residual(x, name):
            y = convbn(x, f"{name}/ConvBN_0")
            y = convbn(y, f"{name}/ConvBN_1")
            return x + torch.relu(y)

        x = convbn(x, "ConvBN_0")
        x = convbn(x, "ConvBN_1", POOL)
        x = residual(x, "Residual_0")
        x = convbn(x, "ConvBN_2", POOL)
        x = convbn(x, "ConvBN_3", POOL)
        x = residual(x, "Residual_1")
        # global max pool (MaxPool2d(4) on the 4x4 CIFAR map)
        x = x.amax(dim=(2, 3))
        return (x @ p["head/kernel"]) * HEAD_WEIGHT
