"""Building blocks of the port's models: the flat-parameter layout, the
Flax initializers, a Flax-style parameter scope, and the layers as
functions on NCHW tensors.

Counterparts of the JAX package's ``models/layers.py``. Weights arrive in
the JAX package's layouts (conv kernels HWIO, Dense kernels (in, out),
``SpatialLayerNorm`` scale and bias (H, W, C)) as views into the model's
flat parameter vector, and are permuted here to what
``torch.nn.functional`` takes.

A CV model (``FlatModel``) is written once, as ``net(p, x)``: each layer
asks the scope ``p`` for its parameters by their Flax names. Traced once
on the ``meta`` device (no memory, no arithmetic) at the model's input
shape, the scope records every leaf's path, shape and initializer; their
paths sorted as ``ravel_pytree`` sorts the Flax tree give the layout. Run
on real tensors, the scope hands out the views. So the layout follows
from the names the forward uses, whatever order it calls its layers in.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# Flax's default kernel init (lecun_normal): truncated normal at +-2 std,
# rescaled so the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978

# fills one parameter view in place from an optional generator
Init = Callable[[torch.Tensor, Optional[torch.Generator]], None]


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


def lecun_normal(view: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> None:
    """Flax's default kernel init: fan-in over every axis but the last
    (a conv kernel's (kh, kw, in / groups), a Dense kernel's in)."""
    lecun_normal_(view, math.prod(view.shape[:-1]), generator)


def constant(value: float) -> Init:
    def init(view, generator=None):
        view.fill_(value)
    return init


zeros = constant(0.0)
ones = constant(1.0)


def he_fan_out(scale: float = 1.0) -> Init:
    """Flax's ``variance_scaling(2.0, "fan_out", "normal")`` (an untruncated
    normal of variance 2 / (kh kw out)) times ``scale``."""
    def init(view, generator=None):
        fan_out = math.prod(view.shape[:-2]) * view.shape[-1]
        view.normal_(0.0, math.sqrt(2.0 / fan_out) * scale,
                     generator=generator)
    return init


def fixup_conv_init(num_layers: int) -> Init:
    """He ``fan_out`` init scaled by L^-1/2, the first conv of a Fixup
    basic block (the JAX package's ``fixup_conv_init``)."""
    return he_fan_out(num_layers ** -0.5)


def scaled_he(num_layers: int, m: int) -> Init:
    """He ``fan_out`` init scaled by L^-1/(2m-2), the convs of a Fixup
    block of m convs but its last (``fixup_resnet.py _scaled_he``)."""
    return he_fan_out(num_layers ** (-1.0 / (2 * m - 2)))


class Params:
    """A Flax-style parameter scope. Recording (no ``views``), ``param``
    notes each leaf's path, shape and initializer and returns a ``meta``
    tensor of its shape; applying, it returns the leaf's view. ``child``
    scopes share the record or the views under a longer path."""

    def __init__(self, views: Optional[Dict[str, torch.Tensor]] = None,
                 prefix: str = "", record: Optional[Dict] = None):
        self.views = views
        self.record = {} if views is None and record is None else record
        self.prefix = prefix

    def child(self, name: str) -> "Params":
        return Params(self.views, f"{self.prefix}{name}/", self.record)

    def param(self, name: str, shape: Sequence[int],
              init: Init) -> torch.Tensor:
        path = self.prefix + name
        if self.views is not None:
            return self.views[path]
        self.record[path] = (tuple(shape), init)
        return torch.zeros(tuple(shape), device="meta")


class FlatModel(nn.Module):
    """A model whose parameters are views into ONE flat float32 vector
    laid out in the JAX package's ravel order. A subclass sets its
    attributes, then calls ``build`` with the NHWC input shape (the layout
    depends on it: channels, and the spatial shape of a LayerNorm); it
    implements ``net(p, x)`` on an NCHW batch. ``device="meta"`` gives the
    layout without allocating the weights."""

    def build(self, input_shape: Sequence[int],
              generator: Optional[torch.Generator] = None,
              device=None) -> None:
        self.input_shape = tuple(input_shape)
        h, w, c = self.input_shape
        scope = Params()
        with torch.no_grad():
            self.net(scope, torch.zeros((1, c, h, w), device="meta"))
        paths = sorted(scope.record, key=lambda path: path.split("/"))
        self.layout = [("params/" + path, scope.record[path][0])
                       for path in paths]
        self._inits = [scope.record[path][1] for path in paths]
        self.num_params = sum(math.prod(s) for _, s in self.layout)
        self.flat = nn.Parameter(torch.empty(self.num_params, device=device))
        if self.flat.device.type != "meta":
            self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Each leaf's Flax initializer. The draws are torch's, not JAX's;
        carry JAX weights over with ``models.convert.params_from_jax``."""
        with torch.no_grad():
            for view, init in zip(self.views(self.flat).values(),
                                  self._inits):
                init(view, generator)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Parameter views into ``flat``, keyed by Flax path without the
        leading ``params/``. One ``split`` rather than a slice per
        parameter: its backward writes the flat gradient with one
        concatenation, where each slice's backward would fill and add a
        whole d-sized zero vector."""
        pieces = torch.split(flat, [math.prod(s) for _, s in self.layout])
        return {path[len("params/"):]: piece.view(shape)
                for (path, shape), piece in zip(self.layout, pieces)}

    def net(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x_nhwc: torch.Tensor,
                flat: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Logits of the NHWC batch ``x_nhwc``, with the weights ``flat``
        (default: the module's own), computed in ``dtype`` (the weights are
        cast once, as one vector)."""
        flat = self.flat if flat is None else flat
        return self.forward_views(self.views(flat.to(dtype)), x_nhwc, dtype)

    def forward_views(self, views: Dict[str, torch.Tensor],
                      x_nhwc: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Logits of ``x_nhwc`` with the parameter ``views`` (keyed as
        ``views`` keys them, already in ``dtype``): a finetune passes
        frozen leaves that carry no gradient beside trainable ones."""
        return self.net(Params(views), x_nhwc.to(dtype).permute(0, 3, 1, 2))


def conv(p: Params, name: str, x: torch.Tensor, features: int, size: int,
         stride: int = 1, padding: int = 0, groups: int = 1,
         dilation: int = 1, init: Init = lecun_normal) -> torch.Tensor:
    """``nn.Conv(features, (size, size), strides, padding, groups,
    dilation, use_bias=False)``; the kernel is (size, size, in / groups,
    features), grouped as ``feature_group_count`` groups it."""
    kernel = p.param(f"{name}/kernel",
                     (size, size, x.shape[1] // groups, features), init)
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=stride,
                    padding=padding, dilation=dilation, groups=groups)


def conv3x3(p: Params, name: str, x: torch.Tensor, features: int,
            stride: int = 1, groups: int = 1, dilation: int = 1,
            init: Init = lecun_normal) -> torch.Tensor:
    """3x3 convolution padded by ``dilation`` (the JAX package's
    ``conv3x3``)."""
    return conv(p, name, x, features, 3, stride, dilation, groups, dilation,
                init)


def conv1x1(p: Params, name: str, x: torch.Tensor, features: int,
            stride: int = 1, init: Init = lecun_normal) -> torch.Tensor:
    """1x1 VALID convolution (the JAX package's ``conv1x1``)."""
    return conv(p, name, x, features, 1, stride, init=init)


def dense(p: Params, name: str, x: torch.Tensor, features: int,
          use_bias: bool = True, init: Init = lecun_normal) -> torch.Tensor:
    """``nn.Dense``: kernel (in, out), bias zero-initialised."""
    y = x @ p.param(f"{name}/kernel", (x.shape[-1], features), init)
    if use_bias:
        y = y + p.param(f"{name}/bias", (features,), zeros)
    return y


def scalar(p: Params, name: str, value: float = 0.0) -> torch.Tensor:
    """``Scalar``: one learned rank-0 leaf ``<name>/value``."""
    return p.param(f"{name}/value", (), constant(value))


def max_pool(x: torch.Tensor, window: int, stride: Optional[int] = None,
             padding: int = 0) -> torch.Tensor:
    """Max pooling over ``window`` x ``window`` (stride: the window),
    padded with -inf as ``nn.max_pool`` pads."""
    return F.max_pool2d(x, window, stride or window, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=(2, 3))


def _normalize(x: torch.Tensor, dims: Tuple[int, ...],
               epsilon: float) -> torch.Tensor:
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + epsilon)


def batch_stat_norm(p: Params, name: str, x: torch.Tensor,
                    epsilon: float = 1e-5) -> torch.Tensor:
    """``BatchStatNorm``: normalize by the current batch's per-channel mean
    and (biased) variance over (N, H, W), in training and evaluation
    alike, then apply the learned scale and bias. No running statistics."""
    c = x.shape[1]
    scale = p.param(f"{name}/scale", (c,), ones)
    bias = p.param(f"{name}/bias", (c,), zeros)
    y = _normalize(x, (0, 2, 3), epsilon)
    return y * scale[None, :, None, None] + bias[None, :, None, None]


def spatial_layer_norm(p: Params, name: str, x: torch.Tensor,
                       epsilon: float = 1e-5) -> torch.Tensor:
    """``SpatialLayerNorm``: each example normalized over its whole (C, H,
    W) map, then a scale and bias of the map's shape, (H, W, C) in the JAX
    layout."""
    shape = (x.shape[2], x.shape[3], x.shape[1])
    scale = p.param(f"{name}/scale", shape, ones).permute(2, 0, 1)
    bias = p.param(f"{name}/bias", shape, zeros).permute(2, 0, 1)
    return _normalize(x, (1, 2, 3), epsilon) * scale + bias


def make_norm(norm: str) -> Callable[[Params, int, torch.Tensor],
                                     torch.Tensor]:
    """``norm(p, i, x)``, the i-th norm of a scope as Flax auto-names it:
    'batch' -> ``BatchStatNorm_i``, 'layer' -> ``SpatialLayerNorm_i``,
    'none' -> the identity (no parameters)."""
    if norm == "batch":
        return lambda p, i, x: batch_stat_norm(p, f"BatchStatNorm_{i}", x)
    if norm == "layer":
        return lambda p, i, x: spatial_layer_norm(p, f"SpatialLayerNorm_{i}",
                                                  x)
    if norm == "none":
        return lambda p, i, x: x
    raise ValueError(f"unknown norm {norm!r}")
