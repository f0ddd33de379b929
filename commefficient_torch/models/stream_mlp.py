"""StreamMLP: the model whose loss owns its backward, for the fused sketch
encode's ``streaming_grad`` hook (core/client.py).

Counterpart of the JAX package's ``models/stream_mlp.py``: ``L``
identical dense + relu blocks of width ``H`` between an input layer and
a linear head. The parameters are one flat vector in the JAX package's
sorted-key ravel layout, ``blocks_b`` (L, H), ``blocks_w`` (L, H, H),
``inp`` (d_in, H), ``out`` (H, C), so the offsets of every layer's
weights in it are fixed.

The plain loss differentiates through autograd and the fused step then
encodes the whole (d,) gradient at once. ``streaming_grad`` runs the
backward by hand, from the head to the input layer, under
``torch.no_grad()``: it encodes the head's weight gradient into the
carry table at its offset (a K1 range launch on the card), then each
block's (H, H) weight gradient and its bias gradient, then the input
layer's, and drops each before the next layer's backward starts. At
most one layer's gradient exists at a time, so the client step's peak
stays under ``d * 4`` bytes on a parameter-dominated model. The forward
keeps each block's input (activations, not parameters) and reads the
weights as views of the flat vector; the backward recomputes each
block's pre-activation from its input. The JAX version threads opaque
zeros and an ``optimization_barrier`` through its backward to keep
XLA's scheduler from running every layer's gradient at once; eager
PyTorch runs the statements in program order, so the port needs neither.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch

from commefficient_torch.models.convert import params_from_jax


def stream_mlp_layout(d_in: int, hidden: int, n_layers: int,
                      n_classes: int):
    """(path, shape) of the leaves in ravel order (sorted keys)."""
    return [("blocks_b", (n_layers, hidden)),
            ("blocks_w", (n_layers, hidden, hidden)),
            ("inp", (d_in, hidden)), ("out", (hidden, n_classes))]


class StreamMLP:
    """A port model: ``flat`` (the weights), ``num_params``, ``layout``.
    ``init_stream_mlp`` draws the weights; ``from_jax`` takes the JAX
    package's parameter tree."""

    def __init__(self, flat: torch.Tensor, d_in: int, hidden: int,
                 n_layers: int, n_classes: int):
        self.layout = stream_mlp_layout(d_in, hidden, n_layers, n_classes)
        self.num_params = sum(math.prod(s) for _, s in self.layout)
        if flat.shape != (self.num_params,):
            raise ValueError(f"flat of shape {tuple(flat.shape)}, want "
                             f"({self.num_params},)")
        self.flat = flat
        self.d_in, self.hidden = d_in, hidden
        self.n_layers, self.n_classes = n_layers, n_classes

    @classmethod
    def from_jax(cls, tree: Mapping) -> "StreamMLP":
        """The model of the JAX package's ``init_stream_mlp`` tree (numpy
        or JAX leaves), bit for bit."""
        n_layers, hidden = tuple(tree["blocks_b"].shape)
        d_in, n_classes = tree["inp"].shape[0], tree["out"].shape[1]
        layout = stream_mlp_layout(d_in, hidden, n_layers, n_classes)
        return cls(params_from_jax(tree, layout=layout), d_in, hidden,
                   n_layers, n_classes)


def init_stream_mlp(d_in: int, hidden: int, n_layers: int, n_classes: int,
                    scale: float = 0.3,
                    generator: Optional[torch.Generator] = None,
                    device="cpu") -> StreamMLP:
    """The JAX package's initialisation (zero biases, normal weights times
    ``scale / sqrt(fan_in)``), drawn from ``generator`` on the CPU and
    moved to ``device``."""
    h = hidden

    def normal(*shape, fan_in):
        return torch.randn(shape, generator=generator) \
            * (scale / math.sqrt(fan_in))

    leaves = [torch.zeros(n_layers, h),
              normal(n_layers, h, h, fan_in=h),
              normal(d_in, h, fan_in=d_in),
              normal(h, n_classes, fan_in=h)]
    flat = torch.cat([t.reshape(-1) for t in leaves]).to(device,
                                                          torch.float32)
    return StreamMLP(flat, d_in, hidden, n_layers, n_classes)


def _views(model: StreamMLP, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    out, pos = {}, 0
    for path, shape in model.layout:
        n = math.prod(shape)
        out[path] = flat[pos:pos + n].view(shape)
        pos += n
    return out


def _loss_from_logits(logits, target, mask):
    """Masked-mean NLL and accuracy of ``logits`` (B, C)."""
    m = mask.to(torch.float32)
    denom = torch.clamp(m.sum(), min=1.0)
    nll = -torch.log_softmax(logits, dim=1).gather(
        1, target[:, None])[:, 0]
    loss = (nll * m).sum() / denom
    acc = ((logits.argmax(dim=1) == target).to(torch.float32) * m).sum() \
        / denom
    return loss, acc


def make_stream_mlp_loss(model: StreamMLP):
    """``loss_fn(flat, batch, mask) -> (loss, (acc,))`` with ``batch =
    {"x": (B, d_in), "target": (B,)}``, carrying
    ``loss_fn.streaming_grad(flat, batch, mask, cs, table, scale=None)
    -> (table, loss, (acc,))``, where the table is ``table +
    cs.encode(scale * gradient)`` (up to float order: sketch linearity)
    and the gradient that of ``loss_fn`` in the flat layout. ``scale``
    multiplies the logits' cotangent, to which every parameter's
    gradient is linear."""
    L, H = model.n_layers, model.hidden
    C = model.n_classes
    off_b = 0
    off_w = off_b + L * H
    off_inp = off_w + L * H * H
    off_out = off_inp + model.d_in * H

    def forward(p, x):
        """Logits, each block's input, and the head's input."""
        h = x @ p["inp"]
        hs = []
        for layer in range(L):
            hs.append(h)
            h = torch.relu(h @ p["blocks_w"][layer] + p["blocks_b"][layer])
        return h @ p["out"], hs, h

    def loss_fn(flat, batch, mask):
        logits, _, _ = forward(_views(model, flat), batch["x"])
        loss, acc = _loss_from_logits(logits, batch["target"], mask)
        return loss, (acc,)

    @torch.no_grad()
    def streaming_grad(flat, batch, mask, cs, table, scale=None):
        p = _views(model, flat)
        x, target = batch["x"], batch["target"]
        logits, hs, h_last = forward(p, x)
        loss, acc = _loss_from_logits(logits, target, mask)
        # the masked-mean NLL's gradient in the logits, times scale
        m = mask.to(torch.float32)
        denom = torch.clamp(m.sum(), min=1.0)
        onehot = torch.nn.functional.one_hot(target, C).to(torch.float32)
        dlogits = (torch.softmax(logits, dim=1) - onehot) \
            * (m / denom)[:, None]
        if scale is not None:
            dlogits = dlogits * scale
        table = cs.encode_accum(table, (h_last.T @ dlogits).reshape(-1),
                                off_out)
        dh = dlogits @ p["out"].T
        del logits, h_last, dlogits
        for layer in range(L - 1, -1, -1):
            w = p["blocks_w"][layer]
            h_in = hs.pop()
            dz = dh * (h_in @ w + p["blocks_b"][layer] > 0)
            table = cs.encode_accum(table, (h_in.T @ dz).reshape(-1),
                                    off_w + layer * H * H)
            table = cs.encode_accum(table, dz.sum(dim=0),
                                    off_b + layer * H)
            dh = dz @ w.T
            del dz, h_in
        table = cs.encode_accum(table, (x.T @ dh).reshape(-1), off_inp)
        return table, loss, (acc,)

    loss_fn.streaming_grad = streaming_grad
    return loss_fn
