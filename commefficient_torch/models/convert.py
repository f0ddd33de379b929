"""Weight carry-over from the JAX package.

``params_from_jax`` takes a Flax parameter tree whose leaves are numpy
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) and returns
the flat float32 vector in ``ravel_pytree`` order (``ops/pytree.py``):
the layout of the port's models (models/resnet9.py, and models/gpt2.py
with its layer-stacked ``h/block`` leaves), so the same vector drives
both packages. Given the model (or a ``layout``: a finetune's trainable
``TrainableView.layout`` or frozen ``FrozenBackbone.layout_frozen``), it
checks every leaf's path and shape against it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from commefficient_torch.ops.pytree import ravel_params, tree_leaves


def params_from_jax(tree: Mapping, model=None, layout=None) -> torch.Tensor:
    if model is not None:
        layout = model.layout
    if layout is not None:
        want = [(p, tuple(s)) for p, s in layout]
        got = [(p, np.shape(a)) for p, a in tree_leaves(tree)]
        if want != got:
            raise ValueError(f"parameter tree does not match the "
                             f"layout:\n want {want}\n got  {got}")
    return ravel_params(tree)[0]
