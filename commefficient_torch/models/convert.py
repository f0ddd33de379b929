"""Weight carry-over from the JAX package.

``params_from_jax`` takes a Flax parameter tree whose leaves are numpy
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) and returns
the flat float32 vector in ``ravel_pytree`` order: the layout of the port's
models (models/resnet9.py), so the same vector drives both packages.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping, model=None) -> torch.Tensor:
    leaves = []

    def walk(node, path):
        if isinstance(node, Mapping):
            for key in sorted(node):
                walk(node[key], f"{path}/{key}" if path else key)
        else:
            leaves.append((path, np.asarray(node, dtype=np.float32)))

    walk(tree, "")
    if model is not None:
        want = [(p, tuple(s)) for p, s in model.layout]
        got = [(p, a.shape) for p, a in leaves]
        if want != got:
            raise ValueError(f"parameter tree does not match the model's "
                             f"layout:\n want {want}\n got  {got}")
    return torch.from_numpy(np.concatenate([a.reshape(-1)
                                            for _, a in leaves]))
