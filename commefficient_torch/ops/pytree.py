"""Flatten a parameter tree to the one float32 vector the port runs on,
and back: the JAX package's ``ops/pytree.py`` (``ravel_params``,
``make_unraveler``) for nested mappings of tensors.

The order is ``ravel_pytree``'s: keys sorted at every level, depth first,
each leaf row-major. It is the layout of the port's models
(``models/layers.py ravel_layout``) and of the weight converter
(``models/convert.py``), so one flat vector means the same weights in
both packages.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch


def tree_leaves(tree: Mapping, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf of the nested mapping ``tree`` in
    ravel order; a path joins the keys with ``/``."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        val = tree[key]
        if isinstance(val, Mapping):
            out.extend(tree_leaves(val, path))
        else:
            out.append((path, val))
    return out


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(torch.float32)
    return torch.from_numpy(np.array(leaf, dtype=np.float32))


def make_unraveler(tree: Mapping) -> Tuple[int, Callable]:
    """``(number of parameters, unravel)`` of a tree."""
    spec = [(path, tuple(np.shape(leaf))) for path, leaf in tree_leaves(tree)]
    sizes = [math.prod(shape) for _, shape in spec]

    def unravel(flat: torch.Tensor) -> Dict:
        """The tree of ``flat``'s pieces, as views where ``flat`` allows."""
        out: Dict = {}
        for (path, shape), piece in zip(spec, torch.split(flat, sizes)):
            *parents, name = path.split("/")
            node = out
            for key in parents:
                node = node.setdefault(key, {})
            node[name] = piece.view(shape)
        return out

    return sum(sizes), unravel


def ravel_params(tree: Mapping) -> Tuple[torch.Tensor, Callable]:
    """``(flat float32 vector, unravel)`` of a tree whose leaves are
    tensors or arrays."""
    leaves = [_as_tensor(leaf).reshape(-1) for _, leaf in tree_leaves(tree)]
    return torch.cat(leaves), make_unraveler(tree)[1]


def layout_leaves(flat: torch.Tensor,
                  layout: Sequence[Tuple[str, Tuple]]) -> Dict[str,
                                                               torch.Tensor]:
    """``{path: view}`` of ``flat``'s pieces in a model's ``(path,
    shape)`` layout (ravel order); ``flat`` must hold exactly its
    floats."""
    sizes = [math.prod(shape) for _, shape in layout]
    if flat.numel() != sum(sizes):
        raise ValueError(f"a vector of {flat.numel()} floats for a layout "
                         f"of {sum(sizes)}")
    return {path: piece.view(shape) for (path, shape), piece
            in zip(layout, torch.split(flat, sizes))}


def nest(leaves: Mapping[str, Any]) -> Dict:
    """The nested tree of ``{path: leaf}`` (paths joined by ``/``)."""
    out: Dict = {}
    for path, leaf in leaves.items():
        *parents, name = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return out
