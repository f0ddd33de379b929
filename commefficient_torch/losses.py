"""Masked softmax cross-entropy and top-1 accuracy, counterpart of
the JAX package's ``losses.py make_cv_loss``."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_cv_loss(model, compute_dtype: str = "bfloat16") -> Callable:
    """``loss_fn(flat, batch, mask) -> (loss, (acc,))``.

    The weights ``flat`` and the images are cast to ``compute_dtype`` for
    the forward (bf16 by default, as in the reference); the logits come
    back to float32 for the loss. ``batch`` holds ``image`` (N, H, W, C)
    and ``target`` (N,) int64; ``mask`` (N,) marks the valid items, and
    both metrics are means over them."""
    dtype = _DTYPES[compute_dtype]

    def loss_fn(flat: torch.Tensor, batch: Dict[str, torch.Tensor],
                mask: torch.Tensor) -> Tuple[torch.Tensor, Tuple]:
        logits = model(batch["image"], flat, dtype=dtype).to(torch.float32)
        labels = batch["target"]
        logp = F.log_softmax(logits, dim=1)
        ce = -logp.gather(1, labels[:, None])[:, 0]
        m = mask.to(torch.float32)
        denom = torch.clamp(m.sum(), min=1.0)
        loss = (ce * m).sum() / denom
        acc = ((logits.argmax(dim=1) == labels) * m).sum() / denom
        return loss, (acc,)

    return loss_fn
