"""Loss functions of the port, counterparts of the JAX package's
``losses.py``: ``make_cv_loss`` (masked softmax cross-entropy and top-1
accuracy) and the GPT-2 DoubleHeads losses ``make_gpt2_train_loss`` and
``make_gpt2_val_loss``.

Every ``make_*`` function returns ``loss_fn(flat, batch, mask) ->
(loss, (acc,))``: ``flat`` the model's flat float32 weights, ``batch`` a
dict of tensors whose leading dimension is the item, ``mask`` (items,)
marking the valid ones; both outputs are masked means."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from commefficient_torch.data.fed_persona import LM_IGNORE

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_cv_loss(model, compute_dtype: str = "bfloat16") -> Callable:
    """``loss_fn(flat, batch, mask) -> (loss, (acc,))``.

    The weights ``flat`` and the images are cast to ``compute_dtype`` for
    the forward (bf16 by default, as in the reference); the logits come
    back to float32 for the loss. ``batch`` holds ``image`` (N, H, W, C)
    and ``target`` (N,) int64; ``mask`` (N,) marks the valid items, and
    both metrics are means over them."""
    dtype = COMPUTE_DTYPES[compute_dtype]

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


def _gpt2_losses(model, flat, batch, mask):
    """Shared DoubleHeads forward: ``(lm_nll_per_token, mc_loss, mc_acc)``.

    The LM loss is the shifted cross-entropy over the tokens whose label is
    not -100, in valid items only. The tied LM head projects only the
    shifted hidden states (``hidden[..., :-1, :]``): the same logits the
    JAX package slices from the full projection, without the last
    position's row."""
    hidden, wte, mc_logits = model.hidden_and_mc(
        batch["input_ids"], batch["mc_token_ids"], batch["token_type_ids"],
        flat)
    m = mask.to(torch.float32)                              # (B,)
    logits = hidden[..., :-1, :] @ wte.T                    # (B, C, S-1, V)
    labels = batch["lm_labels"][..., 1:]
    tok_valid = (labels != LM_IGNORE) * m[:, None, None]
    nll = F.cross_entropy(logits.flatten(0, -2),
                          labels.clamp(min=0).flatten(),
                          reduction="none").view(labels.shape)
    lm_loss = (nll * tok_valid).sum() / torch.clamp(tok_valid.sum(), min=1.0)
    return (lm_loss,) + _mc_metrics(mc_logits, batch["mc_label"], m)


def _mc_metrics(mc_logits, mc_label, m):
    """Masked multiple-choice cross-entropy and accuracy over the
    candidates: mc_logits (B, C), mc_label (B,), m (B,) float."""
    mc_nll = -F.log_softmax(mc_logits, dim=-1).gather(
        -1, mc_label[:, None])[:, 0]
    denom = torch.clamp(m.sum(), min=1.0)
    acc = ((mc_logits.argmax(dim=-1) == mc_label) * m).sum() / denom
    return (mc_nll * m).sum() / denom, acc


def make_gpt2_train_loss(model, lm_coef: float = 1.0,
                         mc_coef: float = 1.0) -> Callable:
    """DoubleHeads training loss ``lm_coef * lm + mc_coef * mc``; metrics
    (mc accuracy,). The model keeps its own dtype policy (models/gpt2.py),
    so the weights stay float32 here. ``batch`` holds ``input_ids``,
    ``token_type_ids``, ``lm_labels`` (B, C, S), ``mc_token_ids`` (B, C)
    and ``mc_label`` (B,), all int64."""

    def loss_fn(flat, batch, mask):
        lm_loss, mc_loss, acc = _gpt2_losses(model, flat, batch, mask)
        return lm_coef * lm_loss + mc_coef * mc_loss, (acc,)

    return loss_fn


def make_gpt2_val_loss(model) -> Callable:
    """Validation metrics: the per-token LM NLL (perplexity on the host)
    and the MC accuracy."""

    def loss_fn(flat, batch, mask):
        lm_loss, _, acc = _gpt2_losses(model, flat, batch, mask)
        return lm_loss, (acc,)

    return loss_fn
