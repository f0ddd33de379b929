"""The fused client step, counterpart of the JAX package's ``core/client.py
make_fused_grad`` with ``fused_encode=True``.

The server consumes ``sum_c n_c g_c``: each client's gradient plus the
weight-decay term, weighted by its datum count n_c. That sum is linear, so
one loop over the round's clients (each client's batch is one microbatch,
the reference's default) streams each flat gradient into ONE (r, c) sketch
table, scaled by n_c on the way in (one K1 launch each); the dense round
gradient never exists. Weight decay enters the same table by linearity.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from commefficient_torch.config import FedConfig


def make_fused_grad(cfg: FedConfig, loss_fn: Callable):
    """Returns ``fused(params_vec, batch, mask, cs) -> (table, results,
    n_per_client)``. ``batch`` leaves are (W, B, ...) tensors, ``mask`` a
    (W, B) bool tensor; ``results`` is a tuple (loss, acc) of (W,)
    per-client means over the valid items."""

    def fused(params_vec: torch.Tensor, batch: Dict[str, torch.Tensor],
              mask: torch.Tensor, cs) -> Tuple[torch.Tensor, Tuple,
                                               torch.Tensor]:
        W = mask.shape[0]
        maskf = mask.to(torch.float32)
        n_per_client = maskf.sum(dim=1)
        # the per-microbatch scales go to the kernel as host floats: one
        # copy of the (W, B) mask per round instead of a sync per launch
        n_host = mask.detach().cpu().numpy().sum(axis=1).astype(np.float32)
        table = cs.empty_table()
        sums = torch.zeros((2, W), dtype=torch.float32,
                           device=params_vec.device)
        for c in range(W):
            w = params_vec.detach().requires_grad_(True)
            loss, (acc,) = loss_fn(w, {k: v[c] for k, v in batch.items()},
                                   mask[c])
            (g,) = torch.autograd.grad(loss, w)
            table = cs.encode_accum(table, g, 0, scale=float(n_host[c]))
            with torch.no_grad():
                sums[:, c] = torch.stack((loss.detach(), acc)) \
                    * n_per_client[c]
        # decoupled weight decay summed over the round's clients
        # (wd / num_workers) * sum_c n_c, encoded by linearity
        if cfg.weight_decay != 0:
            wd_scale = float(np.float32(cfg.weight_decay / cfg.num_workers)
                             * n_host.sum(dtype=np.float32))
            table = cs.encode_accum(table, params_vec, 0, scale=wd_scale)
        denom = torch.clamp(n_per_client, min=1.0)
        return table, (sums[0] / denom, sums[1] / denom), n_per_client

    return fused


def make_val_step(loss_fn: Callable):
    """Masked evaluation: ``val(params_vec, batch, mask) -> ((loss, acc),
    n_valid)``."""

    @torch.no_grad()
    def val(params_vec, batch, mask):
        loss, (acc,) = loss_fn(params_vec, batch, mask)
        return (loss, acc), mask.to(torch.float32).sum()

    return val
