"""The FetchSGD server update, counterpart of the sketch branch of
the JAX package's ``core/server.py server_update`` (table-space state, the
reference's zero error-feedback rule)."""

from __future__ import annotations

from typing import Tuple

import torch

from commefficient_torch.config import FedConfig


def server_update(cfg: FedConfig, gradient: torch.Tensor,
                  Vvelocity: torch.Tensor, Verror: torch.Tensor, lr,
                  cs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """One sketch-mode server step on the round's averaged table.

    Momentum and error accumulate in (r, c) table space; the update is the
    top-k of the decoded error table; the cells the k-sparse update
    occupies are zeroed in both tables (error feedback and momentum factor
    masking, reference fed_aggregator.py:568-613). Returns
    ``(weight_update, Vvelocity', Verror', zeroed_cells)`` with the update
    already multiplied by ``lr``."""
    if cfg.mode != "sketch" or cfg.sketch_ef != "zero":
        raise ValueError("the port's server runs sketch mode with the zero "
                         "error-feedback rule only")
    Vvel = gradient + cfg.virtual_momentum * Vvelocity
    Verr = Verror + Vvel
    update, upd_idx = cs.unsketch_with_idx(Verr, k=cfg.k,
                                           approx=cfg.approx_topk)
    # the cells the update occupies: its sparse re-encode, O(k r)
    cells = cs.encode_at(update, upd_idx) != 0
    Vvel = Vvel.masked_fill(cells, 0.0)
    Verr = Verr.masked_fill(cells, 0.0)
    if cfg.error_decay < 1.0:
        Verr = cfg.error_decay * Verr
    return update * lr, Vvel, Verr, cells
