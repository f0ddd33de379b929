"""FedRuntime on one device, counterpart of
the JAX package's ``core/runtime.py FedRuntime`` cut to the port's slice.

A round follows the reference's ``_round_step`` for the fused-clients,
fused-encode sketch round: the fused client step streams every
microbatch gradient into the round's (r, c) table, the table is divided by
the round's datum count, ``server_update`` runs momentum, error feedback
and the top-k, and the weights move by the update. No mesh, no byte
accounting, no telemetry.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from commefficient_torch.config import FedConfig, auto_num_cols
from commefficient_torch.core.client import make_fused_grad, make_val_step
from commefficient_torch.core.server import server_update
from commefficient_torch.core.state import FedState
from commefficient_torch.ops.circulant import make_circulant_sketch


def _to(x, device, dtype):
    return torch.as_tensor(x, device=device, dtype=dtype)


class FedRuntime:
    """``model`` is a port model whose parameters are one flat vector
    (``model.flat``, the initial weights); ``loss_fn(flat, batch, mask)``
    follows losses.make_cv_loss. ``device`` defaults to the card."""

    def __init__(self, cfg: FedConfig, model, loss_fn: Callable,
                 device="cuda"):
        self.device = torch.device(device)
        d = int(model.num_params)
        cfg = cfg.replace(grad_size=d)
        if not cfg.exact_num_cols:
            c = auto_num_cols(cfg.num_cols)
            if c != cfg.num_cols:
                print(f"auto-sized sketch num_cols {cfg.num_cols} -> {c} "
                      "(1024-aligned, as the JAX package sizes it; "
                      "--exact_num_cols pins the original)")
                cfg = cfg.replace(num_cols=c)
        self.cfg = cfg
        self.initial_weights = model.flat.detach().to(self.device,
                                                      torch.float32)
        self.cs = make_circulant_sketch(d, cfg.num_cols, cfg.num_rows,
                                        seed=cfg.sketch_seed,
                                        device=self.device)
        self._fused_fn = make_fused_grad(cfg, loss_fn)
        self._val_fn = make_val_step(loss_fn)

    def init_state(self) -> FedState:
        return FedState(ps_weights=self.initial_weights.clone(),
                        Vvelocity=self.cs.empty_table(),
                        Verror=self.cs.empty_table(), step=0)

    def _batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {"image": _to(batch["image"], self.device, torch.float32),
                "target": _to(batch["target"], self.device, torch.int64)}

    def round(self, state: FedState, client_ids, batch, mask, lr
              ) -> Tuple[FedState, Dict]:
        """One federated round. ``batch`` leaves are (num_workers,
        batch_size, ...), ``mask`` is (num_workers, batch_size) and ``lr`` a
        scalar; numpy arrays or tensors. ``client_ids`` only names the
        round's clients: the slice keeps no per-client state."""
        del client_ids
        mask = _to(mask, self.device, torch.bool)
        agg, results, n_valid = self._fused_fn(
            state.ps_weights, self._batch(batch), mask, self.cs)
        agg /= torch.clamp(n_valid.sum(), min=1.0)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=self.device)
        update, Vvel, Verr, _ = server_update(
            self.cfg, agg, state.Vvelocity, state.Verror, lr, self.cs)
        new_state = FedState(ps_weights=state.ps_weights - update,
                             Vvelocity=Vvel, Verror=Verr,
                             step=state.step + 1)
        return new_state, {"results": results, "n_valid": n_valid}

    def val(self, state: FedState, batch, mask):
        """Masked evaluation on the current weights: ``((loss, acc),
        n_valid)``."""
        return self._val_fn(state.ps_weights, self._batch(batch),
                            _to(mask, self.device, torch.bool))
