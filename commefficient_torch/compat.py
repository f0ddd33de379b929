"""The reference's user API over the port's ``FedRuntime``: ``FedModel``,
``FedOptimizer`` and ``split_by_client``, counterparts of the JAX
package's ``compat.py``.

    model = FedModel(torch_model, compute_loss_train, cfg, compute_loss_val)
    opt = model.attach_optimizer(FedOptimizer(cfg, lr=0.1))
    loss, acc, download, upload = model(batch)      # a train step
    opt.step()

``torch_model`` is a port model whose weights are one flat vector
(``models.get_model``); the losses follow ``losses.py``. The whole round
runs inside ``model(batch)`` at the optimizer's current rate (the
reference's scheduler sets it before the call), so ``opt.step()`` keeps
only the reference's shape. ``batch`` is the reference's wire format: a
dict of arrays over one flat item axis whose ``client_id`` gives each
item's client (-1 for validation items). The runtime lives on ``device``:
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from commefficient_torch.config import FedConfig
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.ops.pytree import layout_leaves, nest


def split_by_client(client_ids: np.ndarray, batch: Dict[str, np.ndarray],
                    num_workers: int, batch_size: int):
    """The reference's ``_call_train`` split: the flat batch grouped by
    client (the ``num_workers`` smallest ids, each its first
    ``batch_size`` items) into the static (num_workers, batch_size)
    layout. Returns ``(client ids, gathered batch, mask)``."""
    uniq = np.unique(client_ids)
    if len(uniq) < num_workers:
        raise ValueError(
            f"round has {len(uniq)} clients < num_workers={num_workers} "
            "(the reference driver skips such batches)")
    uniq = uniq[:num_workers]
    out_ids = np.zeros(num_workers, np.int64)
    masks = np.zeros((num_workers, batch_size), bool)
    gathered = {k: np.zeros((num_workers, batch_size) + v.shape[1:],
                            v.dtype) for k, v in batch.items()}
    for slot, c in enumerate(uniq):
        sel = np.where(client_ids == c)[0][:batch_size]
        out_ids[slot] = c
        masks[slot, :len(sel)] = True
        for k, v in batch.items():
            gathered[k][slot, :len(sel)] = v[sel]
    return out_ids, gathered, masks


class FedOptimizer:
    """The rate's owner, with the reference's shims (``step``,
    ``zero_grad``, ``get_lr``, and ``param_groups`` for schedulers that
    set ``param_groups[0]["lr"]``)."""

    def __init__(self, cfg: FedConfig, lr: float = 1.0):
        self.cfg = cfg
        self.param_groups = [{"lr": lr}]
        self._model: Optional[FedModel] = None

    def get_lr(self) -> float:
        return float(self.param_groups[0]["lr"])

    def set_lr(self, lr: float) -> None:
        self.param_groups[0]["lr"] = lr

    def step(self) -> None:
        """The server's update ran inside ``model(batch)``."""

    def zero_grad(self) -> None:
        pass


class FedModel:
    """A callable federated model over a ``FedRuntime`` on ``device``
    (the reference's ``fed_aggregator.py`` ``FedModel``)."""

    def __init__(self, module, loss_fn_train: Callable, cfg: FedConfig,
                 loss_fn_val: Optional[Callable] = None,
                 num_clients: Optional[int] = None, device="cuda"):
        if num_clients is not None:
            cfg = cfg.replace(num_clients=num_clients)
        self.module = module
        self.runtime = FedRuntime(cfg, module, loss_fn_train, device=device,
                                  loss_fn_val=loss_fn_val)
        self.cfg = self.runtime.cfg
        self.state = self.runtime.init_state()
        self.training = True
        self._opt: Optional[FedOptimizer] = None

    def attach_optimizer(self, opt: FedOptimizer) -> FedOptimizer:
        self._opt = opt
        opt._model = self
        return opt

    def train(self, mode: bool = True) -> None:
        self.training = mode

    def __call__(self, batch: Dict[str, np.ndarray]):
        """A train step (``(losses (W,), accuracies (W,), download bytes,
        upload bytes)``, a row per client) when training and every item
        has a client, else validation (``(loss (1,), acc (1,))``)."""
        client_ids = np.asarray(batch["client_id"])
        data = {k: np.asarray(v) for k, v in batch.items()
                if k != "client_id"}
        if self.training and (client_ids >= 0).all():
            return self._call_train(client_ids, data)
        return self._call_val(data)

    def _call_train(self, client_ids, data):
        lr = self._opt.get_lr() if self._opt is not None else 1.0
        ids, gathered, masks = split_by_client(
            client_ids, data, self.cfg.num_workers, self.runtime.batch_size)
        self.state, metrics = self.runtime.round(self.state, ids, gathered,
                                                 masks, lr)
        zeros = torch.zeros(self.runtime.num_clients)
        return (metrics["results"][0].cpu().numpy(),
                metrics["results"][1].cpu().numpy(),
                (metrics["download_bytes"] if self.cfg.track_bytes
                 else zeros).cpu().numpy(),
                (metrics["upload_bytes"] if self.cfg.track_bytes
                 else zeros).cpu().numpy())

    def _call_val(self, data):
        """Masked means over ``valid_batch_size`` chunks (the last padded
        and masked); the sums stay on the device and are read once."""
        n = len(next(iter(data.values())))
        vb = self.cfg.valid_batch_size
        sums = None
        for start in range(0, n, vb):
            idx = np.arange(start, min(start + vb, n))
            pad = vb - len(idx)
            chunk = {k: np.concatenate(
                [v[idx], np.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in data.items()}
            mask = np.concatenate([np.ones(len(idx), bool),
                                   np.zeros(pad, bool)])
            (loss, acc), n_valid = self.runtime.val(self.state, chunk, mask)
            contrib = torch.stack((loss * n_valid, acc * n_valid, n_valid))
            sums = contrib if sums is None else sums + contrib
        host = sums.cpu().numpy() if sums is not None else np.zeros(3)
        total = max(float(host[2]), 1.0)
        return (np.array([float(host[0]) / total]),
                np.array([float(host[1]) / total]))

    def finalize(self) -> None:
        """The reference joins its worker processes here."""

    def zero_grad(self) -> None:
        pass

    def get_params(self) -> Dict:
        """The current weights as the model's parameter tree (nested dicts
        keyed by the Flax path), views of one host copy."""
        return nest(layout_leaves(self.state.ps_weights.detach().cpu(),
                                  self.runtime.layout))

    def save_pretrained(self, path: str) -> None:
        """``<path>.npz`` with ``ps_weights``, the file ``--checkpoint``
        writes (and ``--finetune`` reads)."""
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 ps_weights=self.state.ps_weights.cpu().numpy())
