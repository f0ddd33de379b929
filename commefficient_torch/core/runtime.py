"""FedRuntime on one device, counterpart of the JAX package's
``core/runtime.py FedRuntime`` (its ``_round_step``) without a mesh,
telemetry or the robustness subsystem.

A round:

1. download accounting, before the update: each participant's count of
   coordinates changed since its last download;
2. the clients: the fused sketch step (sketch mode with the fused encode,
   the default) streams every microbatch gradient into the round's
   table; every other mode, and ``--sketch_fused_encode off``, runs the
   client step once a client (local momentum, local error, the local
   top-k, or FedAvg's local SGD) and sums the dense transmits, which the
   sketch mode then encodes once;
3. the aggregate is divided by the round's datum count and
   ``server_update`` runs the mode's rule;
4. the weights move by the update, the participants' rows are written
   back, ``coord_last_update`` records the changed coordinates, and
   ``nan_round`` the first round whose update, aggregate or client loss
   was not finite.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from commefficient_torch.config import FedConfig, auto_num_cols
from commefficient_torch.core import client as client_lib
from commefficient_torch.core.server import (server_update,
                                             validate_mode_combo,
                                             validate_regimes)
from commefficient_torch.core.state import FedState
from commefficient_torch.ops.circulant import make_circulant_sketch


def download_coord_counts(coord_last_update: torch.Tensor,
                          thresholds: torch.Tensor) -> torch.Tensor:
    """``counts[w] = |{i : coord_last_update[i] >= thresholds[w]}|``: one
    compare-and-count pass over d a participant, summed in int32 over a
    uint8 view of the comparison (the fastest plain form measured on the
    card), with no atomics and no host read. A histogram of
    ``coord_last_update`` would take one pass, but it piles most
    coordinates into one bin (-1, never updated, in a sparse run; the
    last round in a dense one), and its atomic adds on that bin
    serialise."""
    return torch.stack([
        (coord_last_update >= t).view(torch.uint8).sum(dtype=torch.int32)
        for t in thresholds]).to(torch.int64)


class FedRuntime:
    """``model`` is a port model whose parameters are one flat vector
    (``model.flat``, the initial weights; ``model.num_params``);
    ``loss_fn(flat, batch, mask)`` follows the contract of losses.py, and
    ``loss_fn_val`` (default ``loss_fn``) is the one ``val`` runs. The
    per-client state has ``cfg.default_num_clients()`` rows. ``device``
    defaults to the card."""

    def __init__(self, cfg: FedConfig, model, loss_fn: Callable,
                 device="cuda", loss_fn_val: Optional[Callable] = None):
        self.device = torch.device(device)
        d = int(model.num_params)
        cfg = cfg.replace(grad_size=d)
        if cfg.mode == "sketch" and not cfg.exact_num_cols:
            c = auto_num_cols(cfg.num_cols)
            if c != cfg.num_cols:
                print(f"auto-sized sketch num_cols {cfg.num_cols} -> {c} "
                      "(1024-aligned, as the JAX package sizes it; "
                      "--exact_num_cols pins the original)")
                cfg = cfg.replace(num_cols=c)
        validate_mode_combo(cfg)
        validate_regimes(cfg)
        self.cfg = cfg
        self.num_clients = cfg.default_num_clients()
        self.batch_size = (cfg.local_batch_size if cfg.local_batch_size > 0
                           else cfg.max_client_batch)
        self.initial_weights = model.flat.detach().to(self.device,
                                                      torch.float32)
        # (path, shape) of the flat parameters, for checkpoint fingerprints
        self.layout = getattr(model, "layout", None)
        self.cs = None
        if cfg.mode == "sketch":
            self.cs = make_circulant_sketch(d, cfg.num_cols, cfg.num_rows,
                                            seed=cfg.sketch_seed,
                                            device=self.device)
        self._upload_bytes = cfg.upload_wire_bytes()
        self._fused_fn = self._client_fn = None
        if cfg.mode == "fedavg":
            self._client_fn = client_lib.make_fedavg_client(
                cfg, loss_fn, self.batch_size)
        elif cfg.mode == "sketch" and cfg.sketch_fused_encode != "off":
            self._fused_fn = client_lib.make_fused_grad(cfg, loss_fn,
                                                        self.batch_size)
        else:
            self._client_fn = client_lib.make_client_step(cfg, loss_fn,
                                                          self.batch_size)
        self._val_fn = client_lib.make_val_step(loss_fn_val or loss_fn)

    def state_shapes(self) -> Dict[str, Optional[Tuple[int, ...]]]:
        """The shape of each ``FedState`` field this run holds (None: a
        field it does not hold)."""
        cfg = self.cfg
        d, n = cfg.grad_size, self.num_clients
        server = self.cs.table_shape if cfg.mode == "sketch" else (d,)
        track = cfg.track_bytes
        return {"ps_weights": (d,), "Vvelocity": server, "Verror": server,
                "step": (),
                "client_velocities": ((n, d) if cfg.needs_client_velocities
                                      else None),
                "client_errors": (n, d) if cfg.needs_client_errors else None,
                "coord_last_update": (d,) if track else None,
                "client_last_round": (n,) if track else None,
                "nan_round": ()}

    def init_state(self) -> FedState:
        dev, shapes = self.device, self.state_shapes()

        def zeros(name: str, fill: float = 0.0, dtype=torch.float32):
            shape = shapes[name]
            return (torch.full(shape, fill, dtype=dtype, device=dev)
                    if shape is not None else None)

        return FedState(
            ps_weights=self.initial_weights.clone(),
            Vvelocity=zeros("Vvelocity"), Verror=zeros("Verror"), step=0,
            client_velocities=zeros("client_velocities"),
            client_errors=zeros("client_errors"),
            coord_last_update=zeros("coord_last_update", -1, torch.int32),
            client_last_round=zeros("client_last_round", 0, torch.int32),
            nan_round=zeros("nan_round", -1, torch.int32))

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Every leaf onto the device: floating leaves as float32, integer
        leaves (labels, token ids, positions) as int64."""
        out = {}
        for key, val in batch.items():
            val = torch.as_tensor(val)
            dtype = (torch.float32 if val.is_floating_point()
                     else torch.int64)
            out[key] = val.to(self.device, dtype)
        return out

    def _clients(self, state: FedState, ids: torch.Tensor, batch, mask,
                 mask_host: np.ndarray, lr: torch.Tensor):
        """The round's client work: ``(aggregate, results (W, 2), n_valid
        (W,), new velocity rows or None, new error rows or None)``. The
        aggregate is the sketch table in sketch mode, else a (d,) vector,
        not yet divided by the round's datum count."""
        cfg, w = self.cfg, state.ps_weights
        if self._fused_fn is not None:
            table, results, n_valid = self._fused_fn(w, batch, mask,
                                                     mask_host, self.cs)
            return table, results, n_valid, None, None
        vel_rows = (state.client_velocities[ids]
                    if state.client_velocities is not None else None)
        err_rows = (state.client_errors[ids]
                    if state.client_errors is not None else None)
        agg, results, n_valid, vels, errs = None, [], [], [], []
        for c in range(mask.shape[0]):
            cb = {k: v[c] for k, v in batch.items()}
            if cfg.mode == "fedavg":
                out = self._client_fn(w, cb, mask[c], mask_host[c], lr)
            else:
                out = self._client_fn(
                    w, cb, mask[c],
                    None if vel_rows is None else vel_rows[c],
                    None if err_rows is None else err_rows[c])
            agg = out.transmit if agg is None else agg + out.transmit
            results.append(out.results)
            n_valid.append(out.n_valid)
            vels.append(out.velocity)
            errs.append(out.error)
        if cfg.mode == "sketch":
            # sum of the clients' sketches == sketch of the sum: one encode
            agg = self.cs.encode(agg)
        return (agg, torch.stack(results), torch.stack(n_valid),
                None if vel_rows is None else torch.stack(vels),
                None if err_rows is None else torch.stack(errs))

    def round(self, state: FedState, client_ids, batch, mask, lr
              ) -> Tuple[FedState, Dict]:
        """One federated round. ``client_ids`` (W,) names the round's
        clients, ``batch`` leaves are (W, B, ...), ``mask`` is (W, B) and
        ``lr`` a scalar; numpy arrays or tensors. The participants' rows of
        ``state.client_velocities`` and ``state.client_errors`` are written
        in place (the JAX package donates the state likewise); the rest of
        the new state is new tensors."""
        cfg, dev, step = self.cfg, self.device, state.step
        mask_host = np.asarray(torch.as_tensor(mask).cpu(), dtype=bool)
        mask = torch.as_tensor(mask_host, device=dev)
        ids = torch.as_tensor(np.asarray(client_ids), dtype=torch.int64,
                              device=dev)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        step_t = torch.tensor(step, dtype=torch.int32, device=dev)
        W = mask.shape[0]

        # download accounting, before this round's update
        download_bytes = upload_bytes = None
        client_last_round = state.client_last_round
        if cfg.track_bytes:
            counts = download_coord_counts(state.coord_last_update,
                                           state.client_last_round[ids])
            download_bytes = torch.zeros(
                self.num_clients, dtype=torch.float32,
                device=dev).index_put_((ids,), 4.0 * counts.float())
            upload_bytes = torch.zeros(
                self.num_clients, dtype=torch.float32,
                device=dev).index_put_(
                    (ids,), torch.full((W,), self._upload_bytes,
                                       dtype=torch.float32, device=dev))
            client_last_round = state.client_last_round.index_put(
                (ids,), step_t)

        agg, results, n_valid, vel_new, err_new = self._clients(
            state, ids, self.to_device(batch), mask, mask_host, lr)
        agg = agg / torch.clamp(n_valid.sum(), min=1.0)
        update, Vvel, Verr, sup_mask = server_update(
            cfg, agg, state.Vvelocity, state.Verror, lr, self.cs)

        if vel_new is not None:
            if cfg.mode == "true_topk":
                # momentum factor masking of the participants' rows
                vel_new = vel_new.masked_fill(sup_mask[None, :], 0.0)
            state.client_velocities.index_copy_(0, ids, vel_new)
        if err_new is not None:
            state.client_errors.index_copy_(0, ids, err_new)
        coord_last_update = state.coord_last_update
        if cfg.track_bytes:
            coord_last_update = torch.where(update != 0, step_t,
                                            coord_last_update)
        bad = (~torch.isfinite(update).all() | ~torch.isfinite(agg).all()
               | ~torch.isfinite(results[:, 0]).all())
        nan_round = torch.where((state.nan_round < 0) & bad, step_t,
                                state.nan_round)
        new_state = FedState(
            ps_weights=state.ps_weights - update, Vvelocity=Vvel,
            Verror=Verr, step=step + 1,
            client_velocities=state.client_velocities,
            client_errors=state.client_errors,
            coord_last_update=coord_last_update,
            client_last_round=client_last_round, nan_round=nan_round)
        return new_state, {"results": (results[:, 0], results[:, 1]),
                           "n_valid": n_valid,
                           "download_bytes": download_bytes,
                           "upload_bytes": upload_bytes}

    def val(self, state: FedState, batch, mask):
        """Masked evaluation on the current weights: ``((loss, acc),
        n_valid)``."""
        return self._val_fn(state.ps_weights, self.to_device(batch),
                            torch.as_tensor(mask, device=self.device,
                                            dtype=torch.bool))
