"""FedState: the server state of a federated run, counterpart of
the JAX package's ``core/state.py``, for one device.

Byte accounting keeps, instead of past weight vectors, the round in
which each coordinate last changed (``coord_last_update``) and the round
of each client's last download (``client_last_round``): a client's
download is then 4 bytes x |{i : coord_last_update[i] >=
client_last_round[c]}|. ``nan_round`` is the first round whose update,
aggregate or client loss was not finite, or -1; it stays on the device,
and the driver reads it once an epoch.

The runtime services add three fields, with the JAX package's names and
shapes: ``async_buffer`` and ``async_buffer_n`` (``--async_agg``: the
merged cohorts' staleness-weighted sum, in the server state's shape,
and their raw datum count) and ``defense_ref`` (``--defense normclip``:
the ring of the last ``defense_window`` rounds' median per-datum norms,
NaN until written).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class FedState:
    ps_weights: torch.Tensor   # (d,) float32
    Vvelocity: torch.Tensor    # (r, c) table, or (d,) in the dense modes
                               # and under the dense sketch server state
    Verror: torch.Tensor       # same shape as Vvelocity
    step: int = 0              # rounds taken
    # per-client rows, allocated only for the modes that need them
    client_velocities: Optional[torch.Tensor] = None  # (num_clients, d)
    client_errors: Optional[torch.Tensor] = None      # (num_clients, d)
    # --topk_down: the weights each client last downloaded
    client_weights: Optional[torch.Tensor] = None     # (num_clients, d)
    # byte accounting (None under --no_track_bytes)
    coord_last_update: Optional[torch.Tensor] = None  # (d,) int32, init -1
    client_last_round: Optional[torch.Tensor] = None  # (num_clients,) int32
    nan_round: Optional[torch.Tensor] = None          # () int32, init -1
    # --async_agg: the buffer of merged cohorts (the server state's shape)
    async_buffer: Optional[torch.Tensor] = None
    async_buffer_n: Optional[torch.Tensor] = None     # () float32
    # --defense normclip: the rolling reference, (defense_window,) NaN
    defense_ref: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "FedState":
        return dataclasses.replace(self, **kw)
