"""FedState: the server state of a federated run, counterpart of
the JAX package's ``core/state.py``, cut to the port's slice (one device,
sketch mode, no byte accounting or telemetry)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class FedState:
    ps_weights: torch.Tensor   # (d,) float32
    Vvelocity: torch.Tensor    # (r, c) virtual momentum table
    Verror: torch.Tensor       # (r, c) virtual error table
    step: int = 0              # rounds taken
