"""Learning-rate schedule, counterpart of
the JAX package's ``utils/schedules.py``: a callable ``epoch -> lr``
that the training loop evaluates once per round."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PiecewiseLinear:
    """Linear interpolation through (knot, value) pairs; clamps outside."""

    knots: Sequence[float]
    vals: Sequence[float]

    def __call__(self, t: float) -> float:
        return float(np.interp(t, self.knots, self.vals))


def lr_schedule_for(cfg) -> PiecewiseLinear:
    """The triangular CV schedule: 0 -> lr_scale at pivot_epoch -> 0 at
    num_epochs (reference cv_train.py:393-404)."""
    lr = cfg.lr_scale if cfg.lr_scale is not None else 0.4
    return PiecewiseLinear([0.0, cfg.pivot_epoch, float(cfg.num_epochs)],
                           [0.0, lr, 0.0])
