"""Learning-rate schedules, counterparts of the JAX package's
``utils/schedules.py`` and of its ``gpt2_train.py make_gpt2_schedule``:
callables ``epoch -> lr`` that the training loop evaluates once per
round."""

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


def make_gpt2_schedule(cfg) -> PiecewiseLinear:
    """The GPT-2 schedule: linear from lr_scale (default 0.16) at epoch 0
    to 0 at num_epochs; with ``--lr_warmup``, a linear 0 -> lr_scale ramp
    peaking at pivot_epoch first (JAX gpt2_train.py:66-80)."""
    lr0 = cfg.lr_scale if cfg.lr_scale is not None else 0.16
    if cfg.lr_warmup:
        pivot = min(float(cfg.pivot_epoch), float(cfg.num_epochs))
        return PiecewiseLinear([0.0, pivot, float(cfg.num_epochs)],
                               [0.0, lr0, 0.0])
    return PiecewiseLinear([0.0, float(cfg.num_epochs)], [lr0, 0.0])
