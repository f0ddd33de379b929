"""Console and TSV loggers, a wall-clock timer and run-directory naming,
counterparts of the JAX package's ``utils/logging.py`` (reference
CommEfficient/utils.py:14-99): the table logger fixes its columns at the
first row and prints fixed-width rows; the TSV logger records
``epoch,hours,top1Accuracy``; ``make_logdir`` encodes the run's config
into a timestamped name under ``runs/`` (it creates nothing)."""

from __future__ import annotations

import os
import time
from datetime import datetime
from typing import Dict, List, Optional


class TableLogger:
    """Fixed-width console table; columns fixed by the first row."""

    def __init__(self):
        self.keys: Optional[List[str]] = None

    def append(self, output: Dict):
        if self.keys is None:
            self.keys = list(output.keys())
            print(*(f"{k:>12s}" for k in self.keys))
        row = []
        for k in self.keys:
            v = output[k]
            if isinstance(v, float):
                row.append(f"{v:12.4f}")
            else:
                row.append(f"{v!s:>12}")
        print(*row, flush=True)


class TSVLogger:
    """Time-to-accuracy record: ``epoch,hours,top1Accuracy`` lines."""

    def __init__(self):
        self.log = ["epoch,hours,top1Accuracy"]

    def append(self, output: Dict):
        self.log.append("{},{:.8f},{:.2f}".format(
            output["epoch"], output["total_time"] / 3600,
            output["test_acc"] * 100))

    def __str__(self):
        return "\n".join(self.log)


class Timer:
    """Split timer: each call returns the time since the previous call
    and, unless told otherwise, adds it to ``total_time``."""

    def __init__(self):
        self.times = [time.time()]
        self.total_time = 0.0

    def __call__(self, include_in_total: bool = True) -> float:
        self.times.append(time.time())
        delta = self.times[-1] - self.times[-2]
        if include_in_total:
            self.total_time += delta
        return delta


def make_logdir(cfg) -> str:
    """``runs/<timestamp>_<workers>/<clients>_<mode[: r x c]>_[k: k]``, the
    reference's naming scheme (utils.py:51-64)."""
    if cfg.mode == "sketch":
        sketch_str = f"{cfg.mode}: {cfg.num_rows} x {cfg.num_cols}"
    else:
        sketch_str = cfg.mode
    k_str = f"k: {cfg.k}" if cfg.mode in ("sketch", "true_topk",
                                          "local_topk") else ""
    clients = cfg.num_clients if cfg.num_clients is not None else "auto"
    stamp = datetime.now().strftime("%b%d_%H-%M-%S")
    return os.path.join(
        "runs", f"{stamp}_{cfg.num_workers}/{clients}_{sketch_str}_{k_str}")
