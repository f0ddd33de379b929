"""Extract the per-epoch eval TSV from a ``gpt2_train`` log: the PyTorch
port's copy of the JAX package's ``scripts/gpt2log2tsv.py``.

One shared parser (used by ``curves``) so the TableLogger row format —
10 columns: epoch lr train_time train_loss train_acc test_loss test_acc down up
total_time — is pinned in exactly one place.

Usage: python -m commefficient_torch.scripts.gpt2log2tsv <run.log> <out.tsv>
"""

from __future__ import annotations

import math
import re
import sys


def main(log_path: str, tsv_path: str) -> None:
    rows = ["epoch\thours\ttest_nll\tppl\tmc_acc"]
    for line in open(log_path):
        f = line.split()
        if len(f) == 10 and re.fullmatch(r"\d+", f[0]):
            ep, nll, acc, total = (int(f[0]), float(f[5]), float(f[6]),
                                   float(f[9]))
            rows.append(f"{ep}\t{total/3600:.8f}\t{nll:.4f}"
                        f"\t{math.exp(min(nll, 20)):.2f}\t{acc:.4f}")
    with open(tsv_path, "w") as out:
        out.write("\n".join(rows) + "\n")
    print("wrote", tsv_path)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
