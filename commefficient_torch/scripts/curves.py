"""The study recipes whose learning curves the JAX package committed on
the TPU, run by the port, and ``curve_band``, which holds the port's
curves epoch by epoch to the TPU's.

    python -m commefficient_torch.scripts.curves run --arms ARM[,ARM...]
        [--seeds 21,22,23] [--out curves_out] [--device cuda|cpu]
        [--epochs N]
    python -m commefficient_torch.scripts.curves band [--arms ...]
        [--seeds 21,22,23] [--out curves_out]

``ARMS`` is the table of arms: each one's entry point, its flags (taken
from the reference's records: the hard-v2 recipe of ``runs/README.md``
and the first line of each ``runs/cifar10_hard*v2_*.log`` for CIFAR10,
``scripts/gpt2_convergence.sh``, the result table of
``runs/gpt2_conv/README.md`` and the EF study ``scripts/gpt2_ef_study.sh``
for GPT-2), its epochs, and the TPU's TSV and log. ``run`` calls
``cv_train.main`` or ``gpt2_train.main`` in this process once for each
arm and seed and writes, under ``--out``:

- ``<arm>_s<seed>.tsv``: CIFAR10's ``epoch,hours,top1Accuracy``
  (``utils/logging.py TSVLogger``) or GPT-2's tab-separated ``epoch hours
  test_nll ppl mc_acc`` (parsed from the run's log by ``gpt2log2tsv``);
- ``<arm>_s<seed>.log``: the run's standard output;
- ``<arm>_s<seed>.json``: each epoch's row (download and upload MiB
  included), the run's rounds, round-time median, K1/K2/K3 launches
  and wall seconds.

GPT-2's corpus is written once under ``--out`` by ``make_persona_corpus``
(the JAX script's bytes), the CIFAR10 hard-v2 set once by the entry
point. ``--epochs N`` runs each arm's first N epochs at its full
schedule (the runs stop after those epochs' rounds), for a smoke.

``band`` writes each arm's per-epoch verdict against its TPU curve to
``<arm>_band.txt`` under ``--out`` and prints its first two lines (the
second: the last epoch's port range beside the TPU's value, the runs'
wall seconds, round medians and kernel launches a round), with the
arm's ``BAND``: the port's [min, max] over its seeds, widened by 2
points of top-1 (CIFAR10) or by 0.05 NLL and 0.03 MC accuracy (GPT-2),
and checks each epoch's upload MiB at the TPU's seed against the TPU
log's (each epoch's rounds are the sampler's draws). An arm whose TPU
run aborted (the driver's ``TRAINING DIVERGED`` line in its log, a TSV
with no row past it) is held to that outcome instead
(``abort_verdict``): each port run must abort at the end of the same
epoch, with no epoch row of it; its second line puts each run's first
non-finite round beside the TPU's. Exit status: 0 when every arm's TPU
curve lies inside its band at every epoch and its upload column
matches (every run of an aborted arm aborts in the TPU's epoch), 1
otherwise, 2 when a run's TSV is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the hard-v2 CIFAR10 recipe (runs/README.md:454-461; the knobs frac 0.10,
# delta 45, noise 85 of each log's first line are data/fed_cifar.py's).
# --exact_num_cols keeps the TPU's 500,000 columns: its logs' 687 MiB an
# epoch are 72 uploads of 5 x 500,000 float32 cells
CV_COMMON = ("--dataset_name", "CIFAR10", "--model", "ResNet9",
             "--batchnorm", "--iid", "--num_clients", "40",
             "--num_workers", "8", "--local_batch_size", "64",
             "--synthetic_per_class", "400", "--synthetic_hard",
             "--synthetic_label_noise", "0.08", "--lr_scale", "0.1",
             "--local_momentum", "0.0", "--virtual_momentum", "0.9",
             "--k", "50000", "--num_rows", "5", "--num_cols", "500000",
             "--num_blocks", "20", "--approx_topk", "--exact_num_cols")
# scripts/gpt2_convergence.sh's COMMON (its --dataset_dir is --out/data)
GPT2_COMMON = ("--num_workers", "8", "--local_batch_size", "8",
               "--microbatch_size", "8", "--max_seq_len", "64",
               "--valid_batch_size", "64", "--weight_decay", "0",
               "--local_momentum", "0", "--virtual_momentum", "0.9",
               "--eval_before_start")
CORPUS = "personachat_self_original.json"
SEEDS = (21, 22, 23)
# the TPU curves' seed: the epochs' round counts (9 or 10 on hard-v2) are
# the sampler's draws, so the upload column is the TPU log's at this seed
TPU_SEED = 21
# the band's widening of the port's [min, max] over its seeds, by column
BAND = {"cv": {"top1Accuracy": 2.0},
        "gpt2": {"test_nll": 0.05, "mc_acc": 0.03}}


# the driver's divergence abort, the same line in both packages' logs
ABORT = re.compile(r"TRAINING DIVERGED \(first non-finite update at round "
                   r"(\d+)\)")


def abort_round(text: str) -> Optional[int]:
    """The first non-finite round of a run's log ``text``, from the
    driver's abort line, or None when the run did not abort."""
    hit = ABORT.search(text)
    return int(hit.group(1)) if hit else None


@dataclasses.dataclass(frozen=True)
class Arm:
    kind: str             # "cv" or "gpt2"
    epochs: int
    flags: Tuple[str, ...]
    tpu_tsv: str          # relative to the repository's root
    tpu_log: str

    @functools.cached_property
    def tpu_abort(self) -> Optional[int]:
        """The TPU run's first non-finite round, read from its log's abort
        line; None for a run that trained to its end."""
        with open(os.path.join(REPO, self.tpu_log)) as f:
            return abort_round(f.read())

    @property
    def tpu_abort_epoch(self) -> int:
        """The epoch at whose end the TPU run aborted: the one after its
        TSV's last row (the abort comes before that epoch's row)."""
        return len(read_tsv(os.path.join(REPO, self.tpu_tsv))) + 1


# scripts/gpt2_convergence.sh's flagship sketch: 5 x 524,288, k = 50,000
GPT2_SKETCH = ("--mode", "sketch", "--error_type", "virtual",
               "--num_cols", "524288", "--num_rows", "5", "--k", "50000",
               "--approx_topk")


def _with(flags: Tuple[str, ...], flag: str, value: str) -> Tuple[str, ...]:
    """``flags`` with ``flag``'s value set to ``value``."""
    i = flags.index(flag)
    return flags[:i + 1] + (value,) + flags[i + 2:]


ARMS = {
    "cv_uncompressed24": Arm(
        "cv", 24, ("--mode", "uncompressed", "--error_type", "none"),
        "runs/cifar10_hard24v2_uncompressed.tsv",
        "runs/cifar10_hard24v2_uncompressed.log"),
    "cv_true_topk24": Arm(
        "cv", 24, ("--mode", "true_topk", "--error_type", "virtual"),
        "runs/cifar10_hard24v2_true_topk.tsv",
        "runs/cifar10_hard24v2_true_topk.log"),
    "cv_sketch96": Arm(
        "cv", 96, ("--mode", "sketch", "--error_type", "virtual"),
        "runs/cifar10_hard96v2_sketch.tsv",
        "runs/cifar10_hard96v2_sketch.log"),
    # runs/gpt2_conv/README.md:37: the uncompressed curve clips worker
    # gradients at 1 (an unclipped control diverges at round 83)
    "gpt2_uncompressed24": Arm(
        "gpt2", 24, ("--mode", "uncompressed", "--error_type", "none",
                     "--max_grad_norm", "1"),
        "runs/gpt2_conv/gpt2_uncompressed24.tsv",
        "runs/gpt2_conv/gpt2_uncompressed24.log"),
    "gpt2_true_topk24_clip": Arm(
        "gpt2", 24, ("--mode", "true_topk", "--error_type", "virtual",
                     "--k", "50000", "--approx_topk", "--max_grad_norm",
                     "1"),
        "runs/gpt2_conv/gpt2_true_topk24_clip.tsv",
        "runs/gpt2_conv/gpt2_true_topk24_clip.log"),
    "gpt2_sketch24": Arm(
        "gpt2", 24, GPT2_SKETCH, "runs/gpt2_conv/gpt2_sketch24.tsv",
        "runs/gpt2_conv/gpt2_sketch24.log"),
    # the rest of runs/gpt2_conv/README.md's table (:35-46): the two clip
    # placements at one threshold (the table's, and each worker's dense
    # gradient before the encode), the loose table clip, the wider
    # tables, the unclipped true_topk and the 48-epoch sketch
    "gpt2_sketch24_clip": Arm(
        "gpt2", 24, GPT2_SKETCH + ("--max_grad_norm", "1"),
        "runs/gpt2_conv/gpt2_sketch24_clip.tsv",
        "runs/gpt2_conv/gpt2_sketch24_clip.log"),
    "gpt2_sketch24_denseclip": Arm(
        "gpt2", 24, GPT2_SKETCH + ("--max_grad_norm", "1",
                                   "--sketch_dense_clip"),
        "runs/gpt2_conv/gpt2_sketch24_denseclip.tsv",
        "runs/gpt2_conv/gpt2_sketch24_denseclip.log"),
    "gpt2_sketch24_clip8": Arm(
        "gpt2", 24, GPT2_SKETCH + ("--max_grad_norm", "8"),
        "runs/gpt2_conv/gpt2_sketch24_clip8.tsv",
        "runs/gpt2_conv/gpt2_sketch24_clip8.log"),
    "gpt2_sketch24_c1048576": Arm(
        "gpt2", 24, _with(GPT2_SKETCH, "--num_cols", "1048576"),
        "runs/gpt2_conv/gpt2_sketch24_c1048576.tsv",
        "runs/gpt2_conv/gpt2_sketch24_c1048576.log"),
    "gpt2_sketch24_c2097152": Arm(
        "gpt2", 24, _with(GPT2_SKETCH, "--num_cols", "2097152"),
        "runs/gpt2_conv/gpt2_sketch24_c2097152.tsv",
        "runs/gpt2_conv/gpt2_sketch24_c2097152.log"),
    "gpt2_true_topk24": Arm(
        "gpt2", 24, ("--mode", "true_topk", "--error_type", "virtual",
                     "--k", "50000", "--approx_topk"),
        "runs/gpt2_conv/gpt2_true_topk24.tsv",
        "runs/gpt2_conv/gpt2_true_topk24.log"),
    "gpt2_sketch48": Arm(
        "gpt2", 48, GPT2_SKETCH, "runs/gpt2_conv/gpt2_sketch48.tsv",
        "runs/gpt2_conv/gpt2_sketch48.log"),
}


def _ef_arm(stem: str, flags: Tuple[str, ...]) -> Arm:
    return Arm("gpt2", 24, flags, f"runs/gpt2_conv/{stem}.tsv",
               f"runs/gpt2_conv/{stem}.log")


# The EF study (scripts/gpt2_ef_study.sh, each arm's case there, on
# gpt2_convergence.sh's COMMON): the 15 arms the TPU recorded, named
# after their TSVs. Six of them aborted in their first epoch
# (``Arm.tpu_abort``), the others ran 24 epochs. The script's three other
# arms have no TPU record to hold a curve to (sub_clip1_k200k: no log;
# warmup: a log cut after its epoch-0 validation; uncompressed_warmup: no
# log).
_CLIP1 = ("--max_grad_norm", "1")
_SUB = ("--sketch_ef", "subtract")
_DENSE = ("--sketch_server_state", "dense")
EF_ARMS = {
    "gpt2_sketch24_clip1_decay95": GPT2_SKETCH + _CLIP1 + (
        "--error_decay", "0.95"),
    "gpt2_sketch24_clip1_k200k": _with(GPT2_SKETCH, "--k", "200000")
    + _CLIP1,
    "gpt2_sketch24_clip1_r9": _with(GPT2_SKETCH, "--num_rows", "9") + _CLIP1,
    "gpt2_sketch24_clip1_c1p8m": _with(GPT2_SKETCH, "--num_cols",
                                       "1835008") + _CLIP1,
    "gpt2_sketch24_clip1_c4m": _with(GPT2_SKETCH, "--num_cols", "4194304")
    + _CLIP1,
    "gpt2_sketch24_clip1_c8m": _with(GPT2_SKETCH, "--num_cols", "8388608")
    + _CLIP1,
    "gpt2_sketch24_clip1_r2_c4p6m": _with(_with(
        GPT2_SKETCH, "--num_cols", "4603904"), "--num_rows", "2") + _CLIP1,
    "gpt2_sketch24_densestate_clip1": GPT2_SKETCH + _DENSE + (
        "--sketch_dense_clip",) + _CLIP1,
    "gpt2_sketch24_densestate_clip1_decay95": GPT2_SKETCH + _DENSE + (
        "--sketch_dense_clip",) + _CLIP1 + ("--error_decay", "0.95"),
    "gpt2_sketch24_sub": GPT2_SKETCH + _SUB,
    "gpt2_sketch24_sub_clip1": GPT2_SKETCH + _SUB + _CLIP1,
    "gpt2_sketch24_sub_clip1_decay90": GPT2_SKETCH + _SUB + _CLIP1 + (
        "--error_decay", "0.90"),
    "gpt2_sketch24_sub_clip1_r9": _with(GPT2_SKETCH, "--num_rows", "9")
    + _SUB + _CLIP1,
    "gpt2_sketch24_sub_clip1_c1p8m": _with(GPT2_SKETCH, "--num_cols",
                                           "1835008") + _SUB + _CLIP1,
    "gpt2_sketch24_densestate": GPT2_SKETCH + _DENSE,
}
ARMS.update({name: _ef_arm(name, flags) for name, flags in EF_ARMS.items()})


def arm_argv(name: str, seed: int, out: str, device: str = "cuda") -> list:
    """The entry point's argv for ``name`` at ``seed``, its data and
    stream under ``out``."""
    arm = ARMS[name]
    common = CV_COMMON if arm.kind == "cv" else GPT2_COMMON
    return [*common, *arm.flags, "--num_epochs", str(arm.epochs),
            "--seed", str(seed), "--device", device,
            "--dataset_dir", os.path.join(out, f"data_{arm.kind}"),
            "--logdir", os.path.join(out, "logs", f"{name}_s{seed}")]


def _entry(kind: str):
    from commefficient_torch import cv_train, gpt2_train
    return cv_train if kind == "cv" else gpt2_train


def epoch_rounds(kind: str, argv: Sequence[str], epochs: int) -> List[int]:
    """The rounds of each of the first ``epochs`` epochs of the run
    ``argv`` describes, as the driver's samplers deal them."""
    from commefficient_torch.config import config_from_args, parse_known
    from commefficient_torch.core.driver import epoch_sampler
    entry = _entry(kind)
    cfg = config_from_args(parse_known(entry.build_parser(), argv))
    if kind == "cv":
        train_ds = entry.build_datasets(cfg)[0]
    else:
        from commefficient_torch.data.fed_persona import (FedPERSONA,
                                                          HashTokenizer)
        train_ds = FedPERSONA(
            cfg.dataset_dir, train=True, do_iid=cfg.do_iid,
            num_clients=cfg.num_clients, tokenizer=HashTokenizer(),
            num_candidates=cfg.num_candidates,
            max_seq_len=cfg.max_seq_len, max_history=cfg.max_history,
            personality_permutations=cfg.personality_permutations)
    cfg = cfg.replace(num_clients=train_ds.num_clients)
    return [sum(1 for _ in epoch_sampler(cfg, train_ds, e))
            for e in range(epochs)]


def ensure_corpus(out: str) -> str:
    """GPT-2's corpus under ``out/data_gpt2`` (written once)."""
    from commefficient_torch.scripts import make_persona_corpus
    data = os.path.join(out, "data_gpt2")
    path = os.path.join(data, CORPUS)
    if not os.path.exists(path):
        make_persona_corpus.main([data])
    return path


def prepare_data(name: str, out: str) -> None:
    """Writes the data that arm ``name`` reads under ``out`` (GPT-2's
    corpus, then the prepared training and validation sets, which do not
    depend on the seed), as its first run would: once, before runs that
    share ``out`` start side by side."""
    kind = ARMS[name].kind
    os.makedirs(out, exist_ok=True)
    if kind == "gpt2":
        ensure_corpus(out)
    epoch_rounds(kind, arm_argv(name, TPU_SEED, out), 1)


def run_arm(name: str, seed: int, out: str, device: str = "cuda",
            epochs: Optional[int] = None) -> dict:
    """One run of arm ``name`` at ``seed``: writes its TSV, log and JSON
    under ``out`` and returns the JSON's record (``tsv`` its path)."""
    import torch

    from commefficient_torch.ops import circulant_kernels, flash_attention
    from commefficient_torch.scripts import gpt2log2tsv
    from commefficient_torch.utils.logging import TSVLogger
    arm = ARMS[name]
    os.makedirs(out, exist_ok=True)
    if arm.kind == "gpt2":
        ensure_corpus(out)
    argv = arm_argv(name, seed, out, device)
    if epochs is not None:
        argv += ["--num_rounds",
                 str(sum(epoch_rounds(arm.kind, argv, epochs)))]
    stem = os.path.join(out, f"{name}_s{seed}")
    circulant_kernels.reset_launches()
    flash_attention.reset_launches()
    t0 = time.perf_counter()
    with open(stem + ".log", "w") as log:
        with contextlib.redirect_stdout(log):
            print(f"=== {name} seed {seed}: " + " ".join(argv))
            res = _entry(arm.kind).main(argv)
    wall = time.perf_counter() - t0
    epochs_rows = [{k: (v if isinstance(v, (int, float, str)) else None)
                    for k, v in row.items()} for row in res["log"].epochs]
    if arm.kind == "cv":
        tsv = TSVLogger()
        for row in res["log"].epochs:
            tsv.append(row)
        with open(stem + ".tsv", "w") as f:
            f.write(str(tsv) + "\n")
    else:
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            gpt2log2tsv.main(stem + ".log", stem + ".tsv")
    record = {"arm": name, "seed": seed, "argv": argv,
              "epochs": epochs_rows, "rounds": len(res["losses"]),
              "round_s_median": (statistics.median(res["round_s"])
                                 if res["round_s"] else None),
              "launches": {**circulant_kernels.launches,
                           **flash_attention.launches},
              "wall_s": wall, "tsv": stem + ".tsv"}
    with open(stem + ".json", "w") as f:
        json.dump(record, f, indent=1)
    del res
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return record


# ------------------------------------------------------------------ band


def read_tsv(path: str) -> Dict[int, Dict[str, float]]:
    """{epoch: {column: value}} of a TSV in either format (comma- or
    tab-separated, a header line first)."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    sep = "\t" if "\t" in lines[0] else ","
    head = lines[0].split(sep)
    rows = {}
    for ln in lines[1:]:
        vals = dict(zip(head, (float(v) for v in ln.split(sep))))
        rows[int(vals["epoch"])] = vals
    return rows


def curve_band(port_tsvs: Sequence[str], tpu_tsv: str,
               band: Dict[str, float]) -> dict:
    """Holds the TPU curve ``tpu_tsv`` epoch by epoch to the band of the
    port's curves ``port_tsvs``: for each column of ``band``, the port's
    [min, max] over its curves widened by ``band[column]`` on both sides.
    An epoch is inside when every column's TPU value lies in its band;
    an epoch missing from a port curve is outside. Returns the per-epoch
    rows, ``last`` (the TPU curve's last epoch), ``inside_epochs``,
    ``epochs`` and ``first_miss`` (the first epoch outside, or None)."""
    tpu = read_tsv(tpu_tsv)
    ports = [read_tsv(p) for p in port_tsvs]
    rows = []
    for e in sorted(tpu):
        row = {"epoch": e, "inside": True}
        for col, width in band.items():
            vals = [p[e][col] for p in ports if e in p]
            t = tpu[e][col]
            if len(vals) < len(ports) or not vals:
                cell = {"tpu": t, "port": vals, "lo": None, "hi": None,
                        "inside": False}
            else:
                lo, hi = min(vals) - width, max(vals) + width
                cell = {"tpu": t, "port": vals, "lo": lo, "hi": hi,
                        "inside": lo <= t <= hi}
            row[col] = cell
            row["inside"] = row["inside"] and cell["inside"]
        rows.append(row)
    misses = [r["epoch"] for r in rows if not r["inside"]]
    return {"rows": rows, "last": rows[-1] if rows else None,
            "epochs": len(rows), "inside_epochs": len(rows) - len(misses),
            "first_miss": misses[0] if misses else None,
            "misses": misses}


def abort_verdict(port_stems: Sequence[str], arm: Arm) -> dict:
    """Holds the port's runs of an arm whose TPU run aborted
    (``arm.tpu_abort``) to that outcome: a run is inside when its log ends
    in the driver's abort and its TSV has no epoch row past the epochs
    before the TPU's abort epoch (it stopped at the end of the epoch in
    which the TPU's did). Returns each run's ``(stem, first non-finite
    round or None, epoch rows, inside)``, the TPU's round and epoch, and
    ``inside`` (every run inside)."""
    runs = []
    for stem in port_stems:
        with open(stem + ".log") as f:
            rnd = abort_round(f.read())
        rows = len(read_tsv(stem + ".tsv"))
        runs.append((stem, rnd, rows,
                     rnd is not None and rows == arm.tpu_abort_epoch - 1))
    return {"runs": runs, "tpu_round": arm.tpu_abort,
            "tpu_epoch": arm.tpu_abort_epoch,
            "inside": all(r[3] for r in runs)}


def format_abort(name: str, verdict: dict) -> List[str]:
    """The verdict's lines: the first one whether every run aborted in the
    TPU's epoch, then one a run."""
    runs = verdict["runs"]
    lines = [f"== {name}: aborted at the end of epoch {verdict['tpu_epoch']}"
             f" as the TPU's did in {sum(r[3] for r in runs)} of "
             f"{len(runs)} runs"]
    for stem, rnd, rows, inside in runs:
        lines.append(f"  {os.path.basename(stem)}: "
                     + (f"aborted, first non-finite round {rnd}"
                        if rnd is not None else "did not abort")
                     + f", {rows} epoch rows (TPU: round "
                     f"{verdict['tpu_round']}, "
                     f"{verdict['tpu_epoch'] - 1} rows) "
                     + ("in" if inside else "OUT"))
    return lines


def tpu_log_column(log_path: str, column: int = 8) -> Dict[int, int]:
    """{epoch: column} of the TableLogger epoch rows of a TPU log (10
    fields, the first an integer); column 8 is ``up (MiB)``."""
    out = {}
    with open(log_path) as f:
        for line in f:
            fields = line.split()
            if len(fields) == 10 and fields[0].isdigit():
                out[int(fields[0])] = int(float(fields[column]))
    return out


def up_matches(record: dict, tpu_log: str) -> List[Tuple[int, int, int]]:
    """The epochs of a run ``record`` whose ``up (MiB)`` differs from the
    TPU log's: ``(epoch, port, tpu)``."""
    tpu = tpu_log_column(os.path.join(REPO, tpu_log))
    return [(row["epoch"], row["up (MiB)"], tpu.get(row["epoch"]))
            for row in record["epochs"]
            if row["up (MiB)"] != tpu.get(row["epoch"])]


def format_band(name: str, verdict: dict, band: Dict[str, float]) -> List[str]:
    lines = [f"== {name}: inside at {verdict['inside_epochs']} of "
             f"{verdict['epochs']} epochs"
             + (f"; first outside at epoch {verdict['first_miss']}"
                if verdict["first_miss"] is not None else "")]
    for row in verdict["rows"]:
        cells = []
        for col in band:
            c = row[col]
            rng = ("[missing]" if c["lo"] is None
                   else f"[{c['lo']:.4g}, {c['hi']:.4g}]")
            cells.append(f"{col} tpu {c['tpu']:.4g} port "
                         + "/".join(f"{v:.4g}" for v in c["port"])
                         + f" band {rng} {'in' if c['inside'] else 'OUT'}")
        lines.append(f"  {row['epoch']:3d}  " + "; ".join(cells))
    return lines


def _span(vals, fmt: str) -> str:
    lo, hi = min(vals), max(vals)
    return format(lo, fmt) + ("" if lo == hi else "-" + format(hi, fmt))


def run_summary(verdict: dict, band: Dict[str, float],
                records: Sequence[dict]) -> str:
    """One line of an arm's runs: at the TPU curve's last epoch each
    column's port range over the seeds beside the TPU's value (for an arm
    whose TPU run aborted, each run's first non-finite round beside the
    TPU's), then, from the runs' JSON records, their wall seconds, round
    medians (ms) and the kernels each launched a round."""
    if "tpu_round" in verdict:
        parts = [f"first non-finite round tpu {verdict['tpu_round']} port "
                 + "/".join("none" if r[1] is None else str(r[1])
                            for r in verdict["runs"])]
    else:
        last = verdict["last"]
        parts = [f"epoch {last['epoch']}: " + "; ".join(
            f"{col} tpu {last[col]['tpu']:.4g} port "
            + (_span(last[col]["port"], ".4g") if last[col]["port"]
               else "missing") for col in band)]
    walls = [r["wall_s"] for r in records if r.get("wall_s")]
    meds = [r["round_s_median"] * 1e3 for r in records
            if r.get("round_s_median")]
    if walls:
        parts.append(f"wall {_span(walls, '.1f')} s")
    if meds:
        parts.append(f"round median {_span(meds, '.1f')} ms")
    runs = [r for r in records if r.get("rounds") and "launches" in r]
    if runs:
        names = sorted({k for r in runs for k, v in r["launches"].items()
                        if v})
        per_round = {k: [r["launches"].get(k, 0) / r["rounds"]
                         for r in runs] for k in names}
        parts.append("a round: " + (", ".join(
            f"{k} {_span(v, '.4g')}" for k, v in per_round.items())
            or "no kernel launched"))
    return "  " + "; ".join(parts)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=("run", "band"))
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--out", default="curves_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=None)
    args = ap.parse_args(argv)
    arms = [a for a in args.arms.split(",") if a]
    unknown = [a for a in arms if a not in ARMS]
    if unknown:
        ap.error(f"unknown arms {unknown}; known: {list(ARMS)}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.cmd == "run":
        for name in arms:
            for seed in seeds:
                rec = run_arm(name, seed, args.out, args.device, args.epochs)
                print(f"{name} seed {seed}: {rec['rounds']} rounds in "
                      f"{rec['wall_s']:.1f} s, wrote {rec['tsv']}",
                      flush=True)
        return 0
    bad = False
    for name in arms:
        arm = ARMS[name]
        stems = [os.path.join(args.out, f"{name}_s{s}") for s in seeds]
        missing = [s + ".tsv" for s in stems if not os.path.exists(s + ".tsv")]
        if missing:
            print(f"{name}: missing {missing}", file=sys.stderr)
            return 2
        band = BAND[arm.kind]
        if arm.tpu_abort is not None:
            verdict = abort_verdict(stems, arm)
            lines = format_abort(name, verdict)
        else:
            verdict = curve_band([s + ".tsv" for s in stems],
                                 os.path.join(REPO, arm.tpu_tsv), band)
            lines = format_band(name, verdict, band)
        records = {}
        for stem in stems:
            if os.path.exists(stem + ".json"):
                with open(stem + ".json") as f:
                    records[stem] = json.load(f)
        lines.insert(1, run_summary(verdict, band, list(records.values())))
        with open(os.path.join(args.out, f"{name}_band.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        print("\n".join(lines[:2]))
        if arm.tpu_abort is not None:
            # the TPU log has no epoch row: no upload column to compare
            bad = bad or not verdict["inside"]
            continue
        if TPU_SEED in seeds:
            stem = stems[seeds.index(TPU_SEED)]
            wrong = up_matches(records[stem], arm.tpu_log)
            print(f"  up (MiB) {os.path.basename(stem)}: "
                  + ("equal to the TPU log's at every epoch" if not wrong
                     else f"differs at {wrong[:5]}"))
            bad = bad or bool(wrong)
        bad = bad or verdict["first_miss"] is not None
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
