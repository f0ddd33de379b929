"""Crash/kill fault-injection matrix, the PyTorch port's counterpart of the
JAX package's ``scripts/crash_matrix.py``: prove the resume story against
REAL process death.

For each kill-point (commefficient_torch/faults.py) the harness runs a
small deterministic federated training child three ways:

1. **straight**: no fault, the bit-exact baseline (per-round losses
   read back from its telemetry stream);
2. **faulted**: the same child with ``COMMEFFICIENT_FAULT`` armed:
   ``kill`` points die via ``os._exit(137)`` exactly there (no
   ``finally``, no flush: the SIGKILL-alike), ``sigterm`` points
   self-signal and exercise the graceful --preempt_grace drain;
3. **resumed**: ``--resume`` against the same checkpoint dir and the
   same logdir, so the telemetry stream APPENDS behind a `resume`
   lineage record.

Asserted per point: the resume exits 0; the union of round records is
BIT-identical to the straight baseline (same loss float per global
round: JSON round-trips floats exactly); no ``*.tmp`` litter survives
in the checkpoint dir; the stitched stream carries the lineage
(`resume` event, and a `fault` event for the graceful points); and the
child's final weights are the straight run's bit for bit.

Usage::

    python -m commefficient_torch.scripts.crash_matrix  # full matrix
    python -m commefficient_torch.scripts.crash_matrix \
        --points pre_round,mid_round
    python -m commefficient_torch.scripts.crash_matrix --keep  # keep dirs

Exit status: 0 = every point passed, 1 = any failure, 2 = no point
matches ``--points``.

The child is this same module with ``--child``: the quad model (a 6 x 3
linear map, d = 18) in the sketch mode (2 x 32, k = 5) over 8 clients
of 8 items, W = 4, B = 2, two epochs of 7 rounds (the sampler stops when
fewer than W clients have data left) with a checkpoint at each, run by
the port's ``FedRuntime``, checkpointing and ``RunTelemetry`` through the
driver's epoch loop. Children run on the card (K1 and K2 at d = 18)
unless ``--device cpu`` is given; each prints its final weights' digest
and its K1/K2 launch counts.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

KILL_EXIT = 137          # faults.KILL_EXIT_CODE (the parent imports no torch)
CHILD_TIMEOUT_S = 600

# (label, COMMEFFICIENT_FAULT spec, async child?, expected exit codes).
# The child runs 2 epochs x 7 rounds with a checkpoint at each epoch
# boundary: kills at round 12 land mid-epoch-2, so the resume restores
# the epoch-1 generation and REPLAYS rounds 8.. (their re-emitted
# records must agree bit-for-bit with the faulted run's); the
# mid-checkpoint kill dies during the FIRST save (tmp litter, no
# generation yet); the graceful arm self-SIGTERMs at round 5 and
# resumes from the round-granular preempt checkpoint.
MATRIX = (
    ("pre_round", "kill:pre_round:12", False, (KILL_EXIT,)),
    ("mid_round", "kill:mid_round:12", False, (KILL_EXIT,)),
    ("mid_checkpoint_write", "kill:mid_checkpoint_write", False,
     (KILL_EXIT,)),
    ("mid_telemetry_flush", "kill:mid_telemetry_flush:40", False,
     (KILL_EXIT,)),
    ("async_pool", "kill:async_pool:12", True, (KILL_EXIT,)),
    ("graceful_preempt", "sigterm:pre_round:5", False, (0,)),
)


# ---------------------------------------------------------------- child


def run_child(args) -> int:
    """One deterministic training run: quad model, 8 clients x 8 items,
    W=4 B=2 => 7 rounds/epoch x 2 epochs, checkpoint every epoch,
    per-round telemetry into a FIXED logdir (the resume appends)."""
    import numpy as np
    import torch

    from commefficient_torch.checkpoint import setup_checkpointing
    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.driver import open_telemetry, train
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.ops import circulant_kernels
    from commefficient_torch.utils.logging import TableLogger
    from commefficient_torch.utils.schedules import lr_schedule_for

    D_IN, D_OUT = 6, 3

    class Quad:
        """The JAX child's ``{"w": (6, 3)}`` as one flat vector."""

        def __init__(self):
            w = np.random.RandomState(0).randn(D_IN, D_OUT)
            self.flat = torch.tensor(w.astype(np.float32).ravel())
            self.num_params = D_IN * D_OUT
            self.layout = [("params/w", (D_IN, D_OUT))]

    def loss_fn(flat, batch, mask):
        pred = batch["x"] @ flat.view(D_IN, D_OUT)
        m = mask.to(torch.float32)
        denom = torch.clamp(m.sum(), min=1.0)
        err = ((pred - batch["y"]) ** 2).sum(dim=1)
        loss = (err * m).sum() / denom
        return loss, (loss,)

    class DS:
        data_per_client = np.full(8, 8)   # W=4 x B=2 => 7 rounds/epoch
        num_clients = 8
        _rng = np.random.RandomState(0)
        _x = _rng.randn(256, D_IN).astype(np.float32)
        _y = _rng.randn(256, D_OUT).astype(np.float32)

        def __len__(self):
            return 64

        def gather(self, idx):
            idx = np.asarray(idx)
            return {"x": self._x[idx], "y": self._y[idx]}

    cfg = FedConfig(
        mode="sketch", error_type="virtual", local_momentum=0.0,
        virtual_momentum=0.9, weight_decay=0.0, num_workers=4,
        local_batch_size=2, track_bytes=True, num_clients=8, k=5,
        num_rows=2, num_cols=32, exact_num_cols=True, telemetry_every=1,
        num_epochs=2.0, pivot_epoch=1.0, checkpoint_every=1,
        checkpoint_path=args.ckpt, do_resume=args.resume,
        preempt_grace=20.0, async_agg=args.async_agg,
        max_inflight=2 if args.async_agg else 4,
        buffer_goal=2 if args.async_agg else 1, logdir=args.logdir)
    rt = FedRuntime(cfg, Quad(), loss_fn, device=args.device)
    mgr, start_epoch, restored, global_round = setup_checkpointing(
        rt.cfg, rt, "quad")
    state = restored if restored is not None else rt.init_state()
    _, tel = open_telemetry(rt.cfg, rt, "cv_train", mgr)
    circulant_kernels.reset_launches()
    try:
        state, _, _ = train(
            rt, state, DS(), DS(), lr_schedule_for(rt.cfg),
            loggers=(TableLogger(),), ckpt_mgr=mgr,
            checkpoint_every=rt.cfg.checkpoint_every,
            start_epoch=start_epoch, global_round=global_round,
            services=True, telemetry=tel)
    finally:
        if tel is not None:
            tel.close()
    # final weights fingerprint, for the parent's bitwise comparison
    w = state.ps_weights.detach().cpu().numpy().tobytes()
    print("CHILD_WEIGHTS " + hashlib.sha256(w).hexdigest())
    print("CHILD_LAUNCHES " + json.dumps(dict(circulant_kernels.launches)))
    return 0


# --------------------------------------------------------------- parent


def _read_rounds(logdir: str):
    """{global round -> loss} from a (possibly stitched) stream; a later
    segment's record for the same round must agree with the earlier one
    (replayed rounds are bit-identical by contract)."""
    out, conflicts = {}, []
    path = os.path.join(logdir, "telemetry.jsonl")
    if not os.path.exists(path):
        return out, conflicts, []
    kinds = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except ValueError:
                continue        # the truncated kill-mid-flush fragment
            kinds.append(e.get("event"))
            if e.get("event") == "round":
                r, loss = e["round"], e["loss"]
                if r in out and out[r] != loss:
                    conflicts.append((r, out[r], loss))
                out[r] = loss
    return out, conflicts, kinds


def _tagged(proc, tag: str):
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(tag)]
    return lines[-1][len(tag):].strip() if lines else None


def _spawn(args, extra_env, workdir, label):
    env = dict(os.environ, **extra_env)
    env.pop("COMMEFFICIENT_FAULT", None)
    env.update(extra_env)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run(
        [sys.executable, "-m", "commefficient_torch.scripts.crash_matrix",
         "--child"] + args,
        env=env, cwd=workdir, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    sys.stdout.write(f"    [{label}] exit {proc.returncode}\n")
    sys.stdout.flush()
    return proc


def run_matrix(points, keep: bool, device: str = "cuda",
               results: dict = None) -> int:
    """Runs ``points`` (rows of ``MATRIX``); prints a ``RESULT`` line a
    row. ``results`` (a dict) gets each straight child's K1/K2 launches
    under ``("straight", async?)`` and each row's verdict under its
    label."""
    results = {} if results is None else results
    failures = []
    scratch = tempfile.mkdtemp(prefix="crash_matrix_")
    dev = ["--device", device]
    try:
        baselines = {}
        for is_async in sorted({a for _, _, a, _ in points}):
            base_dir = os.path.join(scratch, f"base_{int(is_async)}")
            args = ["--ckpt", os.path.join(base_dir, "ck"),
                    "--logdir", os.path.join(base_dir, "logs")] + dev
            if is_async:
                args.append("--async_agg")
            proc = _spawn(args, {}, scratch, "baseline")
            rounds, conflicts, _ = _read_rounds(
                os.path.join(base_dir, "logs"))
            if proc.returncode != 0 or not rounds or conflicts:
                print(proc.stdout[-2000:], proc.stderr[-2000:])
                print("FATAL: baseline run failed")
                return 1
            baselines[is_async] = (rounds, _tagged(proc, "CHILD_WEIGHTS"))
            results[("straight", is_async)] = json.loads(
                _tagged(proc, "CHILD_LAUNCHES"))
        for label, spec, is_async, ok_exits in points:
            print(f"== {label} ({spec})")
            d = os.path.join(scratch, label)
            args = ["--ckpt", os.path.join(d, "ck"),
                    "--logdir", os.path.join(d, "logs")] + dev
            if is_async:
                args.append("--async_agg")
            bad = []
            faulted = _spawn(args, {"COMMEFFICIENT_FAULT": spec}, scratch,
                             "faulted")
            if faulted.returncode not in ok_exits:
                bad.append(f"faulted exit {faulted.returncode} not in "
                           f"{ok_exits}")
            resumed = _spawn(args + ["--resume"], {}, scratch, "resumed")
            if resumed.returncode != 0:
                bad.append(f"resume exit {resumed.returncode}")
                print(resumed.stdout[-2000:], resumed.stderr[-2000:])
            rounds, conflicts, kinds = _read_rounds(
                os.path.join(d, "logs"))
            base_rounds, base_weights = baselines[is_async]
            if conflicts:
                bad.append(f"replayed rounds disagree: {conflicts[:3]}")
            if rounds != base_rounds:
                missing = sorted(set(base_rounds) - set(rounds))
                diff = [r for r in rounds
                        if base_rounds.get(r) != rounds[r]]
                bad.append(f"round/loss map != baseline (missing "
                           f"{missing[:5]}, diverged {diff[:5]})")
            weights = _tagged(resumed, "CHILD_WEIGHTS")
            if weights is None or weights != base_weights:
                bad.append("final weights differ from the straight run")
            ck_dir = os.path.join(d, "ck", "quad")
            litter = [fn for fn in os.listdir(ck_dir)
                      if fn.endswith(".tmp")] if os.path.isdir(ck_dir) \
                else []
            if litter:
                bad.append(f".tmp litter survived the resume: {litter}")
            if "resume" not in kinds:
                bad.append("no `resume` lineage record in the stream")
            if spec.startswith("sigterm") and "fault" not in kinds:
                bad.append("graceful preempt left no `fault` event")
            status = "PASS" if not bad else "FAIL: " + "; ".join(bad)
            print(f"RESULT {label}: {status}", flush=True)
            results[label] = status
            if bad:
                failures.append(label)
        return 1 if failures else 0
    finally:
        if keep:
            print(f"scratch kept at {scratch}")
        else:
            shutil.rmtree(scratch, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        usage="python -m commefficient_torch.scripts.crash_matrix "
              "[--points P,...] [--keep] [--device cuda|cpu]")
    p.add_argument("--child", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--async_agg", action="store_true")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--logdir", type=str, default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--points", type=str, default="",
                   help="comma-separated kill-point labels (default all)")
    p.add_argument("--keep", action="store_true")
    args = p.parse_args(argv)
    if args.child:
        return run_child(args)
    wanted = set(filter(None, args.points.split(",")))
    points = [m for m in MATRIX if not wanted or m[0] in wanted]
    if not points:
        print(f"no kill-points match {sorted(wanted)}; known: "
              f"{[m[0] for m in MATRIX]}")
        return 2
    return run_matrix(points, args.keep, args.device)


if __name__ == "__main__":
    sys.exit(main())
