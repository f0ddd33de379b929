"""The multi-host dryrun, counterpart of the JAX package's
``scripts/multihost_dryrun.py``: two ``torchrun`` launchers on 127.0.0.1
(``--nnodes 2``, c10d rendezvous), 4 gloo ranks each, run one sharded
sketch round on the 8-rank world, and it must agree with one launcher of
8 ranks.

Every rank runs the round under the collectives ledger and writes
``rank{r}.json`` to the launch's directory: its checksum (the round's
datum-weighted mean loss and the squared norm of the whole weights, both
the same on every rank), its per-kind launch counts (held to
``ROUND_COLLECTIVE_LAUNCH_BOUNDS``, with the sharded tail's
reduce-scatter and at least three all-gathers) and the launcher it ran
under (``GROUP_RANK``). The two-launcher world must span both launchers,
and its checksums and counts must equal the one launcher's (the sums
are in rank order, so equal means bitwise). Everything runs on this
host's CPU; nothing leaves 127.0.0.1.

    python -m commefficient_torch.scripts.multihost_dryrun
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile

N_GLOBAL = 8
LAUNCH_TIMEOUT_S = 600


def run_round(out_dir: str) -> None:
    """One rank of the world (``torchrun`` set its environment)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.resnet9 import ResNet9
    from commefficient_torch.parallel.mesh import init_distributed, make_mesh
    from commefficient_torch.telemetry.collectives import (
        past_bounds, recording, summarize_ledger)

    torch.set_num_threads(1)
    init_distributed("cpu")
    try:
        mesh = make_mesh((N_GLOBAL,), ("clients",))
        model = ResNet9(num_classes=10,
                        channels={"prep": 4, "layer1": 8, "layer2": 8,
                                  "layer3": 8},
                        generator=torch.Generator().manual_seed(0))
        cfg = FedConfig(mode="sketch", error_type="virtual",
                        local_momentum=0.0, virtual_momentum=0.9,
                        weight_decay=0.0, num_workers=N_GLOBAL,
                        local_batch_size=2, k=8, num_rows=3, num_cols=64,
                        num_blocks=2, num_clients=2 * N_GLOBAL,
                        track_bytes=False, telemetry=False)
        runtime = FedRuntime(cfg, model, make_cv_loss(model, "float32"),
                             device="cpu", mesh=mesh)
        state = runtime.init_state()
        W, B = N_GLOBAL, 2
        rng = np.random.RandomState(0)
        batch = {"image": rng.randn(W, B, 32, 32, 3).astype(np.float32),
                 "target": rng.randint(0, 10, (W, B))}
        with recording() as ledger:
            state, metrics = runtime.round(state, np.arange(W), batch,
                                           np.ones((W, B), bool), 0.1)
        counts = summarize_ledger(ledger)["counts"]
        over = past_bounds(ledger)
        if over:
            raise RuntimeError(f"launches a round past their bounds: {over}")
        if counts.get("reduce-scatter", 0) < 1 or \
                counts.get("all-gather", 0) < 3:
            raise RuntimeError(f"the sharded tail's collectives are "
                               f"missing: {counts}")
        w = runtime.flat_weights(state)
        losses, n = metrics["results"][0], metrics["n_valid"]
        loss = (losses * n).sum() / torch.clamp(n.sum(), min=1.0)
        out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
               "launcher": int(os.environ.get("GROUP_RANK", 0)),
               "checksum": [float(loss), float((w * w).sum())],
               "counts": counts}
        with open(os.path.join(out_dir, f"rank{out['rank']}.json"),
                  "w") as f:
            json.dump(out, f)
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def _launcher(nnodes: int, nproc: int, port: int, out_dir: str):
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nnodes", str(nnodes), "--nproc_per_node", str(nproc),
           "--rdzv_backend", "c10d", "--rdzv_endpoint",
           f"127.0.0.1:{port}", "--rdzv_id", f"dryrun{port}",
           "--local_addr", "127.0.0.1", "--max_restarts", "0",
           "-m", "commefficient_torch.scripts.multihost_dryrun",
           "--worker", "--out", out_dir]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, env=env, cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _launch(nnodes: int, out_dir: str) -> list:
    """Run the world over ``nnodes`` launchers; every rank's record, or
    a RuntimeError with the launchers' output."""
    from commefficient_torch.parallel.mesh import free_port
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    procs = [_launcher(nnodes, N_GLOBAL // nnodes, port, out_dir)
             for _ in range(nnodes)]
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=LAUNCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            # each launcher leads its own session: its ranks end with it
            for q in procs:
                if q.poll() is None:
                    os.killpg(q.pid, signal.SIGKILL)
            out, _ = p.communicate()
            failed = True
        outs.append(out)
        failed = failed or p.returncode != 0
    if failed:
        raise RuntimeError("a launcher failed:\n" + "\n".join(
            o[-3000:] for o in outs))
    recs = []
    for r in range(N_GLOBAL):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="one rank, under torchrun")
    ap.add_argument("--out", default=None,
                    help="the ranks' records (a temp dir, removed, "
                         "without it)")
    args = ap.parse_args(argv)
    if args.worker:
        run_round(args.out)
        return 0
    work = args.out or tempfile.mkdtemp(prefix="multihost_")
    try:
        ref = _launch(1, os.path.join(work, "one_launcher"))
        two = _launch(2, os.path.join(work, "two_launchers"))
    finally:
        if args.out is None:
            shutil.rmtree(work, ignore_errors=True)
    ok = True
    for name, recs in (("one launcher", ref), ("two launchers", two)):
        sums = {tuple(r["checksum"]) for r in recs}
        counts = {json.dumps(r["counts"], sort_keys=True) for r in recs}
        print(f"{name}: launchers {sorted({r['launcher'] for r in recs})}, "
              f"checksums {sorted(sums)}, collectives {sorted(counts)}")
        ok = ok and len(sums) == 1 and len(counts) == 1
    spans = {r["launcher"] for r in two} == {0, 1}
    same = (two[0]["checksum"] == ref[0]["checksum"]
            and two[0]["counts"] == ref[0]["counts"])
    ok = ok and spans and same
    print(f"multihost dryrun: {'PASS' if ok else 'FAIL'} (2 launchers x 4 "
          f"ranks {'==' if same else '!='} 1 launcher x 8 ranks; the world "
          f"spans both launchers: {spans}); collective counts "
          f"{json.dumps(ref[0]['counts'], sort_keys=True)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
