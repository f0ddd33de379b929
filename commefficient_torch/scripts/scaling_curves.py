"""Weak and strong scaling curves of the sharded sketch round,
counterpart of the JAX package's ``scripts/scaling_curves.py``.

The same sharded sketch round (a narrow ResNet-9, r = 3, c = 512) runs
on meshes of 1, 2 and 4 ranks:

- the weak arms: W = 2n clients, the per-rank work fixed, so the
  per-rank throughput should hold;
- the strong arms: W = 8 clients over n ranks, the total work fixed.

The arms of one rank count run in one rank group. Each arm writes one
JSONL line to ``--out``: its items/s, per-rank
items/s, round time, the round's collectives (``telemetry/collectives.py``
summary and ``table_reduce_bytes``) and the backend it ran on; rank 0
writes the arm's telemetry stream (its ``collectives`` and ``bench``
events). Then the ``gate`` line: ``teleview diff --perchip_drop`` from the
smallest multi-rank weak arm to the largest, and under ``--wire_dtype
float32,int8`` the int8 arm's table-reduce wire bytes against the float32
arm's (at most 0.30 of them).

One card cannot hold two NCCL ranks: with ``--device cuda`` the n = 1
arms run on the card (a 1-rank NCCL mesh) and the script says that the
n >= 2 arms run on gloo CPU ranks (``spawn_ranks``), as they do with
``--device cpu``. So the curves test the harness, the collective shapes
and the gate's wiring; they measure no speed across cards.

    python -m commefficient_torch.scripts.scaling_curves \\
        --out chiprun_out/scaling.jsonl [--devices 1,2,4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

DEFAULT_DEVICES = (1, 2, 4)
STRONG_WORKERS = 8       # the strong arms' fixed population
WEAK_PER_DEVICE = 2      # the weak arms' clients a rank
BATCH = 8
# the weak curve's per-rank drop the gate allows: the ranks share one
# host's cores, so the gate bounds the harness's overhead (the JAX
# package's value for its virtual devices)
DRYRUN_PERCHIP_DROP = 0.55
# the int8 table reduce's wire bytes against the float32 arm's
WIRE_BYTES_CEILING = 0.30


def arm_body(rank: int, n: int, scaling: str, wire: str, rounds: int,
             warmup: int, stream_dir: str) -> dict:
    """One arm on this rank of an n-rank mesh: the round ``warmup +
    rounds`` times, the first under the collectives ledger. Returns the
    arm's result (every rank the same)."""
    import numpy as np
    import torch

    from commefficient_torch.config import FedConfig
    from commefficient_torch.core.runtime import FedRuntime
    from commefficient_torch.losses import make_cv_loss
    from commefficient_torch.models.resnet9 import ResNet9
    from commefficient_torch.parallel.mesh import make_mesh
    from commefficient_torch.telemetry.collectives import (
        past_bounds, recording, summarize_ledger, table_reduce_wire_bytes)
    from commefficient_torch.telemetry.run import RunTelemetry

    mesh = make_mesh((n,), ("clients",))
    dev = mesh.device
    W = WEAK_PER_DEVICE * n if scaling == "weak" else STRONG_WORKERS
    model = ResNet9(num_classes=10,
                    channels={"prep": 4, "layer1": 8, "layer2": 8,
                              "layer3": 8},
                    generator=torch.Generator().manual_seed(0))
    cfg = FedConfig(mode="sketch", error_type="virtual",
                    local_momentum=0.0, virtual_momentum=0.9,
                    weight_decay=0.0, num_workers=W, local_batch_size=BATCH,
                    k=8, num_rows=3, num_cols=512, num_blocks=2,
                    num_clients=2 * W, track_bytes=False, telemetry=False,
                    wire_dtype=wire, mesh_shape=(n,))
    runtime = FedRuntime(cfg, model, make_cv_loss(model, "float32"),
                         device=dev, mesh=mesh)
    state = runtime.init_state()
    rng = np.random.RandomState(0x5CA1)
    batches = [{"image": rng.randn(W, BATCH, 32, 32, 3).astype(np.float32),
                "target": rng.randint(0, 10, (W, BATCH))}
               for _ in range(2)]
    ids, mask = np.arange(W), np.ones((W, BATCH), bool)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tw = time.perf_counter()
    with recording() as ledger:
        state, m = runtime.round(state, ids, batches[0], mask, 0.1)
    for g in range(1, warmup):
        state, m = runtime.round(state, ids, batches[g % 2], mask, 0.1)
    sync()
    warmup_s = time.perf_counter() - tw
    mesh.barrier()
    t0 = time.perf_counter()
    for g in range(rounds):
        state, m = runtime.round(state, ids, batches[g % 2], mask, 0.1)
    sync()
    wall = time.perf_counter() - t0
    losses = m["results"][0].cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{scaling} n={n}: nonfinite losses {losses}")
    summary = summarize_ledger(ledger)
    counts = summary["counts"]
    over = past_bounds(ledger)
    if over:
        raise RuntimeError(f"{scaling} n={n}: launches past their bounds "
                           f"{over}")
    if not runtime.sharded_server:
        raise RuntimeError(f"{scaling} n={n}: the sharded tail is off")
    items = W * BATCH * rounds
    result = {
        "scaling": scaling, "devices": n, "num_workers": W, "batch": BATCH,
        "rounds": rounds, "wire_dtype": wire,
        "warmup_s": warmup_s, "wall_s": wall,
        "items_per_s": items / wall, "per_chip_items_per_s": items / wall / n,
        "round_ms": 1e3 * wall / rounds,
        "sharded_server": bool(runtime.sharded_server),
        "d": int(runtime.cfg.grad_size), "final_loss": float(losses.mean()),
        "collectives": counts, "ledger_total_bytes": summary["total_bytes"],
        "table_reduce_bytes": table_reduce_wire_bytes(ledger, n),
        "backend": f"{torch.distributed.get_backend()}-{dev.type}",
    }
    if rank == 0:
        tel = RunTelemetry(stream_dir, "scaling_arm", cfg=runtime.cfg,
                           device=dev)
        tel.collectives_event("round_step", ledger, n_devices=n)
        tel.bench_event("scaling_arm", result)
        tel.write_summary(aborted=False, n_rounds=warmup + rounds)
        tel.close()
    return result


def arms_body(rank: int, n: int, arms, rounds: int, warmup: int,
              workdir: str) -> list:
    """Every arm of ``arms`` ([(scaling, wire)]) on this rank of one
    n-rank group, in order; their results."""
    return [arm_body(rank, n, scaling, wire, rounds, warmup,
                     stream_dir(workdir, scaling, wire, n))
            for scaling, wire in arms]


def stream_dir(workdir: str, scaling: str, wire: str, n: int) -> str:
    path = os.path.join(workdir, f"{scaling}_{wire}_n{n}")
    os.makedirs(path, exist_ok=True)
    return path


def run_arms(n: int, arms, rounds: int, warmup: int, workdir: str,
             device: str) -> list:
    """The arms of one rank count in one rank group: n = 1 in this
    process (a group of one: NCCL on the card, gloo on the CPU, torn down
    after unless the process had one), n >= 2 on gloo CPU ranks."""
    import torch.distributed as dist

    from commefficient_torch.parallel.mesh import (init_distributed,
                                                   spawn_ranks)
    if n > 1:
        if device == "cuda":
            print(f"n={n}: one card cannot hold {n} NCCL ranks; these "
                  "arms run on gloo CPU ranks", flush=True)
        return spawn_ranks(arms_body, n, arms, rounds, warmup, workdir)[0]
    owned = not dist.is_initialized()
    init_distributed(device)
    try:
        return arms_body(0, 1, arms, rounds, warmup, workdir)
    finally:
        if owned:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/scaling.jsonl")
    ap.add_argument("--devices", default=",".join(map(str,
                                                      DEFAULT_DEVICES)))
    ap.add_argument("--device", default="cuda",
                    help="the n = 1 arms' device (the n >= 2 arms run on "
                         "gloo CPU ranks either way)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--wire_dtype", default="float32",
                    help="comma list of table wires (float32,bfloat16,"
                         "int8); wires other than float32 run the weak "
                         "arms only")
    ap.add_argument("--workdir", default=None,
                    help="keep the arms' telemetry streams here (else a "
                         "temp dir, removed at the end)")
    ap.add_argument("--perchip_drop", type=float,
                    default=DRYRUN_PERCHIP_DROP)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
    from commefficient_torch.scripts import teleview

    devices = [int(x) for x in args.devices.split(",") if x]
    wires = [w for w in args.wire_dtype.split(",") if w]
    workdir = args.workdir or tempfile.mkdtemp(prefix="scaling_")
    lines, streams = [], {}
    try:
        for n in devices:
            arms = [(scaling, wire) for wire in wires
                    for scaling in ("weak", "strong")
                    if scaling == "weak" or (wire == "float32"
                                             and STRONG_WORKERS % n == 0)]
            t0 = time.perf_counter()
            recs = run_arms(n, arms, args.rounds, args.warmup, workdir,
                            args.device)
            for rec in recs:
                scaling, wire = rec["scaling"], rec["wire_dtype"]
                rec.update(kind="arm",
                           group_wall_s=time.perf_counter() - t0)
                lines.append(rec)
                streams[(scaling, wire, n)] = os.path.join(
                    stream_dir(workdir, scaling, wire, n), "telemetry.jsonl")
                print(f"{scaling:6s} {wire:8s} n={n} "
                      f"({rec['backend']}): {rec['items_per_s']:.1f} "
                      f"img/s ({rec['per_chip_items_per_s']:.1f} a "
                      f"rank), round {rec['round_ms']:.3f} ms, "
                      f"collectives {rec['collectives']}", flush=True)
        lines.sort(key=lambda r: (wires.index(r["wire_dtype"]),
                                  r["scaling"] != "weak", r["devices"]))
        rc = wire_rc = None
        multi = sorted(n for s, w, n in streams
                       if s == "weak" and w == "float32" and n > 1)
        if len(multi) >= 2:
            base_n, cand_n = multi[0], multi[-1]
            rc = teleview.main([
                "diff", streams[("weak", "float32", base_n)],
                streams[("weak", "float32", cand_n)],
                "--perchip_drop", str(args.perchip_drop),
                "--mfu_drop", "0.95", "--signal_ratio", "1000",
                "--loss_ratio", "1000", "--bytes_ratio", "1000",
                "--temp_bytes_growth", "1000", "--wire_bytes_growth",
                "1000", "--count_slack", "1000"])
            lines.append({"kind": "gate", "gate": "teleview_diff_perchip",
                          "scaling": "weak", "baseline_devices": base_n,
                          "candidate_devices": cand_n,
                          "perchip_drop": args.perchip_drop, "rc": rc,
                          "passed": rc == 0})
            print(f"weak-scaling per-rank gate (n={base_n} -> n={cand_n}, "
                  f"drop <= {args.perchip_drop:.0%}): "
                  f"{'PASS' if rc == 0 else 'FAIL'}", flush=True)
        if "int8" in wires:
            shared = sorted(n for s, w, n in streams
                            if s == "weak" and w == "int8" and n > 1
                            and ("weak", "float32", n) in streams)
            if shared:
                n = shared[-1]
                got = {w: next(r["table_reduce_bytes"] for r in lines
                               if r.get("kind") == "arm"
                               and r["scaling"] == "weak"
                               and r["wire_dtype"] == w
                               and r["devices"] == n)
                       for w in ("float32", "int8")}
                ok = bool(got["float32"]) and \
                    got["int8"] <= WIRE_BYTES_CEILING * got["float32"]
                wire_rc = 0 if ok else 1
                lines.append({"kind": "gate", "gate": "wire_bytes_int8",
                              "devices": n, "ceiling": WIRE_BYTES_CEILING,
                              "f32_table_reduce_bytes": got["float32"],
                              "int8_table_reduce_bytes": got["int8"],
                              "rc": wire_rc, "passed": ok})
                print(f"int8 wire gate (n={n}): {got['int8']} B against "
                      f"{got['float32']} B: {'PASS' if ok else 'FAIL'}",
                      flush=True)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    print(f"wrote {args.out} ({len(lines)} lines)", flush=True)
    return 1 if (rc not in (0, None) or wire_rc not in (0, None)) else 0


if __name__ == "__main__":
    sys.exit(main())
