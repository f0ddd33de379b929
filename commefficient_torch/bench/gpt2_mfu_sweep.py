"""GPT-2 round MFU sweep: remat policy x microbatch x lm_chunk x the
fused encode, over ``bench_gpt2.run``; the counterpart of the JAX
package's ``scripts/gpt2_mfu_sweep.py``.

    python -m commefficient_torch.bench.gpt2_mfu_sweep
        [--out runs/gpt2_mfu_sweep.jsonl] [--arms base,mb4,+policy_nobatch]
        [--rounds 8] [--dryrun] [--ledger_ab] [--device cuda|cpu]

Each arm is one ``bench_gpt2.run`` (the same round and analytic-FLOPs
MFU) and lands as one JSON line in ``--out`` as it finishes; an arm that
fails writes its error on its line and the sweep goes on. The last
stdout line names the best arm. The ``overlap`` arms need the split
round (``--decode_overlap``, ROADMAP A9): their lines carry that error.
``--compile_cache`` is refused (the port has no compile step).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import Optional

from commefficient_torch.bench import bench_gpt2
from commefficient_torch.bench.bench import COMPILE_CACHE_REFUSAL
from commefficient_torch.bench.bench_common import log
from commefficient_torch.config import parse_known

# arm name -> bench_gpt2.run keyword overrides (base: full remat,
# microbatch 8, lm_chunk 128, the fused encode)
ARMS = {
    "base": {},
    # the clients' dense sum encoded once instead of every microbatch
    # gradient streamed into the table
    "unfused_encode": {"fused_encode": "off"},
    # the split round (--decode_overlap): ROADMAP A9
    "overlap": {"decode_overlap": True},
    "overlap_unfused": {"decode_overlap": True, "fused_encode": "off"},
    "no_remat": {"remat": False},
    "policy_dots": {"remat_policy": "dots_saveable"},
    "mb4": {"microbatch": 4},
    "mb2": {"microbatch": 2},
    "chunk64": {"lm_chunk": 64},
    "chunk256": {"lm_chunk": 256},
    "mb4_chunk256": {"microbatch": 4, "lm_chunk": 256},
    "policy_dots_mb4": {"remat_policy": "dots_saveable", "microbatch": 4},
    # opt-in only: --arms +policy_nobatch
    "policy_nobatch": {"remat_policy": "dots_with_no_batch_dims_saveable"},
}
DEFAULT_ARMS = [a for a in ARMS if a != "policy_nobatch"]


def _write(f, rec: dict) -> None:
    # one fsync'd line an arm: a crash mid-sweep keeps every finished arm
    f.write(json.dumps(rec) + "\n")
    f.flush()
    os.fsync(f.fileno())


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="runs/gpt2_mfu_sweep.jsonl",
                    help="JSONL output, one line per arm as it finishes")
    ap.add_argument("--arms", default="",
                    help="comma-separated arm names (default: all except "
                         "policy_nobatch); prefix an arm with + to ADD it "
                         "to the default set")
    ap.add_argument("--rounds", type=int, default=8,
                    help="timed rounds per arm")
    ap.add_argument("--compile_cache", default=None,
                    help="refused: the port has no compile step to cache")
    ap.add_argument("--dryrun", action="store_true",
                    help="every arm at smoke scale (GPT2Config.small, a "
                         "tiny round); each line carries dryrun: true")
    ap.add_argument("--ledger_ab", action="store_true",
                    help="append bench_gpt2.ledger_ab (the cohort's "
                         "memory with the fused encode on and off); "
                         "honors --dryrun")
    ap.add_argument("--device", default="cuda")
    args = parse_known(ap, argv)
    if args.compile_cache is not None:
        raise ValueError(COMPILE_CACHE_REFUSAL)

    names = list(DEFAULT_ARMS)
    if args.arms:
        adds = [a[1:] for a in args.arms.split(",") if a.startswith("+")]
        picks = [a for a in args.arms.split(",") if not a.startswith("+")]
        if picks:
            names = picks
        names += [a for a in adds if a not in names]
    unknown = [a for a in names if a not in ARMS]
    if unknown:
        ap.error(f"unknown arms {unknown}; known: {sorted(ARMS)}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = []
    with open(args.out, "a") as f:
        for name in names:
            log(f"=== arm {name}: {ARMS[name] or 'shipping config'}")
            rec = {"arm": name, "overrides": ARMS[name]}
            if args.dryrun:
                rec["dryrun"] = True
            try:
                rec["result"] = bench_gpt2.run(
                    n_rounds=args.rounds, dryrun=args.dryrun,
                    device=args.device, **ARMS[name])
            except Exception as e:
                log(traceback.format_exc())
                rec["error"] = f"{type(e).__name__}: {e}"
            _write(f, rec)
            results.append(rec)
        if args.ledger_ab:
            log("=== ledger_ab: the cohort's memory, fused encode on and off")
            rec = {"arm": "ledger_ab"}
            if args.dryrun:
                rec["dryrun"] = True
            try:
                rec["result"] = bench_gpt2.ledger_ab(dryrun=args.dryrun,
                                                     device=args.device)
            except Exception as e:
                log(traceback.format_exc())
                rec["error"] = f"{type(e).__name__}: {e}"
            _write(f, rec)

    ok = [r for r in results if r.get("result", {}).get("mfu") is not None]
    if ok:
        best = max(ok, key=lambda r: r["result"]["mfu"])
        print(json.dumps({
            "metric": "gpt2_mfu_sweep_best",
            "arm": best["arm"],
            "mfu": best["result"]["mfu"],
            "tok_per_s": best["result"]["value"],
            "target_0.40_met": best["result"]["mfu"] >= 0.40,
            "arms_run": len(results),
        }))
        return 0
    print(json.dumps({"metric": "gpt2_mfu_sweep_best", "error":
                      "no arm produced an MFU", "arms_run": len(results)}))
    return 1


if __name__ == "__main__":
    sys.exit(main())
