"""Lint telemetry streams against the schema: the PyTorch port's
counterpart of the JAX package's ``scripts/check_telemetry_schema.py``.

Validates every ``telemetry.jsonl`` under the given roots (default:
``runs/``) with ``commefficient_torch.telemetry.schema``, the code the
port's writers and tests run, so a stream that drifts from the documented
schema fails instead of silently rotting.

Usage:
    python -m commefficient_torch.scripts.check_telemetry_schema [root ...]
    python -m commefficient_torch.scripts.check_telemetry_schema path/to/telemetry.jsonl
    python -m commefficient_torch.scripts.check_telemetry_schema --selftest

``--selftest`` generates a sample stream containing one event of EVERY
schema type (signals, collectives, span and utilization included) and
validates it: the cheap proof that the generator vocabulary and the
validator vocabulary have not drifted apart.

Exit status: 0 when every stream found is valid (or none exist),
1 when any stream has problems, 2 on usage errors. The verdicts and
problem lines are the JAX script's on the same inputs.
"""

from __future__ import annotations

import json
import os
import sys

from commefficient_torch.telemetry.schema import (EVENT_FIELDS,
                                                  SCHEMA_VERSION,
                                                  TELEMETRY_BASENAME,
                                                  validate_file,
                                                  validate_lines)

# minimal valid value per predicate-shaped field, keyed by the exact
# field name where a generic fill would be wrong
_SAMPLE_OVERRIDES = {
    "schema": SCHEMA_VERSION,
    "devices": [{"id": 0, "kind": "cpu", "stats": None}],
    "ops": [{"kind": "all-reduce", "n_elements": 192, "dtype": "f32",
             "bytes": 768, "combined_in": 0}],
    "counts": {"all-reduce": 1},
    # schema-v9 quantized-wire fields (collectives/signals/bench): one
    # realistic int8 arm — the table-reduce wire at ~0.27x of f32
    "wire_dtype": "int8",
    "table_reduce_bytes": 1428.0,
    "client_download_bytes": [4.0],
    "client_upload_bytes": [4.0],
    # schema-v10 layer_signals: one realistic coarse attribution — a
    # norm-bias group holding gradient mass but winning none of k (the
    # starvation signature), hh_overlap null where no winner landed
    "signal_groups": "coarse",
    "groups": ["embed", "h0/attn", "h0/norm-bias", "head"],
    "sizes": [16704, 12288, 384, 650],
    "grad_mass": [3.1, 5.4, 0.9, 1.2],
    "update_mass": [1.0, 2.4, 0.0, 0.4],
    "topk_count": [2.0, 5.0, 0.0, 1.0],
    "error_mass": [0.4, 0.9, 2.8, 0.2],
    "hh_overlap": [1.0, 0.8, None, 1.0],
    "spans": [{"name": "data_fetch", "ts": 0.0, "dur_s": 0.01,
               "tid": 0, "depth": 0},
              {"name": "round_dispatch", "ts": 0.01, "dur_s": 0.02,
               "tid": 0, "depth": 1}],
    "flops_source": "cost_analysis",
    # schema-v6 roofline enrichment of the utilization event: one
    # realistic bandwidth-bound window (AI below the v5e ridge)
    "bytes_source": "cost_analysis",
    "bound": "bandwidth",
    "peak_hbm_gbps": 819.0,
    "bytes_per_round": 4.0e9,
    "arithmetic_intensity": 55.0,
    "ridge_intensity": 240.5,
    "achieved_gbps": 500.0,
    "bw_frac": 0.61,
    "expected_round_s": 0.0049,
    # schema-v7 mesh-topology fields of the utilization event (the
    # scaling-curve harness's per-chip normalization inputs)
    "n_devices": 8,
    "mesh_shape": [8],
    # schema-v6 residency enrichment of the memory event (a healthy
    # snapshot with headroom) — null on CPU streams, see memory_ledger
    "live_bytes": 9.0e9,
    "peak_bytes": 1.1e10,
    "delta_peak_bytes": 2.0e8,
    "fragmentation_bytes": 2.0e9,
    "limit_bytes": 1.6e10,
    "headroom_frac": 0.3125,
    # memory_ledger: one realistic executable inventory (temp carrying
    # a dense-gradient-sized buffer, the committed sketch-round shape)
    "temp_bytes": 2.9e9,
    "argument_bytes": 1.2e9,
    "output_bytes": 1.2e9,
    "alias_bytes": 1.1e9,
    "generated_code_bytes": 4.0e6,
    "total_bytes": 5.3e9,
    # client_stats: one realistic per-stat quantile record (ordered
    # quantiles, a null not-applicable stat) + participation fields
    "quantiles": {
        "loss": {"p5": 0.5, "p25": 0.8, "p50": 1.0, "p75": 1.3,
                 "p95": 1.9, "max": 2.0, "mean": 1.1,
                 "argmax_client": 3},
        "grad_norm_pre": {"p5": None, "p25": None, "p50": None,
                          "p75": None, "p95": None, "max": None,
                          "mean": None, "argmax_client": None},
    },
    "coverage": 0.5,
    "distinct_clients": 4,
    "counts_p50": 8.0,
    "counts_max": 16.0,
    "staleness_p50": 1.0,
    "staleness_max": 3.0,
    # async_round: one realistic schema-v4 commit (two merged cohorts,
    # one of them a commit stale, poly-discounted; device fields set as
    # a record-cadence event would carry them)
    "cohorts": [11, 12],
    "staleness_mean": 0.5,
    "staleness_max": 1.0,
    "discount_mean": 0.9,
    "discount_min": 0.8165,
    "buffer_n": 14.0,
    "partial": False,
    "update_norm": 0.25,
    "error_norm": 1.5,
    "velocity_norm": 0.75,
    # defense: one schema-v5 robustness record (a normclip run absorbing
    # a scale attack, one client benched)
    "defense": "normclip",
    "adversary": "scale",
    "nonfinite_action": "quarantine",
    "clip_frac": 0.25,
    "clip_thresh": 42.0,
    "clipped_mass": 1043.0,
    "trim_frac": None,
    "nonfinite_clients": 1.0,
    "quarantined": 1,
    "ejected": 0,
    "quarantine_ids_digest": "1:c1dfd96eea8c",
    "injected": {"scale": 1},
    # manifest: schema-v8 segment id (crash-recovery lineage)
    "stream_id": "cv_train-1234-18c2a9f0e01",
    # fault/resume: one realistic graceful-preemption record + the
    # resumed segment's lineage (schema v8, core/preempt.py)
    "kind": "preempt",
    "signal": "SIGTERM",
    "grace_s": 4.2,
    "detail": None,
    "checkpoint": "./checkpoint/ResNet9/ckpt_000002_r000005_preempt",
    "prior_stream": "cv_train-1200-18c2a9e77b3",
    "prior_events": 412,
    # population (schema v11): one realistic sketch-estimated summary —
    # half the registered fleet seen, the three heavy-hitter tables as
    # [id, count] pairs, the count-min (eps, delta) the counts carry
    # (telemetry/population.py; `estimated` also rides client_stats)
    "estimated": True,
    "registered": 16,
    "distinct": 8.0,
    "counts_p95": 14.0,
    "staleness_p95": 2.0,
    "obs_count_p50": 8.0,
    "obs_count_p95": 12.0,
    "gap_p50": 2.0,
    "gap_p95": 4.0,
    "top_sampled": [[3, 9], [7, 8]],
    "top_loss": [[3, 4]],
    "top_strikes": [],
    "memory_bytes": 3468800.0,
    "cm_epsilon": 4.15e-05,
    "cm_delta": 0.0183,
    "hh_k": 256,
    "sample_size": 4096,
    # alert: a fired statistical rule
    "rule": "loss_spike",
    "severity": "warn",
    "metric": "round.loss",
    "zscore": 8.5,
    "median": 1.0,
    "mad": 0.1,
    "window": 32,
    "action": "log",
}


def _sample_value(field, pred):
    if field in _SAMPLE_OVERRIDES:
        return _SAMPLE_OVERRIDES[field]
    name = pred.__name__
    return {"_int": 1, "_num": 1.0, "_opt_num": 1.0, "_str": "x",
            "_bool": False, "_dict": {}, "_opt_dict": None,
            "_list": [], "_opt_list": []}.get(name, None)


def sample_stream():
    """One well-formed JSONL line per schema event type, manifest first,
    summary last, contiguous seq — a synthetic but schema-complete run."""
    order = (["manifest"]
             + [k for k in EVENT_FIELDS if k not in ("manifest", "summary")]
             + ["summary"])
    lines = []
    for seq, kind in enumerate(order):
        ev = {"event": kind, "t": float(seq), "seq": seq}
        for field, pred in EVENT_FIELDS[kind].items():
            ev[field] = _sample_value(field, pred)
        lines.append(json.dumps(ev))
    return lines


def find_streams(roots):
    for root in roots:
        if os.path.isfile(root):
            yield root
            continue
        for dirpath, _, filenames in os.walk(root):
            for fn in filenames:
                if fn == TELEMETRY_BASENAME:
                    yield os.path.join(dirpath, fn)


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    selftest = "--selftest" in args
    if selftest:
        # the flag composes with roots in any order; run it first and
        # keep linting whatever paths remain
        args = [a for a in args if a != "--selftest"]
        problems = validate_lines(sample_stream())
        for lineno, problem in problems:
            print(f"selftest line {lineno}: {problem}")
        print(f"selftest: {len(EVENT_FIELDS)} event types "
              f"{'INVALID' if problems else 'ok'}")
        if problems:
            return 1
        if not args:
            return 0
    roots = args or ["runs"]
    for root in roots:
        if not os.path.exists(root):
            print(f"check_telemetry_schema: {root} does not exist",
                  file=sys.stderr)
            return 2
    n_checked = n_bad = 0
    for path in sorted(find_streams(roots)):
        n_checked += 1
        problems = validate_file(path)
        if problems:
            n_bad += 1
            print(f"INVALID {path}:")
            for lineno, problem in problems[:20]:
                print(f"  line {lineno}: {problem}")
            if len(problems) > 20:
                print(f"  ... and {len(problems) - 20} more")
        else:
            print(f"ok      {path}")
    print(f"{n_checked} stream(s) checked, {n_bad} invalid")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
