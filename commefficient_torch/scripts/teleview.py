"""teleview: offline analyzer for ``telemetry.jsonl`` streams, the PyTorch
port's counterpart of the JAX package's ``scripts/teleview.py`` (the
same subcommands, output and exit codes).

BENCH/MULTICHIP comparisons have been manual JSON spelunking — ``jq``
one-liners against artifacts whose schema only the writers knew. This
CLI reads one stream (``summarize``/``alerts``/``clients``/
``layers``), two (``diff``), or renders one into a timeline
(``timeline``):

    python -m commefficient_torch.scripts.teleview summarize runs/x/telemetry.jsonl
    python -m commefficient_torch.scripts.teleview alerts runs/x/telemetry.jsonl
    python -m commefficient_torch.scripts.teleview clients runs/x/telemetry.jsonl
    python -m commefficient_torch.scripts.teleview population runs/x/telemetry.jsonl
    python -m commefficient_torch.scripts.teleview layers runs/x/telemetry.jsonl
    python -m commefficient_torch.scripts.teleview memory runs/x/telemetry.jsonl
    python -m commefficient_torch.scripts.teleview trend .
    python -m commefficient_torch.scripts.teleview diff old/telemetry.jsonl new/telemetry.jsonl
    python -m commefficient_torch.scripts.teleview timeline runs/x/telemetry.jsonl -o trace.json

``population`` (schema v11) renders the population-scale participation
stream (``population`` events, telemetry/population.py): the coverage/
distinct trajectory, sample-count and staleness quantiles, the three
heavy-hitter tables, the ledger's memory footprint and — on
sketch-estimated streams — the count-min (eps, delta) bounds the
estimates carry. ``trend`` tabulates the repo's ``BENCH_r*.json``
benchmark checkpoints (img/s, MFU, the saturated and gpt2 arms, wire
bytes, warmup seconds), tolerating every vintage's missing fields.

``layers`` (schema v10) renders the layer-wise compression attribution
stream (``layer_signals`` events, telemetry/layer_signals.py): the
per-group table — coordinate/gradient/update/EF mass shares, top-k win
share, heavy-hitter overlap, STARVED verdicts at the monitor rule's
thresholds — and the per-group win-share trend.

``memory`` (schema v6) renders the per-executable byte inventory
(``memory_ledger`` events), the residency timeline (enriched ``memory``
events: live/peak/fragmentation/headroom per phase) and the roofline
table (arithmetic intensity, ridge, compute-vs-bandwidth bound verdict
per ``utilization`` window); ``timeline`` adds hbm_live/peak_gib
counter tracks from the same snapshots.

``summarize`` prints the manifest header, compile/collective inventory
(per watched executable: launch counts by kind, payload bytes), a
sampled round table, per-signal trends (first/last/min/max of every
signals.py key), the MFU/starvation line from the ``utilization``
events, alert/abort lines, and the epoch table.

``alerts`` lists every ``alert`` event (rule, severity, metric, value,
robust z) plus the nan_abort, and exits 1 when any critical alert (or
abort) is present — the postmortem triage entry point for a stream a
crashed run left behind. ``clients`` renders the ``client_stats``
population trends: per-stat p50/p95/max first->last, participation
coverage/staleness, and the clients that most often owned the round
maximum. Both run torch-free, and both tolerate the truncated trailing
line a crashed writer leaves (see ``load_events``).

``timeline`` renders the ``span`` event stream (telemetry/tracing.py)
into a perfetto / chrome-tracing ``trace.json`` — complete ("X") slice
events per span, plus counter ("C") tracks for MFU, input-wait
fraction, round loss, and (schema v9) the per-executable table-reduce
wire: modeled ICI bytes (``table_reduce_bytes:<name>``) and the wire
dtype's bytes/cell (``wire_dtype_bytes:<name>``) — a quantized wire
silently re-widening shows as a step in the timeline. Open it at
https://ui.perfetto.dev or chrome://tracing.

``diff`` compares two runs and EXITS NONZERO on regression:
- any collective launch-count increase for a watched executable (the
  round-5 32x all_to_all unroll class — count growth is never benign),
  or payload-byte growth beyond ``--bytes_ratio``;
- a final signal norm (error/velocity/update/grad) growing beyond
  ``--signal_ratio``x (sketch-EF divergence shows here rounds before
  the loss goes non-finite), or topk_overlap dropping by more than
  ``--overlap_drop``;
- the final round/epoch loss growing beyond ``--loss_ratio``x;
- MFU dropping more than ``--mfu_drop`` (relative) or the input-wait
  starvation fraction rising more than ``--input_wait_rise`` (absolute),
  from the last ``utilization`` event of each run — the round-pipeline
  regression gate, exercised with its default threshold by
  ``__graft_entry__.dryrun_multichip``;
- on schema-v10 streams, the LAYER starvation gap (max over groups
  above the grad-mass floor of mass share minus top-k win share, final
  ``layer_signals`` event) rising more than ``--starvation_rise``
  (absolute) — a parameter group losing the top-k race it used to win
  (pre-v10 that spelling aliased ``--input_wait_rise``);
- on async buffered-aggregation streams (schema v4), the final
  ``async_round`` staleness_mean rising more than ``--staleness_rise``
  (absolute, commits-stale units), or its post-commit error_norm
  growing beyond ``--signal_ratio``x (staleness-induced EF divergence);
- on schema-v6 streams, a watched executable's ``memory_ledger`` temp
  bytes growing beyond ``--temp_bytes_growth``x (the de-fusion /
  re-materialization regression class), or the final ``utilization``
  ``bw_frac`` dropping more than ``--bw_frac_drop`` (absolute);
- on schema-v11 streams, the final ``population`` coverage dropping
  more than ``--coverage_stall`` (absolute), or the candidate stream
  ending in a distinct-coverage stall (no new distinct participants for
  COVERAGE_STALL_WINDOW records below saturation) the baseline does not
  show — the sampler-reach regression class;
- PER-CHIP throughput (the weak-scaling contract,
  scripts/scaling_curves.py): the last ``bench`` event carrying
  ``result.per_chip_items_per_s`` dropping more than ``--perchip_drop``
  (relative) against the baseline stream — on a weak-scaling sweep the
  baseline is the smallest mesh's arm, so a sharding regression that
  taxes every added chip fails the diff.

Dependency-free (json + argparse), validates nothing itself — run
``python -m commefficient_torch.scripts.check_telemetry_schema`` for
schema enforcement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

try:
    # single source of truth when the port is importable...
    from commefficient_torch.telemetry.clients import CLIENT_STAT_KEYS
    from commefficient_torch.telemetry.health import COVERAGE_STALL_WINDOW
    from commefficient_torch.telemetry.layer_signals import (
        LAYER_SIGNAL_KEYS, STARVATION_MASS_SHARE, STARVATION_WIN_SHARE,
        starved_groups)
    from commefficient_torch.telemetry.memory_ledger import (
        MEMORY_KEYS, MEMORY_LEDGER_KEYS)
    from commefficient_torch.telemetry.population import POPULATION_KEYS
    from commefficient_torch.telemetry.schema import TELEMETRY_BASENAME
    from commefficient_torch.telemetry.signals import SIGNAL_KEYS
    from commefficient_torch.telemetry.utilization import ROOFLINE_KEYS
except ImportError:
    # ...but the analyzer must work on a machine WITHOUT torch (analyzing
    # a downloaded artifact is the whole point of an offline tool, and
    # the telemetry package import pulls torch in). These literals mirror
    # the canonical values; tests/test_torch_scripts.py pins them against
    # the port's package.
    TELEMETRY_BASENAME = "telemetry.jsonl"
    SIGNAL_KEYS = (
        "grad_norm", "grad_true_norm", "grad_l2estimate",
        "velocity_norm", "error_norm", "error_l2estimate",
        "update_norm", "support_density", "topk_overlap",
    )
    CLIENT_STAT_KEYS = (
        "loss", "grad_norm_pre", "grad_norm_post", "clip_frac",
        "tx_norm", "upload_bytes", "download_bytes",
    )
    MEMORY_KEYS = (
        "live_bytes", "peak_bytes", "delta_peak_bytes",
        "fragmentation_bytes", "limit_bytes", "headroom_frac",
    )
    MEMORY_LEDGER_KEYS = (
        "temp_bytes", "argument_bytes", "output_bytes", "alias_bytes",
        "generated_code_bytes", "total_bytes",
    )
    ROOFLINE_KEYS = (
        "peak_hbm_gbps", "bytes_per_round", "bytes_source",
        "arithmetic_intensity", "ridge_intensity", "bound",
        "achieved_gbps", "bw_frac", "expected_round_s",
    )
    LAYER_SIGNAL_KEYS = (
        "grad_mass", "update_mass", "topk_count", "error_mass",
        "hh_overlap",
    )
    STARVATION_MASS_SHARE = 0.05
    STARVATION_WIN_SHARE = 0.02
    # population event fields (schema v11, telemetry/population.py) and
    # the coverage-stall window the monitor rule fires on — literal
    # twins pinned against the port by tests/test_torch_scripts.py
    POPULATION_KEYS = (
        "round", "estimated", "registered", "distinct", "coverage",
        "counts_p50", "counts_p95", "counts_max",
        "staleness_p50", "staleness_p95", "staleness_max",
        "obs_count_p50", "obs_count_p95", "gap_p50", "gap_p95",
        "top_sampled", "top_loss", "top_strikes",
        "memory_bytes", "cm_epsilon", "cm_delta", "hh_k", "sample_size",
    )
    COVERAGE_STALL_WINDOW = 5

    def starved_groups(groups, grad_mass, topk_count,
                       mass_share=STARVATION_MASS_SHARE,
                       win_share=STARVATION_WIN_SHARE):
        # literal twin of layer_signals.starved_groups (pinned against
        # the port by tests/test_torch_scripts.py): groups holding
        # > mass_share of the gradient energy but winning < win_share
        # of the top-k coordinates. Empty when grad_mass is null.
        if not grad_mass or not topk_count:
            return []
        gm = [v if isinstance(v, (int, float)) else 0.0
              for v in grad_mass]
        tc = [v if isinstance(v, (int, float)) else 0.0
              for v in topk_count]
        tm, tk = sum(gm), sum(tc)
        if tm <= 0 or tk <= 0:
            return []
        return [(str(g), gm[i] / tm, tc[i] / tk)
                for i, g in enumerate(groups)
                if gm[i] / tm > mass_share and tc[i] / tk < win_share]

NORM_KEYS = ("grad_norm", "grad_true_norm", "grad_l2estimate",
             "velocity_norm", "error_norm", "error_l2estimate",
             "update_norm")

# async_round fields the analyzer reads (schema v4, core/async_agg.py).
# Literal on purpose — this tool must run torch-free;
# tests/test_torch_scripts.py pins these names against
# telemetry/schema.EVENT_FIELDS["async_round"].
ASYNC_ROUND_KEYS = ("staleness_mean", "staleness_max", "discount_mean",
                    "discount_min", "error_norm", "loss", "n_cohorts",
                    "partial")

# defense fields the analyzer reads (schema v5, core/runtime.py +
# core/quarantine.py). Same torch-free literal pattern;
# tests/test_torch_scripts.py pins these names against
# telemetry/schema.EVENT_FIELDS["defense"].
DEFENSE_KEYS = ("clip_frac", "clip_thresh", "clipped_mass", "trim_frac",
                "nonfinite_clients", "quarantined", "ejected")


def load_events(path: str) -> List[Dict[str, Any]]:
    if os.path.isdir(path):
        path = os.path.join(path, TELEMETRY_BASENAME)
    events = []
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    while lines and not lines[-1]:
        lines.pop()
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            # a crashed run's stream legitimately ends mid-write: the
            # analyzer's whole job is reading exactly those streams, so
            # a truncated TRAILING line is a note, not an error (a bad
            # line mid-stream is still skipped — the schema linter
            # flags it; keep reading either way)
            if i == len(lines) - 1:
                print(f"note: {os.path.basename(path)} ends in a "
                      "truncated line (crashed run?) — ignored",
                      file=sys.stderr)
            continue
        if isinstance(obj, dict):
            events.append(obj)
    return events


def by_kind(events, kind):
    return [e for e in events if e.get("event") == kind]


def latest_collectives(events) -> Dict[str, Dict[str, Any]]:
    """name -> the LAST collectives event per watched executable (a
    recompile re-emits; the last one is the executable that ran)."""
    out: Dict[str, Dict[str, Any]] = {}
    for e in by_kind(events, "collectives"):
        out[str(e.get("name"))] = e
    return out


def latest_memory_ledgers(events) -> Dict[str, Dict[str, Any]]:
    """name -> the LAST memory_ledger event per watched executable
    (schema v6) — same recompile-overwrites semantics as collectives."""
    out: Dict[str, Dict[str, Any]] = {}
    for e in by_kind(events, "memory_ledger"):
        out[str(e.get("name"))] = e
    return out


def _gib(v) -> str:
    return f"{v / 2**30:.3f} GiB" if isinstance(v, (int, float)) else "-"


def _fin(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) else None


# ------------------------------------------------------------------ summarize


def summarize(events: List[Dict[str, Any]], label: str = "") -> None:
    man = next(iter(by_kind(events, "manifest")), {})
    cfgd = man.get("config") or {}
    print(f"== {label or 'run'}: {man.get('run_type', '?')} on "
          f"{man.get('device_count', '?')}x {man.get('device_kind', '?')} "
          f"({man.get('backend', '?')}, jax {man.get('jax_version', '?')})")
    sk = man.get("sketch")
    print(f"   mode={cfgd.get('mode', '?')} grad_size={man.get('grad_size')}"
          + (f" sketch={sk['impl']} {sk['num_rows']}x{sk['num_cols']} "
             f"k={sk['k']} ef={sk['ef']}"
             + (f" wire={sk['wire_dtype']}"
                if sk.get("wire_dtype") not in (None, "float32") else "")
             if sk else ""))

    comps = by_kind(events, "compile")
    if comps:
        print("-- compiles")
        for e in comps:
            print(f"   {e['name']}: #{e['n_compiles']} "
                  f"lower {e['lower_s']:.2f}s compile {e['compile_s']:.2f}s"
                  + (f" flops {e['flops']:.3g}" if e.get("flops") else "")
                  + (" FALLBACK" if e.get("fallback") else ""))

    colls = latest_collectives(events)
    if colls:
        print("-- collectives (per compiled executable)")
        for name, e in sorted(colls.items()):
            counts = e.get("counts") or {}
            inv = " ".join(f"{k}x{v}" for k, v in sorted(counts.items()))
            print(f"   {name}: {e.get('n_collectives', 0)} launches"
                  f" [{inv or 'none'}] payload "
                  f"{(e.get('total_bytes') or 0) / 1024:.1f} KiB")

    rounds = by_kind(events, "round")
    if rounds:
        losses = [_fin(e.get("loss")) for e in rounds]
        fin = [l for l in losses if l is not None]
        print(f"-- rounds: {len(rounds)} records, loss "
              f"first {fin[0]:.4f} last {fin[-1]:.4f} min {min(fin):.4f}"
              if fin else f"-- rounds: {len(rounds)} records (no finite loss)")
        step = max(1, len(rounds) // 8)
        for e in rounds[::step]:
            print(f"   r{e['round']:>6} ep{e['epoch']:>3} "
                  f"lr {e['lr']:.4f} loss "
                  + (f"{e['loss']:.4f}" if _fin(e.get("loss")) is not None
                     else "NaN")
                  + f" host {e['host_s']*1e3:.0f}ms dev "
                    f"{e['device_s']*1e3:.0f}ms")

    utils = by_kind(events, "utilization")
    if utils:
        u = utils[-1]
        mfu = _fin(u.get("mfu"))
        ach = _fin(u.get("achieved_flops"))
        peak = _fin(u.get("peak_flops"))
        wait = _fin(u.get("input_wait_frac"))
        spread = _fin(u.get("straggler_spread"))
        line = (f"-- utilization ({len(utils)} windows, last: "
                f"{u.get('rounds', '?')} rounds on "
                f"{u.get('device_kind', '?')}): ")
        line += f"mfu {mfu:.3g}" if mfu is not None else "mfu n/a"
        if ach is not None:
            line += f", {ach / 1e12:.2f} TFLOP/s"
            if peak:
                line += f" of {peak / 1e12:.0f} peak"
        if wait is not None:
            line += f", input wait {wait * 100:.1f}%"
        if spread is not None:
            line += f", straggler spread {spread:.3f}"
        bound = u.get("bound")
        bw = _fin(u.get("bw_frac"))
        if bound is not None:
            line += f", {bound}-bound"
            if bw is not None:
                line += f" (bw {bw * 100:.1f}% of peak)"
        print(line)

    sigs = by_kind(events, "signals")
    if sigs:
        print(f"-- signals: {len(sigs)} records")
        for key in SIGNAL_KEYS:
            vals = [_fin(e.get(key)) for e in sigs]
            vals = [v for v in vals if v is not None]
            if not vals:
                continue
            print(f"   {key:18s} first {vals[0]:11.5g} last {vals[-1]:11.5g}"
                  f" min {min(vals):11.5g} max {max(vals):11.5g}")

    lsigs = by_kind(events, "layer_signals")
    if lsigs:
        last = lsigs[-1]
        groups = last.get("groups") or []
        sv = starved_groups(groups, last.get("grad_mass"),
                            last.get("topk_count"))
        print(f"-- layers: {len(lsigs)} records, {len(groups)} "
              f"{last.get('signal_groups', '?')} groups"
              + (f"; STARVED last round: "
                 + " ".join(f"{g}({ms * 100:.1f}% mass, "
                            f"{ws * 100:.2f}% of k)" for g, ms, ws in sv)
                 if sv else "; no starved group last round")
              + " (run `teleview layers` for the table)")

    asyncs = by_kind(events, "async_round")
    if asyncs:
        # the staleness line: commits, merged-cohort staleness trend,
        # discount floor, partial flushes — the async-aggregation health
        # summary (schema v4, core/async_agg.py)
        sm = [_fin(e.get("staleness_mean")) for e in asyncs]
        sm = [v for v in sm if v is not None]
        smax = max((_fin(e.get("staleness_max")) or 0.0) for e in asyncs)
        dmin = min((_fin(e.get("discount_min")) or 1.0) for e in asyncs)
        n_partial = sum(1 for e in asyncs if e.get("partial"))
        errs = [_fin(e.get("error_norm")) for e in asyncs]
        errs = [v for v in errs if v is not None]
        line = (f"-- async: {len(asyncs)} commits, staleness mean "
                f"{sm[0]:.2f} -> {sm[-1]:.2f} (max {smax:.0f}), "
                f"discount floor {dmin:.3f}, {n_partial} partial flush"
                + ("es" if n_partial != 1 else ""))
        if errs:
            line += f"; error_norm first {errs[0]:.5g} last {errs[-1]:.5g}"
        print(line)

    defs = by_kind(events, "defense")
    if defs:
        # robustness line: what the defense did over the run (schema v5)
        last = defs[-1]
        cf = [_fin(e.get("clip_frac")) for e in defs]
        cf = [v for v in cf if v is not None]
        nfc = sum(_fin(e.get("nonfinite_clients")) or 0.0 for e in defs)
        line = (f"-- defense: {len(defs)} records, "
                f"{last.get('defense', '?')}"
                + (f" vs adversary={last.get('adversary')}"
                   if last.get("adversary") not in (None, "none") else ""))
        if cf:
            line += (f", clip_frac mean {sum(cf) / len(cf):.3f} "
                     f"max {max(cf):.3f}")
        line += (f"; nonfinite clients {nfc:.0f} total, "
                 f"quarantined {last.get('quarantined', 0)} "
                 f"ejected {last.get('ejected', 0)}")
        print(line)

    epochs = by_kind(events, "epoch")
    if epochs:
        print("-- epochs")

        def fmt(v, spec=".4f"):
            # loss/acc fields are nullable (non-finite serializes as null)
            return format(v, spec) if _fin(v) is not None else "NaN"

        for e in epochs:
            print(f"   ep{e['epoch']:>3} train {fmt(e['train_loss'])}/"
                  f"{fmt(e['train_acc'])} test {fmt(e['test_loss'])}/"
                  f"{fmt(e['test_acc'])} up {fmt(e['upload_mib'], '.0f')}"
                  " MiB")

    cstats = by_kind(events, "client_stats")
    if cstats:
        c = cstats[-1]
        q = (c.get("quantiles") or {}).get("loss") or {}
        spread = (q["p95"] - q["p5"]
                  if _fin(q.get("p95")) is not None
                  and _fin(q.get("p5")) is not None else None)
        print(f"-- clients: {len(cstats)} records, coverage "
              f"{c.get('coverage', 0) * 100:.1f}% "
              f"({c.get('distinct_clients', '?')} seen), last loss "
              f"p50 {q.get('p50')} spread(p95-p5) "
              + (f"{spread:.4g}" if spread is not None else "n/a"))

    pops = by_kind(events, "population")
    if pops:
        p = pops[-1]
        dist = _fin(p.get("distinct"))
        mem = _fin(p.get("memory_bytes"))
        print(f"-- population: {len(pops)} records, "
              f"{'SKETCH' if p.get('estimated') else 'exact'} ledger, "
              f"coverage {(_fin(p.get('coverage')) or 0) * 100:.1f}%"
              + (f" ({dist:.0f} distinct~)" if dist is not None else "")
              + (f", {mem / 2**20:.1f} MiB" if mem is not None else "")
              + " (run `teleview population` for the tables)")

    als = by_kind(events, "alert")
    if als:
        worst = max(als, key=lambda e: ("info", "warn", "critical").index(
            e.get("severity", "info")))
        print(f"-- alerts: {len(als)} fired, worst "
              f"[{worst.get('severity')}] {worst.get('rule')} at round "
              f"{worst.get('round')} (run `teleview alerts` for the list)")

    # crash-recovery lineage (schema v8): a resumed run APPENDS to its
    # predecessor's stream — each manifest opens a segment, each
    # `resume` names the segment it continues and the checkpoint/round
    # it restored, each `fault` names what interrupted a segment
    mans = by_kind(events, "manifest")
    resumes = by_kind(events, "resume")
    fts = by_kind(events, "fault")
    if len(mans) > 1 or resumes or fts:
        seg = f"{len(mans)} segment" + ("s" if len(mans) != 1 else "")
        print(f"-- lineage: {seg} stitched in one stream")
        for e in resumes:
            src = e.get("checkpoint") or "no checkpoint (stream only)"
            print(f"   resume at round {e.get('round')}"
                  + (f" epoch {e.get('epoch')}"
                     if e.get("epoch") is not None else "")
                  + f" from {src}"
                  + (f" (continues segment {e['prior_stream']}, "
                     f"{e.get('prior_events')} events)"
                     if e.get("prior_stream") else ""))
        for e in fts:
            print(f"   fault [{e.get('kind')}] at round {e.get('round')}"
                  + (f" signal {e['signal']}" if e.get("signal") else "")
                  + (f" grace {e['grace_s']}s"
                     if e.get("grace_s") is not None else "")
                  + (f": {e['detail']}" if e.get("detail") else ""))

    # the LAST summary is the lineage's final verdict (earlier segments
    # that drained gracefully wrote their own aborted footers)
    summs = by_kind(events, "summary")
    summ = summs[-1] if summs else None
    if summ is None:
        print("-- NO summary footer: the run DIED before finishing")
    else:
        print(f"-- summary: {'ABORTED' if summ['aborted'] else 'ok'}, "
              f"{summ['n_rounds']} rounds, {summ['wall_time_s']:.1f}s wall")
    for e in by_kind(events, "nan_abort"):
        print(f"   nan_abort at round {e['nan_round']}: {e['reason']}")


# -------------------------------------------------------------------- alerts


def alerts(events: List[Dict[str, Any]]) -> int:
    """Postmortem triage: every alert in firing order, rule counts, the
    nan_abort line. Exit 1 when anything critical (or an abort) fired —
    scriptable as a health gate over a finished run's stream."""
    als = by_kind(events, "alert")
    aborts = by_kind(events, "nan_abort")
    fts = by_kind(events, "fault")
    for e in fts:
        # faults are context, not verdicts: a graceful preempt or a
        # recovered fetch retry must not trip the health gate (a
        # round_stall also fired its own critical alert, counted below)
        print(f"   r{e.get('round', '?'):>6} [fault   ] "
              f"{e.get('kind', '?'):24s}"
              + (f" signal={e['signal']}" if e.get("signal") else "")
              + (f" {e['detail']}" if e.get("detail") else ""))
    if not als and not aborts:
        print("no alerts (and no nan_abort) in the stream"
              + (f" ({len(fts)} fault record(s) above)" if fts else ""))
        return 0
    counts: Dict[str, int] = {}
    for e in als:
        counts[str(e.get("rule"))] = counts.get(str(e.get("rule")), 0) + 1
        z = _fin(e.get("zscore"))
        print(f"   r{e.get('round', '?'):>6} [{e.get('severity', '?'):8s}] "
              f"{e.get('rule', '?'):24s} {e.get('metric', '?')}"
              f"={e.get('value')}"
              + (f" z {z:+.1f}" if z is not None else "")
              + f" action={e.get('action', '?')}")
    for e in aborts:
        print(f"   nan_abort at round {e['nan_round']}: {e['reason']}")
    if counts:
        print("-- rule counts: "
              + " ".join(f"{k}x{v}" for k, v in sorted(counts.items())))
    critical = (any(e.get("severity") == "critical" for e in als)
                or bool(aborts))
    print(f"-- {'CRITICAL' if critical else 'no critical alerts'}")
    return 1 if critical else 0


# ------------------------------------------------------------------- clients


def clients(events: List[Dict[str, Any]]) -> int:
    """Per-client population trends from the ``client_stats`` stream:
    p50/p95/max of every stat first->last, the participation ledger
    trajectory, and the most frequent argmax (round-maximum) clients."""
    cstats = by_kind(events, "client_stats")
    if not cstats:
        print("no client_stats events (pre-PR-4 stream, or "
              "--no_client_stats)")
        return 0
    first, last = cstats[0], cstats[-1]
    print(f"== client population: {len(cstats)} records, "
          f"{last.get('n_participants', '?')} participants/round")
    print(f"-- coverage {first.get('coverage', 0) * 100:.1f}% -> "
          f"{last.get('coverage', 0) * 100:.1f}% "
          f"({last.get('distinct_clients', '?')} distinct); staleness "
          f"p50 {last.get('staleness_p50')} max {last.get('staleness_max')}"
          f"; samples/client p50 {last.get('counts_p50')} "
          f"max {last.get('counts_max')}")
    print("-- per-client stat quantiles (first -> last)")
    for key in CLIENT_STAT_KEYS:
        qf = (first.get("quantiles") or {}).get(key) or {}
        ql = (last.get("quantiles") or {}).get(key) or {}
        if _fin(ql.get("p50")) is None and _fin(qf.get("p50")) is None:
            continue

        def fmt(q):
            vals = [q.get(f) for f in ("p50", "p95", "max")]
            return "/".join(f"{v:.4g}" if _fin(v) is not None else "-"
                            for v in vals)

        print(f"   {key:18s} p50/p95/max {fmt(qf)} -> {fmt(ql)}")
    owners: Dict[int, int] = {}
    for e in cstats:
        c = ((e.get("quantiles") or {}).get("loss") or {}).get(
            "argmax_client")
        if isinstance(c, int):
            owners[c] = owners.get(c, 0) + 1
    if owners:
        top = sorted(owners.items(), key=lambda kv: -kv[1])[:5]
        print("-- clients most often owning the round's max loss: "
              + " ".join(f"#{c}x{n}" for c, n in top))
    return 0


# ---------------------------------------------------------------- population


def _stall_streak(pops: List[Dict[str, Any]]) -> int:
    """Terminal distinct-coverage stall streak of a ``population``
    stream — the jax-free twin of the monitor's ``coverage_stall``
    bookkeeping (telemetry/health.py): consecutive records where the
    round advanced but the distinct-participant estimate did not grow
    while coverage sat below saturation (0.999). The monitor fires at
    ``COVERAGE_STALL_WINDOW``; ``diff --coverage_stall`` reuses this."""
    streak = 0
    prev: Optional[Dict[str, Any]] = None
    for e in pops:
        cov = _fin(e.get("coverage"))
        dist = _fin(e.get("distinct"))
        rnd = _fin(e.get("round"))
        if prev is not None:
            advanced = (rnd is None or _fin(prev.get("round")) is None
                        or rnd > _fin(prev.get("round")))
            grew = (dist is not None
                    and _fin(prev.get("distinct")) is not None
                    and dist > _fin(prev.get("distinct")))
            if cov is not None and cov >= 0.999:
                streak = 0
            elif not advanced:
                pass
            elif grew:
                streak = 0
            else:
                streak += 1
        prev = e
    return streak


def population(events: List[Dict[str, Any]]) -> int:
    """Population-scale participation report (schema-v11 ``population``
    events, telemetry/population.py): coverage/distinct trajectory,
    sample-count and staleness quantiles, the three heavy-hitter tables
    (most-sampled, loss-argmax, quarantine strikes), the ledger's memory
    footprint, and — on sketch-estimated streams — the documented
    count-min (eps, delta) error bounds. Works on exact streams too;
    the ``estimated`` flag says which ledger wrote the numbers."""
    pops = by_kind(events, "population")
    if not pops:
        print("no population events (pre-v11 stream, or "
              "--no_client_stats)")
        return 0
    first, last = pops[0], pops[-1]
    est = bool(last.get("estimated"))
    print(f"== population: {len(pops)} records, "
          f"{last.get('registered', '?')} registered clients, "
          + ("SKETCH-ESTIMATED" if est else "exact") + " ledger")
    dist = _fin(last.get("distinct"))
    reg = _fin(last.get("registered"))
    print(f"-- coverage {(_fin(first.get('coverage')) or 0) * 100:.1f}% -> "
          f"{(_fin(last.get('coverage')) or 0) * 100:.1f}% "
          f"({dist:.0f} of {reg:.0f} distinct"
          + ("~" if est else "") + ")"
          if dist is not None and reg is not None else
          "-- coverage trajectory unavailable (empty ledger)")
    streak = _stall_streak(pops)
    if streak >= COVERAGE_STALL_WINDOW:
        print(f"-- COVERAGE STALL: distinct flat for the last {streak} "
              f"records (monitor fires at {COVERAGE_STALL_WINDOW})")

    def q3(p50, p95, mx):
        vals = [last.get(p50), last.get(p95), last.get(mx)]
        return "/".join(f"{v:.4g}" if _fin(v) is not None else "-"
                        for v in vals)

    print(f"-- samples/client p50/p95/max {q3('counts_p50', 'counts_p95', 'counts_max')}"
          f"; staleness p50/p95/max "
          f"{q3('staleness_p50', 'staleness_p95', 'staleness_max')}")
    oc50, oc95 = _fin(last.get("obs_count_p50")), _fin(last.get("obs_count_p95"))
    g50, g95 = _fin(last.get("gap_p50")), _fin(last.get("gap_p95"))
    if oc50 is not None or g50 is not None:
        print("-- per-participation streams (P2 running quantiles): "
              "samples/slot p50/p95 "
              + "/".join(f"{v:.4g}" if v is not None else "-"
                         for v in (oc50, oc95))
              + ", revisit gap p50/p95 "
              + "/".join(f"{v:.4g}" if v is not None else "-"
                         for v in (g50, g95)))
    for key, label in (("top_sampled", "most-sampled clients"),
                       ("top_loss", "loss-argmax owners"),
                       ("top_strikes", "quarantine strikes")):
        top = last.get(key) or []
        pairs = [(p[0], p[1]) for p in top
                 if isinstance(p, (list, tuple)) and len(p) >= 2]
        if pairs:
            print(f"-- {label}: "
                  + " ".join(f"#{int(c)}x{n:.0f}" for c, n in pairs[:10])
                  + (" (counts are upper bounds)" if est else ""))
    mem = _fin(last.get("memory_bytes"))
    line = (f"-- ledger memory {mem / 2**20:.2f} MiB"
            if mem is not None else "-- ledger memory n/a")
    eps, delta = _fin(last.get("cm_epsilon")), _fin(last.get("cm_delta"))
    if eps is not None and delta is not None:
        line += (f"; count-min bound: overcount <= {eps:.3g}*N "
                 f"w.p. >= {1 - delta:.3g}"
                 f" (hh_k {last.get('hh_k')}, "
                 f"sample {last.get('sample_size')})")
    print(line)
    return 0


# --------------------------------------------------------------------- trend


def trend(path: str) -> int:
    """Benchmark trajectory across the repo's ``BENCH_r*.json``
    checkpoints: one row per file — cifar round throughput (img/s) and
    MFU, the saturated-batch arm, the gpt2 arm (tok/s, MFU), the modeled
    wire bytes when the vintage carries them, and the slowest warmup
    parsed from the captured tail. Every column is vintage-tolerant:
    r01 predates mfu, r02's bench crashed (parsed null), the saturated
    and gpt2 arms appear mid-history, and no vintage so far emits wire
    bytes — absent is '-', never a guess."""
    import glob
    import re
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "BENCH_*.json")))
    else:
        files = sorted(glob.glob(path))
    if not files:
        print(f"no BENCH_*.json under {path}")
        return 1

    def num(v, spec=".4g"):
        return format(v, spec) if isinstance(v, (int, float)) else "-"

    print("   file            img/s     mfu  sat img/s  sat mfu  "
          "gpt2 tok/s  gpt2 mfu  wire MiB  warmup_s")
    for f in files:
        name = os.path.basename(f)
        try:
            with open(f) as fh:
                d = json.load(fh)
        except (OSError, ValueError):
            print(f"   {name:14s} unreadable")
            continue
        parsed = d.get("parsed") if isinstance(d, dict) else None
        parsed = parsed if isinstance(parsed, dict) else {}
        sat = parsed.get("cifar_saturated") or {}
        gpt2 = parsed.get("gpt2") or {}
        # wire bytes: no committed vintage emits these yet; accept the
        # names a future bench would naturally use, render '-' otherwise
        wire = None
        for k in ("wire_mib", "wire_bytes", "table_reduce_bytes"):
            w = _fin(parsed.get(k))
            if w is not None:
                wire = w / 2**20 if k != "wire_mib" else w
                break
        warm = re.findall(r"warmup done in (\d+\.?\d*)s",
                          str(d.get("tail") or ""))
        warm_s = max((float(w) for w in warm), default=None)
        row = (f"   {name:14s} {num(parsed.get('value'), '8.5g'):>8} "
               f"{num(parsed.get('mfu')):>7} "
               f"{num(sat.get('value'), '9.5g'):>9} "
               f"{num(sat.get('mfu')):>8} "
               f"{num(gpt2.get('value'), '10.6g'):>10} "
               f"{num(gpt2.get('mfu')):>9} "
               f"{num(wire, '.3g'):>9} "
               f"{num(warm_s, '.1f'):>9}")
        if not parsed:
            row += f"   (rc={d.get('rc')}: bench produced no parse)"
        print(row)
    return 0


# ------------------------------------------------------------------- defense


def defense(events: List[Dict[str, Any]]) -> int:
    """Robustness report from the schema-v5 ``defense`` stream: the
    configured attack/defense/action, clip and trim activity trends,
    per-round nonfinite counts, the quarantine ledger trajectory and
    injected-fate totals. Exits 1 when any client was permanently
    EJECTED — a fleet losing clients for good is worth a red exit in a
    health-gate pipeline even if the run itself finished."""
    defs = by_kind(events, "defense")
    if not defs:
        print("no defense events (pre-v5 stream, or the robustness "
              "subsystem — --adversary/--defense/--nonfinite_action "
              "quarantine — was not configured)")
        return 0
    first, last = defs[0], defs[-1]
    print(f"== defense: {len(defs)} records, defense="
          f"{last.get('defense', '?')} adversary="
          f"{last.get('adversary', '?')} nonfinite_action="
          f"{last.get('nonfinite_action', '?')}")
    for key in DEFENSE_KEYS:
        vals = [_fin(e.get(key)) for e in defs]
        vals = [v for v in vals if v is not None]
        if not vals:
            continue
        print(f"   {key:18s} first {vals[0]:9.4g} last {vals[-1]:9.4g} "
              f"min {min(vals):9.4g} max {max(vals):9.4g}")
    inj: Dict[str, float] = {}
    for e in defs:
        for kind, n in (e.get("injected") or {}).items():
            if isinstance(n, (int, float)):
                inj[str(kind)] = inj.get(str(kind), 0.0) + float(n)
    if inj:
        print("-- injected slots (sum over records): "
              + " ".join(f"{k}x{v:.0f}" for k, v in sorted(inj.items())))
    digest = last.get("quarantine_ids_digest")
    if digest:
        print(f"-- quarantine ids digest (last): {digest}")
    ejected = int(last.get("ejected") or 0)
    print(f"-- {'EJECTIONS: ' + str(ejected) if ejected else 'no ejections'}"
          f" (quarantined now: {last.get('quarantined', 0)})")
    return 1 if ejected else 0


# -------------------------------------------------------------------- layers


def _shares(vals) -> Optional[List[Optional[float]]]:
    """Per-entry share of a per-group mass/count list (None-safe);
    None when the field is null or carries no mass."""
    if not vals:
        return None
    nums = [v if isinstance(v, (int, float)) else 0.0 for v in vals]
    total = sum(nums)
    if total <= 0:
        return None
    return [v / total for v in nums]


def layers(events: List[Dict[str, Any]]) -> int:
    """Layer-wise compression attribution report (schema-v10
    ``layer_signals`` events): the per-group table of the LAST record —
    coordinate share, dense-gradient mass share, recovered-update mass
    share, top-k win share, EF mass share, heavy-hitter overlap, and a
    STARVED verdict (> {mass}% of gradient mass, < {win}% of k — the
    same thresholds the ``group_starvation`` monitor rule fires on) —
    plus the first->last win-share trend per group, which is the
    mechanism trace the adaptive-compression controller consumes."""
    lsigs = by_kind(events, "layer_signals")
    if not lsigs:
        print("no layer_signals events (pre-v10 stream, or "
              "--signal_groups off / --no_signals)")
        return 0
    first, last = lsigs[0], lsigs[-1]
    groups = [str(g) for g in (last.get("groups") or [])]
    sizes = last.get("sizes") or []
    print(f"== layers: {len(lsigs)} records, {len(groups)} "
          f"{last.get('signal_groups', '?')} groups, mode "
          f"{last.get('mode', '?')}")
    d = sum(v for v in sizes if isinstance(v, (int, float))) or 1
    gshare = _shares(last.get("grad_mass"))
    ushare = _shares(last.get("update_mass"))
    kshare = _shares(last.get("topk_count"))
    eshare = _shares(last.get("error_mass"))
    hh = last.get("hh_overlap")
    starved = {g for g, _, _ in starved_groups(
        groups, last.get("grad_mass"), last.get("topk_count"))}

    def pct(shares, i):
        if shares is None or i >= len(shares) or shares[i] is None:
            return "     -"
        return f"{shares[i] * 100:5.1f}%"

    cshare = [(s / d if isinstance(s, (int, float)) else None)
              for s in sizes]
    print("   group                 coords   grad    upd    k-win"
          "   err     hh")
    for i, g in enumerate(groups):
        h = (hh[i] if hh and i < len(hh) else None)
        print(f"   {g:20s} {pct(cshare, i)}"
              f" {pct(gshare, i)} {pct(ushare, i)} {pct(kshare, i)}"
              f" {pct(eshare, i)}"
              + (f"  {h:5.2f}" if isinstance(h, (int, float)) else "      -")
              + ("   STARVED" if g in starved else ""))
    kf, kl = _shares(first.get("topk_count")), kshare
    if kf and kl and first is not last:
        print(f"-- k-win share trend (r{first.get('round', '?')} -> "
              f"r{last.get('round', '?')})")
        for i, g in enumerate(groups):
            if i < len(kf) and kf[i] is not None and kl[i] is not None:
                print(f"   {g:20s} {kf[i] * 100:5.1f}% -> "
                      f"{kl[i] * 100:5.1f}%")
    if starved:
        print(f"-- STARVED groups (> {STARVATION_MASS_SHARE * 100:.0f}% "
              f"gradient mass, < {STARVATION_WIN_SHARE * 100:.0f}% of k): "
              + " ".join(sorted(starved)))
    else:
        print("-- no starved group in the last record"
              + ("" if gshare is not None else
                 " (grad_mass is null — starvation is measured against "
                 "gradient mass, unavailable on this round's topology)"))
    return 0


# -------------------------------------------------------------------- memory


def memory(events: List[Dict[str, Any]]) -> int:
    """Memory report from the schema-v6 streams: the per-executable
    byte inventory (``memory_ledger`` events — where a compiled round's
    bytes STATICALLY go), the residency timeline (enriched ``memory``
    events — what the allocator DYNAMICALLY held per phase, and which
    phase grew the high-water), and the roofline table (``utilization``
    events — whether each window was compute- or bandwidth-bound)."""
    ledgers = latest_memory_ledgers(events)
    mems = by_kind(events, "memory")
    utils = by_kind(events, "utilization")
    if not ledgers and not mems and not utils:
        print("no memory_ledger/memory/utilization events (pre-v6 "
              "stream, or --no_telemetry)")
        return 0
    if ledgers:
        print("== per-executable byte inventory (memory_analysis, last "
              "compile each)")
        for name, e in sorted(ledgers.items()):
            print(f"   {name}: temp {_gib(e.get('temp_bytes'))}, "
                  f"args {_gib(e.get('argument_bytes'))}, "
                  f"out {_gib(e.get('output_bytes'))}, "
                  f"alias {_gib(e.get('alias_bytes'))}, "
                  f"total {_gib(e.get('total_bytes'))}")
    if mems:
        any_resident = any(_fin(e.get("peak_bytes")) is not None
                           for e in mems)
        print(f"== residency timeline ({len(mems)} snapshots"
              + ("" if any_resident
                 else "; allocator stats unavailable on this backend — "
                      "null means not measurable, not zero") + ")")
        for e in mems:
            delta = _fin(e.get("delta_peak_bytes"))
            head = _fin(e.get("headroom_frac"))
            print(f"   {str(e.get('phase', '?')):24s} "
                  f"live {_gib(e.get('live_bytes'))} "
                  f"peak {_gib(e.get('peak_bytes'))}"
                  + (f" (+{_gib(delta)})" if delta is not None and delta > 0
                     else "")
                  + f" frag {_gib(e.get('fragmentation_bytes'))}"
                  + (f" headroom {head * 100:.1f}%"
                     if head is not None else ""))
    if utils:
        rows = [u for u in utils
                if _fin(u.get("arithmetic_intensity")) is not None]
        if rows:
            print("== roofline (utilization windows with byte counts)")
            for u in rows:
                ai = _fin(u.get("arithmetic_intensity"))
                ridge = _fin(u.get("ridge_intensity"))
                bw = _fin(u.get("bw_frac"))
                mfu = _fin(u.get("mfu"))
                print(f"   r{u.get('round', '?'):>6}: AI {ai:.2f} FLOP/B"
                      + (f" (ridge {ridge:.2f})" if ridge is not None
                         else "")
                      + f" -> {u.get('bound') or 'n/a'}"
                      + (f", bw {bw * 100:.1f}%" if bw is not None else "")
                      + (f", mfu {mfu:.3g}" if mfu is not None else ""))
        else:
            print("== roofline: utilization events carry no byte counts "
                  "(no cost-analysis bytes, or pre-v6 stream)")
    return 0


# ------------------------------------------------------------------- timeline


def build_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome-tracing / perfetto JSON from the span + utilization +
    round event stream. Span events carry spans as (monotonic) seconds
    since their tracer's epoch plus a ``t0_wall`` unix anchor; counter
    tracks use the events' absolute ``t``. All timestamps shift to start
    at 0 and are emitted in MICROseconds (the trace-event format's
    unit), sorted ascending."""
    slices = []   # (abs_start_s, dur_s, name, tid, depth)
    for e in by_kind(events, "span"):
        t0w = _fin(e.get("t0_wall")) or 0.0
        for s in e.get("spans") or []:
            if not isinstance(s, dict):
                continue
            ts, dur = _fin(s.get("ts")), _fin(s.get("dur_s"))
            if ts is None or dur is None:
                continue
            slices.append((t0w + ts, max(dur, 0.0),
                           str(s.get("name", "?")),
                           int(s.get("tid") or 0),
                           int(s.get("depth") or 0)))
    counters = []  # (abs_t_s, track_name, value)
    # wire-width tracks (schema v9, `collectives` events): the modeled
    # per-device table-reduce ICI bytes and the wire dtype's bytes/cell
    # per watched executable — a quantized wire silently re-widening is
    # visible as a step in the timeline, not only in `diff`
    wire_cell_bytes = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0}
    for e in by_kind(events, "collectives"):
        t = _fin(e.get("t"))
        if t is None:
            continue
        name = str(e.get("name", "?"))
        trb = _fin(e.get("table_reduce_bytes"))
        if trb is not None:
            counters.append((t, f"table_reduce_bytes:{name}", trb))
        w = wire_cell_bytes.get(str(e.get("wire_dtype")))
        if w is not None:
            counters.append((t, f"wire_dtype_bytes:{name}", w))
    for e in by_kind(events, "utilization"):
        t = _fin(e.get("t"))
        if t is None:
            continue
        if _fin(e.get("mfu")) is not None:
            counters.append((t, "MFU", e["mfu"]))
        if _fin(e.get("input_wait_frac")) is not None:
            counters.append((t, "input_wait_frac", e["input_wait_frac"]))
    for e in by_kind(events, "round"):
        t, loss = _fin(e.get("t")), _fin(e.get("loss"))
        if t is not None and loss is not None:
            counters.append((t, "loss", loss))
    for e in by_kind(events, "memory"):
        # HBM counter track (schema v6): live + allocator-peak bytes in
        # GiB per residency snapshot — the memory timeline next to the
        # span slices, so an OOM trace shows WHEN the bytes arrived
        t = _fin(e.get("t"))
        if t is None:
            continue
        if _fin(e.get("live_bytes")) is not None:
            counters.append((t, "hbm_live_gib", e["live_bytes"] / 2**30))
        if _fin(e.get("peak_bytes")) is not None:
            counters.append((t, "hbm_peak_gib", e["peak_bytes"] / 2**30))

    starts = [s[0] for s in slices] + [c[0] for c in counters]
    base = min(starts) if starts else 0.0
    trace = []
    for start, dur, name, tid, depth in slices:
        trace.append({"name": name, "ph": "X", "pid": 0, "tid": tid,
                      "ts": (start - base) * 1e6, "dur": dur * 1e6,
                      "args": {"depth": depth}})
    for t, name, value in counters:
        trace.append({"name": name, "ph": "C", "pid": 0,
                      "ts": (t - base) * 1e6, "args": {name: value}})
    trace.sort(key=lambda e: e["ts"])
    man = next(iter(by_kind(events, "manifest")), {})
    meta = [{"name": "process_name", "ph": "M", "pid": 0, "ts": 0,
             "args": {"name": str(man.get("run_type", "run"))}}]
    return {"traceEvents": meta + trace, "displayTimeUnit": "ms"}


def timeline(events: List[Dict[str, Any]], out_path: str) -> int:
    trace = build_trace(events)
    n_slices = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    if n_slices == 0:
        print("WARNING: no span events in the stream (pre-v2 telemetry, "
              "or the run never hit the record cadence) — the trace "
              "holds counter tracks only", file=sys.stderr)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    print(f"wrote {out_path}: {n_slices} spans, "
          f"{len(trace['traceEvents']) - n_slices - 1} counter samples "
          "(open at https://ui.perfetto.dev or chrome://tracing)")
    return 0


# ----------------------------------------------------------------------- diff


def diff(a: List[Dict[str, Any]], b: List[Dict[str, Any]],
         args) -> List[str]:
    """Regressions of run B against baseline A (empty list = clean)."""
    problems: List[str] = []

    ca, cb = latest_collectives(a), latest_collectives(b)
    for name in sorted(set(ca) & set(cb)):
        counts_a = ca[name].get("counts") or {}
        counts_b = cb[name].get("counts") or {}
        for kind in sorted(set(counts_a) | set(counts_b)):
            na, nb = counts_a.get(kind, 0), counts_b.get(kind, 0)
            if nb > na + args.count_slack:
                problems.append(
                    f"collectives[{name}]: {kind} launch count {na} -> {nb}"
                    " (count growth is the 32x-unroll regression class)")
        ba = ca[name].get("total_bytes") or 0
        bb = cb[name].get("total_bytes") or 0
        if ba > 0 and bb > ba * args.bytes_ratio:
            problems.append(
                f"collectives[{name}]: payload bytes {ba} -> {bb} "
                f"(> {args.bytes_ratio:.2f}x)")
        # schema-v9 quantized-wire gate: the modeled table-reduce ICI
        # bytes regressing past threshold means the wire silently
        # re-widened (an int8 arm compiling the f32 reduce, a barrier
        # lost to a jax upgrade) — the exact regression class
        # --wire_dtype int8 exists to prevent
        wa = _fin(ca[name].get("table_reduce_bytes"))
        wb = _fin(cb[name].get("table_reduce_bytes"))
        if wa is not None and wb is not None and wa > 0 \
                and wb > wa * args.wire_bytes_growth:
            problems.append(
                f"collectives[{name}]: table-reduce wire bytes "
                f"{wa:.0f} -> {wb:.0f} "
                f"(> {args.wire_bytes_growth:.2f}x — the quantized "
                "wire re-widened)")

    ma, mb = latest_memory_ledgers(a), latest_memory_ledgers(b)
    for name in sorted(set(ma) & set(mb)):
        # schema-v6 memory gate: temp-buffer growth is the de-fusion /
        # re-materialization regression class (a per-client (W, d)
        # gradient reappearing multiplies temp by the client count)
        ta = _fin(ma[name].get("temp_bytes"))
        tb = _fin(mb[name].get("temp_bytes"))
        if ta is not None and tb is not None and ta > 0 \
                and tb > ta * args.temp_bytes_growth:
            problems.append(
                f"memory_ledger[{name}]: temp bytes {ta:.0f} -> {tb:.0f} "
                f"(> {args.temp_bytes_growth:.2f}x — a working-set "
                "regression: something re-materialized)")

    sa, sb = by_kind(a, "signals"), by_kind(b, "signals")
    if sa and sb:
        for key in NORM_KEYS:
            va, vb = _fin(sa[-1].get(key)), _fin(sb[-1].get(key))
            if va is not None and vb is not None and va > 0 \
                    and vb > va * args.signal_ratio:
                problems.append(
                    f"signals: final {key} {va:.5g} -> {vb:.5g} "
                    f"(> {args.signal_ratio:.2f}x — EF-divergence class)")
        oa, ob = (_fin(sa[-1].get("topk_overlap")),
                  _fin(sb[-1].get("topk_overlap")))
        if oa is not None and ob is not None \
                and ob < oa - args.overlap_drop:
            problems.append(
                f"signals: topk_overlap {oa:.3f} -> {ob:.3f} "
                f"(drop > {args.overlap_drop:.2f} — recovery degraded)")

    ua, ub = by_kind(a, "utilization"), by_kind(b, "utilization")
    if ua and ub:
        ma, mb = _fin(ua[-1].get("mfu")), _fin(ub[-1].get("mfu"))
        if ma is not None and mb is not None and ma > 0 \
                and mb < ma * (1 - args.mfu_drop):
            problems.append(
                f"utilization: final mfu {ma:.4f} -> {mb:.4f} "
                f"(> {args.mfu_drop:.0%} relative drop)")
        wa = _fin(ua[-1].get("input_wait_frac"))
        wb = _fin(ub[-1].get("input_wait_frac"))
        if wa is not None and wb is not None \
                and wb > wa + args.input_wait_rise:
            problems.append(
                f"utilization: input_wait_frac {wa:.3f} -> {wb:.3f} "
                f"(rise > {args.input_wait_rise:.2f} — the input "
                "pipeline started starving the chip)")
        fa = _fin(ua[-1].get("bw_frac"))
        fb = _fin(ub[-1].get("bw_frac"))
        if fa is not None and fb is not None \
                and fb < fa - args.bw_frac_drop:
            problems.append(
                f"utilization: final bw_frac {fa:.3f} -> {fb:.3f} "
                f"(drop > {args.bw_frac_drop:.2f} — achieved HBM "
                "bandwidth regressed against the same peak)")

    def per_chip(events):
        # last bench event carrying the per-chip throughput (the
        # scaling-curve arms emit it; ordinary runs have none and the
        # gate is vacuous-by-absence, like every other diff gate)
        for e in reversed(by_kind(events, "bench")):
            v = _fin((e.get("result") or {}).get("per_chip_items_per_s"))
            if v is not None:
                return v
        return None

    pa, pb = per_chip(a), per_chip(b)
    if pa is not None and pb is not None and pa > 0 \
            and pb < pa * (1 - args.perchip_drop):
        problems.append(
            f"bench: per_chip_items_per_s {pa:.5g} -> {pb:.5g} "
            f"(> {args.perchip_drop:.0%} relative drop — per-chip "
            "throughput regressed; on a weak-scaling sweep this means "
            "added chips are being taxed instead of adding capacity)")

    def starvation_gap(events):
        # max per-group starvation gap (mass share minus k-win share,
        # over groups above the mass floor) of the final layer_signals
        # event; None when the stream has none or grad_mass is null —
        # the gate is vacuous-by-absence like every other diff gate
        ls = by_kind(events, "layer_signals")
        if not ls:
            return None
        e = ls[-1]
        gm = _shares(e.get("grad_mass"))
        tc = _shares(e.get("topk_count"))
        if gm is None or tc is None:
            return None
        gaps = [m - w for m, w in zip(gm, tc)
                if m is not None and w is not None
                and m > STARVATION_MASS_SHARE]
        return max(gaps) if gaps else 0.0

    ga, gb = starvation_gap(a), starvation_gap(b)
    if ga is not None and gb is not None \
            and gb > ga + args.starvation_rise:
        problems.append(
            f"layer_signals: starvation gap (max grad-mass share minus "
            f"k-win share) {ga:.3f} -> {gb:.3f} (rise > "
            f"{args.starvation_rise:.2f} — a parameter group is losing "
            "the top-k race it used to win; the layer-wise compression "
            "allocation regressed)")

    aa, ab = by_kind(a, "async_round"), by_kind(b, "async_round")
    if aa and ab:
        za = _fin(aa[-1].get("staleness_mean"))
        zb = _fin(ab[-1].get("staleness_mean"))
        if za is not None and zb is not None \
                and zb > za + args.staleness_rise:
            problems.append(
                f"async_round: final staleness_mean {za:.2f} -> {zb:.2f} "
                f"(rise > {args.staleness_rise:.2f} — cohorts are landing "
                "later relative to commits; the in-flight pool or the "
                "buffer goal regressed)")
        ea = _fin(aa[-1].get("error_norm"))
        eb = _fin(ab[-1].get("error_norm"))
        if ea is not None and eb is not None and ea > 0 \
                and eb > ea * args.signal_ratio:
            problems.append(
                f"async_round: final error_norm {ea:.5g} -> {eb:.5g} "
                f"(> {args.signal_ratio:.2f}x — staleness-induced EF "
                "divergence class)")

    da, db = by_kind(a, "defense"), by_kind(b, "defense")
    if da and db:
        # schema-v5 robustness gates: a defended run whose clip fraction
        # rises sharply is absorbing a new attack (or clipping honest
        # clients); growth of the bench/eject counts is a fleet-health
        # regression in its own right
        fa = _fin(da[-1].get("clip_frac"))
        fb = _fin(db[-1].get("clip_frac"))
        if fa is not None and fb is not None \
                and fb > fa + args.clip_frac_rise:
            problems.append(
                f"defense: final clip_frac {fa:.3f} -> {fb:.3f} "
                f"(rise > {args.clip_frac_rise:.2f} — the norm clip is "
                "binding on far more clients than the baseline)")
        qa = (_fin(da[-1].get("quarantined")) or 0) + \
            (_fin(da[-1].get("ejected")) or 0)
        qb = (_fin(db[-1].get("quarantined")) or 0) + \
            (_fin(db[-1].get("ejected")) or 0)
        if qb > qa + args.quarantine_growth:
            problems.append(
                f"defense: quarantined+ejected {qa:.0f} -> {qb:.0f} "
                f"(growth > {args.quarantine_growth} — more clients are "
                "producing nonfinite uploads than the baseline)")

    def final_loss(events):
        eps = by_kind(events, "epoch")
        if eps:
            return _fin(eps[-1].get("test_loss"))
        rnds = [_fin(e.get("loss")) for e in by_kind(events, "round")]
        rnds = [v for v in rnds if v is not None]
        return rnds[-1] if rnds else None

    la, lb = final_loss(a), final_loss(b)
    if la is not None:
        if lb is None:
            problems.append("loss: baseline finite, new run has no finite "
                            "loss (diverged?)")
        elif la > 0 and lb > la * args.loss_ratio:
            problems.append(f"loss: final {la:.4f} -> {lb:.4f} "
                            f"(> {args.loss_ratio:.2f}x)")

    def loss_spread(events):
        cs = by_kind(events, "client_stats")
        if not cs:
            return None
        q = (cs[-1].get("quantiles") or {}).get("loss") or {}
        hi, lo = _fin(q.get("p95")), _fin(q.get("p5"))
        return hi - lo if hi is not None and lo is not None else None

    pa, pb = loss_spread(a), loss_spread(b)
    if pa is not None and pb is not None and pa > 0 \
            and pb > pa * args.client_spread_ratio:
        problems.append(
            f"client_stats: final loss spread (p95-p5) {pa:.4g} -> "
            f"{pb:.4g} (> {args.client_spread_ratio:.2f}x — the client "
            "population is diverging)")

    # schema-v11 population gates: final coverage dropping more than
    # --coverage_stall (absolute) against the baseline, or the
    # candidate's stream ENDING in a distinct-coverage stall (streak >=
    # COVERAGE_STALL_WINDOW, the monitor rule's window) the baseline
    # does not show — the sampler stopped reaching new clients
    pop_a, pop_b = by_kind(a, "population"), by_kind(b, "population")
    if pop_a and pop_b:
        va = _fin(pop_a[-1].get("coverage"))
        vb = _fin(pop_b[-1].get("coverage"))
        if va is not None and vb is not None \
                and vb < va - args.coverage_stall:
            problems.append(
                f"population: final coverage {va:.3f} -> {vb:.3f} "
                f"(drop > {args.coverage_stall:.2f} — the candidate is "
                "reaching a smaller slice of the client population)")
        sa, sb_ = _stall_streak(pop_a), _stall_streak(pop_b)
        if sb_ >= COVERAGE_STALL_WINDOW > sa:
            problems.append(
                f"population: candidate ends in a {sb_}-record "
                f"distinct-coverage stall (window "
                f"{COVERAGE_STALL_WINDOW}) the baseline does not — "
                "the client sampler stopped reaching new clients")

    def crit_alerts(events):
        return [e for e in by_kind(events, "alert")
                if e.get("severity") == "critical"]

    na, nb = len(crit_alerts(a)), len(crit_alerts(b))
    if nb > na + args.alert_slack:
        problems.append(
            f"alerts: critical count {na} -> {nb} (the monitor fired on "
            "the candidate where the baseline stayed quiet)")
    for e in by_kind(b, "nan_abort"):
        if not by_kind(a, "nan_abort"):
            problems.append(f"new run aborted non-finite at round "
                            f"{e['nan_round']} (baseline did not)")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="teleview")
    sub = ap.add_subparsers(dest="cmd")
    s = sub.add_parser("summarize", help="one-stream report")
    s.add_argument("path")
    d = sub.add_parser("diff", help="regression check: B against baseline A")
    d.add_argument("baseline")
    d.add_argument("candidate")
    d.add_argument("--count_slack", type=int, default=0,
                   help="collective launch-count growth tolerated (default "
                        "0: any increase fails)")
    d.add_argument("--wire_bytes_growth", type=float, default=1.05,
                   help="max growth of the modeled table-reduce ICI "
                        "bytes (collectives.table_reduce_bytes, schema "
                        "v9) before the diff fails — catches a "
                        "quantized wire silently re-widening to f32")
    d.add_argument("--bytes_ratio", type=float, default=1.05,
                   help="max collective payload-byte growth factor")
    d.add_argument("--signal_ratio", type=float, default=2.0,
                   help="max final signal-norm growth factor")
    d.add_argument("--overlap_drop", type=float, default=0.2,
                   help="max topk_overlap absolute drop")
    d.add_argument("--loss_ratio", type=float, default=1.05,
                   help="max final loss growth factor")
    d.add_argument("--mfu_drop", type=float, default=0.15,
                   help="max RELATIVE drop of the final mfu (0.15 = "
                        "15%% slower per peak-FLOP fails)")
    d.add_argument("--input_wait_rise", dest="input_wait_rise",
                   type=float, default=0.10,
                   help="max ABSOLUTE rise of the final input_wait_frac "
                        "(the round-pipeline starvation gate). "
                        "dryrun_multichip wires the default against its "
                        "pipelined-vs-inline streams. (--starvation_rise "
                        "was an alias of this flag before schema v10; it "
                        "now gates LAYER starvation — see below)")
    d.add_argument("--starvation_rise", type=float, default=0.15,
                   help="max ABSOLUTE rise of the layer-starvation gap "
                        "(schema-v10 layer_signals streams: max over "
                        "groups above the grad-mass floor of mass share "
                        "minus k-win share, from the final record) — a "
                        "group losing the top-k race it used to win. "
                        "Pre-v10 this spelling aliased "
                        "--input_wait_rise; the input-wait gate keeps "
                        "its primary spelling")
    d.add_argument("--staleness_rise", type=float, default=1.0,
                   help="max ABSOLUTE rise of the final async_round "
                        "staleness_mean (async buffered-aggregation "
                        "runs; commits-stale units)")
    d.add_argument("--temp_bytes_growth", type=float, default=1.10,
                   help="max growth factor of a watched executable's "
                        "memory_ledger temp bytes (schema-v6 streams; "
                        "the de-fusion/re-materialization regression "
                        "class)")
    d.add_argument("--bw_frac_drop", type=float, default=0.10,
                   help="max ABSOLUTE drop of the final utilization "
                        "bw_frac (achieved HBM bandwidth as a fraction "
                        "of peak; schema-v6 streams)")
    d.add_argument("--perchip_drop", type=float, default=0.30,
                   help="fail if the last bench event's "
                        "per_chip_items_per_s drops more than this "
                        "relative fraction vs baseline (the weak-"
                        "scaling gate; scripts/scaling_curves.py "
                        "passes its own threshold for virtual-device "
                        "dryruns)")
    d.add_argument("--clip_frac_rise", type=float, default=0.25,
                   help="max ABSOLUTE rise of the final defense "
                        "clip_frac (schema-v5 defense streams)")
    d.add_argument("--quarantine_growth", type=int, default=0,
                   help="quarantined+ejected client-count growth "
                        "tolerated (default 0: any new benched/ejected "
                        "client fails)")
    d.add_argument("--client_spread_ratio", type=float, default=2.0,
                   help="max growth factor of the final per-client loss "
                        "spread (p95-p5) — population divergence")
    d.add_argument("--alert_slack", type=int, default=0,
                   help="critical-alert count growth tolerated (default "
                        "0: any new critical alert fails)")
    d.add_argument("--coverage_stall", type=float, default=0.05,
                   help="max ABSOLUTE drop of the final population "
                        "coverage (schema-v11 population streams); the "
                        "diff also fails when the candidate stream ends "
                        "in a >= COVERAGE_STALL_WINDOW-record distinct-"
                        "coverage stall the baseline does not show — "
                        "the sampler-reach regression gate")
    al = sub.add_parser("alerts", help="postmortem alert triage "
                                       "(exit 1 on critical)")
    al.add_argument("path")
    cl = sub.add_parser("clients",
                        help="per-client population trends from the "
                             "client_stats stream")
    cl.add_argument("path")
    po = sub.add_parser("population",
                        help="population-scale participation report "
                             "from the schema-v11 population stream "
                             "(sketch-estimated or exact)")
    po.add_argument("path")
    tr = sub.add_parser("trend",
                        help="benchmark trajectory across BENCH_r*.json "
                             "checkpoints (img/s, mfu, gpt2 tok/s, wire "
                             "bytes, warmup; vintage-tolerant)")
    tr.add_argument("path", nargs="?", default=".",
                    help="directory holding BENCH_*.json (or a glob); "
                         "default: current directory")
    ly = sub.add_parser("layers",
                        help="layer-wise compression attribution table "
                             "and per-group win-share trend from the "
                             "schema-v10 layer_signals stream")
    ly.add_argument("path")
    de = sub.add_parser("defense",
                        help="robustness report from the schema-v5 "
                             "defense stream (exit 1 on ejections)")
    de.add_argument("path")
    me = sub.add_parser("memory",
                        help="per-executable byte inventory, residency "
                             "timeline and roofline table from the "
                             "schema-v6 memory/memory_ledger/"
                             "utilization streams")
    me.add_argument("path")
    t = sub.add_parser("timeline",
                       help="render the span stream into a perfetto/"
                            "chrome-tracing trace.json")
    t.add_argument("path")
    t.add_argument("-o", "--out", default="trace.json",
                   help="output trace file (default: trace.json)")
    args = ap.parse_args(argv)
    if args.cmd == "summarize":
        summarize(load_events(args.path), label=args.path)
        return 0
    if args.cmd == "alerts":
        return alerts(load_events(args.path))
    if args.cmd == "clients":
        return clients(load_events(args.path))
    if args.cmd == "population":
        return population(load_events(args.path))
    if args.cmd == "trend":
        return trend(args.path)
    if args.cmd == "layers":
        return layers(load_events(args.path))
    if args.cmd == "defense":
        return defense(load_events(args.path))
    if args.cmd == "memory":
        return memory(load_events(args.path))
    if args.cmd == "timeline":
        return timeline(load_events(args.path), args.out)
    if args.cmd == "diff":
        a, b = load_events(args.baseline), load_events(args.candidate)
        summarize(a, label=f"A (baseline) {args.baseline}")
        summarize(b, label=f"B (candidate) {args.candidate}")
        problems = diff(a, b, args)
        if problems:
            print("== REGRESSIONS")
            for p in problems:
                print(f"   {p}")
            return 1
        print("== no regressions beyond thresholds")
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
