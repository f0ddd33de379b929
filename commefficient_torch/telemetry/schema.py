"""The run-telemetry JSONL event schema, and its validator.

One ``telemetry.jsonl`` line = one JSON object = one event. Every event
carries the envelope fields ``event`` (type tag), ``t`` (unix seconds)
and ``seq`` (0-based per-run counter, so a truncated stream is
detectable). The first line of a well-formed stream is a ``manifest``
and the last is a ``summary`` — the footer's absence marks a run that
died rather than finished.

The validator is dependency-free (no jsonschema package in the image):
each event type maps its required fields to a type predicate; extra
fields are always legal (forward compatibility), unknown event types
are not. ``scripts/check_telemetry_schema.py`` and the tier-1 tests
both run exactly this code, so the schema documented in README.md is
the one actually enforced.

The PyTorch port's copy of the JAX package's ``telemetry/schema.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Tuple

SCHEMA_VERSION = 11
# streams written by older code stay readable: v1 lacks the span /
# utilization event types (added in v2), v2 lacks client_stats / alert
# (added in v3), v3 lacks async_round (added in v4), v4 lacks defense
# (added in v5), v5 lacks memory_ledger and the enriched memory /
# utilization fields (added in v6 — the first version to ADD FIELDS to
# existing event types; see FIELDS_SINCE_V6, which the validator only
# requires of v6+ streams), v6 lacks the utilization mesh-topology
# fields (n_devices / mesh_shape, added in v7 for the scaling-curve
# harness — FIELDS_SINCE_V7, same vintage-gated requirement), v7 lacks
# the fault/resume event types and the manifest stream_id (added in v8
# for crash recovery lineage — FIELDS_SINCE_V8), v8 lacks the quantized-
# wire fields on collectives/signals/bench (wire_dtype and the modeled
# table-reduce ICI bytes, added in v9 for --wire_dtype int8 —
# FIELDS_SINCE_V9), v9 lacks the layer_signals event type (the
# layer-wise compression attribution stream, added in v10 — a new type,
# no vintage-gated field additions), v10 lacks the population event
# type and the client_stats `estimated` flag (population-scale sketch
# observability, added in v11 — FIELDS_SINCE_V11), but each is
# otherwise a subset of its successor — so the validator accepts any
# supported manifest version. A version it does not know is the error,
# not a version merely older than current.
SUPPORTED_SCHEMA_VERSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                             SCHEMA_VERSION)
TELEMETRY_BASENAME = "telemetry.jsonl"


def _num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _opt_num(v: Any) -> bool:
    return v is None or _num(v)


def _int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _str(v: Any) -> bool:
    return isinstance(v, str)


def _bool(v: Any) -> bool:
    return isinstance(v, bool)


def _opt_str(v: Any) -> bool:
    return v is None or isinstance(v, str)


def _dict(v: Any) -> bool:
    return isinstance(v, dict)


def _opt_dict(v: Any) -> bool:
    return v is None or isinstance(v, dict)


def _list(v: Any) -> bool:
    return isinstance(v, list)


def _opt_list(v: Any) -> bool:
    return v is None or isinstance(v, list)


# event type -> {required field: predicate}. The envelope (event/t/seq)
# is checked for every line before the per-type fields.
EVENT_FIELDS: Dict[str, Dict[str, Any]] = {
    # run header: resolved config + environment, written once at open
    "manifest": {
        "schema": _int,
        "run_type": _str,          # cv_train | gpt2_train | bench | ...
        "jax_version": _str,
        "backend": _str,
        "device_kind": _str,
        "device_count": _int,
        "mesh_shape": _list,
        "mesh_axes": _list,
        "grad_size": _int,
        "sketch": _opt_dict,       # geometry dict in sketch mode, else null
        "config": _dict,           # full resolved FedConfig
        # schema v8: unique id of this stream SEGMENT — a resumed run
        # appends a new manifest with a fresh id, and its `resume`
        # event names the predecessor's (crash-recovery lineage)
        "stream_id": _str,
    },
    # one federated round (emitted every cfg.telemetry_every rounds).
    # loss/acc are null when the round's metrics went non-finite — the
    # writer serializes NaN/inf as null so the stream stays strict JSON
    "round": {
        "round": _int,
        "epoch": _int,
        "lr": _num,
        "loss": _opt_num,
        "acc": _opt_num,
        "n_valid": _num,
        "download_bytes": _opt_num,   # null when --no_track_bytes
        "upload_bytes": _opt_num,
        "host_s": _num,               # host batch assembly
        "dispatch_s": _num,           # jitted-call return (async dispatch)
        "device_s": _num,             # block_until_ready remainder
    },
    # per-epoch validation record (mirrors the console table row);
    # loss/acc metrics are null if non-finite (e.g. a NaN val sweep that
    # does not trip the train-side divergence abort)
    "epoch": {
        "epoch": _int,
        "lr": _num,
        "train_time": _num,
        "train_loss": _opt_num,
        "train_acc": _opt_num,
        "test_loss": _opt_num,
        "test_acc": _opt_num,
        "download_mib": _num,
        "upload_mib": _num,
        "total_time": _num,
    },
    # one XLA compile of a watched jitted function; n_compiles > 1 for a
    # name means a RECOMPILE (shape change / donation miss) happened
    "compile": {
        "name": _str,
        "n_compiles": _int,
        "lower_s": _num,
        "compile_s": _num,
        "flops": _opt_num,            # XLA cost_analysis; null if opaque
        "bytes_accessed": _opt_num,
        "fallback": _bool,            # True: watcher gave up on AOT path
    },
    # per-device memory_stats() snapshot (+ host RSS). Schema v6 adds
    # the derived residency fields (telemetry/memory_ledger.py
    # residency_fields): max-over-devices live/peak bytes, the peak's
    # growth since the PREVIOUS snapshot (which phase grew the
    # high-water), fragmentation = peak - live, the device byte limit
    # and the headroom fraction (limit - peak)/limit — the near-OOM
    # precursor health.py's hbm_pressure rule watches. All null on
    # backends without allocator stats (CPU) — never fake zeros.
    "memory": {
        "phase": _str,                # init | rounds_<n> | epoch_<n> | ...
        "devices": _list,             # [{id, kind, stats: dict|null}, ...]
        "host_rss_bytes": _opt_num,
        "live_bytes": _opt_num,
        "peak_bytes": _opt_num,
        "delta_peak_bytes": _opt_num,
        "fragmentation_bytes": _opt_num,
        "limit_bytes": _opt_num,
        "headroom_frac": _opt_num,
    },
    # static byte inventory of one compiled executable (schema v6,
    # telemetry/memory_ledger.py, from XLA's memory_analysis): temp
    # buffers (the working set — where a fusion regression or the
    # sketch round's dense-gradient materialization shows up),
    # argument/output/alias bytes (the resident state the executable
    # touches) and generated-code bytes. Emitted by the JitWatcher next
    # to each `compile` event; dryrun_multichip asserts hard ceilings.
    # Fields are null when XLA reported no count — never fake zeros.
    "memory_ledger": {
        "name": _str,                 # watched function (round_step, ...)
        "temp_bytes": _opt_num,
        "argument_bytes": _opt_num,
        "output_bytes": _opt_num,
        "alias_bytes": _opt_num,
        "generated_code_bytes": _opt_num,
        "total_bytes": _opt_num,      # arg + output + temp + generated
    },
    # structured divergence diagnostic, emitted instead of a bare exit
    "nan_abort": {
        "nan_round": _int,            # -1: host-side NaN (epoch loss)
        "reason": _str,
        "mode": _str,
        "max_grad_norm": _opt_num,
        "sketch": _opt_dict,
        "last_round": _opt_dict,      # last finite round record, if any
        "last_epoch": _opt_dict,      # last completed epoch record, if any
    },
    # benchmark stage result (bench.py / bench_gpt2.py share the stream)
    # schema v9 adds wire_dtype so BENCH trajectory arms under different
    # --wire_dtype settings stay distinguishable from the stream alone
    "bench": {
        "metric": _str,
        "result": _dict,
        "wire_dtype": _opt_str,
    },
    # compression-signal health for one round (telemetry/signals.py):
    # on-device norms of the aggregated gradient / EF accumulators /
    # applied update, sketch collision-noise proxies, heavy-hitter
    # recovery overlap, and exact per-client byte costs. Norm fields are
    # null when not applicable to the mode/topology (e.g. no dense
    # pre-image on a mesh) — never silently zero
    "signals": {
        "round": _int,
        "mode": _str,
        "grad_norm": _opt_num,
        "grad_true_norm": _opt_num,     # dense preimage norm, if one exists
        "grad_l2estimate": _opt_num,    # sketch table norm estimate
        "velocity_norm": _opt_num,
        "error_norm": _opt_num,
        "error_l2estimate": _opt_num,
        "update_norm": _opt_num,
        "support_density": _opt_num,
        "topk_overlap": _opt_num,       # --signals_exact only, else null
        "download_bytes": _opt_num,     # round totals; null w/o track_bytes
        "upload_bytes": _opt_num,
        "client_download_bytes": _opt_list,  # per participating client,
        "client_upload_bytes": _opt_list,    # ordered by client_ids
        "wire_dtype": _opt_str,              # v9: the table wire dtype
    },
    # layer-wise compression attribution for one round (schema v10,
    # telemetry/layer_signals.py): per-parameter-group reductions of
    # the round's dense quantities, one list entry per named group in
    # ravel order. Masses are squared-L2 energies (additive — per-group
    # masses sum to the matching whole-vector signal norm squared);
    # topk_count sums to nnz(update) (= k for the sparsifying modes).
    # grad_mass/error_mass/hh_overlap are null — never fake zeros —
    # where the round holds no dense gradient / dense EF / exact
    # reference (fused-encode and mesh sketch rounds; --signals_exact
    # off), mirroring the signals NaN contract. Entries inside live
    # lists may be null too (a group that owns no top-k winner has no
    # defined hh_overlap).
    "layer_signals": {
        "round": _int,
        "mode": _str,
        "signal_groups": _str,          # coarse | leaf (the config axis)
        "groups": _list,                # group names, ravel order
        "sizes": _list,                 # coordinate counts per group
        "grad_mass": _opt_list,
        "update_mass": _opt_list,
        "topk_count": _opt_list,
        "error_mass": _opt_list,
        "hh_overlap": _opt_list,
    },
    # collective inventory of one compiled executable (telemetry/
    # collectives.py): per-kind LAUNCH counts, total payload bytes and
    # the per-element op list — emitted next to each `compile` event so
    # a collective-count regression (the round-5 32x all_to_all unroll
    # class) is visible in every run's stream, not only in the dryruns
    "collectives": {
        "name": _str,                   # watched function (round_step, ...)
        "n_collectives": _int,          # total launches
        "counts": _dict,                # kind -> launch count
        "total_bytes": _num,
        "ops": _list,                   # [{kind, n_elements, dtype, bytes,
                                        #   combined_in}, ...]
        # schema v9 (--wire_dtype int8): the configured table wire dtype
        # and the MODELED per-device ICI bytes of the table-reduce
        # collectives (reduce-scatter / all-to-all; collectives.py
        # table_reduce_wire_bytes) — the quantized-wire regression
        # channel `teleview diff --wire_bytes_growth` gates
        "wire_dtype": _opt_str,
        "table_reduce_bytes": _opt_num,
    },
    # batched wall-time spans (telemetry/tracing.py): the tracer's
    # completed-span buffer, drained at the round-record cadence OUTSIDE
    # the timed region. Each span: {name, ts (seconds since t0 on the
    # monotonic clock), dur_s, tid, depth}. t0_wall anchors the
    # monotonic epoch to unix time; teleview's `timeline` subcommand
    # renders the stream into a perfetto/chrome-tracing trace.json
    "span": {
        "t0_wall": _num,
        "n_dropped": _int,            # spans lost to the buffer cap in
                                      # THIS window (per-event counts sum
                                      # to the run total)
        "spans": _list,
    },
    # step-time attribution + MFU (telemetry/utilization.py): per-round
    # device time joined with the compiled round's cost-analysis FLOPs
    # and the per-device_kind peak table (--peak_flops overrides).
    # flops_per_round/mfu are null when no FLOPs count or no peak is
    # known — never a fake zero; the three *_frac fields are fractions
    # of wall_s and need not sum to 1 (device waits are only measured
    # on rounds that synced)
    # schema v6 adds the roofline attribution fields (utilization.py
    # roofline_fields): cost-analysis bytes-accessed joined with the
    # FLOPs into arithmetic intensity, the ridge point of the pinned
    # peak pair, a compute/bandwidth bound verdict, achieved-vs-peak
    # bandwidth fraction and the two-term expected round time. Null
    # whenever a byte count or a peak is unknown — never fake zeros.
    "utilization": {
        "round": _int,
        "rounds": _int,               # rounds in this window
        "wall_s": _num,
        "device_kind": _str,
        "peak_flops": _opt_num,
        "flops_per_round": _opt_num,
        "flops_source": _opt_str,     # cost_analysis | analytic | null
        "achieved_flops": _opt_num,   # FLOP/s over the window
        "mfu": _opt_num,
        "input_wait_frac": _opt_num,  # host batch assembly (starvation)
        "dispatch_frac": _opt_num,
        "device_wait_frac": _opt_num,
        "straggler_spread": _opt_num,  # (max-min)/mean per-host device_s
        "peak_hbm_gbps": _opt_num,    # GB/s (--peak_hbm_gbps overrides)
        "bytes_per_round": _opt_num,  # cost-analysis bytes accessed
        "bytes_source": _opt_str,     # cost_analysis | null
        "arithmetic_intensity": _opt_num,  # FLOPs per byte accessed
        "ridge_intensity": _opt_num,  # peak_flops / peak_hbm bytes/s
        "bound": _opt_str,            # compute | bandwidth | null
        "achieved_gbps": _opt_num,    # bytes * rounds / wall_s, in GB/s
        "bw_frac": _opt_num,          # achieved_gbps / peak_hbm_gbps
        "expected_round_s": _opt_num,  # max(flops/peakF, bytes/peakBW)
        # schema v7 (the scaling-curve harness): the window's mesh
        # topology, so per-chip normalization (throughput/chip, the
        # weak-scaling contract) is computable from the stream alone.
        # n_devices is the device count the watched executable ran
        # over; mesh_shape the mesh dims (null when no mesh)
        "n_devices": _opt_num,
        "mesh_shape": _opt_list,
    },
    # per-client population summary for one round (telemetry/clients.py):
    # on-device quantile reductions over the round's client axis (the
    # full (W,) vectors never reach the stream — JSONL stays small at
    # num_workers=512) joined with the host-side participation ledger.
    # ``quantiles`` maps each stat key (loss, grad_norm_pre/post,
    # clip_frac, tx_norm, upload/download_bytes) to
    # {p5,p25,p50,p75,p95,max,mean,argmax_client}; values are null where
    # the stat does not exist for the mode/path (e.g. per-client grad
    # norms under the fused-clients fast path) — never silently zero
    "client_stats": {
        "round": _int,
        "n_participants": _int,       # client slots in this round
        "quantiles": _dict,
        "coverage": _num,             # distinct participants / num_clients
        "distinct_clients": _int,     # seen at least once so far
        "counts_p50": _opt_num,       # per-seen-client sample counts
        "counts_max": _opt_num,
        "staleness_p50": _opt_num,    # rounds since last participation
        "staleness_max": _opt_num,
        # schema v11: whether the participation fields are sketch
        # estimates (--population_sketch; telemetry/population.py) —
        # the ledger never fakes exactness
        "estimated": _bool,
    },
    # population-scale participation summary (schema v11, telemetry/
    # population.py + the exact ledger's population_snapshot): the
    # ledger's full view of the client universe at the record cadence.
    # In sketch mode (estimated=true) distinct/coverage come from a KMV
    # bottom-S estimator, counts/staleness quantiles from its uniform
    # distinct-client sample (DKW rank bound), counts via a count-min
    # sketch whose (epsilon, delta) ride along, and the top_* lists are
    # space-saving top-K over the most-sampled / loss-argmax /
    # quarantine-strike streams ([id, count] pairs, count an upper
    # estimate). obs_count/gap quantiles are P2 estimates of the
    # per-participation sample-count and staleness-at-participation
    # streams in BOTH modes; sketch parameters are null in exact mode —
    # never fake values
    "population": {
        "round": _int,
        "estimated": _bool,
        "registered": _int,           # configured client universe size
        "distinct": _num,             # distinct-participant (estimate)
        "coverage": _num,
        "counts_p50": _opt_num,       # per-seen-client cumulative counts
        "counts_p95": _opt_num,
        "counts_max": _opt_num,
        "staleness_p50": _opt_num,    # rounds since last participation
        "staleness_p95": _opt_num,
        "staleness_max": _opt_num,
        "obs_count_p50": _opt_num,    # per-participation sample counts
        "obs_count_p95": _opt_num,
        "gap_p50": _opt_num,          # staleness at participation
        "gap_p95": _opt_num,
        "top_sampled": _list,         # [[client_id, count], ...] desc
        "top_loss": _list,
        "top_strikes": _list,
        "memory_bytes": _num,         # ledger resident footprint model
        "cm_epsilon": _opt_num,       # count-min e/width; null if exact
        "cm_delta": _opt_num,         # count-min e^-depth; null if exact
        "hh_k": _opt_num,             # space-saving capacity; null if exact
        "sample_size": _opt_num,      # KMV sample size; null if exact
    },
    # one async buffered-aggregation commit (core/async_agg.py): which
    # cohorts merged, their measured staleness (commits between dispatch
    # and merge) and discount weights, the raw datum count the commit
    # averaged over, and the post-commit EF-accumulator norms —
    # the staleness-divergence signal health.py's async_ef_blowup rule
    # watches. ``round`` is the COMMIT index (the server version), not a
    # dispatch tick; ``partial`` marks the epoch-boundary flush of a
    # buffer below --buffer_goal. loss is the datum-weighted dispatch
    # loss of the merged cohorts; the device-derived fields (loss,
    # buffer_n, *_norm) are null off the record cadence — fetching them
    # costs a host sync, and a null is never a fake zero
    "async_round": {
        "round": _int,
        "n_cohorts": _int,
        "cohorts": _list,             # global round index of each cohort
        "staleness_mean": _num,
        "staleness_max": _num,
        "discount_mean": _num,
        "discount_min": _num,
        "partial": _bool,
        "buffer_n": _opt_num,
        "loss": _opt_num,
        "update_norm": _opt_num,
        "error_norm": _opt_num,
        "velocity_norm": _opt_num,
        "lr": _num,
    },
    # robustness status of one round (schema v5; core/runtime.py +
    # core/quarantine.py): what the configured defense actually did —
    # clip fraction/threshold/removed mass (normclip), trim fraction
    # (trim), per-round nonfinite-client count and the quarantine
    # ledger's bench/eject state — plus the injected adversary counts
    # when fault injection is on. Emitted only when the robustness
    # subsystem is active (defense, adversary or quarantine configured);
    # numeric fields are null where not applicable to the configured
    # defense/action — never silently zero
    "defense": {
        "round": _int,
        "defense": _str,              # none | normclip | trim
        "adversary": _str,            # none | labelflip | ... (config)
        "nonfinite_action": _str,     # abort | quarantine
        "clip_frac": _opt_num,        # clipped / participating clients
        "clip_thresh": _opt_num,      # per-datum norm threshold applied
        "clipped_mass": _opt_num,     # L2 of the mass the clip removed
        "trim_frac": _opt_num,        # 2*floor(trim_frac*V)/V actually
                                      # cut, V = live (data-carrying)
                                      # clients, not the slot count W
        "nonfinite_clients": _opt_num,  # zeroed out of THIS round
        "quarantined": _int,          # currently benched (backoff running)
        "ejected": _int,              # permanently ejected so far
        "quarantine_ids_digest": _opt_str,  # "<n>:<sha1[:12]>" or null
        "injected": _opt_dict,        # {kind: slots-this-round} when on
    },
    # a run-level fault (schema v8, core/preempt.py + the drivers):
    # what interrupted or degraded the run, and what survived it. kind:
    # "preempt" = graceful SIGTERM/SIGINT drain (signal + grace used +
    # the preempt-tagged checkpoint written); "corrupt_checkpoint" = a
    # resume fell back past a damaged generation (detail names it);
    # "round_stall" = the hang watchdog's deadline expired;
    # "fetch_retry" = a retryable input phase needed a backoff retry.
    # round is -1 when no round context exists (a fault at resume
    # time). Numeric/str fields are null where not applicable.
    "fault": {
        "round": _int,
        "kind": _str,             # preempt | corrupt_checkpoint |
                                  # round_stall | fetch_retry | kill
        "signal": _opt_str,       # SIGTERM | SIGINT | null
        "grace_s": _opt_num,      # drain seconds actually used
        "detail": _opt_str,       # human context (paths, errors)
        "checkpoint": _opt_str,   # checkpoint written/skipped, if any
    },
    # crash-recovery lineage (schema v8): a resumed run's first records.
    # Written when the stream is opened in APPEND mode over a
    # predecessor's events.jsonl (prior_stream/prior_events name the
    # segment it continues) and/or when the driver restores a
    # checkpoint (round/epoch/checkpoint say where training resumes;
    # round is -1 when only the stream — not training state — resumed).
    "resume": {
        "round": _int,            # first global round of the resumed run
        "epoch": _opt_num,
        "checkpoint": _opt_str,   # the generation restored from
        "prior_stream": _opt_str,  # predecessor segment's stream_id
        "prior_events": _opt_num,  # events the predecessor had written
    },
    # online anomaly alert (telemetry/health.py): a monitor rule fired
    # against the rolling median/MAD history of a watched stream field.
    # zscore/median/mad are null for non-statistical rules (nonfinite
    # precursors); ``action`` records the configured --alert_action so
    # postmortems know whether a flight-recorder bundle should exist
    "alert": {
        "round": _int,
        "rule": _str,
        "severity": _str,             # info | warn | critical
        "metric": _str,
        "value": _opt_num,
        "zscore": _opt_num,
        "median": _opt_num,
        "mad": _opt_num,
        "window": _int,
        "action": _str,               # log | warn | checkpoint | abort
    },
    # end-of-run footer
    "summary": {
        "run_type": _str,
        "aborted": _bool,
        "n_rounds": _int,
        "total_download_mib": _opt_num,
        "total_upload_mib": _opt_num,
        "wall_time_s": _num,
        "event_counts": _dict,
        "final": _opt_dict,           # last epoch record / bench result
    },
}

ENVELOPE = {"event": _str, "t": _num, "seq": _int}

# fields ADDED to pre-existing event types in schema v6 (the residency
# and roofline enrichments): a v1-v5 stream legitimately omits them, so
# the validator only REQUIRES them of v6+ streams — but a pre-v6 stream
# that does carry one must still type-check (forward-written fields are
# ordinary extra fields otherwise).
FIELDS_SINCE_V6: Dict[str, Tuple[str, ...]] = {
    "memory": ("live_bytes", "peak_bytes", "delta_peak_bytes",
               "fragmentation_bytes", "limit_bytes", "headroom_frac"),
    "utilization": ("peak_hbm_gbps", "bytes_per_round", "bytes_source",
                    "arithmetic_intensity", "ridge_intensity", "bound",
                    "achieved_gbps", "bw_frac", "expected_round_s"),
}

# fields ADDED in schema v7 (the scaling-curve mesh-topology fields) —
# same vintage-gated requirement as FIELDS_SINCE_V6
FIELDS_SINCE_V7: Dict[str, Tuple[str, ...]] = {
    "utilization": ("n_devices", "mesh_shape"),
}

# fields ADDED in schema v8 (crash-recovery lineage) — same vintage-
# gated requirement: pre-v8 manifests legitimately carry no stream_id
FIELDS_SINCE_V8: Dict[str, Tuple[str, ...]] = {
    "manifest": ("stream_id",),
}

# fields ADDED in schema v9 (the quantized sketch wire, --wire_dtype
# int8) — same vintage-gated requirement
FIELDS_SINCE_V9: Dict[str, Tuple[str, ...]] = {
    "collectives": ("wire_dtype", "table_reduce_bytes"),
    "signals": ("wire_dtype",),
    "bench": ("wire_dtype",),
}

# fields ADDED in schema v11 (population-scale sketch observability:
# the participation fields may now be estimates, and the flag says so)
# — same vintage-gated requirement
FIELDS_SINCE_V11: Dict[str, Tuple[str, ...]] = {
    "client_stats": ("estimated",),
}


def validate_event(obj: Any,
                   version: int = SCHEMA_VERSION) -> List[str]:
    """Return a list of problems with one decoded event (empty = valid).
    ``version`` is the stream's manifest schema version: fields added in
    a later version than the stream claims are optional for it (see
    FIELDS_SINCE_V6) — validate_lines threads the observed manifest
    version through; standalone calls default to the current schema."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"event is not an object: {type(obj).__name__}"]
    for field, pred in ENVELOPE.items():
        if field not in obj:
            problems.append(f"missing envelope field {field!r}")
        elif not pred(obj[field]):
            problems.append(f"envelope field {field!r} has wrong type")
    kind = obj.get("event")
    if not isinstance(kind, str):
        return problems
    spec = EVENT_FIELDS.get(kind)
    if spec is None:
        problems.append(f"unknown event type {kind!r}")
        return problems
    v6_only = FIELDS_SINCE_V6.get(kind, ())
    v7_only = FIELDS_SINCE_V7.get(kind, ())
    v8_only = FIELDS_SINCE_V8.get(kind, ())
    v9_only = FIELDS_SINCE_V9.get(kind, ())
    v11_only = FIELDS_SINCE_V11.get(kind, ())
    for field, pred in spec.items():
        if field not in obj:
            if version < 6 and field in v6_only:
                continue
            if version < 7 and field in v7_only:
                continue
            if version < 8 and field in v8_only:
                continue
            if version < 9 and field in v9_only:
                continue
            if version < 11 and field in v11_only:
                continue
            problems.append(f"{kind}: missing field {field!r}")
        elif not pred(obj[field]):
            problems.append(
                f"{kind}: field {field!r} fails its type check "
                f"(got {type(obj[field]).__name__})")
    return problems


def validate_lines(lines: Iterable[str]) -> List[Tuple[int, str]]:
    """Validate an iterable of JSONL lines. Returns [(lineno, problem)];
    also checks the stream shape: seq must be 0,1,2,..., the first event
    must be a manifest with a SUPPORTED schema version."""
    problems: List[Tuple[int, str]] = []
    expected_seq = 0
    version = SCHEMA_VERSION
    for lineno, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError as e:
            problems.append((lineno, f"not valid JSON: {e}"))
            continue
        if (isinstance(obj, dict) and obj.get("event") == "manifest"
                and obj.get("schema") in SUPPORTED_SCHEMA_VERSIONS):
            # the stream's own vintage governs which per-event fields
            # are required of it (see validate_event / FIELDS_SINCE_V6)
            version = obj["schema"]
        for p in validate_event(obj, version=version):
            problems.append((lineno, p))
        if isinstance(obj, dict):
            if expected_seq == 0 and obj.get("event") != "manifest":
                problems.append((lineno, "first event must be a manifest"))
            if (obj.get("event") == "manifest"
                    and obj.get("schema") not in SUPPORTED_SCHEMA_VERSIONS):
                problems.append(
                    (lineno, f"manifest schema {obj.get('schema')!r} not in "
                             f"supported {SUPPORTED_SCHEMA_VERSIONS}"))
            if obj.get("seq") != expected_seq:
                problems.append(
                    (lineno, f"seq {obj.get('seq')!r} != expected "
                             f"{expected_seq} (truncated/merged stream?)"))
            if isinstance(obj.get("seq"), int):
                # resynchronize to the observed counter: one gap is one
                # problem, not a cascade of bogus mismatches on every
                # following line
                expected_seq = obj["seq"] + 1
            else:
                expected_seq += 1
        # non-object lines (already flagged above) do not advance the
        # counter: the writer's own seq continues around an insertion
    if expected_seq == 0:
        problems.append((0, "empty stream (no events)"))
    return problems


def validate_file(path: str) -> List[Tuple[int, str]]:
    with open(path) as f:
        return validate_lines(f)
