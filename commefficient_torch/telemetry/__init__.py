"""Run telemetry of the PyTorch port, the counterpart of the JAX
package's ``telemetry/``: the schema-v11 ``telemetry.jsonl`` stream
(schema.py, run.py), the compression signals computed on the device
(signals.py, layer_signals.py over ops/segments.py), per-client
population statistics and the participation ledger (clients.py,
population.py), the anomaly monitor and flight recorder (health.py),
span tracing (tracing.py), utilization and memory on the card
(utilization.py, memory_ledger.py) and the profiler window
(profiling.py), shared by ``cv_train`` and ``gpt2_train`` through
``core/driver.py``. The JAX package's collective ledger (a mesh's) and
compile watcher (an XLA compile's) have no counterpart in a one-device
eager run. ``scripts/teleview.py`` summarizes either package's stream."""

from commefficient_torch.telemetry.clients import (CLIENT_STAT_KEYS,
                                                   ParticipationLedger,
                                                   client_stats_to_host,
                                                   make_ledger,
                                                   quantiles_ordered,
                                                   summarize_per_client)
from commefficient_torch.telemetry.health import (MONITORED_KINDS,
                                                  AnomalyMonitor,
                                                  FlightRecorder, robust_z)
from commefficient_torch.telemetry.layer_signals import (LAYER_SIGNAL_KEYS,
                                                         GroupSpec,
                                                         layer_group_signals,
                                                         layer_signals_to_host,
                                                         make_group_spec,
                                                         starved_groups)
from commefficient_torch.telemetry.memory_ledger import (
    MEMORY_KEYS, MEMORY_LEDGER_KEYS, ResidencyTracker,
    check_dense_grad_floor, ledger_from_round, measure_round,
    residency_fields)
from commefficient_torch.telemetry.population import (AUTO_SKETCH_THRESHOLD,
                                                      MEMORY_BUDGET_BYTES,
                                                      POPULATION_KEYS,
                                                      CountMinSketch,
                                                      KMVSample, P2Quantile,
                                                      PopulationLedger,
                                                      SpaceSaving)
from commefficient_torch.telemetry.profiling import (ProfilerWindow,
                                                     parse_profile_rounds)
from commefficient_torch.telemetry.run import RunTelemetry, maybe_create
from commefficient_torch.telemetry.schema import (SCHEMA_VERSION,
                                                  TELEMETRY_BASENAME,
                                                  validate_event,
                                                  validate_file,
                                                  validate_lines)
from commefficient_torch.telemetry.signals import (SIGNAL_KEYS,
                                                   round_signals,
                                                   signals_to_host,
                                                   tree_to_host)
from commefficient_torch.telemetry.tracing import (NullTracer, SpanTracer,
                                                   span)
from commefficient_torch.telemetry.utilization import (
    PEAK_FLOPS_BY_KIND, PEAK_HBM_GBPS_BY_KIND, ROOFLINE_KEYS,
    UtilizationTracker, emit_from_totals, peak_flops_for, peak_hbm_for,
    roofline_fields)

__all__ = [
    "CLIENT_STAT_KEYS", "ParticipationLedger", "client_stats_to_host",
    "make_ledger", "quantiles_ordered", "summarize_per_client",
    "AUTO_SKETCH_THRESHOLD", "MEMORY_BUDGET_BYTES", "POPULATION_KEYS",
    "CountMinSketch", "KMVSample", "P2Quantile", "PopulationLedger",
    "SpaceSaving", "MONITORED_KINDS", "AnomalyMonitor", "FlightRecorder",
    "robust_z", "ProfilerWindow", "parse_profile_rounds", "RunTelemetry",
    "maybe_create", "SCHEMA_VERSION", "TELEMETRY_BASENAME",
    "validate_event", "validate_file", "validate_lines", "SIGNAL_KEYS",
    "round_signals", "signals_to_host", "tree_to_host",
    "LAYER_SIGNAL_KEYS", "GroupSpec", "layer_group_signals",
    "layer_signals_to_host", "make_group_spec", "starved_groups",
    "NullTracer", "SpanTracer", "span", "PEAK_FLOPS_BY_KIND",
    "PEAK_HBM_GBPS_BY_KIND", "ROOFLINE_KEYS", "UtilizationTracker",
    "emit_from_totals",
    "peak_flops_for", "peak_hbm_for",
    "roofline_fields", "MEMORY_KEYS", "MEMORY_LEDGER_KEYS",
    "ResidencyTracker", "check_dense_grad_floor",
    "ledger_from_round", "measure_round", "residency_fields",
]
