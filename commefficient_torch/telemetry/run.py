"""RunTelemetry: the machine-readable event stream of one run, the
port's counterpart of the JAX package's ``telemetry/run.py``.

Writes ``telemetry.jsonl`` (schema.py, the JAX package's schema v11: one
stream validates under either package's validator and
``scripts/teleview.py`` reads both) into the run's logdir. The console
rows stay as they are: telemetry is a parallel channel. Every event is
flushed the moment it is written, and a telemetry failure disables
telemetry, never the run.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Dict, Optional

from commefficient_torch.faults import fault_matches, trigger
from commefficient_torch.telemetry.schema import (SCHEMA_VERSION,
                                                TELEMETRY_BASENAME)


def _jsonable(v: Any) -> Any:
    if isinstance(v, float):
        # non-finite floats serialize as null: json.dumps would emit the
        # literal NaN/Infinity tokens Python accepts but strict JSON
        # parsers (jq, JSON.parse, serde) reject — and a diverging run is
        # exactly when the stream must stay machine-readable. The schema
        # treats the metric fields as nullable for this reason.
        return v if math.isfinite(v) else None
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item"):          # numpy scalars, 0-d tensors
        try:
            return _jsonable(v.item())
        except Exception:
            pass
    return str(v)


def _sketch_geometry(cfg) -> Optional[Dict[str, Any]]:
    if getattr(cfg, "mode", None) != "sketch":
        return None
    return {
        "impl": cfg.sketch_impl,
        "num_rows": cfg.num_rows,
        "num_cols": cfg.num_cols,
        "k": cfg.k,
        "num_blocks": cfg.num_blocks,
        "ef": cfg.sketch_ef,
        "server_state": cfg.sketch_server_state,
        "dtype": cfg.sketch_dtype,
        "wire_dtype": getattr(cfg, "wire_dtype", None) or cfg.sketch_dtype,
    }


class RunTelemetry:
    """Owns the JSONL stream; one instance per run (or per benchmark
    artifact — bench.py threads its instance through bench_gpt2 so both
    stages land in the same file)."""

    def __init__(self, logdir: str, run_type: str, cfg=None,
                 manifest_extra: Optional[Dict[str, Any]] = None,
                 resume_info: Optional[Dict[str, Any]] = None,
                 device=None):
        self.logdir = logdir
        # the run's device (a torch.device or its name): the manifest's
        # backend and device_kind, and the memory events' allocator
        self.device = device
        self.run_type = run_type
        # kept for the schema-v9 wire fields: collectives/signals/bench
        # events name the run's table wire dtype (None for cfg-less
        # streams — the emitters take an explicit override)
        self.cfg = cfg
        self.path = os.path.join(logdir, TELEMETRY_BASENAME)
        self._seq = 0
        # serialize writers: the round loop owns most events, but the
        # hang watchdog's stall callback and the prefetch worker's
        # fetch-retry notes write from THEIR threads — without a lock
        # two writers could allocate the same seq (a validator-visible
        # corruption) or interleave half-lines in the shared buffer
        import threading
        # RLock: the monitor forwarding at the end of event() can fire
        # an alert that re-enters event() on the same thread
        self._lock = threading.RLock()
        # unique segment id: a resumed run appends a new manifest with a
        # fresh id, and its `resume` event names the predecessor's —
        # the crash-recovery lineage chain (schema v8)
        self.stream_id = (f"{run_type}-{os.getpid()}-"
                          f"{int(time.time() * 1000):x}")
        # durations come off the monotonic clock: an NTP step during the
        # run must not produce a negative/skewed wall_time_s. time.time()
        # stays only for the absolute `t` envelope field.
        self._t0 = time.perf_counter()
        self._file = None
        self._counts: Dict[str, int] = {}
        self._monitor = None
        self.last_round: Optional[Dict[str, Any]] = None
        self.last_epoch: Optional[Dict[str, Any]] = None
        # ring buffer of recent serialized events — the flight recorder's
        # "last N events before it died" (telemetry/health.py); 256 covers
        # several record windows of every event type at trivial memory
        self.recent: collections.deque = collections.deque(maxlen=256)
        # recent memory (residency) snapshots, separately ring-buffered:
        # the flight recorder's memory.json wants a residency TIMELINE
        # even when the main ring has long since rotated the early
        # snapshots out under round/span traffic
        self.recent_memory: collections.deque = collections.deque(maxlen=32)
        # residency tracker (telemetry/memory_ledger.py): previous-peak
        # state for delta attribution + the one-time CPU-degradation note
        self._residency = None
        prior = None
        try:
            os.makedirs(logdir, exist_ok=True)
            if (os.path.exists(self.path)
                    and os.path.getsize(self.path) > 0):
                # NEVER clobber an existing stream with mode "w": the
                # file is a predecessor segment (a crashed or preempted
                # run pointed at the same logdir) and this run APPENDS
                # to it behind a `resume` lineage record. The prior
                # run's records — the whole point of a postmortem —
                # survive the restart.
                prior = self._scan_prior()
                self._file = open(self.path, "a")
                if prior["needs_newline"]:
                    # the predecessor died mid-line; terminate the
                    # truncated fragment so appended events stay
                    # line-delimited (the analyzer already tolerates
                    # one malformed line, schema lint flags it)
                    self._file.write("\n")
                self._seq = prior["last_seq"] + 1
            else:
                self._file = open(self.path, "w")
        except OSError as e:
            print(f"WARNING: telemetry disabled ({e})", file=sys.stderr)
            return
        info = dict(resume_info or {})
        if prior is not None:
            # segment boundary marker FIRST (lineage: which segment this
            # continues, and how far it had written), then the fresh
            # manifest — the stream's first line is still the original
            # manifest, so the shape contract holds
            self.resume_event(rnd=int(info.get("round", -1)),
                              epoch=info.get("epoch"),
                              checkpoint=info.get("checkpoint"),
                              prior_stream=prior["stream_id"],
                              prior_events=prior["last_seq"] + 1)
        self.event("manifest", schema=SCHEMA_VERSION, run_type=run_type,
                   stream_id=self.stream_id,
                   **self._environment(device), **self._config_fields(cfg),
                   **(manifest_extra or {}))
        if prior is None and resume_info is not None:
            # a resumed run writing into a FRESH logdir still records
            # its lineage (checkpoint + resume round; no prior segment
            # in this file to name)
            self.resume_event(rnd=int(info.get("round", -1)),
                              epoch=info.get("epoch"),
                              checkpoint=info.get("checkpoint"),
                              prior_stream=info.get("prior_stream"),
                              prior_events=None)

    def _scan_prior(self) -> Dict[str, Any]:
        """Lineage of the existing stream this run appends to: the
        predecessor manifest's stream_id, the last valid seq (ours
        continue from there — the validator's contiguity check spans
        segments), and whether the final line was truncated mid-write.
        Streams line-by-line: a long predecessor run's file can be
        hundreds of MB, and buffering it (plus its decoded copy) would
        double the resume's peak memory for three scalar answers."""
        stream_id = None
        last_seq = -1
        with open(self.path, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(obj, dict):
                    continue
                if obj.get("event") == "manifest" and obj.get("stream_id"):
                    stream_id = obj["stream_id"]
                if isinstance(obj.get("seq"), int):
                    last_seq = max(last_seq, obj["seq"])
        with open(self.path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            needs_newline = f.read(1) != b"\n"
        return {"stream_id": stream_id, "last_seq": last_seq,
                "needs_newline": needs_newline}

    # -------------------------------------------------------------- plumbing

    @property
    def active(self) -> bool:
        """False once the stream failed to open or was closed/disabled."""
        return self._file is not None

    @staticmethod
    def _environment(device=None) -> Dict[str, Any]:
        """The JAX schema's required manifest fields, filled from torch:
        ``backend`` "cuda" or "cpu", ``device_kind`` the card's name,
        ``jax_version`` a string no one can read as a JAX version; and
        ``torch_version``/``cuda_version`` as extra fields."""
        import torch
        dev = torch.device(device if device is not None
                           else ("cuda" if torch.cuda.is_available()
                                 else "cpu"))
        cuda = dev.type == "cuda"
        return {
            "jax_version": "none (PyTorch port)",
            "backend": "cuda" if cuda else "cpu",
            "device_kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
            "device_count": torch.cuda.device_count() if cuda else 1,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
        }

    @staticmethod
    def _config_fields(cfg) -> Dict[str, Any]:
        """``mesh_shape``/``mesh_axes`` as the JAX package writes them:
        the configured mesh ([] on one device)."""
        if cfg is None:
            return {"mesh_shape": [], "mesh_axes": [], "grad_size": 0,
                    "sketch": None, "config": {}}
        return {
            "mesh_shape": list(cfg.mesh_shape),
            "mesh_axes": list(cfg.mesh_axes),
            "grad_size": int(cfg.grad_size),
            "sketch": _sketch_geometry(cfg),
            "config": _jsonable(dataclasses.asdict(cfg)),
        }

    def event(self, kind: str, /, **fields) -> None:
        """Append one event; never raises — a full disk or closed stream
        prints one warning and disables further telemetry. The event
        type is positional-only so a field may itself be named "kind"
        (the v8 `fault` event's fault-kind). Thread-safe: writers off
        the round loop (the watchdog's stall callback, the prefetch
        worker's fetch-retry notes) serialize on the instance lock."""
        with self._lock:
            self._event_locked(kind, fields)

    def _event_locked(self, kind: str, fields) -> None:
        if self._file is None:
            return
        record = {"event": kind, "t": time.time(), "seq": self._seq}
        record.update({k: _jsonable(v) for k, v in fields.items()})
        try:
            # allow_nan=False backstops _jsonable's non-finite mapping:
            # the stream must never contain tokens strict parsers reject
            line = json.dumps(record, allow_nan=False)
            if fault_matches("mid_telemetry_flush", self._seq):
                # crash-matrix kill-point: half a line reaches the file,
                # the process dies unflushed — the resumed run's append
                # path must repair the truncated fragment
                self._file.write(line[: max(len(line) // 2, 1)])
                self._file.flush()
                os.fsync(self._file.fileno())
                trigger("mid_telemetry_flush")
                # sigterm action: trigger() RETURNS (the graceful drain
                # owns what happens next) — terminate the staged
                # fragment so the full line below starts on its own
                # line instead of merging into a permanently malformed
                # record no successor would ever repair
                self._file.write("\n")
            self._file.write(line + "\n")
            self._file.flush()
            if kind in ("alert", "nan_abort", "summary", "fault",
                        "resume"):
                # the events a postmortem reader needs most are exactly
                # the ones written while the run is dying: push them
                # through the OS cache so a crash cannot truncate them
                os.fsync(self._file.fileno())
        except (OSError, ValueError) as e:
            print(f"WARNING: telemetry write failed, disabling ({e})",
                  file=sys.stderr)
            try:
                self._file.close()
            except Exception:
                pass
            self._file = None
            return
        self._seq += 1
        self._counts[kind] = self._counts.get(kind, 0) + 1
        self.recent.append(record)
        if kind == "memory":
            self.recent_memory.append(record)
        if kind == "round":
            # last_round feeds nan_abort as "last record known FINITE":
            # a record whose loss/acc went non-finite (serialized null)
            # must not overwrite the last healthy snapshot
            if (record.get("loss") is not None
                    and record.get("acc") is not None):
                self.last_round = record
        elif kind == "epoch":
            self.last_epoch = record
        if self._monitor is not None:
            # feed the anomaly monitor AFTER serialization so it sees
            # exactly what a postmortem reader will see (NaN -> null);
            # alerts it fires come back through event() with kind
            # "alert", which is not monitored — no recursion
            from commefficient_torch.telemetry.health import MONITORED_KINDS
            if kind in MONITORED_KINDS:
                self._monitor.observe(kind, record)

    def set_monitor(self, monitor) -> None:
        """Attach a health.AnomalyMonitor: every monitored event written
        to the stream is forwarded to it (see event())."""
        self._monitor = monitor

    def fsync(self) -> None:
        """Force the stream through the OS cache — the abort paths call
        this so a postmortem is never truncated by the death it
        documents. Safe on a closed/disabled stream."""
        if self._file is not None:
            try:
                self._file.flush()
                os.fsync(self._file.fileno())
            except OSError:
                pass

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except Exception:
                pass
            self._file = None

    def __enter__(self) -> "RunTelemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- records

    def round_event(self, *, rnd: int, epoch: int, lr: float, loss: float,
                    acc: float, n_valid: float,
                    download_bytes: Optional[float],
                    upload_bytes: Optional[float],
                    host_s: float, dispatch_s: float,
                    device_s: float) -> None:
        self.event("round", round=rnd, epoch=epoch, lr=float(lr),
                   loss=float(loss), acc=float(acc), n_valid=float(n_valid),
                   download_bytes=download_bytes, upload_bytes=upload_bytes,
                   host_s=round(host_s, 6), dispatch_s=round(dispatch_s, 6),
                   device_s=round(device_s, 6))

    def epoch_event(self, summary: Dict[str, Any], **extra) -> None:
        """``summary`` is the exact dict the TableLogger receives; its
        presentation keys ("down (MiB)") are normalized for the stream."""
        s = dict(summary)
        self.event("epoch", epoch=int(s.pop("epoch")),
                   lr=float(s.pop("lr")),
                   train_time=float(s.pop("train_time")),
                   train_loss=float(s.pop("train_loss")),
                   train_acc=float(s.pop("train_acc")),
                   test_loss=float(s.pop("test_loss")),
                   test_acc=float(s.pop("test_acc")),
                   download_mib=float(s.pop("down (MiB)")),
                   upload_mib=float(s.pop("up (MiB)")),
                   total_time=float(s.pop("total_time")),
                   **{**s, **extra})

    def memory_event(self, phase: str) -> None:
        """Device memory snapshot and the derived residency fields
        (telemetry/memory_ledger.py): live and peak bytes, the peak's
        growth since the previous snapshot, fragmentation and headroom;
        null, never zero, off the card (a one-time note), with the host's
        RSS either way."""
        if self._file is None:
            return
        from commefficient_torch.telemetry.memory_ledger import \
            ResidencyTracker
        if self._residency is None:
            self._residency = ResidencyTracker()
        devices, derived = self._residency.snapshot(
            [self.device if self.device is not None else "cpu"])
        rss = None
        try:
            import resource
            rss = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                   * 1024)  # linux reports KiB
        except Exception:
            pass
        self.event("memory", phase=phase,
                   devices=[{**d, "stats": _jsonable(d["stats"])
                             if d["stats"] else None} for d in devices],
                   host_rss_bytes=rss, **derived)

    @property
    def residency(self):
        """The stream's ResidencyTracker (made at first use)."""
        from commefficient_torch.telemetry.memory_ledger import \
            ResidencyTracker
        if self._residency is None:
            self._residency = ResidencyTracker()
        return self._residency

    def memory_ledger_event(self, name: str, ledger: Dict[str, Any],
                            **extra) -> None:
        """A byte inventory of one step (schema v6): in the port the
        measured ``round_step`` ledger (memory_ledger.measure_round),
        with ``source: "measured"`` among ``extra``."""
        from commefficient_torch.telemetry.memory_ledger import \
            MEMORY_LEDGER_KEYS
        self.event("memory_ledger", name=name,
                   **{k: ledger.get(k) for k in MEMORY_LEDGER_KEYS},
                   **extra)

    def nan_abort(self, *, nan_round: int, reason: str, cfg) -> None:
        """The structured replacement for the bare 'TRAINING DIVERGED'
        exit: which round went non-finite, under which mode/clip/sketch
        config, and the last records known finite."""
        self.event("nan_abort", nan_round=int(nan_round), reason=reason,
                   mode=cfg.mode,
                   max_grad_norm=cfg.max_grad_norm,
                   sketch=_sketch_geometry(cfg),
                   last_round=self.last_round,
                   last_epoch=self.last_epoch)

    def _wire_dtype(self) -> Optional[str]:
        """The run's sketch-table wire dtype for the schema-v9 wire
        fields: the resolved --wire_dtype in sketch mode, null for
        cfg-less streams or modes with no table wire."""
        if self.cfg is None or getattr(self.cfg, "mode", None) != "sketch":
            return None
        return (getattr(self.cfg, "wire_dtype", None)
                or getattr(self.cfg, "sketch_dtype", None))

    def bench_event(self, metric: str, result: Dict[str, Any],
                    wire_dtype: Optional[str] = None) -> None:
        self.event("bench", metric=metric, result=result,
                   wire_dtype=wire_dtype or self._wire_dtype())

    def signals_event(self, *, rnd: int, mode: str,
                      signals: Dict[str, Any],
                      download_bytes: Optional[float] = None,
                      upload_bytes: Optional[float] = None,
                      client_download_bytes=None,
                      client_upload_bytes=None) -> None:
        """Compression-signal health for one round (telemetry/signals.py
        computes the dict on device; the driver fetches it at the same
        cadence as the round record). Non-finite values — the NaN used
        for not-applicable signals — serialize as null via _jsonable."""
        self.event("signals", round=rnd, mode=mode, **signals,
                   download_bytes=download_bytes, upload_bytes=upload_bytes,
                   client_download_bytes=client_download_bytes,
                   client_upload_bytes=client_upload_bytes,
                   wire_dtype=self._wire_dtype())

    def layer_signals_event(self, *, rnd: int, mode: str,
                            signal_groups: str, groups, sizes,
                            values: Dict[str, Any]) -> None:
        """Layer-wise compression attribution for one round (schema
        v10, telemetry/layer_signals.py computes the per-group vectors
        on device; the driver fetches them at the signals cadence).
        ``values`` is the layer_signals_to_host dict — None fields and
        NaN entries serialize as nulls, never fake zeros."""
        from commefficient_torch.telemetry.layer_signals import \
            LAYER_SIGNAL_KEYS
        self.event("layer_signals", round=int(rnd), mode=mode,
                   signal_groups=signal_groups,
                   groups=list(groups), sizes=list(sizes),
                   **{k: values.get(k) for k in LAYER_SIGNAL_KEYS})

    def client_stats_event(self, *, rnd: int, n_participants: int,
                           quantiles: Dict[str, Any],
                           participation: Dict[str, Any]) -> None:
        """Per-client population summary for one round
        (telemetry/clients.py): the device-reduced quantiles joined with
        the host-side participation ledger snapshot — same cadence, same
        host sync as the round record."""
        self.event("client_stats", round=int(rnd),
                   n_participants=int(n_participants),
                   quantiles=quantiles, **participation)

    def population_event(self, *, snapshot: Dict[str, Any]) -> None:
        """Population-scale participation summary (schema v11): the
        ledger's population_snapshot dict — sketch-estimated or exact,
        its ``estimated`` flag says which (telemetry/population.py)."""
        self.event("population", **snapshot)

    def async_round_event(self, *, rec: Dict[str, Any], lr: float,
                          loss: Optional[float] = None,
                          with_device: bool = False) -> None:
        """One async buffered-aggregation commit (core/async_agg.py
        commit record). ``with_device=True`` fetches the record's device
        scalar refs (buffer_n and the post-commit norms) — the caller
        opts in only at the record cadence, because each fetch is a host
        sync; off-cadence commits record their (host-side) staleness
        bookkeeping with the device fields null."""

        def dev(key):
            if not with_device or rec.get(key) is None:
                return None
            v = rec[key]
            return float(v.item() if hasattr(v, "item") else v)

        self.event("async_round", round=int(rec["round"]),
                   n_cohorts=int(rec["n_cohorts"]),
                   cohorts=[int(c) for c in rec["cohorts"]],
                   staleness_mean=float(rec["staleness_mean"]),
                   staleness_max=float(rec["staleness_max"]),
                   discount_mean=float(rec["discount_mean"]),
                   discount_min=float(rec["discount_min"]),
                   partial=bool(rec["partial"]),
                   buffer_n=dev("buffer_n"), loss=loss,
                   update_norm=dev("update_norm"),
                   error_norm=dev("error_norm"),
                   velocity_norm=dev("velocity_norm"),
                   lr=float(lr))

    def defense_event(self, *, rnd: int, defense: str, adversary: str,
                      nonfinite_action: str,
                      device: Optional[Dict[str, Any]] = None,
                      quarantine: Optional[Dict[str, Any]] = None,
                      injected: Optional[Dict[str, Any]] = None) -> None:
        """Robustness status of one round (schema v5, core/runtime.py):
        ``device`` is the round's defense scalar dict (already fetched;
        NaN = not-applicable, serialized null), ``quarantine`` the
        QuarantineLedger snapshot, ``injected`` the per-fate injected
        slot counts when fault injection is on."""
        device = device or {}
        q = quarantine or {}
        self.event("defense", round=int(rnd), defense=defense,
                   adversary=adversary, nonfinite_action=nonfinite_action,
                   clip_frac=device.get("clip_frac"),
                   clip_thresh=device.get("clip_thresh"),
                   clipped_mass=device.get("clipped_mass"),
                   trim_frac=device.get("trim_frac"),
                   nonfinite_clients=device.get("nonfinite_clients"),
                   quarantined=int(q.get("quarantined", 0)),
                   ejected=int(q.get("ejected", 0)),
                   quarantine_ids_digest=q.get("quarantine_ids_digest"),
                   injected=injected)

    def alert_event(self, *, rnd: int, rule: str, severity: str,
                    metric: str, value: Optional[float] = None,
                    zscore: Optional[float] = None,
                    median: Optional[float] = None,
                    mad: Optional[float] = None, window: int = 0,
                    action: str = "log") -> None:
        """One anomaly alert (telemetry/health.py normally emits these
        through the monitor; the drivers use this directly for the final
        nonfinite-abort alert so a postmortem's LAST event before the
        nan_abort names the rule that killed the run)."""
        self.event("alert", round=int(rnd), rule=rule, severity=severity,
                   metric=metric, value=value, zscore=zscore, median=median,
                   mad=mad, window=int(window), action=action)

    def fault_event(self, *, rnd: int, kind: str,
                    signal: Optional[str] = None,
                    grace_s: Optional[float] = None,
                    detail: Optional[str] = None,
                    checkpoint: Optional[str] = None) -> None:
        """One run-level fault (schema v8, core/preempt.py): a graceful
        preemption drain, a corrupt-checkpoint fallback at resume, a
        watchdog round_stall, an input-phase retry. Fsynced on write
        (see event()) — a fault record that the fault itself truncates
        would be useless."""
        self.event("fault", round=int(rnd), kind=kind, signal=signal,
                   grace_s=(round(float(grace_s), 3)
                            if grace_s is not None else None),
                   detail=detail, checkpoint=checkpoint)

    def resume_event(self, *, rnd: int, epoch: Optional[int] = None,
                     checkpoint: Optional[str] = None,
                     prior_stream: Optional[str] = None,
                     prior_events: Optional[int] = None) -> None:
        """Crash-recovery lineage record (schema v8). The append-mode
        constructor writes one automatically when it continues an
        existing stream; drivers use this form when the resumed run
        lands in a fresh logdir."""
        self.event("resume", round=int(rnd), epoch=epoch,
                   checkpoint=checkpoint, prior_stream=prior_stream,
                   prior_events=prior_events)

    def span_event(self, tracer) -> None:
        """Drain a tracing.SpanTracer's completed spans into one batched
        ``span`` event. Call OUTSIDE the timed region (the drivers do it
        next to the round record) — the JSONL flush must not land inside
        any phase the spans measure. No-op when nothing happened.
        n_dropped is per-WINDOW (pop_dropped resets the counter), so
        summing it across span events gives the true drop total."""
        dropped = tracer.pop_dropped()
        spans = tracer.drain()
        if not spans and not dropped:
            return
        self.event("span", t0_wall=tracer.t0_wall,
                   n_dropped=int(dropped), spans=spans)

    def write_summary(self, *, aborted: bool, n_rounds: int,
                      total_download_mib: Optional[float] = None,
                      total_upload_mib: Optional[float] = None,
                      final: Optional[Dict[str, Any]] = None) -> None:
        self.event("summary", run_type=self.run_type, aborted=aborted,
                   n_rounds=int(n_rounds),
                   total_download_mib=total_download_mib,
                   total_upload_mib=total_upload_mib,
                   wall_time_s=round(time.perf_counter() - self._t0, 3),
                   event_counts=dict(self._counts),
                   final=final)


def maybe_create(cfg, run_type: str, logdir: Optional[str] = None,
                 resume_info: Optional[Dict[str, Any]] = None,
                 device=None) -> Optional[RunTelemetry]:
    """Driver entry point: honours --no_telemetry, defaults the logdir to
    the run's ``make_logdir`` location, announces the path on stderr.
    ``resume_info`` ({round, epoch, checkpoint}) threads the restored
    position into the stream's ``resume`` lineage record."""
    if not getattr(cfg, "telemetry", True):
        return None
    if logdir is None:
        from commefficient_torch.utils.logging import make_logdir
        logdir = make_logdir(cfg)
    tel = RunTelemetry(logdir, run_type, cfg=cfg, resume_info=resume_info,
                       device=device)
    if not tel.active:
        return None
    print(f"telemetry: {tel.path}", file=sys.stderr)
    return tel
