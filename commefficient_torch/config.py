"""Run configuration of the PyTorch port: the part of the JAX package's
``FedConfig`` that the port runs, plus ``auto_num_cols``.

The port runs the single-device round in every mode of ``MODES``
(uncompressed, true_topk, local_topk, fedavg and the FetchSGD sketch
with the circulant, hash or SRHT sketch, either error-feedback rule and
the table or dense server state), with local momentum and local or
virtual error, microbatches, whole-client batches, gradient clipping,
DP, top-k download and byte accounting, of every CV model of the JAX
package's registry (``models.MODEL_NAMES``; Fixup's per-parameter rates
for the Fixup models) on CIFAR10, CIFAR100 or LEAF FEMNIST (``EMNIST``),
ImageNet, natural or iid clients, finetuning a saved model's head
(``cv_train``), and GPT-2 DoubleHeads on PersonaChat (``gpt2_train``,
with block remat, the chunked LM loss, local HF weights and
``save_pretrained``), with whole-state checkpoints and resume in both,
the host path's batches fetched ahead by the round input pipeline
(``core/pipeline.py``), the sketch table's float32, bf16 or int8 wire
(``--wire_dtype``, ``--wire_block``, the deprecated ``--sketch_dtype``),
the SRHT's row scan (``--sketch_scan_rows``), the runtime services
(``add_service_args``: robust aggregation, adversaries and the
quarantine, FedBuff and its straggler scenarios, the preemption drain
and the watchdog) and the run telemetry (``add_telemetry_args``: the
``telemetry.jsonl`` stream, the in-round signals and client statistics,
the anomaly monitor, utilization peaks and the profiler window), on one
device or a clients mesh (``--mesh_shape``, one process a rank; the
sharded sketch server tail, ``--sketch_sharded_server``), with the round
split into its client and decode halves under ``--decode_overlap``. A
value or flag outside it raises and names the flag: the XLA-only flags,
a ``seq`` mesh axis, ``--checkpoint_sharded`` and the int8 wire on a mesh
are not ported.
Which combinations of mode, error type and momentum are legal is the
server's rule (``core/server.py validate_mode_combo``), checked when a
runtime is built, as in the JAX package. Defaults and choices are the
JAX package's (its ``config.py``), so one command line configures the
same run in both packages; like the JAX package's, the defaults
(``--error_type none``, ``--local_momentum 0.9``) are illegal in the
default sketch mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence, Tuple

from commefficient_torch.models import MODEL_NAMES

MODES = ("sketch", "true_topk", "local_topk", "fedavg", "uncompressed")
ERROR_TYPES = ("none", "local", "virtual")
DP_MODES = ("worker", "server")
SKETCH_IMPLS = ("circ", "hash", "rht")
SERVER_STATES = ("table", "dense")
WIRE_DTYPES = ("float32", "bfloat16", "int8")
# the runtime services (core/async_agg.py, data/scenarios.py,
# core/server.py robust_aggregate, core/quarantine.py, core/preempt.py)
ADVERSARY_KINDS = ("none", "labelflip", "signflip", "scale", "noise", "nan")
DEFENSES = ("none", "normclip", "trim")
NONFINITE_ACTIONS = ("abort", "quarantine")
DISCOUNT_RULES = ("none", "poly", "exp")
SCENARIO_KINDS = ("none", "uniform", "lognormal", "stragglers")
# the run telemetry (telemetry/): the anomaly monitor's actions, the
# layer-signal groupings, the participation ledger's backings
ALERT_ACTIONS = ("log", "warn", "checkpoint", "abort")
SIGNAL_GROUPS = ("coarse", "leaf", "off")
POPULATION_SKETCH = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class FedConfig:
    mode: str = "sketch"
    model: str = "ResNet9"
    dataset_name: str = "CIFAR10"
    dataset_dir: str = "./dataset"
    do_iid: bool = False
    # the train split normalised only: no crop or flip (implied by
    # synthetic_hard)
    no_augment: bool = False
    do_batchnorm: bool = False
    seed: int = 21
    synthetic_per_class: int = 64
    # the synthetic CIFAR generator's non-saturating regime and its
    # train-only label noise (data/fed_cifar.py synthetic_cifar)
    synthetic_hard: bool = False
    synthetic_label_noise: float = 0.0
    # finetune: the head of <finetune_path>/<model>.npz, trained at the
    # dataset's class count on the backbone of the model trained on
    # finetuned_from, which stays frozen
    do_finetune: bool = False
    finetune_path: str = "./finetune"
    finetuned_from: Optional[str] = None
    eval_before_start: bool = False
    # the round input pipeline: the host path fetches the next rounds'
    # batches on a worker thread, at most prefetch_depth ahead; False
    # fetches inline (the device store always does)
    pipeline: bool = True
    prefetch_depth: int = 2
    k: int = 50_000
    num_cols: int = 500_000
    num_rows: int = 5
    num_blocks: int = 20           # the hash sketch's encode blocks
    exact_num_cols: bool = False
    do_topk_down: bool = False
    local_momentum: float = 0.9
    virtual_momentum: float = 0.0
    weight_decay: float = 5e-4
    num_epochs: float = 24.0
    num_fedavg_epochs: int = 1
    fedavg_batch_size: int = -1
    fedavg_lr_decay: float = 1.0
    error_type: str = "none"
    lr_scale: Optional[float] = 0.4
    pivot_epoch: float = 5.0
    num_clients: Optional[int] = None
    num_workers: int = 1
    local_batch_size: int = 8      # -1: each client's whole dataset
    valid_batch_size: int = 8
    microbatch_size: int = -1      # -1: the whole batch in one fwd/bwd
    # the static bound that whole-client batches are padded to
    max_client_batch: int = 512
    track_bytes: bool = True
    compute_dtype: str = "bfloat16"
    sketch_seed: int = 42
    sketch_impl: str = "circ"
    allow_divergent_rht: bool = False
    # the deprecated alias of wire_dtype; it also sets the SRHT's
    # transform dtype. __post_init__ resolves the pair as the JAX package
    # does: an empty wire_dtype inherits it, a bf16 wire sets it to bf16,
    # a float32 or int8 wire to float32
    sketch_dtype: str = "float32"
    # what a sketch table cell costs on the wire (ops/wire.py): bf16
    # rounds each uploaded table, int8 block-quantizes it with
    # stochastic rounding and wire_block columns a float32 scale
    wire_dtype: str = ""
    wire_block: int = 256
    # the SRHT's row-at-a-time transforms: -1 on at d' >= 2^25, 0 off, 1 on
    sketch_scan_rows: int = -1
    sketch_server_state: str = "table"
    sketch_ef: str = "zero"
    sketch_fused_encode: str = "auto"
    # the clients mesh (parallel/mesh.py): () is one device; the sharded
    # sketch server tail on it (auto, on, off), and the round split into
    # client and server-decode halves (core/pipeline.py)
    mesh_shape: Tuple[int, ...] = ()
    mesh_axes: Tuple[str, ...] = ("clients",)
    sketch_sharded_server: str = "auto"
    decode_overlap: bool = False
    error_decay: float = 1.0
    approx_topk: bool = False
    strict_regimes: bool = False
    # clipping (the dense gradient's, x num_iters, in the dense modes and
    # under sketch_dense_clip; else each client's table) and DP
    max_grad_norm: Optional[float] = None
    sketch_dense_clip: bool = False
    do_dp: bool = False
    dp_mode: str = "worker"
    l2_norm_clip: float = 1.0
    noise_multiplier: float = 0.0
    grad_size: int = 0
    # checkpoints (checkpoint.py): every N epochs under checkpoint_path,
    # resume from the newest intact one, and the end-of-run weights
    checkpoint_every: int = 0
    checkpoint_path: str = "./checkpoint"
    do_resume: bool = False
    resume_unverified: bool = False
    do_checkpoint: bool = False
    # GPT-2 / PersonaChat (gpt2_train)
    do_test: bool = False
    lr_warmup: bool = False
    num_candidates: int = 2
    max_history: int = 2
    max_seq_len: int = 0
    lm_coef: float = 1.0
    mc_coef: float = 1.0
    personality_permutations: int = 1
    attn_impl: str = "auto"
    # GPT-2's memory levers: block recompute and its JAX policy name, and
    # the LM loss lm_chunk positions at a time (0: all at once)
    do_remat: bool = False
    remat_policy: str = ""
    lm_chunk: int = 0
    # a local HF checkpoint (directory or hub-cache name) to start from
    model_checkpoint: str = "gpt2"
    # the runtime services, with the JAX package's defaults. Asynchronous
    # buffered aggregation (core/async_agg.py, FedBuff): up to
    # max_inflight cohorts in flight, a commit every buffer_goal merged
    # cohorts, each merged at staleness_discount's weight; the straggler
    # scenario (data/scenarios.py) draws each cohort's latency, dropout
    # and participation and needs async_agg
    async_agg: bool = False
    max_inflight: int = 4
    buffer_goal: int = 1
    staleness_discount: str = "poly"
    staleness_alpha: float = 0.5
    scenario: str = "none"
    scenario_latency: float = 1.0
    scenario_spread: float = 0.5
    scenario_straggler_frac: float = 0.1
    scenario_straggler_mult: float = 10.0
    scenario_dropout: float = 0.0
    scenario_participation: float = 1.0
    # adversarial clients (a deterministic adversary_frac of the universe,
    # keyed by (seed, client id)), robust aggregation in transmitted
    # space (core/server.py robust_aggregate) and the quarantine of
    # clients whose uploads went nonfinite (core/quarantine.py)
    adversary: str = "none"
    adversary_frac: float = 0.0
    adversary_scale: float = 10.0
    defense: str = "none"
    defense_clip_mult: float = 3.0
    defense_window: int = 8
    defense_trim_frac: float = 0.1
    nonfinite_action: str = "abort"
    quarantine_backoff: int = 8
    quarantine_strikes: int = 3
    # preemption (core/preempt.py): the drain's budget in seconds after
    # the first SIGTERM/SIGINT, and the hang watchdog
    preempt_grace: float = 30.0
    watchdog: bool = False
    watchdog_mult: float = 10.0
    # run telemetry (telemetry/), with the JAX package's defaults: the
    # telemetry.jsonl stream in the run's logdir (logdir "" = make_logdir's
    # timestamped directory), a round record every telemetry_every rounds
    # (-1: every round under --test, else every 64; 0: none), the
    # in-round signals (signals_exact adds topk_overlap and, on the table
    # state, the dense shadow pair), the layer-signal groups, the
    # per-client statistics and the participation ledger's backing, the
    # anomaly monitor, the peaks of the utilization events (0: the
    # per-card table), and the profiler window
    telemetry: bool = True
    telemetry_every: int = -1
    logdir: str = ""
    use_tensorboard: bool = False
    signals: bool = True
    signals_exact: bool = False
    signal_groups: str = "coarse"
    client_stats: bool = True
    population_sketch: str = "auto"
    alert_action: str = "log"
    alert_window: int = 32
    alert_zscore: float = 6.0
    peak_flops: float = 0.0
    peak_hbm_gbps: float = 0.0
    profile_dir: str = ""
    profile_rounds: str = "2:4"

    def __post_init__(self):
        if self.synthetic_hard and not self.no_augment:
            # the hard regime's class evidence is per pixel: a crop or a
            # flip scrambles it (the JAX package's rule)
            object.__setattr__(self, "no_augment", True)
        if self.prefetch_depth < 1:
            raise ValueError(
                f"--prefetch_depth {self.prefetch_depth} must be >= 1 (the "
                "prefetcher's queue bound; 2 = double-buffered); "
                "--no_pipeline fetches inline")
        if self.do_finetune and self.finetuned_from not in CV_DATASETS:
            raise ValueError(
                f"--finetune needs --finetuned_from, the dataset the saved "
                f"model was trained on (one of {', '.join(CV_DATASETS)}); "
                f"got {self.finetuned_from!r}")
        choices = {"mode": MODES, "error_type": ERROR_TYPES,
                   "sketch_ef": ("zero", "subtract"),
                   "dp_mode": DP_MODES, "sketch_impl": SKETCH_IMPLS,
                   "sketch_server_state": SERVER_STATES,
                   "sketch_fused_encode": ("auto", "on", "off"),
                   "sketch_sharded_server": ("auto", "on", "off"),
                   "attn_impl": ("auto", "dense", "flash"),
                   "compute_dtype": ("bfloat16", "float32"),
                   "staleness_discount": DISCOUNT_RULES,
                   "scenario": SCENARIO_KINDS, "adversary": ADVERSARY_KINDS,
                   "defense": DEFENSES,
                   "nonfinite_action": NONFINITE_ACTIONS,
                   "signal_groups": SIGNAL_GROUPS,
                   "population_sketch": POPULATION_SKETCH,
                   "alert_action": ALERT_ACTIONS}
        for name, legal in choices.items():
            if getattr(self, name) not in legal:
                raise ValueError(f"--{name} {getattr(self, name)!r}: want "
                                 "one of " + ", ".join(legal))
        self._resolve_wire()
        self._check_services()
        self._check_telemetry()
        if (self.model, self.dataset_name) not in MODEL_DATASETS:
            raise ValueError(
                f"--model {self.model} --dataset_name {self.dataset_name} "
                "is outside the PyTorch port's slice (ported: the CV "
                f"models {', '.join(MODEL_NAMES)} on "
                f"{', '.join(CV_DATASETS)}; GPT2 on PERSONA)")
        if self.local_batch_size == 0 or self.local_batch_size < -1:
            raise ValueError(f"--local_batch_size {self.local_batch_size}: "
                             "want a positive batch, or -1 for each "
                             "client's whole dataset")
        if self.microbatch_size == 0 or self.microbatch_size < -1:
            raise ValueError(f"--microbatch_size {self.microbatch_size}: "
                             "want a positive size, or -1 for the whole "
                             "batch")
        if self.num_workers < 1 or self.k < 1 or self.num_rows < 1 \
                or self.num_cols < 1 or self.max_client_batch < 1 \
                or self.num_fedavg_epochs < 1 or self.checkpoint_every < 0:
            raise ValueError("--num_workers, --k, --num_rows, --num_cols, "
                             "--max_client_batch and --num_fedavg_epochs "
                             "must be positive, --checkpoint_every not "
                             "negative")
        if self.sketch_fused_encode == "on" and self.mode != "sketch":
            raise ValueError(
                f"--sketch_fused_encode on requires --mode sketch (mode="
                f"{self.mode} has no sketch encode to fuse); use auto")
        if self.sketch_sharded_server == "on" and self.mode != "sketch":
            raise ValueError(
                f"--sketch_sharded_server on requires --mode sketch (mode="
                f"{self.mode} has no sketch server tail to shard); drop "
                "the flag or use --sketch_sharded_server auto (a no-op "
                "off sketch mode)")
        if self.decode_overlap and self.async_agg:
            raise ValueError(
                "--decode_overlap and --async_agg are mutually exclusive: "
                "async buffered aggregation already splits the round into "
                "cohort and commit executables (and adds buffering "
                "semantics on top). Drop one of the flags.")
        from commefficient_torch.parallel.mesh import check_axes
        check_axes(self.mesh_shape, self.mesh_axes)
        if self.sketch_dense_clip and (self.mode != "sketch"
                                       or self.max_grad_norm is None):
            # a clip study run unclipped would measure the wrong rule
            raise ValueError("--sketch_dense_clip requires --mode sketch "
                             "and --max_grad_norm")
        if self.mode == "fedavg" and self.local_batch_size != -1:
            # the reference's invariant (its utils.py:225-228); the mode,
            # error and momentum rules are validate_mode_combo's
            raise ValueError("--mode fedavg requires --local_batch_size -1")

    def _check_services(self) -> None:
        """The JAX package's refusals of the runtime services' numbers
        (its ``config.py``); which modes each service admits is the
        runtime's check (``validate_async_combo``,
        ``validate_defense_combo``)."""
        if self.staleness_alpha <= 0:
            raise ValueError(
                f"--staleness_alpha {self.staleness_alpha} must be > 0")
        if self.async_agg:
            if self.buffer_goal < 1:
                raise ValueError(
                    f"--buffer_goal {self.buffer_goal} must be >= 1")
            if self.max_inflight < 1:
                raise ValueError(
                    f"--max_inflight {self.max_inflight} must be >= 1")
        if not 0.0 <= self.scenario_dropout < 1.0:
            raise ValueError(f"--scenario_dropout {self.scenario_dropout} "
                             "must be in [0, 1)")
        if not 0.0 < self.scenario_participation <= 1.0:
            raise ValueError(
                f"--scenario_participation {self.scenario_participation} "
                "must be in (0, 1]")
        if not self.async_agg and (
                self.scenario != "none" or self.scenario_dropout > 0
                or self.scenario_participation < 1.0):
            raise ValueError(
                "--scenario/--scenario_dropout/--scenario_participation "
                "require --async_agg: the synchronous round loop has no "
                "notion of a late, dropped or partially-participating "
                "cohort, so the scenario would be silently ignored.")
        if not 0.0 <= self.adversary_frac <= 1.0:
            raise ValueError(
                f"--adversary_frac {self.adversary_frac} must be in [0, 1]")
        if self.adversary != "none" and self.adversary_frac == 0.0:
            raise ValueError(
                f"--adversary {self.adversary} with --adversary_frac 0 "
                "injects nothing; pass --adversary_frac > 0 (fraction of "
                "the client universe that is hostile)")
        if self.adversary == "none" and self.adversary_frac > 0.0:
            raise ValueError(
                f"--adversary_frac {self.adversary_frac} without "
                "--adversary selects clients that then do nothing; pass "
                f"--adversary {{{','.join(ADVERSARY_KINDS[1:])}}}")
        if self.adversary_scale <= 0:
            raise ValueError(
                f"--adversary_scale {self.adversary_scale} must be > 0 "
                "(scale attack multiplier / noise sigma)")
        if self.defense_clip_mult <= 0:
            raise ValueError(
                f"--defense_clip_mult {self.defense_clip_mult} must be > 0")
        if self.defense_window < 1:
            raise ValueError(
                f"--defense_window {self.defense_window} must be >= 1")
        if not 0.0 <= self.defense_trim_frac < 0.5:
            raise ValueError(
                f"--defense_trim_frac {self.defense_trim_frac} must be in "
                "[0, 0.5): trimming half or more of the clients per side "
                "leaves nothing to average")
        if self.quarantine_backoff < 1:
            raise ValueError(
                f"--quarantine_backoff {self.quarantine_backoff} must be "
                ">= 1 (rounds a struck client sits out before a retry)")
        if self.quarantine_strikes < 1:
            raise ValueError(
                f"--quarantine_strikes {self.quarantine_strikes} must be "
                ">= 1 (strikes before permanent ejection)")
        if self.preempt_grace <= 0:
            raise ValueError(
                f"--preempt_grace {self.preempt_grace} must be > 0 "
                "seconds (the graceful-drain budget after the first "
                "SIGTERM/SIGINT; a second signal always force-exits)")
        if self.watchdog_mult < 1:
            raise ValueError(
                f"--watchdog_mult {self.watchdog_mult} must be >= 1: the "
                "stall deadline is this multiple of the rolling median "
                "round time, and a sub-1 multiplier would declare the "
                "median round stalled")

    def _check_telemetry(self) -> None:
        """The JAX package's refusals of the telemetry flags."""
        if self.telemetry_every < -1:
            raise ValueError(f"--telemetry_every {self.telemetry_every} "
                             "must be >= -1 (-1 auto, 0 none)")
        if self.alert_window < 4:
            raise ValueError(
                f"--alert_window {self.alert_window} must be >= 4")
        if self.alert_zscore <= 0:
            raise ValueError(
                f"--alert_zscore {self.alert_zscore} must be > 0")
        if self.watchdog and (not self.telemetry
                              or self.telemetry_every == 0):
            # its deadline history and its round_stall alert live in the
            # stream: without round records it would never arm
            raise ValueError(
                "--watchdog requires telemetry round records to arm "
                "(its deadline history fills on synced record rounds "
                "and its round_stall alert goes to the stream): drop "
                "--no_telemetry / set --telemetry_every != 0, or drop "
                "--watchdog.")
        if self.profile_dir:
            # a bad window fails at start-up, not at its first round
            from commefficient_torch.telemetry.profiling import \
                parse_profile_rounds
            parse_profile_rounds(self.profile_rounds)

    @property
    def telemetry_round_every(self) -> int:
        """The resolved --telemetry_every: -1 is every round under
        --test, every 64 rounds otherwise."""
        if self.telemetry_every != -1:
            return self.telemetry_every
        return 1 if self.do_test else 64

    def _resolve_wire(self) -> None:
        """The JAX package's resolution of ``wire_dtype`` and its alias
        ``sketch_dtype``, and its refusals of the int8 wire."""
        if self.sketch_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"--sketch_dtype {self.sketch_dtype!r}: want "
                             "float32 or bfloat16")
        if self.wire_dtype == "":
            object.__setattr__(self, "wire_dtype", self.sketch_dtype)
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"--wire_dtype {self.wire_dtype!r}: want one "
                             "of " + ", ".join(WIRE_DTYPES))
        # the SRHT's transform follows a bf16 wire; an explicit float32 or
        # int8 wire wins over the deprecated bf16 alias (else the bf16
        # rounding would run under another wire's byte accounting)
        object.__setattr__(self, "sketch_dtype",
                           "bfloat16" if self.wire_dtype == "bfloat16"
                           else "float32")
        if self.wire_block < 8:
            raise ValueError(
                f"--wire_block {self.wire_block} must be >= 8: each block "
                "pays 4 bytes of float32 scale, so blocks below 8 columns "
                "spend more on scales than a bf16 wire spends on cells")
        if self.sketch_scan_rows not in (-1, 0, 1):
            raise ValueError(f"--sketch_scan_rows {self.sketch_scan_rows}: "
                             "want -1 (auto), 0 or 1")
        if self.wire_dtype == "int8":
            if self.mode != "sketch":
                raise ValueError(
                    f"--wire_dtype int8 requires --mode sketch (mode="
                    f"{self.mode} has no table-shaped wire to quantize; "
                    "dense-mode payloads keep their f32 wire)")
            if self.sketch_impl == "rht":
                raise ValueError(
                    "--wire_dtype int8 is unsupported with sketch_impl="
                    "rht: its dense transform has no cell-addressable "
                    "table to block-quantize (use circ or hash)")
            if self.sketch_server_state == "dense":
                raise ValueError(
                    "--wire_dtype int8 is unsupported with "
                    "--sketch_server_state dense: that server path "
                    "consumes the dense aggregated gradient, so no table "
                    "crosses the wire to quantize")

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)

    @property
    def upload_floats(self) -> int:
        """Floats a participating client uploads a round (the reference's
        byte table, fed_aggregator.py:291-299)."""
        return {
            "uncompressed": self.grad_size,
            "true_topk": self.grad_size,
            "local_topk": self.k,
            "sketch": self.num_rows * self.num_cols,
            "fedavg": self.grad_size,
        }[self.mode]

    def upload_wire_bytes(self, block: Optional[int] = None) -> float:
        """A participating client's upload bytes a round under the wire
        dtype: 4 a float on the float32 wire (and in every mode but the
        sketch), 2 a table cell on the bf16 wire, and on the int8 wire 1
        a cell plus 4 for each row's scale of every ``block`` columns
        (``wire_block`` unless the runtime passes its effective block)."""
        if self.mode != "sketch" or self.wire_dtype == "float32":
            return 4.0 * self.upload_floats
        cells = self.num_rows * self.num_cols
        if self.wire_dtype == "bfloat16":
            return 2.0 * cells
        b = int(block or self.wire_block)
        return float(cells + 4 * self.num_rows * (-(-self.num_cols // b)))

    @property
    def table_clip(self) -> bool:
        """The reference's clip of each client's sketch table
        (``--max_grad_norm`` in sketch mode without
        ``--sketch_dense_clip``): a per-client nonlinearity, so the round
        cannot encode the clients' sum once."""
        return (self.mode == "sketch" and self.max_grad_norm is not None
                and not self.sketch_dense_clip)

    @property
    def needs_client_velocities(self) -> bool:
        return self.local_momentum > 0

    @property
    def needs_client_errors(self) -> bool:
        return self.error_type == "local"

    def default_num_clients(self) -> int:
        if self.num_clients is not None:
            return self.num_clients
        return {"CIFAR10": 10, "CIFAR100": 100, "EMNIST": 3500,
                "PERSONA": 17568}[self.dataset_name]

    @property
    def num_classes(self) -> int:
        return CV_DATASETS[self.dataset_name][0]

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        """The dataset's NHWC image shape, which the models' layouts
        follow."""
        return CV_DATASETS[self.dataset_name][1]


# the JAX package's CV datasets: (classes, NHWC image shape)
CV_DATASETS = {"CIFAR10": (10, (32, 32, 3)), "CIFAR100": (100, (32, 32, 3)),
               "EMNIST": (62, (28, 28, 1)),
               "ImageNet": (1000, (224, 224, 3))}
# the JAX package's pairs: any registry model on any CV dataset
MODEL_DATASETS = tuple((m, d) for m in MODEL_NAMES for d in CV_DATASETS) \
    + (("GPT2", "PERSONA"),)


def auto_num_cols(num_cols: int) -> int:
    """Round ``num_cols`` up to the next multiple of 1024, but only when that
    grows the table by at most 5% (500,000 -> 500,736); smaller tables are
    left as they are. The same rule as the JAX package, so both packages
    build the same sketch from the same flags; ``--exact_num_cols``
    bypasses it."""
    align = 1024
    c = -(-num_cols // align) * align
    if c != num_cols and (c - num_cols) / num_cols > 0.05:
        return num_cols
    return c


def add_args(p: argparse.ArgumentParser) -> None:
    """The port's flags, named as in the JAX package's parser."""
    p.add_argument("--mode", default="sketch")
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--model", default="ResNet9")
    p.add_argument("--dataset_name", default="CIFAR10")
    p.add_argument("--dataset_dir", default="./dataset")
    p.add_argument("--iid", action="store_true", dest="do_iid")
    p.add_argument("--no_augment", action="store_true",
                   help="train on normalised images only (no crop or flip)")
    p.add_argument("--batchnorm", action="store_true", dest="do_batchnorm")
    p.add_argument("--synthetic_per_class", type=int, default=64)
    p.add_argument("--synthetic_hard", action="store_true")
    p.add_argument("--synthetic_label_noise", type=float, default=0.0)
    p.add_argument("--finetune", action="store_true", dest="do_finetune")
    p.add_argument("--finetune_path", default="./finetune")
    p.add_argument("--finetuned_from", choices=list(CV_DATASETS))
    p.add_argument("--eval_before_start", action="store_true")
    p.add_argument("--no_pipeline", dest="pipeline", action="store_false",
                   default=True,
                   help="fetch the host path's batches inline (the same "
                        "rounds, no prefetch; the device store's always "
                        "are)")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="rounds the input pipeline fetches ahead")
    p.add_argument("--mesh_shape", default="",
                   help="comma-separated clients mesh, e.g. 2 (one process "
                        "a rank: torchrun --nproc_per_node 2); empty = one "
                        "device")
    p.add_argument("--mesh_axes", default="clients",
                   help="the mesh's axis names; only clients is ported")
    p.add_argument("--k", type=int, default=50_000)
    p.add_argument("--num_cols", type=int, default=500_000)
    p.add_argument("--num_rows", type=int, default=5)
    p.add_argument("--num_blocks", type=int, default=20)
    p.add_argument("--topk_down", action="store_true", dest="do_topk_down")
    p.add_argument("--exact_num_cols", action="store_true")
    p.add_argument("--local_momentum", type=float, default=0.9)
    p.add_argument("--virtual_momentum", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--num_epochs", type=float, default=24)
    p.add_argument("--num_fedavg_epochs", type=int, default=1)
    p.add_argument("--fedavg_batch_size", type=int, default=-1)
    p.add_argument("--fedavg_lr_decay", type=float, default=1.0)
    p.add_argument("--error_type", default="none")
    p.add_argument("--lr_scale", type=float, default=0.4)
    p.add_argument("--pivot_epoch", type=float, default=5)
    p.add_argument("--num_clients", type=int)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--local_batch_size", type=int, default=8)
    p.add_argument("--valid_batch_size", type=int, default=8)
    p.add_argument("--microbatch_size", type=int, default=-1)
    p.add_argument("--max_client_batch", type=int, default=512)
    p.add_argument("--no_track_bytes", dest="track_bytes",
                   action="store_false", default=True)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--max_grad_norm", type=float)
    p.add_argument("--sketch_dense_clip", action="store_true",
                   help="clip the dense worker gradient before the sketch "
                        "encode (threshold x num_iters) instead of the "
                        "reference's table clip")
    p.add_argument("--dp", action="store_true", dest="do_dp")
    p.add_argument("--dp_mode", choices=DP_MODES, default="worker")
    p.add_argument("--l2_norm_clip", type=float, default=1.0)
    p.add_argument("--noise_multiplier", type=float, default=0.0)
    p.add_argument("--sketch_seed", type=int, default=42)
    p.add_argument("--allow_divergent_rht", action="store_true")
    p.add_argument("--sketch_impl", choices=SKETCH_IMPLS, default="circ")
    p.add_argument("--sketch_dtype", choices=("float32", "bfloat16"),
                   default=None,
                   help="deprecated alias of --wire_dtype (a warning at "
                        "parse time); the SRHT's transform dtype follows "
                        "it")
    p.add_argument("--wire_dtype", choices=WIRE_DTYPES, default="",
                   help="the sketch table's wire: float32 (default), "
                        "bfloat16 (each table rounded) or int8 (block "
                        "scales, stochastic rounding; ops/wire.py)")
    p.add_argument("--wire_block", type=int, default=256,
                   help="int8 wire: columns a float32 scale")
    p.add_argument("--sketch_scan_rows", type=int, default=-1,
                   choices=(-1, 0, 1),
                   help="SRHT row-at-a-time transforms: -1 auto (on at "
                        "d' >= 2^25), 0 batched, 1 by rows")
    p.add_argument("--sketch_server_state", choices=SERVER_STATES,
                   default="table")
    p.add_argument("--sketch_ef", default="zero")
    p.add_argument("--sketch_fused_encode", default="auto")
    p.add_argument("--sketch_sharded_server", default="auto",
                   help="shard the sketch server tail over the mesh "
                        "(reduce-scattered table, range decode, candidate "
                        "top-k merge): auto = on an eligible mesh, on = "
                        "require, off = the replicated tail")
    p.add_argument("--decode_overlap", action="store_true",
                   help="split the round into client and server-decode "
                        "halves, so that the host stages round t+1 while "
                        "the card decodes round t (bitwise the same "
                        "rounds; the constraints of --async_agg)")
    p.add_argument("--error_decay", type=float, default=1.0)
    p.add_argument("--approx_topk", action="store_true",
                   help="accepted for the reference's command lines; the "
                        "port's top-k is exact either way")
    p.add_argument("--strict_regimes", action="store_true")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="write the whole state every N epochs (0 = never)")
    p.add_argument("--checkpoint_path", default="./checkpoint")
    p.add_argument("--resume", action="store_true", dest="do_resume",
                   help="continue from the newest intact checkpoint")
    p.add_argument("--resume_unverified", action="store_true",
                   help="resume under another layout fingerprint or sketch "
                        "(another sketch: the tables are zeroed)")
    add_service_args(p)


def add_service_args(p: argparse.ArgumentParser) -> None:
    """The runtime services' flags, with the JAX package's names and
    defaults; choices are checked by ``FedConfig`` (a ValueError naming
    the flag)."""
    p.add_argument("--async_agg", action="store_true",
                   help="FedBuff-style buffered aggregation: up to "
                        "--max_inflight cohorts in flight, a commit every "
                        "--buffer_goal merged cohorts")
    p.add_argument("--max_inflight", type=int, default=4,
                   help="cohorts in flight (K)")
    p.add_argument("--buffer_goal", type=int, default=1,
                   help="cohorts merged a commit (M)")
    p.add_argument("--staleness_discount", default="poly",
                   help="none (1), poly ((1+s)^-alpha) or exp "
                        "(exp(-alpha s))")
    p.add_argument("--staleness_alpha", type=float, default=0.5)
    p.add_argument("--scenario", default="none",
                   help="cohort latency: none, uniform, lognormal or "
                        "stragglers (requires --async_agg)")
    p.add_argument("--scenario_latency", type=float, default=1.0)
    p.add_argument("--scenario_spread", type=float, default=0.5)
    p.add_argument("--scenario_straggler_frac", type=float, default=0.1)
    p.add_argument("--scenario_straggler_mult", type=float, default=10.0)
    p.add_argument("--scenario_dropout", type=float, default=0.0)
    p.add_argument("--scenario_participation", type=float, default=1.0)
    p.add_argument("--adversary", default="none",
                   help="labelflip, signflip, scale, noise or nan on "
                        "--adversary_frac of the clients")
    p.add_argument("--adversary_frac", type=float, default=0.0)
    p.add_argument("--adversary_scale", type=float, default=10.0)
    p.add_argument("--defense", default="none",
                   help="normclip or trim (robust aggregation)")
    p.add_argument("--defense_clip_mult", type=float, default=3.0)
    p.add_argument("--defense_window", type=int, default=8)
    p.add_argument("--defense_trim_frac", type=float, default=0.1)
    p.add_argument("--nonfinite_action", default="abort",
                   help="abort, or quarantine: zero a nonfinite client out "
                        "of the round, bench it, eject it after "
                        "--quarantine_strikes")
    p.add_argument("--quarantine_backoff", type=int, default=8)
    p.add_argument("--quarantine_strikes", type=int, default=3)
    p.add_argument("--preempt_grace", type=float, default=30.0,
                   help="seconds the drain may take after SIGTERM/SIGINT "
                        "(a second signal force-exits)")
    p.add_argument("--watchdog", action="store_true",
                   help="deadline each round at --watchdog_mult x the "
                        "rolling median round time; retry the input fetch")
    p.add_argument("--watchdog_mult", type=float, default=10.0)
    add_telemetry_args(p)


def add_telemetry_args(p: argparse.ArgumentParser) -> None:
    """The run telemetry's flags (telemetry/), with the JAX package's
    names and defaults; choices are checked by ``FedConfig``."""
    p.add_argument("--logdir", default="",
                   help="fixed run directory for telemetry/tensorboard "
                        "(empty = runs/<timestamp>_...); a resumed run "
                        "pointed at its predecessor's logdir appends to "
                        "the stream behind a resume lineage record")
    p.add_argument("--tensorboard", dest="use_tensorboard",
                   action="store_true")
    p.add_argument("--no_telemetry", dest="telemetry", action="store_false",
                   default=True,
                   help="disable the telemetry.jsonl event stream")
    p.add_argument("--telemetry_every", type=int, default=-1,
                   help="a round record every N rounds (0 = none, -1 = "
                        "auto: 1 under --test, 64 otherwise)")
    p.add_argument("--no_signals", dest="signals", action="store_false",
                   default=True,
                   help="drop the per-round compression signals")
    p.add_argument("--signals_exact", action="store_true",
                   help="compute topk_overlap against the exact dense "
                        "error top-k (a dense shadow error pair for the "
                        "table-state sketch)")
    p.add_argument("--signal_groups", default="coarse",
                   help="layer-signal groups: coarse, leaf or off")
    p.add_argument("--no_client_stats", dest="client_stats",
                   action="store_false", default=True,
                   help="drop the per-client population statistics")
    p.add_argument("--population_sketch", default="auto",
                   help="participation-ledger backing: auto (sketch at "
                        ">= 1e5 clients), on or off")
    p.add_argument("--alert_action", default="log",
                   help="anomaly-monitor action: log, warn, checkpoint "
                        "(+ a flight-recorder bundle) or abort")
    p.add_argument("--alert_window", type=int, default=32)
    p.add_argument("--alert_zscore", type=float, default=6.0)
    p.add_argument("--peak_flops", type=float, default=0.0,
                   help="peak FLOP/s of the card for MFU (0 = the table)")
    p.add_argument("--peak_hbm_gbps", type=float, default=0.0,
                   help="peak memory GB/s of the card (0 = the table)")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler chrome trace of the "
                        "--profile_rounds window here")
    p.add_argument("--profile_rounds", default="2:4",
                   help="1-based inclusive round window, START:STOP")


def add_gpt2_args(p: argparse.ArgumentParser) -> None:
    """The GPT-2 / PersonaChat flags of ``gpt2_train``."""
    p.add_argument("--test", action="store_true", dest="do_test")
    p.add_argument("--lr_warmup", action="store_true")
    p.add_argument("--num_candidates", type=int, default=2)
    p.add_argument("--max_history", type=int, default=2)
    p.add_argument("--max_seq_len", type=int, default=0,
                   help="PERSONA packed sequence length; 0 = the entry "
                        "point's default")
    p.add_argument("--lm_coef", type=float, default=1.0)
    p.add_argument("--mc_coef", type=float, default=1.0)
    p.add_argument("--personality_permutations", type=int, default=1)
    p.add_argument("--attn_impl", default="auto")
    p.add_argument("--remat", action="store_true", dest="do_remat",
                   help="recompute each block in the backward")
    p.add_argument("--remat_policy", default="",
                   help="the JAX checkpoint policy under --remat ("
                        "dots_saveable, dots_with_no_batch_dims_saveable, "
                        "...; \"\" = full remat)")
    p.add_argument("--lm_chunk", type=int, default=0,
                   help="compute the LM loss this many positions at a time "
                        "(0 = all at once)")
    p.add_argument("--model_checkpoint", default="gpt2",
                   help="local HF GPT-2 checkpoint: a directory or a hub "
                        "name in the hub cache")
    p.add_argument("--checkpoint", action="store_true",
                   dest="do_checkpoint",
                   help="save_pretrained the final model to "
                        "<checkpoint_path>/gpt2_doubleheads")


def config_from_args(ns: argparse.Namespace) -> FedConfig:
    kw = dict(vars(ns))
    kw["mesh_shape"] = tuple(int(x) for x in
                             str(kw.get("mesh_shape", "")).split(",") if x)
    kw["mesh_axes"] = tuple(x for x in
                            str(kw.get("mesh_axes", "clients")).split(",")
                            if x)
    if kw.get("sketch_dtype") is not None:
        # the JAX package's parse-time warning; an explicit --wire_dtype
        # wins over the alias
        print("WARNING: --sketch_dtype is a deprecated alias of "
              "--wire_dtype (it now also covers the int8 quantized "
              "wire); update the invocation.", file=sys.stderr)
        if not kw.get("wire_dtype"):
            kw["wire_dtype"] = kw["sketch_dtype"]
    else:
        kw["sketch_dtype"] = "float32"
    names = {f.name for f in dataclasses.fields(FedConfig)}
    return FedConfig(**{k: v for k, v in kw.items() if k in names})


def parse_known(parser: argparse.ArgumentParser,
                argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """``parse_known_args`` that raises on any flag outside the slice,
    naming it (the JAX package's other flags, such as
    ``--compile_cache``, are not ported)."""
    ns, rest = parser.parse_known_args(argv)
    if "--checkpoint_sharded" in rest:
        from commefficient_torch.parallel.mesh import NEXT_SLICE
        raise ValueError(
            "--checkpoint_sharded: per-rank checkpoint shards are "
            f"{NEXT_SLICE}; the port writes the gathered state from rank "
            "0 (--checkpoint_every)")
    if rest:
        flags = [a for a in rest if a.startswith("-")] or rest
        raise ValueError(
            f"{' '.join(flags)}: outside the PyTorch port's slice "
            "(the CV models on CIFAR10/100, FEMNIST or ImageNet, or GPT-2 "
            "on PersonaChat, on one device or a clients mesh)")
    return ns
