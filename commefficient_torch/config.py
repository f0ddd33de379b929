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
(``core/pipeline.py``). A value
or flag outside it raises and names the flag: the bf16 and int8 wires,
``--sketch_scan_rows``/``--sketch_dtype`` and meshes are not ported
(``--mesh_shape ""``, the JAX package's single device, is accepted).
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
from typing import Optional, Sequence, Tuple

from commefficient_torch.models import MODEL_NAMES

MODES = ("sketch", "true_topk", "local_topk", "fedavg", "uncompressed")
ERROR_TYPES = ("none", "local", "virtual")
DP_MODES = ("worker", "server")
SKETCH_IMPLS = ("circ", "hash", "rht")
SERVER_STATES = ("table", "dense")


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
    sketch_server_state: str = "table"
    sketch_ef: str = "zero"
    sketch_fused_encode: str = "auto"
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
                   "attn_impl": ("auto", "dense", "flash"),
                   "compute_dtype": ("bfloat16", "float32")}
        for name, legal in choices.items():
            if getattr(self, name) not in legal:
                raise ValueError(f"--{name} {getattr(self, name)!r}: want "
                                 "one of " + ", ".join(legal))
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
        if self.sketch_dense_clip and (self.mode != "sketch"
                                       or self.max_grad_norm is None):
            # a clip study run unclipped would measure the wrong rule
            raise ValueError("--sketch_dense_clip requires --mode sketch "
                             "and --max_grad_norm")
        if self.mode == "fedavg" and self.local_batch_size != -1:
            # the reference's invariant (its utils.py:225-228); the mode,
            # error and momentum rules are validate_mode_combo's
            raise ValueError("--mode fedavg requires --local_batch_size -1")

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

    def upload_wire_bytes(self) -> float:
        """A participating client's upload bytes a round: 4 a float on the
        float32 wire, the only wire the port runs (``--wire_dtype`` is not
        ported)."""
        return 4.0 * self.upload_floats

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
                   help="the JAX package's device mesh; only \"\" (one "
                        "device) is ported")
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
    p.add_argument("--sketch_server_state", choices=SERVER_STATES,
                   default="table")
    p.add_argument("--sketch_ef", default="zero")
    p.add_argument("--sketch_fused_encode", default="auto")
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
    if getattr(ns, "mesh_shape", ""):
        raise ValueError(
            f"--mesh_shape {ns.mesh_shape!r}: the PyTorch port runs one "
            "device (multi-GPU meshes are ROADMAP A9); pass --mesh_shape "
            '"" or leave it out')
    names = {f.name for f in dataclasses.fields(FedConfig)}
    return FedConfig(**{k: v for k, v in vars(ns).items() if k in names})


def parse_known(parser: argparse.ArgumentParser,
                argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """``parse_known_args`` that raises on any flag outside the slice,
    naming it (the JAX package's other flags, such as ``--wire_dtype``
    (the float32 wire), ``--sketch_scan_rows``, ``--sketch_dtype`` and
    ``--mesh_axes``, are not ported yet)."""
    ns, rest = parser.parse_known_args(argv)
    if rest:
        flags = [a for a in rest if a.startswith("-")] or rest
        raise ValueError(
            f"{' '.join(flags)}: outside the PyTorch port's slice "
            "(the CV models on CIFAR10/100, FEMNIST or ImageNet, or GPT-2 "
            "on PersonaChat, one device, the float32 wire and the batched "
            "float32 SRHT; no meshes)")
    return ns
