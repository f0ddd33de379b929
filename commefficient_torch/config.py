"""Run configuration of the PyTorch port: the slice of the JAX package's
``FedConfig`` that the port runs, plus ``auto_num_cols``.

The slice is the FetchSGD round (``mode sketch`` with the circulant count
sketch, ``error_type virtual``, no local momentum, the zero error-feedback
rule, fused clients with the fused sketch encode, each client's batch one
microbatch, on one device) of two models: ResNet-9 on CIFAR10
(``cv_train``) and GPT-2 DoubleHeads on PersonaChat (``gpt2_train``). A
value or flag outside it raises and names the flag. Defaults are the JAX
package's (its ``config.py``), except ``local_momentum``, whose reference
default 0.9 is illegal in sketch mode.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class FedConfig:
    mode: str = "sketch"
    model: str = "ResNet9"
    dataset_name: str = "CIFAR10"
    do_batchnorm: bool = False
    seed: int = 21
    synthetic_per_class: int = 64
    k: int = 50_000
    num_cols: int = 500_000
    num_rows: int = 5
    exact_num_cols: bool = False
    local_momentum: float = 0.0
    virtual_momentum: float = 0.0
    weight_decay: float = 5e-4
    num_epochs: float = 24.0
    error_type: str = "virtual"
    lr_scale: Optional[float] = 0.4
    pivot_epoch: float = 5.0
    num_clients: Optional[int] = None
    num_workers: int = 1
    local_batch_size: int = 8
    valid_batch_size: int = 8
    compute_dtype: str = "bfloat16"
    sketch_seed: int = 42
    sketch_ef: str = "zero"
    error_decay: float = 1.0
    approx_topk: bool = False
    grad_size: int = 0
    microbatch_size: int = -1
    # GPT-2 / PersonaChat (gpt2_train)
    do_test: bool = False
    dataset_dir: str = "./dataset"
    lr_warmup: bool = False
    num_candidates: int = 2
    max_history: int = 2
    max_seq_len: int = 0
    lm_coef: float = 1.0
    mc_coef: float = 1.0
    personality_permutations: int = 1
    attn_impl: str = "auto"

    def __post_init__(self):
        fixed = {"mode": "sketch", "error_type": "virtual",
                 "sketch_ef": "zero", "local_momentum": 0.0}
        for name, want in fixed.items():
            if getattr(self, name) != want:
                raise ValueError(
                    f"--{name} {getattr(self, name)!r} is outside the "
                    f"PyTorch port's slice (only {want!r} is ported)")
        if (self.model, self.dataset_name) not in MODEL_DATASETS:
            raise ValueError(
                f"--model {self.model} --dataset_name {self.dataset_name} "
                "is outside the PyTorch port's slice (ported: "
                + ", ".join(f"{m} on {d}" for m, d in MODEL_DATASETS) + ")")
        if self.microbatch_size not in (-1, self.local_batch_size):
            raise ValueError(
                f"--microbatch_size {self.microbatch_size}: the port runs "
                "each client's batch as one microbatch (-1 or "
                "--local_batch_size)")
        if self.attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(f"--attn_impl {self.attn_impl!r}: want auto, "
                             "dense or flash")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"--compute_dtype {self.compute_dtype!r}: "
                             "want bfloat16 or float32")
        if self.local_batch_size <= 0:
            raise ValueError(
                f"--local_batch_size {self.local_batch_size}: the port "
                "takes a fixed positive batch (whole-client batches, -1, "
                "are outside its slice)")
        if self.num_workers < 1 or self.k < 1 or self.num_rows < 1 \
                or self.num_cols < 1:
            raise ValueError("--num_workers, --k, --num_rows and "
                             "--num_cols must be positive")

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)


MODEL_DATASETS = (("ResNet9", "CIFAR10"), ("GPT2", "PERSONA"))


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
    """The slice's flags, named as in the JAX package's parser."""
    p.add_argument("--mode", default="sketch")
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--model", default="ResNet9")
    p.add_argument("--dataset_name", default="CIFAR10")
    p.add_argument("--batchnorm", action="store_true", dest="do_batchnorm")
    p.add_argument("--synthetic_per_class", type=int, default=64)
    p.add_argument("--k", type=int, default=50_000)
    p.add_argument("--num_cols", type=int, default=500_000)
    p.add_argument("--num_rows", type=int, default=5)
    p.add_argument("--exact_num_cols", action="store_true")
    p.add_argument("--local_momentum", type=float, default=0.0)
    p.add_argument("--virtual_momentum", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--num_epochs", type=float, default=24)
    p.add_argument("--error_type", default="virtual")
    p.add_argument("--lr_scale", type=float, default=0.4)
    p.add_argument("--pivot_epoch", type=float, default=5)
    p.add_argument("--num_clients", type=int)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--local_batch_size", type=int, default=8)
    p.add_argument("--valid_batch_size", type=int, default=8)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--sketch_seed", type=int, default=42)
    p.add_argument("--sketch_ef", default="zero")
    p.add_argument("--error_decay", type=float, default=1.0)
    p.add_argument("--approx_topk", action="store_true",
                   help="accepted for the reference's command lines; the "
                        "port's top-k is exact either way")
    p.add_argument("--microbatch_size", type=int, default=-1)


def add_gpt2_args(p: argparse.ArgumentParser) -> None:
    """The GPT-2 / PersonaChat flags of ``gpt2_train``."""
    p.add_argument("--test", action="store_true", dest="do_test")
    p.add_argument("--dataset_dir", default="./dataset")
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


def config_from_args(ns: argparse.Namespace) -> FedConfig:
    names = {f.name for f in dataclasses.fields(FedConfig)}
    return FedConfig(**{k: v for k, v in vars(ns).items() if k in names})


def parse_known(parser: argparse.ArgumentParser,
                argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """``parse_known_args`` that raises on any flag outside the slice,
    naming it (the JAX package's other flags are not ported yet)."""
    ns, rest = parser.parse_known_args(argv)
    if rest:
        flags = [a for a in rest if a.startswith("-")] or rest
        raise ValueError(
            f"{' '.join(flags)}: outside the PyTorch port's slice "
            "(sketch-mode ResNet-9 on CIFAR10 or GPT-2 on PersonaChat, "
            "one device)")
    return ns
