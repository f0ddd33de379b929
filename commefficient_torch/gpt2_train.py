"""GPT-2 DoubleHeads on federated PersonaChat, entry point of the PyTorch
port (the FetchSGD sketch round of the JAX package's ``gpt2_train.py``,
without checkpointing, telemetry or meshes).

    python -m commefficient_torch.gpt2_train --mode sketch \\
        --error_type virtual --virtual_momentum 0.9 --num_workers 8 \\
        --local_batch_size 4 --num_candidates 2 --max_seq_len 1024 \\
        --k 50000 --num_rows 5 --num_cols 524288 --num_rounds 4

Runs on the card unless ``--device cpu`` is given. GPT-2 small's width
(n_embd 768, 12 layers, 12 heads) over the HashTokenizer vocabulary of
data/fed_persona.py; ``--test`` runs ``GPT2Config.small`` with a 10-column
sketch, one round and one validation batch, as the JAX package's
gpt2_train does (``--num_rounds`` more: one round per epoch). Prints one
row per round (loss, MC accuracy, round time), then the validation NLL,
perplexity and MC accuracy, and the analytic tokens and model FLOPs per
round (``gpt2_model_flops``).
"""

from __future__ import annotations

import argparse
import math
import statistics
from typing import Optional, Sequence

import numpy as np
import torch

from commefficient_torch.config import (add_args, add_gpt2_args,
                                        config_from_args, parse_known)
from commefficient_torch.core.driver import train, validate
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data.fed_persona import FedPERSONA, HashTokenizer
from commefficient_torch.losses import (COMPUTE_DTYPES,
                                        make_gpt2_train_loss,
                                        make_gpt2_val_loss)
from commefficient_torch.models.gpt2 import (GPT2Config, GPT2DoubleHeads,
                                             gpt2_model_flops)
from commefficient_torch.ops import circulant_kernels, flash_attention
from commefficient_torch.utils.schedules import make_gpt2_schedule


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_args(p)
    add_gpt2_args(p)
    p.set_defaults(model="GPT2", dataset_name="PERSONA", lr_scale=0.16)
    p.add_argument("--num_rounds", type=int, default=0,
                   help="stop after this many rounds (0 = run num_epochs)")
    p.add_argument("--device", default="cuda")
    return p


def build_gpt2(cfg, tokenizer) -> GPT2Config:
    """GPT-2 small's width, or ``GPT2Config.small`` under ``--test`` (in
    its default bf16, as the JAX package's gpt2_train builds it)."""
    vocab = len(tokenizer) - 5
    if cfg.do_test:
        return GPT2Config.small(vocab_size=vocab)
    return GPT2Config(vocab_size=vocab,
                      compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype])


def setup(ns: argparse.Namespace):
    """Data, model and runtime for the parsed flags ``ns``: returns
    ``(runtime, state, train_ds, val_ds, gcfg)``."""
    cfg = config_from_args(ns)
    if cfg.model != "GPT2":
        raise ValueError(f"--model {cfg.model}: gpt2_train runs GPT2")
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    if cfg.do_test:
        cfg = cfg.replace(num_cols=10, num_rows=1, k=10)
    cfg = cfg.replace(max_seq_len=cfg.max_seq_len
                      or (64 if cfg.do_test else 280))
    S = cfg.max_seq_len
    torch.manual_seed(cfg.seed)
    np.random.seed(cfg.seed)
    tokenizer = HashTokenizer()
    data_kw = dict(tokenizer=tokenizer, num_candidates=cfg.num_candidates,
                   max_seq_len=S, max_history=cfg.max_history)
    train_ds = FedPERSONA(cfg.dataset_dir, train=True,
                          num_clients=cfg.num_clients,
                          personality_permutations=(
                              cfg.personality_permutations), **data_kw)
    val_ds = FedPERSONA(cfg.dataset_dir, train=False, **data_kw)
    cfg = cfg.replace(num_clients=train_ds.num_clients)

    gcfg = build_gpt2(cfg, tokenizer)
    if S > gcfg.n_positions:
        raise ValueError(f"--max_seq_len {S} exceeds the model's "
                         f"{gcfg.n_positions} positions")
    model = GPT2DoubleHeads(gcfg, attn_impl=cfg.attn_impl,
                            generator=torch.Generator().manual_seed(cfg.seed))
    runtime = FedRuntime(cfg, model,
                         make_gpt2_train_loss(model, cfg.lm_coef,
                                              cfg.mc_coef),
                         device=device, loss_fn_val=make_gpt2_val_loss(model))
    cfg = runtime.cfg
    print(f"d={cfg.grad_size} c={cfg.num_cols} r={cfg.num_rows} k={cfg.k} "
          f"W={cfg.num_workers} B={cfg.local_batch_size} "
          f"C={cfg.num_candidates} S={S} attn={cfg.attn_impl} "
          f"device={device}")
    return runtime, runtime.init_state(), train_ds, val_ds, gcfg


def kernel_launches() -> dict:
    """Launch counts of every kernel of the slice (K1, K2, K3)."""
    return {**circulant_kernels.launches, **flash_attention.launches}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ns = parse_known(build_parser(), argv)
    runtime, state, train_ds, val_ds, gcfg = setup(ns)
    cfg = runtime.cfg
    tokens = (cfg.num_workers * cfg.local_batch_size * cfg.num_candidates
              * cfg.max_seq_len)
    flops = gpt2_model_flops(gcfg, tokens, cfg.max_seq_len)
    # --test: one round, as the JAX package's loop breaks after it, unless
    # --num_rounds asks for more (one per epoch)
    state, times, losses = train(
        runtime, state, train_ds, make_gpt2_schedule(cfg),
        ns.num_rounds or (1 if cfg.do_test else 0),
        max_per_epoch=1 if cfg.do_test else None)
    round_launches = kernel_launches()
    nll, acc = validate(runtime, state, val_ds, cfg.valid_batch_size,
                        max_batches=1 if cfg.do_test else None)
    ppl = math.exp(min(nll, 20))
    print(f"final val nll {nll:.4f} ppl {ppl:.2f} mc acc {acc:.4f}")
    if times:
        rt = statistics.median(times)
        print(f"{tokens} tokens and {flops / 1e12:.3f} model TFLOP per "
              f"round (analytic); median round {rt:.4f} s: "
              f"{tokens / rt:.1f} tokens/s, {flops / rt / 1e12:.3f} "
              f"TFLOP/s on {runtime.device}")
    return {"losses": losses, "round_s": times, "val_loss": nll,
            "val_ppl": ppl, "val_acc": acc, "rounds": len(losses),
            "tokens_per_round": tokens, "model_flops_per_round": flops,
            "launches_after_rounds": round_launches}


if __name__ == "__main__":
    main()
