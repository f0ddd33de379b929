"""Long-context attention on one card: dense attention against K3
(``flash``) for the forward and backward of ``GPT2LMHead`` with every
block recomputed in the backward, at S = 1024, 2048 and 4096 and a
constant 16,384 tokens a step (B = 16, 8, 4 sequences); the counterpart
of the JAX package's ``scripts/bench_longctx.py``.

    python -m commefficient_torch.bench.bench_longctx [reps=4]
        [--device cuda|cpu]

Dense attention stores (B, 12, S, S) float32 scores a layer (3.2 GB at
S = 4096, one layer at a time under the recompute); K3 never stores
them. A flash step launches K3 at (B, S, 12, 64): two forwards a layer
(the forward and the backward's recompute), one dq and one dk/dv. Both
arms at one S start from the same seeded weights and tokens, so their
first-step losses agree. Timing is a chain of ``reps`` steps, each
step's weights moved by the previous gradient, between two
``torch.cuda.synchronize()`` calls, after one warm step. MFU uses
``gpt2_model_flops``. Prints a row an arm, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from commefficient_torch.bench.bench_common import (log, mfu_of,
                                                    peak_flops,
                                                    resolve_device,
                                                    time_chain)
from commefficient_torch.bench.bench_gpt2 import seeded_gpt2
from commefficient_torch.config import parse_known
from commefficient_torch.models.gpt2 import (GPT2Config, GPT2LMHead,
                                             gpt2_model_flops)

TOKENS = 16384
SEQS = (1024, 2048, 4096)
ATTNS = ("dense", "flash")
# the chain's step, as in bench_gpt2_model
CHAIN_STEP = 1e-12


def lm_loss(model, ids, labels):
    """Mean next-token NLL of ``model`` on ``ids`` (the JAX script's
    loss: log-softmax of the logits at every position but the last)."""

    def loss_fn(flat):
        logits = model(ids, flat=flat)
        lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
        return -lp.gather(-1, labels[:, 1:, None]).mean()

    return loss_fn


def lm_batch(gcfg: GPT2Config, B: int, S: int, device):
    """The JAX script's seeded tokens and labels, (B, S) int64 on
    ``device``."""
    rng = np.random.RandomState(0)
    ids, labels = (torch.as_tensor(rng.randint(0, gcfg.vocab_size, (B, S)),
                                   dtype=torch.int64, device=device)
                   for _ in range(2))
    return ids, labels


def grad_step(loss_fn, v):
    """One step of the chain: the loss and its gradient at ``v``; returns
    the next step's weights, moved by this gradient, and the loss."""
    w = v.detach().requires_grad_(True)
    loss = loss_fn(w)
    (g,) = torch.autograd.grad(loss, w)
    return v - CHAIN_STEP * g, loss.detach()


def run(reps: int = 4, *, device="cuda", seqs=SEQS, tokens: int = TOKENS,
        gcfg_kw: Optional[dict] = None) -> list:
    """One record an (S, attention) arm: ``ms`` a step, ``tok_per_s``,
    ``mfu`` (null where the peak is unknown), ``first_loss`` (the warm
    step's loss), or ``error``. ``gcfg_kw`` overrides GPT-2 small's
    config (tests: a tiny model)."""
    dev = resolve_device(device)
    peak = peak_flops(dev)
    print(f"{'S':>6s} {'B':>3s} {'attn':>6s} {'ms/step':>9s} "
          f"{'tok/s':>9s} {'MFU':>6s}", flush=True)
    out = []
    for S in seqs:
        B = tokens // S
        gcfg = GPT2Config(**{**(gcfg_kw or {}), "n_positions": S,
                             "remat": True})
        ids, labels = lm_batch(gcfg, B, S, dev)
        for attn in ATTNS:
            rec = {"S": S, "B": B, "attn": attn}

            def setup():
                model = seeded_gpt2(GPT2LMHead, gcfg, attn, dev)
                loss_fn = lm_loss(model, ids, labels)
                return (lambda v: grad_step(loss_fn, v)), model.flat.detach()

            dt = time_chain(rec, setup, reps, dev)
            if dt is None:
                print(f"{S:6d} {B:3d} {attn:>6s}    FAILED "
                      f"{rec['error'].splitlines()[0][:90]}", flush=True)
            else:
                mfu = mfu_of(gpt2_model_flops(gcfg, B * S, S), 1, dt, peak)
                rec.update(ms=dt * 1e3, tok_per_s=B * S / dt, mfu=mfu)
                print(f"{S:6d} {B:3d} {attn:>6s} {dt * 1e3:9.2f} "
                      f"{B * S / dt:9.0f} "
                      f"{'null' if mfu is None else f'{mfu:6.1%}'}",
                      flush=True)
            out.append(rec)
    return out


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("reps", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = parse_known(ap, argv)
    log(f"bench_longctx: {args.reps} chained steps an arm")
    arms = run(args.reps, device=args.device)
    print(json.dumps({"metric": "gpt2_longctx_step", "arms": arms}))
    return arms


if __name__ == "__main__":
    main()
