"""The bare GPT-2 model step, with no federation: 8 clients' microbatched
forward and backward at ``bench_gpt2``'s round shape (8 dialogues x 2
candidates x 256 tokens a client, microbatches of 8 dialogues, the LM
loss 128 positions at a time), the round's compute core measured alone;
the counterpart of the JAX package's ``scripts/bench_gpt2_model.py``.

    python -m commefficient_torch.bench.bench_gpt2_model [reps=6]
        [--device cuda|cpu]

Arms: remat on and off x dense attention and K3 (``flash``). The flash
arms launch K3 at (N, S, H, D) = (16, 256, 12, 64): one forward a layer
and client (two under remat: the backward recomputes the block), one dq
and one dk/dv. Timing is a chain of ``reps`` steps, each step's weights
perturbed by the previous step's gradient (the JAX chain's dependence),
between two ``torch.cuda.synchronize()`` calls, after one warm step.
MFU uses ``gpt2_model_flops`` over the card's peak bf16 FLOP/s. An arm
that fails prints its error on its line and the others run. Prints a
line an arm, then one JSON line of every arm.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from commefficient_torch.bench.bench_common import (log, mfu_of,
                                                    peak_flops,
                                                    resolve_device,
                                                    time_chain)
from commefficient_torch.bench.bench_gpt2 import random_batch, seeded_gpt2
from commefficient_torch.config import FedConfig, parse_known
from commefficient_torch.core.client import make_forward_grad
from commefficient_torch.losses import make_gpt2_train_loss
from commefficient_torch.models.gpt2 import (GPT2Config, GPT2DoubleHeads,
                                             gpt2_model_flops)

SHAPE = (8, 8, 2, 256)          # W, B, NC, S
MICROBATCH = 8
# the chain's step: the JAX chain's, which makes each step depend on the
# previous gradient and leaves the weights all but unchanged
CHAIN_STEP = 1e-12
LM_CHUNK = 128
# (label, remat, attention)
ARMS = (("remat + dense", True, "dense"),
        ("remat + flash", True, "flash"),
        ("NO remat + flash", False, "flash"),
        ("NO remat + dense", False, "dense"))


def model_step_config(W: int, B: int) -> FedConfig:
    return FedConfig(mode="uncompressed", error_type="none",
                     local_momentum=0.0, virtual_momentum=0.9,
                     weight_decay=0.0, num_workers=W, local_batch_size=B,
                     microbatch_size=MICROBATCH, num_clients=100,
                     track_bytes=False, lm_chunk=LM_CHUNK)


def chained_step(fwd, p, batch, mask):
    """One step of the chain: every client's microbatched gradient at
    ``p`` (``fwd`` from ``make_forward_grad``), summed; returns the next
    step's weights, which depend on this gradient, and the mean client
    loss."""
    g, loss = None, 0.0
    for c in range(mask.shape[0]):
        gc, res, _ = fwd(p, {k: v[c] for k, v in batch.items()}, mask[c])
        g = gc if g is None else g + gc
        loss = loss + res[0]
    return p - CHAIN_STEP * g, loss / mask.shape[0]


def run(reps: int = 6, *, device="cuda", gcfg_kw: Optional[dict] = None,
        shape=SHAPE) -> list:
    """One record an arm: ``ms`` a step, ``tok_per_s``, ``mfu`` (null
    where the peak is unknown), ``first_loss`` (the warm step's mean
    client loss) and ``flops_per_step``, or ``error``. ``gcfg_kw``
    overrides GPT-2 small's config and ``shape`` the round (tests: a
    tiny model)."""
    dev = resolve_device(device)
    W, B, NC, S = shape
    peak = peak_flops(dev)
    cfg = model_step_config(W, B)
    out = []
    for label, remat, attn in ARMS:
        rec = {"arm": label, "remat": remat, "attn": attn}
        gcfg = GPT2Config(**{**(gcfg_kw or {}), "remat": remat})

        def setup():
            model = seeded_gpt2(GPT2DoubleHeads, gcfg, attn, dev)
            batch = random_batch(gcfg, shape, dev)
            mask = torch.ones((W, B), dtype=torch.bool, device=dev)
            fwd = make_forward_grad(cfg, make_gpt2_train_loss(
                model, lm_chunk=cfg.lm_chunk), B)
            return ((lambda p: chained_step(fwd, p, batch, mask)),
                    model.flat.detach())

        dt = time_chain(rec, setup, reps, dev)
        if dt is None:
            print(f"{label:20s}: FAILED "
                  f"{rec['error'].splitlines()[0][:120]}", flush=True)
        else:
            toks = W * B * NC * S
            flops = gpt2_model_flops(gcfg, toks, S)
            mfu = mfu_of(flops, 1, dt, peak)
            rec.update(ms=dt * 1e3, tok_per_s=toks / dt, mfu=mfu,
                       flops_per_step=flops)
            print(f"{label:20s}: {dt * 1e3:9.2f} ms/step  "
                  f"{toks / dt:9.0f} tok/s  MFU "
                  f"{'null' if mfu is None else f'{mfu:.3f}'}", flush=True)
        out.append(rec)
    return out


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("reps", nargs="?", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = parse_known(ap, argv)
    log(f"bench_gpt2_model: {args.reps} chained steps an arm")
    arms = run(args.reps, device=args.device)
    print(json.dumps({"metric": "gpt2_model_step", "arms": arms}))
    return arms


if __name__ == "__main__":
    main()
