"""GPT-2 DoubleHeads on federated PersonaChat, entry point of the PyTorch
port (the JAX package's ``gpt2_train.py``; the FetchSGD sketch round is
the path built for the card). Under ``torchrun`` with ``--mesh_shape``
it runs on a mesh, and ``--mesh_axes clients,seq --mesh_shape C,S``
shards each client's sequence over S ranks (ring attention).

    python -m commefficient_torch.gpt2_train --mode sketch \\
        --error_type virtual --local_momentum 0 --virtual_momentum 0.9 \\
        --num_workers 8 --local_batch_size 4 --num_candidates 2 \\
        --max_seq_len 1024 --k 50000 --num_rows 5 --num_cols 524288 \\
        --num_rounds 4

Runs on the card unless ``--device cpu`` is given. GPT-2 small's width
(n_embd 768, 12 layers, 12 heads) over the HashTokenizer vocabulary of
data/fed_persona.py; ``--test`` runs ``GPT2Config.small`` with a 10-column
sketch, one round and one validation batch, as the JAX package's
gpt2_train does (``--num_rounds`` more: one round per epoch). The epoch
loop is ``cv_train``'s (core/driver.py): at each epoch's end the epoch's
rounds (loss, MC accuracy, round time), the validation and the epoch row
with its download and upload MiB; at the end the validation NLL,
perplexity and MC accuracy of the last epoch, and the analytic tokens and
model FLOPs per round (``gpt2_model_flops``). ``--checkpoint_every N``
writes the whole state every N epochs under
``<checkpoint_path>/gpt2_doubleheads`` and ``--resume`` continues from
the newest intact one (checkpoint.py), as in ``cv_train``.

The JAX package's GPT-2 flags: ``--remat`` recomputes each block in the
backward, ``--remat_policy NAME`` keeps the saved set of that JAX
checkpoint policy (models/gpt2.py ``REMAT_POLICIES``), ``--lm_chunk N``
computes the LM loss N positions at a time (training and validation);
``--model_checkpoint`` (default ``gpt2``) starts from a local HF GPT-2
checkpoint (a directory holding ``model.safetensors`` or
``pytorch_model.bin``, or a name in the HF hub cache), else from the
seeded initialisation with a warning; ``--iid`` deals the PersonaChat
items to ``--num_clients`` clients; ``--checkpoint`` ends the run with
``save_pretrained`` into ``<checkpoint_path>/gpt2_doubleheads``
(``weights.npz``, ``config.json`` with the JAX package's layout
fingerprint, ``hash_tokenizer.json``), which ``load_pretrained`` of
either package reads. The PersonaChat packs are written once under
``--dataset_dir`` and read by later runs of either package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
from typing import Optional, Sequence

import numpy as np
import torch

from commefficient_torch.checkpoint import (params_fingerprint_jax,
                                            setup_checkpointing)
from commefficient_torch.config import (add_args, add_gpt2_args,
                                        config_from_args, parse_known)
from commefficient_torch.core.driver import (make_writer, open_telemetry,
                                              train)
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.data.fed_persona import FedPERSONA, HashTokenizer
from commefficient_torch.losses import (COMPUTE_DTYPES, DTYPE_NAMES,
                                        make_gpt2_train_loss,
                                        make_gpt2_val_loss)
from commefficient_torch.models.gpt2 import (GPT2Config, GPT2DoubleHeads,
                                             gpt2_model_flops,
                                             load_hf_weights)
from commefficient_torch.ops import circulant_kernels, flash_attention
from commefficient_torch.parallel.mesh import setup_mesh
from commefficient_torch.utils.logging import TableLogger, Timer, TSVLogger
from commefficient_torch.utils.schedules import make_gpt2_schedule

# batch leaf -> the index of its sequence dimension in the round's arrays
# (W, B, candidates, S); None replicates the leaf over the seq axis (the
# JAX package's PERSONA_SEQ_SPEC)
PERSONA_SEQ_SPEC = {"input_ids": 3, "token_type_ids": 3, "lm_labels": 3,
                    "mc_token_ids": None, "mc_label": None}


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
    its default bf16, as the JAX package's gpt2_train builds it), with
    ``--remat`` and ``--remat_policy``."""
    kw = dict(vocab_size=len(tokenizer) - 5, remat=cfg.do_remat,
              remat_policy=cfg.remat_policy)
    if cfg.do_test:
        return GPT2Config.small(**kw)
    return GPT2Config(compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype], **kw)


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
    # the mesh (the JAX package's gpt2_train.py:186-217): clients, and
    # with --mesh_axes clients,seq the seq axis of ring attention
    device, mesh = setup_mesh(cfg, device)
    if cfg.do_test:
        cfg = cfg.replace(num_cols=10, num_rows=1, k=10)
    cfg = cfg.replace(max_seq_len=cfg.max_seq_len
                      or (64 if cfg.do_test else 280))
    S = cfg.max_seq_len
    torch.manual_seed(cfg.seed)
    np.random.seed(cfg.seed)
    tokenizer = HashTokenizer()
    # one prep config for both splits: the packs share one cache
    data_kw = dict(tokenizer=tokenizer, num_candidates=cfg.num_candidates,
                   max_seq_len=S, max_history=cfg.max_history,
                   personality_permutations=cfg.personality_permutations)
    # on a mesh rank 0 prepares the data directory, then the others read
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
    train_ds = FedPERSONA(cfg.dataset_dir, train=True, do_iid=cfg.do_iid,
                          num_clients=cfg.num_clients, **data_kw)
    val_ds = FedPERSONA(cfg.dataset_dir, train=False, **data_kw)
    if mesh is not None and mesh.rank == 0:
        mesh.barrier()
    cfg = cfg.replace(num_clients=train_ds.num_clients)

    gcfg = build_gpt2(cfg, tokenizer)
    if S > gcfg.n_positions:
        raise ValueError(f"--max_seq_len {S} exceeds the model's "
                         f"{gcfg.n_positions} positions")
    model = GPT2DoubleHeads(gcfg, attn_impl=cfg.attn_impl,
                            generator=torch.Generator().manual_seed(cfg.seed))
    loaded = load_hf_weights(model, gcfg, cfg.model_checkpoint)
    if loaded is not None:
        with torch.no_grad():
            model.flat.copy_(loaded)
        print("loaded pretrained GPT-2 weights")
    else:
        print("WARNING: no local pretrained GPT-2; training from scratch")
    # the long-context configuration: every client's model seq-sharded
    # over the seq axis (ring attention); validation runs the dense model
    seq = mesh.seq if mesh is not None else None
    train_model = model
    if seq is not None:
        if S % seq.size:
            raise ValueError(
                f"the seq mesh axis size ({seq.size}) must divide "
                f"max_seq_len ({S})")
        train_model = GPT2DoubleHeads(gcfg, attn_impl=cfg.attn_impl,
                                      seq_axis=seq)
        train_model.flat = model.flat
        print(f"sequence parallelism: ring attention over {seq.size} "
              "shards")
    runtime = FedRuntime(cfg, model,
                         make_gpt2_train_loss(train_model, cfg.lm_coef,
                                              cfg.mc_coef, cfg.lm_chunk),
                         device=device,
                         loss_fn_val=make_gpt2_val_loss(model, cfg.lm_chunk),
                         mesh=mesh,
                         seq_spec=PERSONA_SEQ_SPEC if seq is not None
                         else None)
    cfg = runtime.cfg
    print(f"d={cfg.grad_size} c={cfg.num_cols} r={cfg.num_rows} k={cfg.k} "
          f"W={cfg.num_workers} B={cfg.local_batch_size} "
          f"C={cfg.num_candidates} S={S} attn={cfg.attn_impl} "
          f"remat={gcfg.remat_policy or gcfg.remat} lm_chunk={cfg.lm_chunk} "
          f"device={device}"
          + (f" mesh={mesh.size} ranks" if mesh is not None else ""))
    return runtime, runtime.init_state(), train_ds, val_ds, gcfg


def save_pretrained(out_dir: str, runtime, state, gcfg: GPT2Config,
                    tokenizer) -> None:
    """The JAX package's ``save_pretrained`` format: ``weights.npz``
    (``ps_weights``), ``config.json`` (``model_type``, the config's
    fields, ``compute_dtype`` by name, ``params_fingerprint``: the JAX
    package's fingerprint of the DoubleHeads layout) and
    ``hash_tokenizer.json``; reloadable without this run's flags."""
    mesh = getattr(runtime, "mesh", None)
    if mesh is None:
        weights = state.ps_weights
    else:
        weights = runtime.flat_weights(state)  # every rank gathers
        if mesh.rank != 0:
            return
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "weights.npz"),
             ps_weights=weights.cpu().numpy())
    cfg_dict = dataclasses.asdict(gcfg)
    cfg_dict["compute_dtype"] = DTYPE_NAMES[gcfg.compute_dtype]
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"model_type": "gpt2_doubleheads", **cfg_dict,
                   "params_fingerprint": params_fingerprint_jax(
                       runtime.layout)}, f, indent=1)
    with open(os.path.join(out_dir, "hash_tokenizer.json"), "w") as f:
        json.dump({"type": "HashTokenizer",
                   "base_vocab": tokenizer.base_vocab}, f)
    print(f"saved pretrained checkpoint to {out_dir}")


def load_pretrained(out_dir: str, device="cpu"):
    """``(model, flat, gcfg, tokenizer)`` from a ``save_pretrained``
    directory of either package: the DoubleHeads model (dense attention)
    with its weights ``flat`` on ``device``. Refuses weights written
    under another layout (the fingerprint)."""
    with open(os.path.join(out_dir, "config.json")) as f:
        cfg_dict = json.load(f)
    saved_fp = cfg_dict.pop("params_fingerprint", None)
    cfg_dict.pop("model_type", None)
    cfg_dict["compute_dtype"] = COMPUTE_DTYPES[cfg_dict["compute_dtype"]]
    gcfg = GPT2Config(**cfg_dict)
    model = GPT2DoubleHeads(gcfg)
    fp = params_fingerprint_jax(model.layout)
    if saved_fp is not None and fp != saved_fp:
        raise ValueError(
            f"{out_dir}: saved weights were written under a different "
            f"parameter layout ({saved_fp} != {fp})")
    model = model.to(device)
    with np.load(os.path.join(out_dir, "weights.npz")) as z, \
            torch.no_grad():
        model.flat.copy_(torch.from_numpy(z["ps_weights"]))
    with open(os.path.join(out_dir, "hash_tokenizer.json")) as f:
        tokenizer = HashTokenizer(json.load(f)["base_vocab"])
    return model, model.flat.detach(), gcfg, tokenizer


def kernel_launches() -> dict:
    """Launch counts of every kernel of the slice (K1, K2, the cell sum and
    each K3 route)."""
    return {**circulant_kernels.launches, **flash_attention.launches}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    timer = Timer()
    ns = parse_known(build_parser(), argv)
    runtime, state, train_ds, val_ds, gcfg = setup(ns)
    cfg = runtime.cfg
    ckpt_mgr, start_epoch, restored, global_round = setup_checkpointing(
        cfg, runtime, "gpt2_doubleheads")
    if restored is not None:
        state = restored
    tokens = (cfg.num_workers * runtime.batch_size * cfg.num_candidates
              * cfg.max_seq_len)
    flops = gpt2_model_flops(gcfg, tokens, cfg.max_seq_len)
    logdir, telemetry = open_telemetry(cfg, runtime, "gpt2_train",
                                       ckpt_mgr)
    # --test: one round and one validation batch, as the JAX package's
    # loop breaks after them, unless --num_rounds asks for more rounds
    # (one per epoch)
    tsv = TSVLogger()
    try:
        state, summary, log = train(
            runtime, state, train_ds, val_ds, make_gpt2_schedule(cfg),
            ns.num_rounds or (1 if cfg.do_test else 0),
            max_per_epoch=1 if cfg.do_test else None,
            val_max_batches=1 if cfg.do_test else None,
            loggers=(TableLogger(), tsv), timer=timer, ckpt_mgr=ckpt_mgr,
            checkpoint_every=cfg.checkpoint_every, start_epoch=start_epoch,
            global_round=global_round, telemetry=telemetry,
            model_flops_per_round=flops, writer=make_writer(cfg, logdir))
    finally:
        if telemetry is not None:
            telemetry.close()
    print(tsv)
    nll = summary["test_loss"] if summary else float("nan")
    acc = summary["test_acc"] if summary else float("nan")
    ppl = math.exp(min(nll, 20)) if summary else float("nan")
    print(f"final val nll {nll:.4f} ppl {ppl:.2f} mc acc {acc:.4f}")
    if cfg.do_checkpoint and summary is not None:
        save_pretrained(os.path.join(cfg.checkpoint_path,
                                     "gpt2_doubleheads"),
                        runtime, state, gcfg, train_ds.tokenizer)
    if log.round_s:
        rt = statistics.median(log.round_s)
        print(f"{tokens} tokens and {flops / 1e12:.3f} model TFLOP per "
              f"round (analytic); median round {rt:.4f} s: "
              f"{tokens / rt:.1f} tokens/s, {flops / rt / 1e12:.3f} "
              f"TFLOP/s on {runtime.device}")
    return {"losses": log.losses, "round_s": log.round_s, "val_loss": nll,
            "val_ppl": ppl, "val_acc": acc, "rounds": len(log.losses),
            "summary": summary, "state": state,
            "val_batches": log.val_batches,
            "total_download_mib": log.total_download_mib,
            "total_upload_mib": log.total_upload_mib,
            "tokens_per_round": tokens, "model_flops_per_round": flops,
            "logdir": logdir, "telemetry": telemetry, "log": log,
            "runtime": runtime}


if __name__ == "__main__":
    main()
