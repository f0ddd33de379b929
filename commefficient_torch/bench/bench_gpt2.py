"""The GPT-2 (124M) sketched federated round, timed: the port's
counterpart of the JAX package's ``bench_gpt2.py``. Prints one JSON line
like ``bench``, which nests it under its ``"gpt2"`` key.

    python -m commefficient_torch.bench.bench_gpt2 [--telemetry_dir D]
        [--wire_dtype float32|bfloat16|int8] [--device cuda|cpu]

The round is the JAX package's: W = 8 clients x B = 8 dialogues x NC = 2
candidates x S = 256 random tokens over GPT-2's full vocabulary (32,768
tokens a round), microbatches of 8 dialogues with every block
recomputed in the backward, the LM loss 128 positions at a time, bf16
compute, dense attention (the JAX bench's model default), k = 50,000 and
a 5 x 524,288 circulant sketch, weight decay 0.

``mfu`` is the analytic forward and backward model FLOPs
(``gpt2_model_flops``, bitwise the JAX formula's value) x rounds over
the timed seconds x the card's peak bf16 FLOP/s; null on a device the
peak table does not know (the CPU included). ``memory_ledger`` is the
peak above resident memory of one warm round on the card
(``telemetry/memory_ledger.py measure_round``), null on the CPU. The
port has no compiler cost analysis, so the roofline's byte fields are
null. The timed rounds run with ``observe=False`` (bench_common).

``ledger_ab`` measures the client half of the split round
(``FedRuntime.cohort``) with the fused sketch encode on and off.
``decode_overlap`` (the JAX package's split round behind
``--decode_overlap``) is ROADMAP A9 and raises here.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

from commefficient_torch.bench.bench_common import (log, mfu_of,
                                                    peak_flops,
                                                    peak_hbm_gbps,
                                                    resolve_device,
                                                    timed_rounds,
                                                    with_retries)
from commefficient_torch.config import FedConfig
from commefficient_torch.core.runtime import FedRuntime
from commefficient_torch.losses import make_gpt2_train_loss
from commefficient_torch.models.gpt2 import (GPT2Config, GPT2DoubleHeads,
                                             gpt2_model_flops)
from commefficient_torch.telemetry.memory_ledger import measure_round
from commefficient_torch.telemetry.utilization import (device_kind_of,
                                                       emit_from_totals,
                                                       roofline_fields)

# PersonaChat-lineage throughput anchor, NOMINAL (not measured; the JAX
# package's figure for one V100)
NOMINAL_SINGLE_GPU_TOK_PER_SEC = 4500.0

DECODE_OVERLAP_REFUSAL = (
    "decode_overlap: the split round (--decode_overlap: the decode of "
    "round t running while round t+1 stages) is not ported; it is queued "
    "with the multi-GPU work in ROADMAP A9")


def refuse_decode_overlap(decode_overlap: bool) -> None:
    if decode_overlap:
        raise ValueError(DECODE_OVERLAP_REFUSAL)


def run_config(remat: bool = True, *, remat_policy: str = "",
               microbatch: int = 8, lm_chunk: int = 128,
               fused_encode: str = "auto", wire_dtype: str = "float32",
               dryrun: bool = False
               ) -> Tuple[GPT2Config, Tuple[int, int, int, int], FedConfig]:
    """The model config, the round shape (W, B, NC, S) and the FedConfig
    of ``run``. ``dryrun`` shrinks the model (``GPT2Config.small``), the
    round and the sketch so an arm runs in seconds on the CPU;
    ``microbatch`` keeps its ratio to the full client batch of 8 there,
    and ``lm_chunk`` is capped at S."""
    if dryrun:
        gcfg = GPT2Config.small(remat=remat, remat_policy=remat_policy)
        W, B, NC, S = 4, 4, 2, 64
        microbatch = max(1, (microbatch * B) // 8)
        lm_chunk = min(lm_chunk, S)
        sketch_kw = dict(k=1_000, num_rows=3, num_cols=16_384,
                         num_blocks=2)
    else:
        gcfg = GPT2Config(remat=remat, remat_policy=remat_policy)
        W, B, NC, S = 8, 8, 2, 256
        sketch_kw = dict(k=50_000, num_rows=5, num_cols=524_288,
                         num_blocks=20)
    cfg = FedConfig(mode="sketch", error_type="virtual", local_momentum=0.0,
                    virtual_momentum=0.9, weight_decay=0.0,
                    num_workers=W, local_batch_size=B,
                    microbatch_size=microbatch,
                    num_clients=100, track_bytes=False, approx_topk=True,
                    lm_chunk=lm_chunk, sketch_fused_encode=fused_encode,
                    wire_dtype=wire_dtype, **sketch_kw)
    return gcfg, (W, B, NC, S), cfg


def random_batch(gcfg: GPT2Config, shape, device) -> dict:
    """The JAX bench's seeded random round: ids over the vocabulary,
    (W, B, NC, S) leaves and (W, B, NC) / (W, B) ones, int64 on
    ``device``."""
    W, B, NC, S = shape
    rng = np.random.RandomState(0)
    V = gcfg.vocab_size
    batch = {
        "input_ids": rng.randint(0, V, (W, B, NC, S)),
        "mc_token_ids": rng.randint(0, S, (W, B, NC)),
        "lm_labels": rng.randint(0, V, (W, B, NC, S)),
        "mc_label": rng.randint(0, NC, (W, B)),
        "token_type_ids": rng.randint(0, 2, (W, B, NC, S)),
    }
    return {k: torch.as_tensor(v, dtype=torch.int64, device=device)
            for k, v in batch.items()}


def seeded_gpt2(cls, gcfg: GPT2Config, attn_impl: str, device):
    """A GPT-2 model (``cls``) whose flat weights are drawn on ``device``
    from a generator seeded 0: drawing 124M truncated normals on the host
    takes seconds a model."""
    dev = torch.device(device)
    with dev:
        return cls(gcfg, attn_impl=attn_impl,
                   generator=torch.Generator(device=dev).manual_seed(0))


def build_runtime(gcfg: GPT2Config, cfg: FedConfig, device) -> FedRuntime:
    model = seeded_gpt2(GPT2DoubleHeads, gcfg, "dense", device)
    return FedRuntime(cfg, model,
                      make_gpt2_train_loss(model, lm_chunk=cfg.lm_chunk),
                      device=device)


def run(remat: bool = True, telemetry=None, profiler=None, *,
        remat_policy: str = "", microbatch: int = 8, lm_chunk: int = 128,
        fused_encode: str = "auto", decode_overlap: bool = False,
        n_rounds: int = 8, wire_dtype: str = "float32",
        dryrun: bool = False, device="cuda") -> dict:
    """Build, warm up (one round) and time ``n_rounds`` GPT-2 rounds;
    returns the result dict (the JAX bench's keys).

    ``remat``, ``remat_policy``, ``microbatch`` and ``lm_chunk`` are the
    MFU sweep's knobs (``gpt2_mfu_sweep``); ``microbatch`` must divide
    the client batch. ``fused_encode`` passes through to
    ``--sketch_fused_encode`` (``auto``: every microbatch gradient
    streams into the round's table; ``off``: the clients' dense sum is
    encoded once; ``on``: fail if ineligible). ``dryrun``: the smoke
    scale of ``run_config``, its line marked ``dryrun: true``."""
    refuse_decode_overlap(decode_overlap)
    dev = resolve_device(device)
    log("device:", device_kind_of(dev))
    gcfg, (W, B, NC, S), cfg = run_config(
        remat, remat_policy=remat_policy, microbatch=microbatch,
        lm_chunk=lm_chunk, fused_encode=fused_encode, wire_dtype=wire_dtype,
        dryrun=dryrun)
    runtime = build_runtime(gcfg, cfg, dev)
    if telemetry is not None:
        telemetry.memory_event("gpt2_init")
    batch = random_batch(gcfg, (W, B, NC, S), dev)
    mask = np.ones((W, B), bool)
    ids = np.arange(W)
    args = (ids, batch, mask, 0.1)
    dt, metrics, phases = timed_rounds(runtime, args, warmup=1,
                                       rounds=n_rounds, desc="gpt2",
                                       profiler=profiler, device=dev)
    warmup_s = phases.pop("warmup_s", None)

    toks = n_rounds * W * B * NC * S
    tps = toks / dt
    loss = float(metrics["results"][0].mean())
    flops = gpt2_model_flops(gcfg, W * B * NC * S, S)
    peak = peak_flops(dev)
    mfu = mfu_of(flops, n_rounds, dt, peak)
    log(f"{n_rounds} rounds in {dt:.3f}s -> {tps:.0f} tok/s, loss {loss:.3f}")
    log(f"model FLOPs/round {flops:.3e}, peak {peak}, MFU {mfu}")

    # the peak above resident memory of one warm round (on the card)
    mledger = None
    if dev.type == "cuda":
        state = runtime.init_state()
        with measure_round(dev) as mr:
            runtime.round(state, *args, observe=False)
            torch.cuda.synchronize(dev)
        mledger = mr.ledger()
        del state
        log(f"memory ledger of a warm round: {mledger}")
    roof = roofline_fields(
        rounds=n_rounds, wall_s=dt, flops_per_round=flops,
        bytes_per_round=None, bytes_source=None, peak_flops=peak,
        peak_hbm_gbps=peak_hbm_gbps(dev))

    result = {
        "metric": "gpt2_sketch_round_throughput",
        "value": round(tps, 1),
        "unit": "tokens/sec",
        "vs_baseline": round(tps / NOMINAL_SINGLE_GPU_TOK_PER_SEC, 3),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "tokens_per_round": W * B * NC * S,
        "timed_rounds": n_rounds,
        "wire_dtype": runtime.cfg.wire_dtype,
        # the bytes the round's tables take on the wire: W clients x the
        # runtime's own count (its sized table and effective int8 block)
        "wire_bytes_per_round": W * runtime.cfg.upload_wire_bytes(
            runtime._wire_block or None),
        "warmup_s": warmup_s,
        "phase_split": phases,
        "input_wait_frac": round(phases["host_s"] / dt, 6),
        "roofline": roof,
        "memory_ledger": mledger,
        # the split round's decode ledger: never, the split is A9
        "memory_ledger_decode": None,
        "dryrun": dryrun,
        "config": {"remat": remat, "remat_policy": remat_policy,
                   "microbatch": cfg.microbatch_size,
                   "lm_chunk": cfg.lm_chunk, "fused_encode": fused_encode,
                   "decode_overlap": decode_overlap},
    }
    if telemetry is not None:
        emit_from_totals(
            telemetry, rnd=n_rounds, rounds=n_rounds, wall_s=dt,
            host_s=phases["host_s"], dispatch_s=phases["dispatch_s"],
            device_s=phases["device_wait_s"],
            flops_per_round=flops, flops_source="analytic",
            device_kind=device_kind_of(dev))
        telemetry.bench_event(result["metric"], result,
                              wire_dtype=runtime.cfg.wire_dtype)
    return result


def ledger_ab(dryrun: bool = False, *, device="cuda",
              decode_overlap: bool = False) -> dict:
    """The client half of the split round (``FedRuntime.cohort``, the
    async split) with ``sketch_fused_encode`` auto and off, at the JAX
    record's geometries: the full GPT-2 round, or under ``dryrun`` a
    mid-size GPT-2 (vocabulary 8,192, 4 layers of width 256, one
    32-token dialogue). Each arm's ledger is the peak above resident
    memory of its second cohort call on the card (the first pays one-time
    set-up), null off the card; the record has the JAX record's keys.
    ``decode_overlap`` (the JAX record's executable) raises: ROADMAP A9."""
    refuse_decode_overlap(decode_overlap)
    dev = resolve_device(device)
    if dryrun:
        gcfg = GPT2Config(vocab_size=8192, n_positions=128, n_embd=256,
                          n_layer=4, n_head=4, remat=True)
        W, B, NC, S, mb = 1, 1, 1, 32, 1
        sketch_kw = dict(k=5_000, num_rows=3, num_cols=262_144,
                         num_blocks=8)
    else:
        gcfg = GPT2Config(remat=True)
        W, B, NC, S, mb = 8, 8, 2, 256, 8
        sketch_kw = dict(k=50_000, num_rows=5, num_cols=524_288,
                         num_blocks=20)
    batch = random_batch(gcfg, (W, B, NC, S), dev)
    mask = np.ones((W, B), bool)
    ids = np.arange(W)
    rec = {"metric": "gpt2_fused_encode_ledger_ab", "d": None,
           "dense_grad_bytes": None, "dryrun": dryrun,
           "round_shape": [W, B, NC, S], "microbatch": mb, "arms": {}}
    for fe in ("auto", "off"):
        cfg = FedConfig(mode="sketch", error_type="virtual",
                        local_momentum=0.0, virtual_momentum=0.9,
                        weight_decay=0.0, num_workers=W,
                        local_batch_size=B, microbatch_size=mb,
                        num_clients=100, track_bytes=False,
                        approx_topk=True, lm_chunk=min(128, S),
                        sketch_fused_encode=fe, async_agg=True,
                        telemetry=False, **sketch_kw)
        runtime = build_runtime(gcfg, cfg, dev)
        d = runtime.cfg.grad_size
        rec["d"], rec["dense_grad_bytes"] = d, d * 4

        def arm(runtime=runtime):
            state = runtime.init_state()
            runtime.cohort(state, ids, batch, mask, 0.1)
            if dev.type != "cuda":
                return None
            with measure_round(dev) as mr:
                runtime.cohort(state, ids, batch, mask, 0.1)
                torch.cuda.synchronize(dev)
            return mr.ledger()

        led = with_retries(arm, desc=f"ledger_ab fe={fe}")
        rec["arms"][fe] = led
        t = (led or {}).get("temp_bytes")
        log(f"ledger_ab fe={fe}: cohort temp {t} ({t / (d * 4):.2f}x d*4)"
            if t is not None else f"ledger_ab fe={fe}: no ledger")
        del runtime
    a, o = rec["arms"].get("auto") or {}, rec["arms"].get("off") or {}
    if a.get("temp_bytes") is not None and o.get("temp_bytes") is not None:
        rec["temp_drop_bytes"] = o["temp_bytes"] - a["temp_bytes"]
        rec["drop_covers_dense_grad"] = bool(
            rec["temp_drop_bytes"] >= rec["dense_grad_bytes"])
        log(f"ledger_ab: temp drop {rec['temp_drop_bytes']} B vs dense grad "
            f"{rec['dense_grad_bytes']} B -> covers: "
            f"{rec['drop_covers_dense_grad']}")
    return rec


def main(argv: Optional[list] = None) -> dict:
    import argparse

    from commefficient_torch.bench.bench import (add_bench_args,
                                                 make_bench_telemetry,
                                                 parse_bench_args)
    ap = argparse.ArgumentParser(description=__doc__)
    add_bench_args(ap)
    args = parse_bench_args(ap, argv)
    telemetry, profiler = make_bench_telemetry(args, "bench_gpt2")
    result = run(telemetry=telemetry, profiler=profiler,
                 wire_dtype=args.wire_dtype, device=args.device)
    if telemetry is not None:
        telemetry.write_summary(aborted=False,
                                n_rounds=result["timed_rounds"],
                                final=result)
        telemetry.close()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
