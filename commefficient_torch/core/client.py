"""Client-side computation, counterpart of the JAX package's
``core/client.py``: microbatched gradients, clipping and DP, the client
step with local momentum, local error, the local top-k and the
per-client sketch table, the FedAvg local-SGD loop, the fused sketch
step and the top-k download.

A client's batch is padded to a fixed shape with a validity mask. Its
gradient is the sum over its microbatches of each microbatch's mean
gradient (the reference's ``loss.backward()`` accumulation), plus the
decoupled weight decay ``weight_decay / num_workers * w``. Where the JAX
package ``vmap``s or ``scan``s, the port loops in Python over the
round's clients and a client's microbatches. DP noise is drawn from the
``torch.Generator`` the runtime keys by (seed, round, slot): a resumed
run draws the same noise (JAX's threefry draws cannot be reproduced).

``loss_fn(flat, batch, mask) -> (loss, (acc,))`` follows the contract of
losses.py: masked means over the valid items of a batch. A loss that owns
its backward carries ``loss_fn.streaming_grad(flat, batch, mask, cs,
table, scale=None) -> (table, loss, (acc,))`` (models/stream_mlp.py):
under the fused encode each microbatch calls it in place of autograd
and the whole-vector K1, and it streams each layer's gradient into the
table as the backward produces it.

The fused encode launches one K1 over the flat gradient, the JAX
package's own route on its accelerator (its ``encode_grad_tree`` ravels
the leaves there; its chunked form exists for its other backends, and
the port's gradient is already one flat vector).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from commefficient_torch.config import FedConfig
from commefficient_torch.ops.topk import clip_by_l2_norm, topk
from commefficient_torch.ops.wire import wire_round_trip


class ClientOut(NamedTuple):
    transmit: torch.Tensor             # what the client uploads, x n_c
    velocity: Optional[torch.Tensor]   # its new local velocity row
    error: Optional[torch.Tensor]      # its new local error row
    results: torch.Tensor              # (2,): mean loss and accuracy
    n_valid: torch.Tensor              # () valid items processed


# the update-space adversaries: they act on each client's upload
INJECT_KINDS = ("signflip", "scale", "noise", "nan")


def per_client_uploads(cfg: FedConfig) -> bool:
    """Whether the round needs each client's own upload (the JAX
    package's gating of its fused client loop): an update-space
    adversary, a robust aggregation or the quarantine act on them, so
    the round keeps the (W, ...) uploads instead of their running sum."""
    return (cfg.adversary in INJECT_KINDS or cfg.defense != "none"
            or cfg.nonfinite_action == "quarantine")


def fused_encode_blockers(cfg: FedConfig) -> list:
    """What makes the fused sketch encode (``--sketch_fused_encode``)
    unsound for ``cfg``, each naming the dense-space consumer and what to
    change; empty when nothing does. ``FedRuntime`` adds the blockers of
    the sketch and the server state and raises under ``on``."""
    if cfg.mode != "sketch":
        return [f"--mode {cfg.mode} has no sketch encode to fuse"]
    problems = []
    if cfg.defense != "none" and not cfg.table_clip:
        problems.append(
            f"--defense {cfg.defense} measures per-client norms on the "
            "dense deferred-encode uploads; fusing would move the defense "
            "to table-Frobenius space and silently change its "
            "clipping/trimming numerics")
    if cfg.adversary in INJECT_KINDS or cfg.nonfinite_action == "quarantine":
        problems.append(
            "--adversary " + cfg.adversary + " / --nonfinite_action "
            + cfg.nonfinite_action + " act on each client's own upload, "
            "which the fused client loop sums away; the JAX package's "
            "default round keeps those uploads dense (its per-client "
            "gradient statistics block the fused encode whenever the fused "
            "client loop is off). Pass --sketch_fused_encode auto")
    if cfg.do_dp:
        problems.append(
            "--dp clips and noises the DENSE per-client gradient before the "
            "encode; fusing would skip the privacy mechanism. Drop --dp, or "
            "run the unfused round")
    if cfg.sketch_dense_clip:
        problems.append(
            "--sketch_dense_clip clips the DENSE worker gradient before the "
            "encode; the fused path never materializes it. Use the table "
            "clip (--max_grad_norm without --sketch_dense_clip)")
    return problems


def flip_labels(batch: Dict[str, torch.Tensor], adv: torch.Tensor,
                num_classes: int, key: str = "target"
                ) -> Dict[str, torch.Tensor]:
    """Label flipping (data space): the adversarial slots of ``adv`` (W,)
    train on ``(C - 1) - y``, applied to the whole (W, B) batch before
    the clients run, so every client path sees it."""
    if key not in batch:
        raise ValueError(
            f"--adversary labelflip needs a {key!r} batch leaf (integer "
            f"class labels); this batch has {sorted(batch)} — label "
            "flipping is only defined for classification datasets")
    t = batch[key]
    advb = adv.reshape((-1,) + (1,) * (t.ndim - 1))
    return {**batch, key: torch.where(advb, (num_classes - 1) - t, t)}


def inject_adversary(cfg: FedConfig, tx: torch.Tensor, adv: torch.Tensor,
                     gens=None, n_valid: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Update-space injection on the (W, ...) uploads ``tx`` (dense
    gradients, tables or FedAvg deltas, each already times its datum
    count): signflip uploads -x, scale ``adversary_scale`` x, noise x +
    ``adversary_scale`` N(0, I) drawn from slot w's generator ``gens[w]``
    (the runtime keys them by (seed, round, slot) and the adversary's
    fold: the JAX package's threefry draws cannot be reproduced), nan an
    all-NaN upload. A slot with ``n_valid == 0`` uploads nothing and is
    never injected."""
    kind = cfg.adversary
    if kind in ("none", "labelflip"):
        return tx
    if n_valid is not None:
        adv = adv & (n_valid > 0)
    advb = adv.reshape((-1,) + (1,) * (tx.ndim - 1))
    if kind == "signflip":
        return torch.where(advb, -tx, tx)
    if kind == "scale":
        return torch.where(advb, cfg.adversary_scale * tx, tx)
    if kind == "noise":
        noise = torch.stack([
            torch.randn(tx.shape[1:], generator=g, dtype=tx.dtype,
                        device=tx.device) for g in gens])
        return torch.where(advb, tx + cfg.adversary_scale * noise, tx)
    if kind == "nan":
        return torch.where(advb, torch.full_like(tx, float("nan")), tx)
    raise ValueError(f"unknown adversary kind {kind!r}")


def quarantine_zero(tx: torch.Tensor, n_valid: torch.Tensor,
                    results: torch.Tensor):
    """``--nonfinite_action quarantine``: a client whose upload or loss
    went nonfinite is zeroed out of the round (its upload, its datum
    count and its (2,) results). Returns ``(tx, n_valid, results,
    finite)``, ``finite`` the (W,) flags the quarantine ledger reads."""
    W = tx.shape[0]
    fin = torch.isfinite(tx.reshape(W, -1)).all(dim=1) \
        & torch.isfinite(results[:, 0])
    finb = fin.reshape((-1,) + (1,) * (tx.ndim - 1))
    zero = tx.new_zeros(())
    return (torch.where(finb, tx, zero), torch.where(fin, n_valid, zero),
            torch.where(fin[:, None], results, zero), fin)


def int8_wire_uploads(cfg: FedConfig, tables, step: int, block: int,
                      slot0: int = 0) -> list:
    """Each client's (r, c) table as the server reads it after the int8
    wire (``wire_round_trip``), client ``w`` of the round drawing its
    rounding with salt ``slot0 + w``: the per-client path of
    ``--wire_dtype int8`` (the table clip keeps per-client tables)."""
    return [wire_round_trip(t, block, seed=cfg.seed, round_idx=step,
                            salt=slot0 + w) for w, t in enumerate(tables)]


def _num_microbatches(cfg: FedConfig, batch_size: int) -> Tuple[int, int]:
    """``(number of microbatches, microbatch size)`` of a batch."""
    if cfg.microbatch_size > 0:
        mb = min(batch_size, cfg.microbatch_size)
    else:
        mb = batch_size
    return math.ceil(batch_size / mb), mb


def _pad(batch: Dict[str, torch.Tensor], mask: torch.Tensor, to: int):
    """Pad the items of ``batch`` and ``mask`` with zeros (invalid) up to
    ``to``, as the JAX package pads a batch whose size the microbatch or
    chunk does not divide."""
    pad = to - mask.shape[0]
    if pad == 0:
        return batch, mask
    batch = {k: torch.cat((v, v.new_zeros((pad,) + v.shape[1:])))
             for k, v in batch.items()}
    return batch, torch.cat((mask, mask.new_zeros(pad)))


def _grad(loss_fn: Callable, params_vec: torch.Tensor, batch, mask):
    """``(loss, acc, gradient of the mean loss)`` at ``params_vec``."""
    w = params_vec.detach().requires_grad_(True)
    loss, (acc,) = loss_fn(w, batch, mask)
    (g,) = torch.autograd.grad(loss, w)
    return loss.detach(), acc.detach(), g


def make_forward_grad(cfg: FedConfig, loss_fn: Callable, batch_size: int,
                      fused_encode: bool = False):
    """The microbatched gradient of one client (reference
    fed_worker.py:249-335). Returns ``fwd(params_vec, batch, mask,
    gen=None, cs=None) -> (g, results, n_valid)``: ``g`` the sum over
    microbatches of their mean gradients plus the weight-decay term,
    then clipped and noised (below), ``results`` the (2,) mean loss and
    accuracy over the valid items.

    - ``--max_grad_norm`` in the dense modes, or in sketch mode with
      ``--sketch_dense_clip``: the dense ``g`` is clipped at
      ``max_grad_norm`` x the number of microbatches;
    - ``--dp``: clipped at ``l2_norm_clip``, then (``--dp_mode worker``)
      plus ``noise_multiplier * sqrt(num_workers)`` x N(0, 1) drawn from
      ``gen``;
    - under the table clip (``cfg.table_clip``): ``g`` is the client's
      own (r, c) table, clipped at the bare ``max_grad_norm``.
      Under ``fused_encode`` each microbatch gradient and the weight-decay
      term stream into it (a K1 launch each on the card, or the loss's
      ``streaming_grad``'s range launches); otherwise the dense ``g`` is
      encoded once.
    """
    num_iters, mb = _num_microbatches(cfg, batch_size)
    dense_clip = cfg.max_grad_norm is not None and (
        cfg.mode != "sketch" or cfg.sketch_dense_clip)
    wd = cfg.weight_decay / cfg.num_workers
    stream = (getattr(loss_fn, "streaming_grad", None) if fused_encode
              else None)

    def fwd(params_vec: torch.Tensor, batch: Dict[str, torch.Tensor],
            mask: torch.Tensor, gen: Optional[torch.Generator] = None,
            cs=None):
        batch, mask = _pad(batch, mask, num_iters * mb)
        g = cs.empty_table() if fused_encode else None
        sums = torch.zeros(2, dtype=torch.float32, device=params_vec.device)
        for i in range(num_iters):
            sl = slice(i * mb, (i + 1) * mb)
            mb_mask = mask[sl]
            mb_batch = {k: v[sl] for k, v in batch.items()}
            if stream is not None:
                g, loss, (acc,) = stream(params_vec, mb_batch, mb_mask, cs,
                                         g)
            else:
                loss, acc, g_mb = _grad(loss_fn, params_vec, mb_batch,
                                        mb_mask)
                if fused_encode:
                    g = cs.encode_accum(g, g_mb, 0)
                else:
                    g = g_mb if g is None else g + g_mb
            sums += torch.stack((loss, acc)) * mb_mask.to(torch.float32).sum()
        n_valid = mask.to(torch.float32).sum()
        results = sums / torch.clamp(n_valid, min=1.0)
        if cfg.weight_decay != 0:
            if fused_encode:
                g = cs.encode_accum(g, params_vec, 0, scale=wd)
            else:
                g = g + wd * params_vec
        if dense_clip:
            g = clip_by_l2_norm(g, cfg.max_grad_norm * num_iters)
        if cfg.do_dp:
            g = clip_by_l2_norm(g, cfg.l2_norm_clip)
            if cfg.dp_mode == "worker":
                g = g + cfg.noise_multiplier * math.sqrt(cfg.num_workers) \
                    * torch.randn(g.shape, generator=gen, device=g.device)
        if cfg.table_clip:
            if not fused_encode:
                g = cs.encode(g)
            g = cs.clip(g, cfg.max_grad_norm)
        return g, results, n_valid

    return fwd


def make_client_step(cfg: FedConfig, loss_fn: Callable, batch_size: int,
                     fused_encode: bool = False):
    """One client's round (reference fed_worker.py:184-230). Returns
    ``step(params_vec, batch, mask, velocity, error, gen, cs) ->
    ClientOut``; ``velocity`` and ``error`` are the client's rows, or None
    when the mode keeps none, ``gen`` the client's DP noise generator.
    In sketch mode the transmit is the client's clipped table under the
    table clip (``make_forward_grad``); otherwise it is dense, or, under
    ``fused_encode``, its table, and the runtime sums the transmits and
    encodes a dense sum once."""
    fwd = make_forward_grad(cfg, loss_fn, batch_size, fused_encode)

    def step(params_vec, batch, mask, velocity=None, error=None, gen=None,
             cs=None) -> ClientOut:
        g, results, n_valid = fwd(params_vec, batch, mask, gen, cs)
        # weighted by the datum count: the server divides by the round's
        g = g * n_valid
        new_velocity, new_error = velocity, error
        if cfg.local_momentum > 0:
            new_velocity = cfg.local_momentum * velocity + g
            base = new_velocity
        else:
            base = g
        if cfg.error_type == "local":
            new_error = error + base
            to_transmit = new_error
        else:
            to_transmit = base
        if cfg.mode == "local_topk":
            to_transmit = topk(to_transmit, cfg.k, approx=cfg.approx_topk)
            nz = to_transmit != 0
            if new_error is not None:
                new_error = new_error.masked_fill(nz, 0.0)
            if cfg.local_momentum > 0:
                new_velocity = new_velocity.masked_fill(nz, 0.0)
        return ClientOut(to_transmit, new_velocity, new_error, results,
                         n_valid)

    return step


def make_fedavg_client(cfg: FedConfig, loss_fn: Callable, batch_size: int):
    """The FedAvg local-SGD loop (reference fed_worker.py:61-113): the
    client's whole padded dataset is cut into ``fedavg_batch_size``
    chunks and trained for ``num_fedavg_epochs`` epochs of SGD with the
    rate decayed by ``fedavg_lr_decay ** step``; the transmit is the
    weight delta times the client's datum count.

    Returns ``step(params_vec, batch, mask, mask_host, lr, gen=None) ->
    ClientOut``; ``mask_host`` is the mask as a numpy array, ``gen`` the
    client's DP noise generator (each local step clips and noises its
    gradient). A chunk with no valid item is a no-op, as in the JAX
    package (no step, no decay, no metric), and is skipped without
    running it."""
    if cfg.fedavg_batch_size == -1:
        chunk = batch_size
    else:
        chunk = min(cfg.fedavg_batch_size, batch_size)
    n_chunks = math.ceil(batch_size / chunk)
    fwd = make_forward_grad(cfg, loss_fn, chunk)

    def step(params_vec, batch, mask, mask_host: np.ndarray,
             lr: torch.Tensor, gen=None) -> ClientOut:
        n_c = mask.to(torch.float32).sum()
        batch, mask = _pad(batch, mask, n_chunks * chunk)
        w = params_vec
        res = torch.zeros(2, dtype=torch.float32, device=w.device)
        decay = torch.tensor(cfg.fedavg_lr_decay, dtype=torch.float32,
                             device=w.device)
        step_idx = 0
        for _ in range(cfg.num_fedavg_epochs):
            for i in range(n_chunks):
                sl = slice(i * chunk, (i + 1) * chunk)
                if not mask_host[sl].any():
                    continue
                g, results, n_valid = fwd(
                    w, {k: v[sl] for k, v in batch.items()}, mask[sl], gen)
                w = w - g * (lr * decay ** step_idx)
                res = res + results * n_valid
                step_idx += 1
        results = res / torch.clamp(n_c * cfg.num_fedavg_epochs, min=1.0)
        return ClientOut((params_vec - w) * n_c, None, None, results, n_c)

    return step


def make_fused_grad(cfg: FedConfig, loss_fn: Callable, batch_size: int):
    """The fused sketch step (reference ``make_fused_grad`` with
    ``fused_encode=True``). The server consumes ``sum_c n_c g_c``, which
    is linear in the microbatch gradients, so every microbatch gradient
    of every client streams into ONE (r, c) table, scaled by its client's
    datum count n_c (one K1 launch each); the dense round gradient never
    exists. A microbatch never straddles two clients: a client's batch
    that the microbatch does not divide is padded with invalid items.
    Weight decay enters the same table by linearity (one more launch).

    A loss with ``streaming_grad`` streams each microbatch itself, with
    its client's datum count as ``scale``.

    Returns ``fused(params_vec, batch, mask, mask_host, cs) -> (table,
    results (W, 2), n_per_client (W,))``; ``batch`` leaves are (W, B,
    ...) tensors, ``mask`` (W, B) bool and ``mask_host`` its numpy
    copy."""
    num_iters, mb = _num_microbatches(cfg, batch_size)
    stream = getattr(loss_fn, "streaming_grad", None)

    def fused(params_vec, batch, mask, mask_host: np.ndarray, cs):
        W = mask.shape[0]
        n_per_client = mask.to(torch.float32).sum(dim=1)
        # the scales go to the kernel as host floats, from the round's one
        # copy of the mask
        n_host = mask_host.sum(axis=1).astype(np.float32)
        table = cs.empty_table()
        sums = torch.zeros((W, 2), dtype=torch.float32,
                           device=params_vec.device)
        for c in range(W):
            cb, cm = _pad({k: v[c] for k, v in batch.items()}, mask[c],
                          num_iters * mb)
            for i in range(num_iters):
                sl = slice(i * mb, (i + 1) * mb)
                mb_batch = {k: v[sl] for k, v in cb.items()}
                if stream is not None:
                    table, loss, (acc,) = stream(params_vec, mb_batch,
                                                 cm[sl], cs, table,
                                                 scale=float(n_host[c]))
                else:
                    loss, acc, g = _grad(loss_fn, params_vec, mb_batch,
                                         cm[sl])
                    table = cs.encode_accum(table, g, 0,
                                            scale=float(n_host[c]))
                sums[c] += torch.stack((loss, acc)) \
                    * cm[sl].to(torch.float32).sum()
        # decoupled weight decay summed over the round's clients,
        # (wd / num_workers) * sum_c n_c, encoded by linearity
        if cfg.weight_decay != 0:
            wd_scale = float(np.float32(cfg.weight_decay / cfg.num_workers)
                             * n_host.sum(dtype=np.float32))
            table = cs.encode_accum(table, params_vec, 0, scale=wd_scale)
        return table, sums / torch.clamp(n_per_client, min=1.0)[:, None], \
            n_per_client

    return fused


def make_val_step(loss_fn: Callable):
    """Masked evaluation: ``val(params_vec, batch, mask) -> ((loss, acc),
    n_valid)``."""

    @torch.no_grad()
    def val(params_vec, batch, mask):
        loss, (acc,) = loss_fn(params_vec, batch, mask)
        return (loss, acc), mask.to(torch.float32).sum()

    return val


def topk_down_weights(cfg: FedConfig, ps_weights: torch.Tensor,
                      worker_weights: torch.Tensor) -> torch.Tensor:
    """Download compression (reference fed_worker.py:232-247): a client's
    stale weights advance by the top-k of their lag behind the server's,
    row by row for a (W, d) ``worker_weights``."""
    return worker_weights + topk(ps_weights - worker_weights, cfg.k,
                                 approx=cfg.approx_topk)
