"""Ring attention: causal attention with the sequence sharded over the
``seq`` axis of the mesh, counterpart of the JAX package's
``parallel/ring.py``.

Shard i of n holds the tokens ``[i S/n, (i+1) S/n)``. Its queries stay
home while the key and value blocks go round the ring, one hop a step,
n steps; softmax is accumulated online in float32 (the running max
``m``, the normalizer ``l`` and the weighted sum ``o``), so no shard
forms the S x S scores, and causality comes from the global positions,
so the result is dense causal attention's. A block that lies wholly
above the diagonal (its keys all later than the shard's queries) adds
nothing, and is skipped: the JAX package computes it and masks every
term, which leaves ``m``, ``l`` and ``o`` as they were, bit for bit.

``torch.distributed``'s point-to-point calls carry no gradient, so the
backward is written out (``RingAttention``): a second pass round the
ring, each shard adding its queries' share to the dk and dv of the
blocks passing through, which travel with their blocks and are home
after n hops; dq stays home. The rotation is an argument: ``MeshRing``
is one shard a process (``Mesh.rotate``, a ``batch_isend_irecv`` on the
seq group), ``LocalRing`` all n shards in one process, rotating a list
(what one card can run). ``ring_attention_inner`` is the model's
attention on a seq mesh; ``ring_attention_shards`` the single-process
form.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

NEG = -1e30


class MeshRing:
    """One shard a process: this rank of the seq axis's mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.size
        self.ids = [mesh.rank]

    def rotate(self, groups: Sequence[List[torch.Tensor]]) -> list:
        """Each list's one block to the next shard, the previous one's
        back, all lists in one launch."""
        got = self.mesh.rotate([g[0] for g in groups])
        return [[t] for t in got]


class LocalRing:
    """All n shards in this process, shard i at list position i."""

    def __init__(self, n: int):
        self.n = n
        self.ids = list(range(n))

    def rotate(self, groups: Sequence[List[torch.Tensor]]) -> list:
        return [[g[-1]] + list(g[:-1]) for g in groups]


def _logits(q, k, scale, diagonal: bool):
    """(..., H, Sq, Sk) float32 scores of a block, the diagonal block's
    later keys set to NEG; and the diagonal block's keep mask."""
    s = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if not diagonal:
        return s, None
    n = s.shape[-1]
    keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
    return s.masked_fill(~keep, NEG), keep


def _forward(ring, qs, ks, vs):
    """Float32 outputs and log-sum-exps of every local shard."""
    n, ids = ring.n, ring.ids
    D = qs[0].shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf = [q.float() for q in qs]
    ms, ls, os_ = [], [], []
    for q in qf:
        batch, (Sl, H) = q.shape[:-3], q.shape[-3:-1]
        ms.append(torch.full(batch + (H, Sl), NEG, dtype=torch.float32,
                             device=q.device))
        ls.append(torch.zeros(batch + (H, Sl), dtype=torch.float32,
                              device=q.device))
        os_.append(torch.zeros(q.shape, dtype=torch.float32,
                               device=q.device))
    kb, vb, src = list(ks), list(vs), list(ids)
    for t in range(n):
        for j, me in enumerate(ids):
            if src[j] > me:
                continue
            s, keep = _logits(qf[j], kb[j].float(), scale, src[j] == me)
            m_new = torch.maximum(ms[j], s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if keep is not None:
                p = p.masked_fill(~keep, 0.0)
            corr = torch.exp(ms[j] - m_new)
            ls[j] = ls[j] * corr + p.sum(dim=-1)
            pv = torch.einsum("...hqk,...khd->...qhd", p, vb[j].float())
            os_[j] = os_[j] * corr.transpose(-1, -2)[..., None] + pv
            ms[j] = m_new
        if t < n - 1:
            kb, vb = ring.rotate([kb, vb])
            src = [(x - 1) % n for x in src]
    outs, lses = [], []
    for m, l, o in zip(ms, ls, os_):
        denom = torch.clamp(l.transpose(-1, -2), min=1e-30)[..., None]
        outs.append(o / denom)
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    return outs, lses


def _backward(ring, qs, ks, vs, outs, lses, dos):
    """dq, dk, dv of every local shard (float32)."""
    n, ids = ring.n, ring.ids
    scale = 1.0 / math.sqrt(qs[0].shape[-1])
    qf = [q.float() for q in qs]
    dof = [d.float() for d in dos]
    # delta = rowsum(dO * O), (..., H, Sl)
    deltas = [(d * o).sum(dim=-1).transpose(-1, -2)
              for d, o in zip(dof, outs)]
    dqs = [torch.zeros_like(q) for q in qf]
    kb, vb = list(ks), list(vs)
    dkb = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in ks]
    dvb = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for v in vs]
    src = list(ids)
    for t in range(n):
        for j, me in enumerate(ids):
            if src[j] > me:
                continue
            k, v = kb[j].float(), vb[j].float()
            s, keep = _logits(qf[j], k, scale, src[j] == me)
            p = torch.exp(s - lses[j][..., None])
            if keep is not None:
                p = p.masked_fill(~keep, 0.0)
            dvb[j] = dvb[j] + torch.einsum("...hqk,...qhd->...khd", p,
                                           dof[j])
            dp = torch.einsum("...qhd,...khd->...hqk", dof[j], v)
            ds = p * (dp - deltas[j][..., None])
            dqs[j] = dqs[j] + torch.einsum("...hqk,...khd->...qhd", ds,
                                           k) * scale
            dkb[j] = dkb[j] + torch.einsum("...hqk,...qhd->...khd", ds,
                                           qf[j]) * scale
        if t < n - 1:
            kb, vb, dkb, dvb = ring.rotate([kb, vb, dkb, dvb])
        else:
            # the last hop brings each block's dk and dv home
            dkb, dvb = ring.rotate([dkb, dvb])
        src = [(x - 1) % n for x in src]
    return dqs, dkb, dvb


class RingAttention(torch.autograd.Function):
    """``apply(ring, *q_shards, *k_shards, *v_shards)`` -> the local
    shards' outputs (q's dtype), with the ring backward."""

    @staticmethod
    def forward(ctx, ring, *qkv):
        m = len(qkv) // 3
        qs, ks, vs = qkv[:m], qkv[m:2 * m], qkv[2 * m:]
        outs, lses = _forward(ring, qs, ks, vs)
        ctx.ring = ring
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(o.to(q.dtype) for o, q in zip(outs, qs))

    @staticmethod
    def backward(ctx, *dos):
        saved = ctx.saved_tensors
        m = len(dos)
        qs, ks, vs = saved[:m], saved[m:2 * m], saved[2 * m:3 * m]
        outs, lses = saved[3 * m:4 * m], saved[4 * m:]
        dqs, dks, dvs = _backward(ctx.ring, qs, ks, vs, outs, lses, dos)
        return (None,
                *(d.to(q.dtype) for d, q in zip(dqs, qs)),
                *(d.to(k.dtype) for d, k in zip(dks, ks)),
                *(d.to(v.dtype) for d, v in zip(dvs, vs)))


def ring_attention_inner(q, k, v, mesh):
    """Causal ring attention of this rank's (..., S/n, H, D) shards over
    the seq axis's ``mesh`` (the JAX package's ``ring_attention_inner``);
    returns the local output."""
    (out,) = RingAttention.apply(MeshRing(mesh), q, k, v)
    return out


def ring_attention_shards(qs: Sequence[torch.Tensor],
                          ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor]) -> list:
    """The single-process form: all n shards of q, k and v in lists (shard
    i at position i), the ring a rotating list; returns the n output
    shards."""
    return list(RingAttention.apply(LocalRing(len(qs)), *qs, *ks, *vs))


class SeqSum(torch.autograd.Function):
    """The sum over the seq axis of a value every shard computes its part
    of (``Mesh.all_reduce``, in shard order); its backward hands each
    shard the cotangent unchanged, so each shard's gradient is its own
    part's and the shards' gradients add up to the dense one."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def seq_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    return SeqSum.apply(x, mesh)


def from_next_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """The next shard's ``x`` (shard i gets shard i+1's; the last shard
    gets the first's, which callers mask)."""
    (got,) = mesh.rotate([x], shift=-1)
    return got
