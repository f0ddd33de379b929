"""GPT-2 with LM and multiple-choice heads, counterpart of the JAX
package's ``models/gpt2.py`` (``GPT2DoubleHeads`` with ``scan_layers``).

Token, learned-position and token-type embeddings (token types look up
``wte``), pre-LN causal blocks, ``ln_f``, the LM head tied to ``wte`` and
a bias-free one-unit multiple-choice head on the hidden state at each
candidate's ``mc_token_id``.

Every parameter is a view into ONE flat float32 vector laid out as
``ravel_pytree`` lays out the Flax tree: keys sorted at every level, so
``mc_head`` comes before ``transformer``, and each ``h/block/*`` leaf is
stacked over the layers (n_layer, ...), Dense kernels (in, out). The flat
gradient therefore comes back in the order the sketch encodes, and weights
move between the packages as one vector (models/convert.py).

The JAX dtype policy: LayerNorms in float32; the Dense layers in the
compute dtype, their float32 weights cast per call; the residual stream in
the compute dtype; ``ln_f`` returns float32, so the tied LM head is a
float32 product. Attention dispatch follows the JAX rules (``resolve_attn``):
``auto`` runs K3 (ops/flash_attention.py) from S = 1024 up and dense
attention below; ``flash`` runs K3 when S % 128 == 0 and otherwise dense
attention with a warning. That is the JAX package's documented policy,
not a fallback on failure: a K3 launch that fails raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from commefficient_torch.models.layers import lecun_normal_, ravel_layout
from commefficient_torch.ops.flash_attention import flash_attention

NUM_SPECIAL_TOKENS = 5  # <bos> <eos> <speaker1> <speaker2> <pad>


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    num_added_tokens: int = NUM_SPECIAL_TOKENS
    layer_norm_eps: float = 1e-5
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def total_vocab(self) -> int:
        return self.vocab_size + self.num_added_tokens

    @classmethod
    def small(cls, **kw) -> "GPT2Config":
        """A tiny config for tests and smoke runs (not a reference size)."""
        base = dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2,
                    n_head=4)
        base.update(kw)
        return cls(**base)


def gpt2_model_flops(gcfg: GPT2Config, tokens: int, S: int) -> float:
    """Analytic forward+backward model FLOPs for ``tokens`` tokens at
    sequence length S (2 FLOPs a multiply-add, backward twice the
    forward): block products 12 E^2 per token and layer, attention scores
    and values 2 S E per token and layer (causal masking not discounted),
    the tied LM head E V per token."""
    E, L, V = gcfg.n_embd, gcfg.n_layer, gcfg.total_vocab
    fwd_per_tok = 2 * (12 * E * E * L + 2 * S * E * L + E * V)
    return 3.0 * fwd_per_tok * tokens


def dense_causal_attention(q, k, v):
    """Plain causal attention: q, k, v (..., S, H, D) -> (..., S, H, D),
    the scores and their softmax in float32 whatever the input dtype, the
    probabilities cast back to v's dtype."""
    S = q.shape[-3]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qhd,...khd->...hqk", q, k).float() * scale
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


def flash_causal_attention(q, k, v, _warn_fallback: bool = False):
    """Causal attention through K3, which never stores the (H, S, S)
    scores. Sequence lengths that are not a multiple of 128 run dense
    attention, as in the JAX package; an explicit ``flash`` request warns
    when that happens (``_warn_fallback``, set by ``resolve_attn``)."""
    S = q.shape[-3]
    if S % 128:
        if _warn_fallback:
            warnings.warn(
                "attn_impl='flash' was requested but the kernel is "
                f"ineligible here (S={S} % 128 != 0): running DENSE "
                "attention instead; memory and speed will be the dense "
                "path's (pick a multiple of 128)", stacklevel=2)
        return dense_causal_attention(q, k, v)
    return flash_attention(q, k, v)


def auto_causal_attention(q, k, v):
    """The JAX package's crossover policy: K3 from S = 1024 up, dense
    attention below."""
    if q.shape[-3] >= 1024:
        return flash_causal_attention(q, k, v)
    return dense_causal_attention(q, k, v)


ATTN_IMPLS = {"dense": dense_causal_attention,
              "flash": functools.partial(flash_causal_attention,
                                         _warn_fallback=True),
              "auto": auto_causal_attention}


def resolve_attn(name: str) -> Callable:
    """``--attn_impl`` name -> attention callable."""
    try:
        return ATTN_IMPLS[name]
    except KeyError:
        raise ValueError(f"unknown attn_impl {name!r}: "
                         f"want one of {sorted(ATTN_IMPLS)}") from None


def param_tree(gcfg: GPT2Config) -> Dict:
    """Nested dict of parameter shapes, named as Flax names them under
    ``scan_layers`` (block leaves stacked over the layers)."""
    E, L = gcfg.n_embd, gcfg.n_layer

    def dense(n_in, n_out):
        return {"bias": (L, n_out), "kernel": (L, n_in, n_out)}

    def norm(shape):
        return {"bias": shape, "scale": shape}

    return {"params": {
        "mc_head": {"kernel": (E, 1)},
        "transformer": {
            "h": {"block": {
                "c_attn": dense(E, 3 * E), "c_fc": dense(E, 4 * E),
                "c_proj": dense(E, E), "ln_1": norm((L, E)),
                "ln_2": norm((L, E)), "mlp_proj": dense(4 * E, E)}},
            "ln_f": norm((E,)),
            "wpe": (gcfg.n_positions, E),
            "wte": (gcfg.total_vocab, E),
        }}}


class GPT2DoubleHeads(nn.Module):
    """``forward(input_ids, mc_token_ids, token_type_ids, flat)`` ->
    (lm_logits float32 (..., S, V), mc_logits float32 (...,)), inputs
    (..., S) and (...,) int64; ``flat`` defaults to the module's own
    weights."""

    def __init__(self, gcfg: GPT2Config, attn_impl: str = "dense",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gcfg = gcfg
        self.attn_impl = attn_impl
        self.attn = resolve_attn(attn_impl)
        self.layout: List[Tuple[str, Tuple]] = ravel_layout(param_tree(gcfg))
        self.num_params = sum(math.prod(s) for _, s in self.layout)
        self.flat = nn.Parameter(torch.empty(self.num_params))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initializers: lecun_normal Dense kernels (fan-in of one
        layer's kernel), zero biases, LayerNorm scale 1, ``wte`` normal
        0.02 and ``wpe`` normal 0.01. The draws are torch's, not JAX's;
        carry JAX weights over with ``models.convert.params_from_jax``."""
        with torch.no_grad():
            for path, view in self.views(self.flat).items():
                if path.endswith("/kernel"):
                    lecun_normal_(view, view.shape[-2], generator)
                elif path.endswith("/scale"):
                    view.fill_(1.0)
                elif path.endswith("/wte") or path.endswith("/wpe"):
                    view.normal_(0.0, 0.02 if path.endswith("/wte") else 0.01,
                                 generator=generator)
                else:
                    view.zero_()

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Parameter views into ``flat``, keyed by Flax path without the
        leading ``params/`` (one ``split``: its backward writes the flat
        gradient with one concatenation)."""
        pieces = torch.split(flat, [math.prod(s) for _, s in self.layout])
        return {path[len("params/"):]: piece.view(shape)
                for (path, shape), piece in zip(self.layout, pieces)}

    def _block(self, x, p, i):
        g = self.gcfg
        H, D, dt = g.n_head, g.n_embd // g.n_head, g.compute_dtype

        def ln(y, name):
            return F.layer_norm(y.float(), (g.n_embd,), p[f"{name}/scale"][i],
                                p[f"{name}/bias"][i], g.layer_norm_eps)

        def dense(y, name):
            return y @ p[f"{name}/kernel"][i].to(dt) \
                + p[f"{name}/bias"][i].to(dt)

        qkv = dense(ln(x, "ln_1").to(dt), "c_attn")
        q, k, v = (t.unflatten(-1, (H, D))
                   for t in qkv.split(g.n_embd, dim=-1))
        a = self.attn(q, k, v).flatten(-2)
        x = x + dense(a, "c_proj")
        h = F.gelu(dense(ln(x, "ln_2").to(dt), "c_fc"), approximate="tanh")
        return x + dense(h, "mlp_proj")

    def hidden_and_mc(self, input_ids, mc_token_ids, token_type_ids=None,
                      flat: Optional[torch.Tensor] = None):
        """The backbone without the LM projection: ``(hidden float32
        (..., S, E), wte, mc_logits float32 (...,))``."""
        g = self.gcfg
        P = {k[len("transformer/"):] if k.startswith("transformer/") else k: v
             for k, v in self.views(self.flat if flat is None
                                    else flat).items()}
        # the stacked block leaves split once into per-layer views: the
        # backward then stacks the layers' gradients in one pass, where a
        # per-layer index would fill and add a whole stack for each layer
        p = {k[len("h/block/"):]: v.unbind(0) for k, v in P.items()
             if k.startswith("h/block/")}
        S = input_ids.shape[-1]
        wte = P["wte"]
        x = F.embedding(input_ids, wte) + P["wpe"][:S]
        if token_type_ids is not None:
            x = x + F.embedding(token_type_ids, wte)
        x = x.to(g.compute_dtype)
        for i in range(g.n_layer):
            x = self._block(x, p, i)
        hidden = F.layer_norm(x.float(), (g.n_embd,), P["ln_f/scale"],
                              P["ln_f/bias"], g.layer_norm_eps)
        mc_hidden = torch.gather(
            hidden, -2, mc_token_ids[..., None, None].expand(
                mc_token_ids.shape + (1, g.n_embd)))[..., 0, :]
        mc_logits = (mc_hidden @ P["mc_head/kernel"])[..., 0]
        return hidden, wte, mc_logits

    def forward(self, input_ids, mc_token_ids, token_type_ids=None,
                flat: Optional[torch.Tensor] = None):
        hidden, wte, mc_logits = self.hidden_and_mc(
            input_ids, mc_token_ids, token_type_ids, flat)
        return hidden @ wte.T, mc_logits
