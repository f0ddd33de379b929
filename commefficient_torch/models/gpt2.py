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

``GPT2Config.remat`` runs each block under non-reentrant
``torch.utils.checkpoint`` (the JAX package's ``nn.remat(Block)``), and
``remat_policy`` names the JAX checkpoint policy whose saved set it
keeps (``REMAT_POLICIES``). K3 is reached through ctypes, so no policy
saves its outputs: its forward runs again in the backward, as the Pallas
call is recomputed under JAX's remat. ``GPT2LMHead`` is the LM-only
model (no ``mc_head`` in its layout). On a seq mesh axis
(``seq_axis``, the axis's ``parallel.Mesh``; the JAX package's
``seq_axis``/``seq_shards``) the model runs on its shard's S/n tokens:
the position ids start at the shard's offset, attention is the ring
(``parallel/ring.py``), and the multiple-choice head reads the hidden
state on the shard that holds each ``mc_token_id`` and sums the logit
over the shards (``seq_sum``: each shard's gradient stays its own).
``load_state_dict`` and
``load_hf_weights`` map a HuggingFace GPT-2 state dict (a local
``model.safetensors`` or ``pytorch_model.bin``) onto either layout.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from commefficient_torch.models.layers import lecun_normal_, ravel_layout
from commefficient_torch.ops.flash_attention import flash_attention
from commefficient_torch.parallel.ring import ring_attention_inner, seq_sum

NUM_SPECIAL_TOKENS = 5  # <bos> <eos> <speaker1> <speaker2> <pad>

_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm, _aten.addmm, _aten.bmm))
_DOTS_NO_BATCH = frozenset((_aten.mm, _aten.addmm))
# the JAX package's jax.checkpoint_policies -> the aten ops whose outputs
# a checkpointed block saves (None: no checkpoint, everything is saved).
# The Dense layers are mm/addmm (no batch dimension), the dense
# attention's einsums bmm; "" is --remat without a policy, full remat.
REMAT_POLICIES = {"": frozenset(), "nothing_saveable": frozenset(),
                  "dots_saveable": _DOTS, "checkpoint_dots": _DOTS,
                  "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
                  "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
                  "everything_saveable": None}


def _remat_context(saved: frozenset) -> Callable:
    """``context_fn`` of a checkpoint that saves the outputs of the ops in
    ``saved`` and recomputes every other op. Full remat (nothing saved)
    takes the plain checkpoint: a selective one runs every op of the
    block through a Python dispatch mode, which costs the host time."""
    if not saved:
        return noop_context_fn

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


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
    # recompute each block in the backward (torch.utils.checkpoint), and
    # the JAX checkpoint policy whose saved set it keeps ("" = full remat)
    remat: bool = False
    remat_policy: str = ""
    # the JAX package's layer scan: the port's flat layout is the scanned
    # one (block leaves stacked over the layers), so it must stay True
    scan_layers: bool = True

    def __post_init__(self):
        if not self.scan_layers:
            raise ValueError("scan_layers=False: the port's GPT-2 runs the "
                             "scanned layout (h/block leaves stacked over "
                             "the layers) only")
        if self.remat and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}: want one of "
                f"{sorted(p for p in REMAT_POLICIES if p)}")

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


def param_tree(gcfg: GPT2Config, mc_head: bool = True) -> Dict:
    """Nested dict of parameter shapes, named as Flax names them under
    ``scan_layers`` (block leaves stacked over the layers); ``mc_head``
    False gives ``GPT2LMHead``'s tree."""
    E, L = gcfg.n_embd, gcfg.n_layer

    def dense(n_in, n_out):
        return {"bias": (L, n_out), "kernel": (L, n_in, n_out)}

    def norm(shape):
        return {"bias": shape, "scale": shape}

    tree = {"transformer": {
        "h": {"block": {
            "c_attn": dense(E, 3 * E), "c_fc": dense(E, 4 * E),
            "c_proj": dense(E, E), "ln_1": norm((L, E)),
            "ln_2": norm((L, E)), "mlp_proj": dense(4 * E, E)}},
        "ln_f": norm((E,)),
        "wpe": (gcfg.n_positions, E),
        "wte": (gcfg.total_vocab, E),
    }}
    if mc_head:
        tree["mc_head"] = {"kernel": (E, 1)}
    return {"params": tree}


class _GPT2(nn.Module):
    """The backbone over one flat weight vector; the heads subclass it."""

    mc_head = True

    def __init__(self, gcfg: GPT2Config, attn_impl: str = "dense",
                 generator: Optional[torch.Generator] = None,
                 seq_axis=None):
        super().__init__()
        self.gcfg = gcfg
        self.attn_impl = attn_impl
        self.attn = resolve_attn(attn_impl)
        # a seq axis of size 1 is none
        self.seq_axis = (seq_axis if seq_axis is not None
                         and seq_axis.size > 1 else None)
        self.seq_shards = self.seq_axis.size if self.seq_axis else 1
        if self.seq_axis is not None:
            self.attn = functools.partial(ring_attention_inner,
                                          mesh=self.seq_axis)
        self.layout: List[Tuple[str, Tuple]] = ravel_layout(
            param_tree(gcfg, self.mc_head))
        policy = REMAT_POLICIES[gcfg.remat_policy] if gcfg.remat else None
        self._remat = None if policy is None else _remat_context(policy)
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

    def _block(self, x, p):
        """One block on its layer's parameter views ``p``."""
        g = self.gcfg
        H, D, dt = g.n_head, g.n_embd // g.n_head, g.compute_dtype

        def ln(y, name):
            return F.layer_norm(y.float(), (g.n_embd,), p[f"{name}/scale"],
                                p[f"{name}/bias"], g.layer_norm_eps)

        def dense(y, name):
            return y @ p[f"{name}/kernel"].to(dt) + p[f"{name}/bias"].to(dt)

        qkv = dense(ln(x, "ln_1").to(dt), "c_attn")
        q, k, v = (t.unflatten(-1, (H, D))
                   for t in qkv.split(g.n_embd, dim=-1))
        a = self.attn(q, k, v).flatten(-2)
        x = x + dense(a, "c_proj")
        h = F.gelu(dense(ln(x, "ln_2").to(dt), "c_fc"), approximate="tanh")
        return x + dense(h, "mlp_proj")

    def hidden(self, input_ids, token_type_ids=None,
               flat: Optional[torch.Tensor] = None):
        """The backbone: ``(hidden float32 (..., S, E), wte, P)``, ``P``
        the parameter views keyed without ``transformer/``. Under
        ``remat`` each block runs checkpointed while autograd records."""
        g = self.gcfg
        P = {k[len("transformer/"):] if k.startswith("transformer/") else k: v
             for k, v in self.views(self.flat if flat is None
                                    else flat).items()}
        # the stacked block leaves split once into per-layer views: the
        # backward then stacks the layers' gradients in one pass, where a
        # per-layer index would fill and add a whole stack for each layer
        stacked = {k[len("h/block/"):]: v.unbind(0) for k, v in P.items()
                   if k.startswith("h/block/")}
        layers = [{k: v[i] for k, v in stacked.items()}
                  for i in range(g.n_layer)]
        S = input_ids.shape[-1]
        wte = P["wte"]
        # the global positions of this shard's tokens
        first = self.seq_axis.rank * S if self.seq_axis is not None else 0
        x = F.embedding(input_ids, wte) + P["wpe"][first:first + S]
        if token_type_ids is not None:
            x = x + F.embedding(token_type_ids, wte)
        x = x.to(g.compute_dtype)
        remat = self._remat is not None and torch.is_grad_enabled()
        for p in layers:
            # a block draws no random numbers and its recompute gives the
            # forward's shapes (and bits), so the checkpoint keeps no RNG
            # state and records no per-tensor metadata: both cost the host
            # a Python call for each tensor the block saves
            x = (checkpoint(self._block, x, p, use_reentrant=False,
                            context_fn=self._remat, preserve_rng_state=False,
                            determinism_check="none")
                 if remat else self._block(x, p))
        hidden = F.layer_norm(x.float(), (g.n_embd,), P["ln_f/scale"],
                              P["ln_f/bias"], g.layer_norm_eps)
        return hidden, wte, P


class GPT2DoubleHeads(_GPT2):
    """``forward(input_ids, mc_token_ids, token_type_ids, flat)`` ->
    (lm_logits float32 (..., S, V), mc_logits float32 (...,)), inputs
    (..., S) and (...,) int64; ``flat`` defaults to the module's own
    weights."""

    def hidden_and_mc(self, input_ids, mc_token_ids, token_type_ids=None,
                      flat: Optional[torch.Tensor] = None):
        """The backbone without the LM projection: ``(hidden float32
        (..., S, E), wte, mc_logits float32 (...,))``."""
        g = self.gcfg
        hidden, wte, P = self.hidden(input_ids, token_type_ids, flat)
        idx, owned = mc_token_ids, None
        if self.seq_axis is not None:
            # mc_token_ids are global positions: the shard holding one
            # contributes its hidden state's logit, the others 0
            S = hidden.shape[-2]
            local = mc_token_ids - self.seq_axis.rank * S
            owned = (local >= 0) & (local < S)
            idx = local.clamp(0, S - 1)
        mc_hidden = torch.gather(
            hidden, -2, idx[..., None, None].expand(
                idx.shape + (1, g.n_embd)))[..., 0, :]
        if owned is not None:
            mc_hidden = torch.where(owned[..., None], mc_hidden, 0.0)
        mc_logits = (mc_hidden @ P["mc_head/kernel"])[..., 0]
        if self.seq_axis is not None:
            mc_logits = seq_sum(mc_logits, self.seq_axis)
        return hidden, wte, mc_logits

    def forward(self, input_ids, mc_token_ids, token_type_ids=None,
                flat: Optional[torch.Tensor] = None):
        hidden, wte, mc_logits = self.hidden_and_mc(
            input_ids, mc_token_ids, token_type_ids, flat)
        return hidden @ wte.T, mc_logits


class GPT2LMHead(_GPT2):
    """The LM-only model: ``forward(input_ids, token_type_ids, flat)`` ->
    float32 logits (..., S, V) of the tied LM head; its layout has no
    ``mc_head``."""

    mc_head = False

    def forward(self, input_ids, token_type_ids=None,
                flat: Optional[torch.Tensor] = None):
        hidden, wte, _ = self.hidden(input_ids, token_type_ids, flat)
        return hidden @ wte.T


# HF GPT-2's Conv1D weights are already (in, out), as the Dense kernels
_HF_OF = {("c_attn", "kernel"): "attn.c_attn.weight",
          ("c_attn", "bias"): "attn.c_attn.bias",
          ("c_proj", "kernel"): "attn.c_proj.weight",
          ("c_proj", "bias"): "attn.c_proj.bias",
          ("c_fc", "kernel"): "mlp.c_fc.weight",
          ("c_fc", "bias"): "mlp.c_fc.bias",
          ("mlp_proj", "kernel"): "mlp.c_proj.weight",
          ("mlp_proj", "bias"): "mlp.c_proj.bias",
          ("ln_1", "scale"): "ln_1.weight",
          ("ln_1", "bias"): "ln_1.bias",
          ("ln_2", "scale"): "ln_2.weight",
          ("ln_2", "bias"): "ln_2.bias"}


def load_state_dict(target: Union[nn.Module, torch.Tensor],
                    gcfg: GPT2Config,
                    sd: Mapping[str, np.ndarray]) -> torch.Tensor:
    """The flat float32 weights (on the CPU) of ``target`` (a
    ``GPT2DoubleHeads`` or ``GPT2LMHead``, or either's flat vector) with
    the backbone taken from an HF-GPT-2-layout ``name -> array`` mapping
    (``wte.weight``, ``h.<i>.attn.c_attn.weight``, ...), as the JAX
    package's ``load_state_dict`` fills its tree: ``wte`` padded for the
    added special tokens with the mean row, ``wpe`` cut to
    ``n_positions``, the layers stacked; ``mc_head`` keeps ``target``'s
    value. A missing key raises ``KeyError``, a wrong shape
    ``ValueError``."""
    if isinstance(target, nn.Module):
        layout, flat = target.layout, target.flat
    else:
        flat = target
        layouts = [ravel_layout(param_tree(gcfg, mc)) for mc in (True, False)]
        layout = next((lay for lay in layouts if flat.numel() == sum(
            math.prod(s) for _, s in lay)), None)
        if layout is None:
            raise ValueError(f"a flat vector of {flat.numel()} floats is "
                             "neither GPT-2 head's layout at this config")
    sizes = [math.prod(s) for _, s in layout]
    leaves = {path: piece.view(shape).numpy().copy() for (path, shape), piece
              in zip(layout, torch.split(flat.detach().float().cpu(), sizes))}

    def put(path, value):
        value = np.array(value, np.float32)
        want = leaves[path].shape
        if tuple(want) != value.shape:
            raise ValueError(
                f"HF weight shape {value.shape} does not match target leaf "
                f"{path!r} shape {tuple(want)}")
        leaves[path] = value

    tr = "params/transformer/"
    wte = np.asarray(sd["wte.weight"])
    pad = gcfg.total_vocab - wte.shape[0]
    if pad < 0:
        raise ValueError(f"HF wte has {wte.shape[0]} rows, more than the "
                         f"model's {gcfg.total_vocab}")
    put(tr + "wte", np.concatenate(
        [wte, np.tile(wte.mean(0, keepdims=True), (pad, 1))], 0))
    put(tr + "wpe", np.asarray(sd["wpe.weight"])[:gcfg.n_positions])
    for (mod, leaf), hf_name in _HF_OF.items():
        put(f"{tr}h/block/{mod}/{leaf}", np.stack(
            [np.asarray(sd[f"h.{i}.{hf_name}"])
             for i in range(gcfg.n_layer)]))
    put(tr + "ln_f/scale", sd["ln_f.weight"])
    put(tr + "ln_f/bias", sd["ln_f.bias"])
    return torch.cat([torch.from_numpy(leaves[path]).reshape(-1)
                      for path, _ in layout])


# safetensors dtype names -> numpy (little-endian); BF16 is widened
_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2",
                       "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
                       "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file (the documented format: an
    8-byte little-endian header length, a JSON header of ``name ->
    {dtype, shape, data_offsets}``, then the raw little-endian buffers),
    as numpy arrays; bf16 tensors come back as float32."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        begin, end = entry["data_offsets"]
        buf = data[begin:end]
        if entry["dtype"] == "BF16":
            arr = (np.frombuffer(buf, "<u2").astype(np.uint32)
                   << 16).view(np.float32)
        else:
            arr = np.frombuffer(buf, _SAFETENSORS_DTYPES[entry["dtype"]])
        out[name] = arr.reshape(entry["shape"])
    return out


def hf_checkpoint_dir(checkpoint: str) -> Optional[str]:
    """The directory of a local HF checkpoint: ``checkpoint`` itself, or
    for a hub name (``gpt2``, ``org/name``) its snapshot in the hub cache
    (``HF_HUB_CACHE``, else ``HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``; the revision ``refs/main`` names, else
    the newest snapshot); None when there is none."""
    if os.path.isdir(checkpoint):
        return checkpoint
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(
            os.path.expanduser("~"), ".cache", "huggingface"), "hub")
    repo = os.path.join(hub, "models--" + checkpoint.replace("/", "--"))
    snapshots = os.path.join(repo, "snapshots")
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            path = os.path.join(snapshots, f.read().strip())
        return path if os.path.isdir(path) else None
    if not os.path.isdir(snapshots):
        return None
    revs = [os.path.join(snapshots, r) for r in os.listdir(snapshots)]
    revs = [r for r in revs if os.path.isdir(r)]
    return max(revs, key=os.path.getmtime) if revs else None


def read_hf_state_dict(checkpoint: str) -> Optional[Dict[str, np.ndarray]]:
    """The GPT-2 state dict of a local HF checkpoint (``model.safetensors``
    or ``pytorch_model.bin``, read without ``transformers``) as float32
    numpy arrays, keys without the ``transformer.`` prefix of an LM-head
    checkpoint (as ``GPT2Model.from_pretrained`` strips it); None when
    there is no such file."""
    root = hf_checkpoint_dir(checkpoint)
    if root is None:
        return None
    st, pt = (os.path.join(root, n) for n in ("model.safetensors",
                                               "pytorch_model.bin"))
    if os.path.isfile(st):
        sd = read_safetensors(st)
    elif os.path.isfile(pt):
        sd = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
              for k, v in torch.load(pt, map_location="cpu",
                                     weights_only=True).items()}
    else:
        return None
    prefix = "transformer."
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


def load_hf_weights(target: Union[nn.Module, torch.Tensor],
                    gcfg: GPT2Config,
                    checkpoint: str = "gpt2") -> Optional[torch.Tensor]:
    """``load_state_dict`` of a local HF checkpoint (a directory, or a hub
    name found in the hub cache): the flat weights, or None when there is
    no checkpoint (the caller trains from scratch). Mapping errors
    propagate."""
    sd = read_hf_state_dict(checkpoint)
    return None if sd is None else load_state_dict(target, gcfg, sd)
