"""The decoder-only LMs (the dense, MoE and VLM families): training and
decoding.

Counterpart of ``repro.models.transformer``: ``LMConfig``, ``init_lm``, the
block, ``forward`` and ``loss_fn``, and for serving ``cache_buf_len``,
``init_cache``, ``decode_step`` and ``prefill``. The reference scans its
stacked blocks under one layer tag, ``"L"``; the port loops an
``nn.ModuleList`` and names every block's layers under that same tag
(``L.attn.q``, ``L.mlp.gate``, ``L.moe.up``, ...), so that rules such as
``L*.mlp.*``, telemetry tags and the dither streams (``fold_in(key,
name_salt(name))``, the same key for every layer at a step, as in the
reference) match. With ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable``): its forward runs again in the backward, its residual
encodes included; the rerun's context is marked ``recompute``, so each
block's memory telemetry is recorded once a step, by the first run.

The block: pre-norm attention (q/k/v biases with ``qkv_bias``) and an MLP
of kind ``act`` (``swiglu``, ``geglu``, ``relu2``) or, with ``moe``, the
mixture-of-experts layer (``repro_torch.models.moe``), whose load-balance
loss each block returns: ``loss_fn`` adds their sum. Sliding windows: with
``window``, layer i is local (its mask keeps the last ``window`` positions)
unless ``window_pattern`` N > 0 and (i + 1) % (N + 1) == 0
(:meth:`LMConfig.layer_is_local`). The unembedding is the embedding table
(``tie_embeddings``) or its own ``head.lm_head``.

The VLM (internvl2-2b, ``vlm_patches`` > 0): precomputed patch embeddings
(B, vlm_patches, vit_dim) go through the projector, ``vit_proj1``, GELU
(tanh form) and ``vit_proj2`` (both dithered, under those names), and are
prepended to the token embeddings as a visual prefix; the loss counts the
text positions only. Without patch embeddings the model is a text decoder
(serving feeds text only, as the reference's engine does).

Parameters (``LM.named_parameters()``): ``embed.table`` (V, d),
``layers.{i}.attn.{wq,wk,wv,wo}`` (and ``{bq,bk,bv}``),
``layers.{i}.mlp.{w_gate,w_up,w_down}`` (no ``w_gate`` for relu2) or
``layers.{i}.moe.{router,w_gate,w_up,w_down,ws_gate,ws_up,ws_down}``,
``layers.{i}.ln1``, ``layers.{i}.ln2``, ``head.ln_f`` (and
``head.lm_head``, ``head.vit_proj1`` (vit_dim, d), ``head.vit_proj2`` (d,
d)); dense weights (in, out), as the reference's
(``repro_torch.convert.lm_params_from_jax`` maps its stacked tree onto
them).

Decoding runs the blocks one by one with no dither context and no
autograd, each layer with its own cache: dense (K, V) buffers (B, S_buf,
KV, hd), a local layer's a ring of ``min(window, max_len)`` slots, or a
paged cache (``repro_torch.serve.kvcache``, global layers only). The cache
dtype is the model's.

Not ported: the settings that no reference config sets (``norm``,
``softcap``, ``rope_scaling``), and the cache specs of the dry run
(ROADMAP.md section 1, item 9).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.dithered import dense
from repro_torch.core.policy import DitherCtx
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, init_moe, moe_layer

LAYER_TAG = "L"  # the reference's scan tag: every block's layers share it


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    act: str = "swiglu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window size of local layers
    window_pattern: int = 0  # N -> every (N+1)th layer global; 0 -> none
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    moe: Optional[MoEConfig] = None
    # VLM (internvl2): a visual prefix of precomputed patch embeddings
    vlm_patches: int = 0
    vit_dim: int = 0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True  # activation checkpointing per block in training

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_is_local(self, i: int) -> bool:
        """Whether layer ``i`` attends within the window."""
        if self.window is None:
            return False
        if self.window_pattern == 0:
            return True
        return (i + 1) % (self.window_pattern + 1) != 0

    def layer_window(self, i: int) -> Optional[int]:
        return self.window if self.layer_is_local(i) else None

    @property
    def param_count(self) -> int:
        """Total parameters (the reference's count; the q/k/v biases are
        not in it, the VLM projector is)."""
        d, f, V, hd = self.d_model, self.d_ff, self.vocab, self.hd
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.moe is None:
            mlp = (3 if self.act in L.GATED else 2) * d * f
        else:
            m = self.moe
            mlp = 3 * m.n_experts * d * m.d_ff_expert + d * m.n_experts
            if m.n_shared:
                mlp += 3 * d * m.d_ff_expert * m.n_shared
        per_layer = attn + mlp + 2 * d
        emb = V * d * (1 if self.tie_embeddings else 2)
        proj = (self.vit_dim * d + d * d) if self.vlm_patches else 0
        return self.n_layers * per_layer + emb + d + proj

    @property
    def active_param_count(self) -> int:
        """Parameters a token meets (MoE: its top_k and the shared
        experts)."""
        if self.moe is None:
            return self.param_count
        m, d = self.moe, self.d_model
        dense_total = (self.param_count
                       - self.n_layers * 3 * m.n_experts * d * m.d_ff_expert)
        return dense_total + self.n_layers * 3 * m.top_k * d * m.d_ff_expert


class Block(nn.Module):
    """One pre-norm block: x + attn(rms(x)), then + mlp(rms(.)) or
    + moe(rms(.))."""

    def __init__(self, cfg: LMConfig, ini: L.Init):
        super().__init__()
        self.cfg = cfg
        self.attn = L.init_attention(ini, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.hd, cfg.qkv_bias)
        if cfg.moe is not None:
            self.moe = init_moe(ini, cfg.d_model, cfg.moe)
        else:
            self.mlp = L.init_mlp(ini, cfg.d_model, cfg.d_ff, cfg.act)
        self.ln1 = ini.ones(cfg.d_model)
        self.ln2 = ini.ones(cfg.d_model)

    def ffn(self, h: torch.Tensor, ctx: Optional[DitherCtx], tag: str):
        """(y, aux): the MLP's output and None, or the MoE layer's."""
        cfg = self.cfg
        if cfg.moe is not None:
            return moe_layer(self.moe, h, cfg.moe, ctx, name=f"{tag}.moe")
        return L.mlp(self.mlp, h, cfg.act, ctx=ctx, name=f"{tag}.mlp"), None

    def forward(self, x: torch.Tensor, pos_b: torch.Tensor,
                mask: torch.Tensor, ctx: Optional[DitherCtx]):
        """(x, aux) after the block; aux None for an MLP block."""
        cfg = self.cfg
        h = L.rms_norm(x, self.ln1)
        y, _ = L.attention(self.attn, h, pos_b, mask, cfg.n_heads,
                           cfg.n_kv_heads, cfg.hd, cfg.rope_theta, ctx=ctx,
                           name=f"{LAYER_TAG}.attn")
        x = x + y
        y, aux = self.ffn(L.rms_norm(x, self.ln2), ctx, LAYER_TAG)
        return x + y, aux


class LM(nn.Module):
    """The decoder: ``embed``, ``layers`` (a ModuleList of blocks) and
    ``head`` (the final norm, and the unembedding when untied)."""

    def __init__(self, cfg: LMConfig, ini: L.Init):
        super().__init__()
        self.cfg = cfg
        self.embed = L.init_embedding(ini, cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(Block(cfg, ini)
                                    for _ in range(cfg.n_layers))
        self.head = nn.ParameterDict({"ln_f": ini.ones(cfg.d_model)})
        if not cfg.tie_embeddings:
            self.head["lm_head"] = ini.normal(cfg.d_model, cfg.vocab,
                                              stddev=0.02)
        if cfg.vlm_patches:
            self.head["vit_proj1"] = ini.normal(cfg.vit_dim, cfg.d_model,
                                                fan_in=cfg.vit_dim)
            self.head["vit_proj2"] = ini.normal(cfg.d_model, cfg.d_model,
                                                fan_in=cfg.d_model)


def init_lm(cfg: LMConfig, *, seed: int = 0,
            device: Optional[torch.device] = None) -> LM:
    """A model of ``cfg`` with parameters drawn on ``device`` (CUDA unless
    named) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, L.Init(gen, dev, cfg.dtype))


def _embed_inputs(net: LM, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor] = None,
                  ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """The token embeddings, behind the projected visual prefix when the
    config has one and patch embeddings are given."""
    x = L.embed(net.embed["table"], tokens)
    if net.cfg.embed_scale:
        x = x * L.embed_scale(net.cfg.d_model, x.dtype)
    if net.cfg.vlm_patches and patch_embeds is not None:
        pe = dense(patch_embeds.to(x.dtype), net.head["vit_proj1"], ctx=ctx,
                   name="vit_proj1")
        pe = dense(L.act_fn("gelu")(pe), net.head["vit_proj2"], ctx=ctx,
                   name="vit_proj2")
        x = torch.cat([pe, x], 1)
    return x


def _rerun_marked(block):
    """``block`` (called with the dither context last) for
    ``torch.utils.checkpoint``: its second call, the rerun in the backward,
    gets its context marked ``recompute``."""
    calls = []

    def run(*args):
        *args, ctx = args
        if calls and ctx is not None:
            ctx = dataclasses.replace(ctx, recompute=True)
        calls.append(None)
        return block(*args, ctx)
    return run


def _masks(cfg: LMConfig, pos_b: torch.Tensor):
    """{window: mask} for the windows the layers use (None: global)."""
    return {w: L.attention_mask(pos_b, pos_b, window=w)
            for w in {cfg.layer_window(i) for i in range(cfg.n_layers)}}


def _unembed(net: LM, x: torch.Tensor, ctx: Optional[DitherCtx] = None
             ) -> torch.Tensor:
    x = L.rms_norm(x, net.head["ln_f"])
    if net.cfg.tie_embeddings:
        return L.unembed(net.embed["table"], x, ctx=ctx)
    return dense(x, net.head["lm_head"], ctx=ctx, name="lm_head")


def forward_aux(net: LM, tokens: torch.Tensor, *,
                ctx: Optional[DitherCtx] = None,
                patch_embeds: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (logits (B, S_total, V) in the model's dtype, the
    blocks' aux loss summed, f32; None for the dense family). S_total is S
    plus the visual prefix's ``vlm_patches`` when ``patch_embeds`` are
    given."""
    cfg = net.cfg
    x = _embed_inputs(net, tokens, patch_embeds, ctx)
    B, S = x.shape[:2]
    pos_b = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    masks = _masks(cfg, pos_b)
    auxs = []
    for i, block in enumerate(net.layers):
        mask = masks[cfg.layer_window(i)]
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(_rerun_marked(block), x, pos_b, mask, ctx,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = block(x, pos_b, mask, ctx)
        auxs.append(aux)
    aux = torch.sum(torch.stack(auxs)) if cfg.moe is not None else None
    return _unembed(net, x, ctx), aux


def forward(net: LM, tokens: torch.Tensor, *,
            ctx: Optional[DitherCtx] = None,
            patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S_total, V) in the model's dtype."""
    return forward_aux(net, tokens, ctx=ctx, patch_embeds=patch_embeds)[0]


def loss_fn(net: LM, batch: Dict[str, torch.Tensor], *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """Next-token cross-entropy in f32, the mean over every text position
    (a visual prefix's positions are dropped), plus the MoE aux loss."""
    pe = batch.get("patch_embeds")
    logits, aux = forward_aux(net, batch["tokens"], ctx=ctx, patch_embeds=pe)
    if net.cfg.vlm_patches and pe is not None:
        logits = logits[:, -batch["labels"].shape[1]:]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = batch["labels"]
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss = torch.sum(nll) / math.prod(labels.shape)
    return loss if aux is None else loss + aux


# ---------------------------------------------------------------------------
# decode (serving): per-layer caches, no dither context
# ---------------------------------------------------------------------------

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def cache_buf_len(cfg: LMConfig, i: int, max_len: int) -> int:
    """Buffer length of layer ``i``'s cache: ``min(window, max_len)`` for
    a local layer (a ring), ``max_len`` for a global one."""
    if cfg.layer_is_local(i):
        return min(cfg.window, max_len)
    return max_len


def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device: Optional[torch.device] = None) -> Cache:
    """Zero (K, V) buffers (batch, S_buf, KV, hd) in the model's dtype, one
    pair a layer."""
    dev = resolve_device(device)
    return [tuple(torch.zeros(batch, cache_buf_len(cfg, i, max_len),
                              cfg.n_kv_heads, cfg.hd, dtype=cfg.dtype,
                              device=dev) for _ in range(2))
            for i in range(cfg.n_layers)]


def _cache_index(t: Union[int, torch.Tensor], device) -> torch.Tensor:
    """t as an int64 tensor on ``device``; a Python int by a fill, which
    needs no host-to-device copy."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.int64)
    return torch.full((), int(t), dtype=torch.int64, device=device)


@torch.no_grad()
def decode_step(net: LM, cache, token: torch.Tensor,
                t: Union[int, torch.Tensor], *, t_host=None):
    """One decoding step. token (B, 1) ids; t: one position for the batch
    (an int or a 0-d tensor) or per-slot positions (B,), t < 0 for an
    inactive slot (see ``layers.cached_attention``); ``t_host``, the
    per-slot t on the host, spares a paged cache a device sync. Returns
    (logits (B, 1, V), new cache); dense buffers are new tensors, paged
    caches are written in place. An MoE block routes the B tokens of the
    step (capacity ``moe.capacity(cfg, B)``), inactive slots' included, as
    the reference's."""
    cfg = net.cfg
    t = _cache_index(t, token.device)
    x = _embed_inputs(net, token)
    rope = L.rope_table(L.decode_positions(t), cfg.hd, cfg.rope_theta)
    new_cache = []
    for i, (block, kv) in enumerate(zip(net.layers, cache)):
        h = L.rms_norm(x, block.ln1)
        y, kv = L.cached_attention(block.attn, h, t, kv, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.hd, cfg.rope_theta,
                                   t_host=t_host, rope=rope,
                                   window=cfg.layer_window(i),
                                   name=f"L{i}.attn")
        x = x + y
        x = x + block.ffn(L.rms_norm(x, block.ln2), None, f"L{i}")[0]
        new_cache.append(kv)
    return _unembed(net, x), new_cache


@torch.no_grad()
def prefill(net: LM, tokens: torch.Tensor, max_len: int,
            patch_embeds: Optional[torch.Tensor] = None):
    """Run the whole prompt (B, S), behind its visual prefix when
    ``patch_embeds`` are given, and build a decode cache of ``max_len``
    positions. Returns (logits (B, S_total, V), cache, t = S_total - 1). A
    local layer whose ring is shorter than the prompt keeps the last S_buf
    positions, position p at slot p mod S_buf."""
    cfg = net.cfg
    x = _embed_inputs(net, tokens, patch_embeds)
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(f"prefill: a {S}-token prompt does not fit "
                         f"max_len {max_len}")
    pos_b = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    masks = _masks(cfg, pos_b)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    for i, (block, (K, V)) in enumerate(zip(net.layers, cache)):
        h = L.rms_norm(x, block.ln1)
        y, (k, v) = L.attention(block.attn, h, pos_b,
                                masks[cfg.layer_window(i)], cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd, cfg.rope_theta,
                                name=f"L{i}.attn")
        x = x + y
        x = x + block.ffn(L.rms_norm(x, block.ln2), None, f"L{i}")[0]
        s_buf = K.shape[1]
        if s_buf >= S:
            K[:, :S] = k
            V[:, :S] = v
        else:  # the ring: the last s_buf positions, p at slot p % s_buf
            roll = (S - s_buf) % s_buf
            K.copy_(torch.roll(k[:, S - s_buf:], roll, dims=1))
            V.copy_(torch.roll(v[:, S - s_buf:], roll, dims=1))
    return _unembed(net, x), cache, S - 1
