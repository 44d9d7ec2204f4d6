"""The dense decoder-only LM (gemma-2b's family): training and decoding.

Counterpart of the dense path of ``repro.models.transformer``: ``LMConfig``,
``init_lm``, the block, ``forward`` and ``loss_fn``, and for serving
``cache_buf_len``, ``init_cache``, ``decode_step`` and ``prefill``. The
reference scans its stacked blocks under one layer tag, ``"L"``; the port
loops an ``nn.ModuleList`` and names every block's layers under that same
tag (``L.attn.q``, ``L.mlp.gate``, ...), so that rules such as ``L*.mlp.*``,
telemetry tags and the dither streams (``fold_in(key, name_salt(name))``,
the same key for every layer at a step, as in the reference) match. With
``cfg.remat`` each block runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` with ``nothing_saveable``): its forward runs
again in the backward, its residual encodes included; the rerun's context
is marked ``recompute``, so each block's memory telemetry is recorded once
a step, by the first run.

Parameters (``LM.named_parameters()``): ``embed.table`` (V, d),
``layers.{i}.attn.{wq,wk,wv,wo}``, ``layers.{i}.mlp.{w_gate,w_up,w_down}``,
``layers.{i}.ln1``, ``layers.{i}.ln2``, ``head.ln_f``; dense weights (in,
out), as the reference's (``repro_torch.convert.lm_params_from_jax`` maps
its stacked tree onto them).

Decoding runs the blocks one by one with no dither context and no
autograd, each layer with its own cache: dense (K, V) buffers (B, S_buf,
KV, hd) or a paged cache (``repro_torch.serve.kvcache``). The cache
dtype is the model's.

The block is gemma's: a GeGLU MLP, no sliding window and no logit
soft-cap, the lm_head tied to the embedding. Not ported yet: the
reference's other ``LMConfig`` settings (``act``, ``tie_embeddings``,
``window``, ``softcap``, ``moe``, ``vlm_patches``) with the archs that set
them (ROADMAP.md section 1, item 6; ``repro_torch.configs`` refuses those
archs), and with ``window`` the sliding-window ring buffers; the cache
specs of the dry run (item 9).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.policy import DitherCtx
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

ZOO_TODO = "ROADMAP.md section 1, item 6 (the LM zoo)"
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
    rope_theta: float = 10_000.0
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True  # activation checkpointing per block in training

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def param_count(self) -> int:
        """Total parameters: the blocks, the tied embedding and ln_f."""
        d, f, V, hd = self.d_model, self.d_ff, self.vocab, self.hd
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        per_layer = attn + 3 * d * f + 2 * d
        return self.n_layers * per_layer + V * d + d


class Block(nn.Module):
    """One pre-norm block: x + attn(rms(x)), then + mlp(rms(.))."""

    def __init__(self, cfg: LMConfig, ini: L.Init):
        super().__init__()
        self.cfg = cfg
        self.attn = L.init_attention(ini, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.hd)
        self.mlp = L.init_mlp(ini, cfg.d_model, cfg.d_ff)
        self.ln1 = ini.ones(cfg.d_model)
        self.ln2 = ini.ones(cfg.d_model)

    def forward(self, x: torch.Tensor, pos_b: torch.Tensor,
                mask: torch.Tensor, ctx: Optional[DitherCtx]) -> torch.Tensor:
        cfg = self.cfg
        h = L.rms_norm(x, self.ln1)
        y, _ = L.attention(self.attn, h, pos_b, mask, cfg.n_heads,
                           cfg.n_kv_heads, cfg.hd, cfg.rope_theta, ctx=ctx,
                           name=f"{LAYER_TAG}.attn")
        x = x + y
        h = L.rms_norm(x, self.ln2)
        return x + L.mlp(self.mlp, h, ctx=ctx, name=f"{LAYER_TAG}.mlp")


class LM(nn.Module):
    """The decoder: ``embed``, ``layers`` (a ModuleList of blocks) and
    ``head`` (the final norm); the unembedding is the tied table."""

    def __init__(self, cfg: LMConfig, ini: L.Init):
        super().__init__()
        self.cfg = cfg
        self.embed = L.init_embedding(ini, cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(Block(cfg, ini)
                                    for _ in range(cfg.n_layers))
        self.head = nn.ParameterDict({"ln_f": ini.ones(cfg.d_model)})


def init_lm(cfg: LMConfig, *, seed: int = 0,
            device: Optional[torch.device] = None) -> LM:
    """A model of ``cfg`` with parameters drawn on ``device`` (CUDA unless
    named) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, L.Init(gen, dev, cfg.dtype))


def _embed_inputs(net: LM, tokens: torch.Tensor) -> torch.Tensor:
    x = L.embed(net.embed["table"], tokens)
    if net.cfg.embed_scale:
        x = x * L.embed_scale(net.cfg.d_model, x.dtype)
    return x


def _rerun_marked(block):
    """``block`` for ``torch.utils.checkpoint``: its second call, the rerun
    in the backward, gets its context marked ``recompute``."""
    calls = []

    def run(x, pos_b, mask, ctx):
        if calls and ctx is not None:
            ctx = dataclasses.replace(ctx, recompute=True)
        calls.append(None)
        return block(x, pos_b, mask, ctx)
    return run


def forward(net: LM, tokens: torch.Tensor, *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in the model's dtype."""
    cfg = net.cfg
    x = _embed_inputs(net, tokens)
    B, S = tokens.shape
    pos_b = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    mask = L.attention_mask(pos_b, pos_b)
    for block in net.layers:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_rerun_marked(block), x, pos_b, mask, ctx,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, pos_b, mask, ctx)
    x = L.rms_norm(x, net.head["ln_f"])
    return L.unembed(net.embed["table"], x, ctx=ctx)


def loss_fn(net: LM, batch: Dict[str, torch.Tensor], *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """Next-token cross-entropy in f32, the mean over every position."""
    logits = forward(net, batch["tokens"], ctx=ctx).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"]
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.sum(nll) / math.prod(labels.shape)


# ---------------------------------------------------------------------------
# decode (serving): per-layer caches, no dither context
# ---------------------------------------------------------------------------

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def cache_buf_len(cfg: LMConfig, i: int, max_len: int) -> int:
    """Buffer length of layer ``i``'s cache: ``max_len`` (every dense layer
    is global; windowed layers come with item 6)."""
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
    caches are written in place."""
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
                                   name=f"L{i}.attn")
        x = x + y
        x = x + L.mlp(block.mlp, L.rms_norm(x, block.ln2),
                      name=f"L{i}.mlp")
        new_cache.append(kv)
    x = L.rms_norm(x, net.head["ln_f"])
    return L.unembed(net.embed["table"], x), new_cache


@torch.no_grad()
def prefill(net: LM, tokens: torch.Tensor, max_len: int):
    """Run the whole prompt (B, S) and build a decode cache of ``max_len``
    positions. Returns (logits (B, S, V), cache, t = S - 1)."""
    cfg = net.cfg
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prefill: a {S}-token prompt does not fit "
                         f"max_len {max_len}")
    x = _embed_inputs(net, tokens)
    pos_b = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    mask = L.attention_mask(pos_b, pos_b)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    for i, (block, (K, V)) in enumerate(zip(net.layers, cache)):
        h = L.rms_norm(x, block.ln1)
        y, (k, v) = L.attention(block.attn, h, pos_b, mask, cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd, cfg.rope_theta,
                                name=f"L{i}.attn")
        x = x + y
        x = x + L.mlp(block.mlp, L.rms_norm(x, block.ln2),
                      name=f"L{i}.mlp")
        K[:, :S] = k
        V[:, :S] = v
    x = L.rms_norm(x, net.head["ln_f"])
    return L.unembed(net.embed["table"], x), cache, S - 1
