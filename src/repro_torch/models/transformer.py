"""The dense decoder-only LM (gemma-2b's family) for training.

Counterpart of the dense path of ``repro.models.transformer``: ``LMConfig``,
``init_lm``, the block, ``forward`` and ``loss_fn``. The reference scans its
stacked blocks under one layer tag, ``"L"``; the port loops an
``nn.ModuleList`` and names every block's layers under that same tag
(``L.attn.q``, ``L.mlp.gate``, ...), so that rules such as ``L*.mlp.*``,
telemetry tags and the dither streams (``fold_in(key, name_salt(name))``,
the same key for every layer at a step, as in the reference) match. With
``cfg.remat`` each block runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` with ``nothing_saveable``): its forward runs
again in the backward, its residual encodes included.

Parameters (``LM.named_parameters()``): ``embed.table`` (V, d),
``layers.{i}.attn.{wq,wk,wv,wo}``, ``layers.{i}.mlp.{w_gate,w_up,w_down}``,
``layers.{i}.ln1``, ``layers.{i}.ln2``, ``head.ln_f``; dense weights (in,
out), as the reference's (``repro_torch.convert.lm_params_from_jax`` maps
its stacked tree onto them).

The block is gemma's: a GeGLU MLP, no sliding window and no logit
soft-cap, the lm_head tied to the embedding. Not ported yet: decode, prefill
and the KV cache (with serving, ROADMAP.md section 1, item 8); the
reference's other ``LMConfig`` settings (``act``, ``tie_embeddings``,
``window``, ``softcap``, ``moe``, ``vlm_patches``) with the archs that set
them (item 6; ``repro_torch.configs`` refuses those archs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

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
        x = x + L.attention(self.attn, h, pos_b, mask, cfg.n_heads,
                            cfg.n_kv_heads, cfg.hd, cfg.rope_theta, ctx=ctx,
                            name=f"{LAYER_TAG}.attn")
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
            x = checkpoint(block, x, pos_b, mask, ctx, use_reentrant=False,
                           preserve_rng_state=False)
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
