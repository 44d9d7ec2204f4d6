"""The layers of the dense decoder: initialisation, RMSNorm, rotary
embedding, grouped-query attention, the GeGLU MLP and the tied embedding.

Counterpart of the parts of ``repro.models.layers`` that the dense LM calls.
Every weight-bearing product goes through ``repro_torch.core.dithered.dense``,
so dithered backprop covers each projection and the tied unembedding. The
attention itself (scores, softmax, the probability-value product) is plain
PyTorch, as it is plain JAX in the reference. Layouts are the reference's:
dense weights (in, out), activations (B, S, ...), heads (B, S, H, D).

Not ported yet (ROADMAP.md section 1, item 6): layer norm, the other MLP
kinds, biases on q/k/v, sliding windows and soft-capping, cross-attention,
and the decode-time cache helpers.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dithered import dense
from repro_torch.core.policy import DitherCtx


class Init:
    """Draws parameters on ``device`` from an explicit ``torch.Generator``:
    normal(0, 1 / sqrt(fan_in)) (fan_in: the first dimension unless named)
    or normal(0, stddev), drawn in f32 and cast to ``dtype``, as the
    reference's ``Init.normal``; ones for the norm scales."""

    def __init__(self, generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype):
        self.generator, self.device, self.dtype = generator, device, dtype

    def normal(self, *shape: int, fan_in: Optional[int] = None,
               stddev: Optional[float] = None) -> nn.Parameter:
        if stddev is None:
            stddev = 1.0 / np.sqrt(max(fan_in if fan_in is not None
                                       else shape[0], 1))
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return nn.Parameter(x.mul_(float(np.float32(stddev))).to(self.dtype))

    def ones(self, *shape: int) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, device=self.device,
                                       dtype=self.dtype))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """x / rms(x) * scale over the last axis, in f32, cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of x (..., S, H, D) at ``positions`` (broadcastable
    to (..., S)): the two halves of D rotated by position x frequency, in
    f32, cast back."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta).to(x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    ang = ang[..., None, :]  # the head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """(..., Sq, Sk) causal mask from position indices: key <= query."""
    return k_pos[..., None, :] <= q_pos[..., :, None]


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped-query attention. q (B, Sq, H, D); k, v (B, Sk, KV, D) with KV
    dividing H: each group of H / KV query heads attends to its KV head,
    which is never repeated. Scores in f32 times 1 / sqrt(D), masked with
    -1e30, softmax, probabilities cast to q's dtype before the value
    product. mask: (B, Sq, Sk) or (Sq, Sk)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    logits = logits * float(np.float32(1.0 / np.sqrt(D)))
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        logits = logits.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def init_attention(ini: Init, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int) -> nn.ParameterDict:
    """wq (d, H hd), wk and wv (d, KV hd), wo (H hd, d)."""
    d = d_model
    return nn.ParameterDict({
        "wq": ini.normal(d, n_heads * head_dim, fan_in=d),
        "wk": ini.normal(d, n_kv_heads * head_dim, fan_in=d),
        "wv": ini.normal(d, n_kv_heads * head_dim, fan_in=d),
        "wo": ini.normal(n_heads * head_dim, d, fan_in=n_heads * head_dim)})


def attention(p: nn.ParameterDict, h: torch.Tensor, pos_b: torch.Tensor,
              mask: torch.Tensor, n_heads: int, n_kv_heads: int,
              head_dim: int, rope_theta: float, *,
              ctx: Optional[DitherCtx] = None, name: str = "attn"
              ) -> torch.Tensor:
    """Causal self-attention of h (B, S, d) with a precomputed mask: the
    dithered projections ``{name}.q``, ``.k``, ``.v`` and ``.o`` (the
    reference's ``transformer._attend_with_mask``)."""
    B, S = h.shape[:2]
    q = dense(h, p["wq"], ctx=ctx, name=f"{name}.q")
    k = dense(h, p["wk"], ctx=ctx, name=f"{name}.k")
    v = dense(h, p["wv"], ctx=ctx, name=f"{name}.v")
    q = apply_rope(q.reshape(B, S, n_heads, head_dim), pos_b, rope_theta)
    k = apply_rope(k.reshape(B, S, n_kv_heads, head_dim), pos_b, rope_theta)
    v = v.reshape(B, S, n_kv_heads, head_dim)
    y = _sdpa(q, k, v, mask).reshape(B, S, n_heads * head_dim)
    return dense(y, p["wo"], ctx=ctx, name=f"{name}.o")


def init_mlp(ini: Init, d_model: int, d_ff: int) -> nn.ParameterDict:
    """The GeGLU MLP's w_gate and w_up (d, f) and w_down (f, d)."""
    return nn.ParameterDict({
        "w_gate": ini.normal(d_model, d_ff, fan_in=d_model),
        "w_up": ini.normal(d_model, d_ff, fan_in=d_model),
        "w_down": ini.normal(d_ff, d_model, fan_in=d_ff)})


def mlp(p: nn.ParameterDict, x: torch.Tensor, *,
        ctx: Optional[DitherCtx] = None, name: str = "mlp") -> torch.Tensor:
    """GeGLU: down(gelu(gate(x)) * up(x)), GELU in its tanh form (the
    default of ``jax.nn.gelu``)."""
    g = dense(x, p["w_gate"], ctx=ctx, name=f"{name}.gate")
    u = dense(x, p["w_up"], ctx=ctx, name=f"{name}.up")
    h = F.gelu(g, approximate="tanh") * u
    return dense(h, p["w_down"], ctx=ctx, name=f"{name}.down")


def init_embedding(ini: Init, vocab: int, d_model: int) -> nn.ParameterDict:
    return nn.ParameterDict({"table": ini.normal(vocab, d_model,
                                                 stddev=0.02)})


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)


def unembed(table: torch.Tensor, x: torch.Tensor, *,
            ctx: Optional[DitherCtx] = None, name: str = "lm_head"
            ) -> torch.Tensor:
    """Logits x . table^T through the dithered dense ``lm_head`` (the tied
    unembedding)."""
    return dense(x, table.t().to(x.dtype), ctx=ctx, name=name)


def embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype``: the factor the reference casts to
    the activations' dtype before the product."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))
