"""The layers of the LMs: initialisation, RMSNorm and layer norm, the
activations, rotary embedding (none at theta <= 0), grouped-query
attention (q/k/v biases, sliding windows) and cross-attention, the gated
(SwiGLU, GeGLU), squared-ReLU and GELU MLPs and the embedding.

Counterpart of the parts of ``repro.models.layers`` that the LMs call.
Every weight-bearing product goes through ``repro_torch.core.dithered.dense``,
so dithered backprop covers each projection and the tied unembedding. The
attention itself (scores, softmax, the probability-value product) is plain
PyTorch, as it is plain JAX in the reference. Layouts are the reference's:
dense weights (in, out), activations (B, S, ...), heads (B, S, H, D).

Decode (serving): :func:`cached_attention` writes one token a slot into a
dense (B, S_buf, KV, hd) buffer, under one shared position or per-slot
positions (t < 0: an inactive slot, whose write is dropped and whose row is
all invalid), or into a paged cache (``repro_torch.serve.kvcache``), and
attends over the whole buffer. A windowed layer's buffer is a ring of
``min(window, max_len)`` slots (position p at slot p mod S_buf), or, with a
pinned prefix of P positions (hymba's meta tokens), P fixed slots followed
by a ring of S_buf - P: position p < P at slot p, a later one at P + (p -
P) mod (S_buf - P); the prefix stays attendable whatever the window.

Cross-attention (the encoder-decoder's, ``repro_torch.models.encdec``):
:func:`cross_attention` projects its keys and values from the encoder's
states, with no mask and no rotary embedding; at decode time
:func:`cross_attention_cached` reads them precomputed.

Not ported yet: soft-capping (no reference config sets it).
"""
from __future__ import annotations

import functools
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
    reference's ``Init.normal``; ones for the norm scales, zeros, and
    constants computed in f32 (``const``, the reference's ``Init.const``)."""

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

    def zeros(self, *shape: int) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, device=self.device,
                                        dtype=self.dtype))

    def const(self, value: torch.Tensor) -> nn.Parameter:
        """``value`` (drawn or computed in f32) cast to ``dtype``."""
        return nn.Parameter(value.to(device=self.device, dtype=self.dtype))

    def uniform(self, *shape: int) -> torch.Tensor:
        """An f32 draw in [0, 1) from the generator (not a parameter)."""
        return torch.rand(shape, generator=self.generator,
                          device=self.device, dtype=torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """x / rms(x) * scale over the last axis, in f32, cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * scale + bias over the last axis, in
    f32 (the population variance, the mean of the squared deviations, as
    ``jnp.var``), cast back to x's dtype."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


_ACTS = {
    "gelu": functools.partial(F.gelu, approximate="tanh"),  # jax.nn.gelu's
    "silu": F.silu,
    "relu": F.relu,
    "relu2": _relu2,
    "tanh": torch.tanh,
}


def act_fn(name: str):
    """The reference's activations by name; GELU in its tanh form (the
    default of ``jax.nn.gelu``), relu2 the squared ReLU."""
    return _ACTS[name]


def rope_freqs(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    """:func:`rope_freqs` on ``device``, copied there once: a copy from
    the host on every call would wait for the device's stream."""
    return rope_freqs(head_dim, theta).to(device)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0):
    """The rotation of :func:`apply_rope` at ``positions`` (..., S): f32
    (cos, sin) of the angles position x frequency, each (..., S, 1, D)
    with its halves laid out as [cos, cos] and [-sin, sin]; computed once
    for every head and layer that shares the positions. None at theta <= 0
    (no rotary embedding: absolute or learned positions)."""
    if theta <= 0:
        return None
    ang = positions[..., None].to(torch.float32) * _freqs_on(
        head_dim, theta, positions.device)
    ang = ang[..., None, :]  # the head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, *, table=None) -> torch.Tensor:
    """Rotary embedding of x (..., S, H, D) at ``positions`` (broadcastable
    to (..., S)): the halves (x1, x2) of D become (x1 cos - x2 sin, x2 cos
    + x1 sin), in f32, cast back. With the table's halves that is x cos +
    swap(x) sin, the same products and sums (a - b is a + (-b) exactly).
    ``table``: the positions' :func:`rope_table`, when the caller has
    it. theta <= 0 disables it: x is returned as it is (whisper)."""
    if theta <= 0:
        return x
    cos, sin = (rope_table(positions, x.shape[-1], theta) if table is None
                else table)
    xf = x.to(torch.float32)
    swapped = torch.roll(xf, x.shape[-1] // 2, dims=-1)  # (x2, x1)
    return (xf * cos + swapped * sin).to(x.dtype)


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                   valid_k: Optional[torch.Tensor] = None, *,
                   window: Optional[int] = None,
                   prefix_len: int = 0) -> torch.Tensor:
    """(..., Sq, Sk) causal mask from position indices: key <= query,
    within the last ``window`` positions (key > query - window) or among
    the first ``prefix_len`` (always attendable) when a window is given,
    and the key valid where ``valid_k`` (..., Sk) is given."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    m = kp <= qp
    if window is not None:
        in_window = kp > qp - window
        if prefix_len > 0:
            in_window = in_window | (kp < prefix_len)
        m = m & in_window
    if valid_k is not None:
        m = m & valid_k[..., None, :]
    return m


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


def decode_positions(t: torch.Tensor) -> torch.Tensor:
    """Rope and mask positions of one decode step from the cache index t: a
    0-d t (one position for the batch) -> (1,), per-slot t (B,) -> (B, 1),
    so that they broadcast against (B, 1, H, D) tokens."""
    return t[None] if t.dim() == 0 else t[:, None]


def ring_write_slot(t: torch.Tensor, s_buf: int, prefix: int = 0
                    ) -> torch.Tensor:
    """Buffer slot of absolute position t: slots [0, prefix) are pinned to
    the prefix, the rest is a ring of ``s_buf - prefix``; a negative t
    stays negative, a slot no write reaches."""
    return torch.where(t < prefix, t, prefix + (t - prefix) % (s_buf - prefix))


def ring_slot_positions(t: torch.Tensor, s_buf: int, prefix: int = 0):
    """(absolute position, valid) of every slot, (..., s_buf), given that
    the newest position written is t (...): a prefix slot i holds position
    i, valid once t >= i; a ring slot i holds t - ((r - i) mod ring), r the
    slot of t, valid once written (>= prefix) and not ahead of t."""
    slot = torch.arange(s_buf, device=t.device)
    ring = s_buf - prefix
    tt = t[..., None]
    rel = prefix + (tt - prefix) % ring  # the slot t was written to
    abs_ring = tt - ((rel - slot) % ring)
    in_prefix = slot < prefix
    pos = torch.where(in_prefix, slot, abs_ring)
    valid = torch.where(in_prefix, slot <= tt,
                        (abs_ring >= prefix) & (abs_ring <= tt))
    return pos, valid


def init_attention(ini: Init, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qkv_bias: bool = False) -> nn.ParameterDict:
    """wq (d, H hd), wk and wv (d, KV hd), wo (H hd, d); with ``qkv_bias``
    the zero biases bq (H hd), bk and bv (KV hd)."""
    d = d_model
    p = nn.ParameterDict({
        "wq": ini.normal(d, n_heads * head_dim, fan_in=d),
        "wk": ini.normal(d, n_kv_heads * head_dim, fan_in=d),
        "wv": ini.normal(d, n_kv_heads * head_dim, fan_in=d),
        "wo": ini.normal(n_heads * head_dim, d, fan_in=n_heads * head_dim)})
    if qkv_bias:
        p["bq"] = ini.zeros(n_heads * head_dim)
        p["bk"] = ini.zeros(n_kv_heads * head_dim)
        p["bv"] = ini.zeros(n_kv_heads * head_dim)
    return p


def _qkv(p: nn.ParameterDict, h: torch.Tensor, ctx, name: str):
    """The q, k and v projections of h, each bias (when the layer has one)
    added outside the dithered product, as in the reference."""
    return tuple(dense(h, p[f"w{c}"], p[f"b{c}"] if f"b{c}" in p else None,
                       ctx=ctx, name=f"{name}.{c}") for c in "qkv")


def attention(p: nn.ParameterDict, h: torch.Tensor, pos_b: torch.Tensor,
              mask: torch.Tensor, n_heads: int, n_kv_heads: int,
              head_dim: int, rope_theta: float, *,
              ctx: Optional[DitherCtx] = None, name: str = "attn"):
    """Causal self-attention of h (B, S, d) with a precomputed mask: the
    dithered projections ``{name}.q``, ``.k``, ``.v`` and ``.o`` (the
    reference's ``transformer._attend_with_mask``). Returns (y, (k, v)),
    k and v the roped keys and values (B, S, KV, hd) that prefill caches."""
    B, S = h.shape[:2]
    q, k, v = _qkv(p, h, ctx, name)
    q = apply_rope(q.reshape(B, S, n_heads, head_dim), pos_b, rope_theta)
    k = apply_rope(k.reshape(B, S, n_kv_heads, head_dim), pos_b, rope_theta)
    v = v.reshape(B, S, n_kv_heads, head_dim)
    y = _sdpa(q, k, v, mask).reshape(B, S, n_heads * head_dim)
    return dense(y, p["wo"], ctx=ctx, name=f"{name}.o"), (k, v)


def cross_attention(p: nn.ParameterDict, h: torch.Tensor,
                    x_kv: torch.Tensor, n_heads: int, n_kv_heads: int,
                    head_dim: int, *, ctx: Optional[DitherCtx] = None,
                    name: str = "xattn") -> torch.Tensor:
    """Cross-attention of h (B, S, d) over the encoder states x_kv (B, S_kv,
    d): the dithered projections ``{name}.q`` of h, ``{name}.k`` and
    ``.v`` of x_kv and ``.o``; no mask, no rotary embedding (the
    reference's ``attention`` with ``x_kv``)."""
    B, S = h.shape[:2]
    S_kv = x_kv.shape[1]
    q = dense(h, p["wq"], ctx=ctx, name=f"{name}.q")
    k = dense(x_kv, p["wk"], ctx=ctx, name=f"{name}.k")
    v = dense(x_kv, p["wv"], ctx=ctx, name=f"{name}.v")
    y = _sdpa(q.reshape(B, S, n_heads, head_dim),
              k.reshape(B, S_kv, n_kv_heads, head_dim),
              v.reshape(B, S_kv, n_kv_heads, head_dim), None)
    return dense(y.reshape(B, S, n_heads * head_dim), p["wo"], ctx=ctx,
                 name=f"{name}.o")


def cross_attention_cached(p: nn.ParameterDict, x: torch.Tensor, enc_kv,
                           n_heads: int, head_dim: int, *,
                           name: str = "xattn") -> torch.Tensor:
    """Decode-time cross-attention of x (B, 1, d) over precomputed encoder
    keys and values ``enc_kv`` = (K, V), each (B, S_kv, KV, hd), which it
    does not write; no dither context (serving has no backward)."""
    B, S = x.shape[:2]
    q = dense(x, p["wq"], name=f"{name}.q").reshape(B, S, n_heads, head_dim)
    K, V = enc_kv
    y = _sdpa(q, K.to(q.dtype), V.to(q.dtype), None)
    return dense(y.reshape(B, S, n_heads * head_dim), p["wo"],
                 name=f"{name}.o")


def _write_token(buf: torch.Tensor, new: torch.Tensor, write_at: torch.Tensor
                 ) -> torch.Tensor:
    """buf (B, S_buf, KV, hd) with row b's slot ``write_at[b]`` replaced by
    new[b] (B, 1, KV, hd); a slot outside [0, S_buf) writes nothing (the
    reference's scatter with ``mode="drop"``). A new tensor: no host
    sync, no in-place write."""
    hit = torch.arange(buf.shape[1], device=buf.device) == write_at[:, None]
    return torch.where(hit[:, :, None, None], new.to(buf.dtype), buf)


def cached_attention(p: nn.ParameterDict, x: torch.Tensor, t: torch.Tensor,
                     kv_cache, n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: float, *, rope, t_host=None,
                     window: Optional[int] = None, prefix: int = 0,
                     name: str = "attn"):
    """One decode step of causal self-attention for x (B, 1, d), the new
    token of each slot, at cache index t; returns (y (B, 1, d), new cache).
    The reference's ``attention`` with ``kv_cache`` and ``cache_index``:

    * ``kv_cache=(K, V)``, dense buffers (B, S_buf, KV, hd), and t 0-d: the
      batch writes slot t mod S_buf and attends over the slots written;
    * the same buffers and per-slot t (B,): slot b writes t[b] mod S_buf,
      or nothing where t[b] < 0 (an inactive slot, whose row is then all
      invalid: its softmax goes uniform and the caller drops its output);
    * a paged cache (``repro_torch.serve.kvcache.PagedKV``) and per-slot t:
      the cache writes, seals and decodes (``update_and_view``); ``t_host``
      is t on the host, which decides what seals without a device sync.

    The projections run with no dither context (serving has no backward).
    ``rope``: the rotary table of ``decode_positions(t)``, which every
    layer of a step shares (:func:`rope_table`; None at rope_theta <= 0,
    where no rotary embedding is applied). ``window``: a windowed
    layer's size, on dense buffers only (the ring of its last positions;
    the mask holds the window as well, as the reference's does);
    ``prefix``: the pinned positions ahead of its ring (S_buf = window +
    prefix), always attendable.
    """
    B = x.shape[0]
    positions = decode_positions(t)
    q, k, v = _qkv(p, x, None, name)
    q = q.reshape(B, 1, n_heads, head_dim)
    k = k.reshape(B, 1, n_kv_heads, head_dim)
    v = v.reshape(B, 1, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta, table=rope)
    k = apply_rope(k, positions, rope_theta, table=rope)
    if hasattr(kv_cache, "update_and_view"):
        K, V, k_pos, valid, out_cache = kv_cache.update_and_view(
            k, v, t, t_host=t_host)
        mask = valid[:, None, :]  # valid keys are never ahead of t
    else:
        K, V = kv_cache
        s_buf = K.shape[1]
        write_at = ring_write_slot(t, s_buf, prefix).expand(B)
        k_pos, valid = ring_slot_positions(t, s_buf, prefix)
        if t.dim() == 0:
            k_pos, valid = k_pos.expand(B, s_buf), valid.expand(B, s_buf)
        else:
            valid = valid & (t >= 0)[:, None]
        K, V = _write_token(K, k, write_at), _write_token(V, v, write_at)
        out_cache = (K, V)
        mask = attention_mask(t.expand(B)[:, None], k_pos, valid_k=valid,
                              window=window, prefix_len=prefix)
    y = _sdpa(q, K.to(q.dtype), V.to(q.dtype), mask)
    y = y.reshape(B, 1, n_heads * head_dim)
    return dense(y, p["wo"], name=f"{name}.o"), out_cache


GATED = ("swiglu", "geglu")  # the MLP kinds with a gate projection


def init_mlp(ini: Init, d_model: int, d_ff: int, kind: str
             ) -> nn.ParameterDict:
    """A gated MLP's (``swiglu``, ``geglu``) w_gate and w_up (d, f) and
    w_down (f, d); the other kinds (``relu2``, ``gelu``) have no gate."""
    p = nn.ParameterDict()
    if kind in GATED:
        p["w_gate"] = ini.normal(d_model, d_ff, fan_in=d_model)
    p["w_up"] = ini.normal(d_model, d_ff, fan_in=d_model)
    p["w_down"] = ini.normal(d_ff, d_model, fan_in=d_ff)
    return p


def mlp(p: nn.ParameterDict, x: torch.Tensor, kind: str, *,
        ctx: Optional[DitherCtx] = None, name: str = "mlp") -> torch.Tensor:
    """down(act(gate(x)) * up(x)) for the gated kinds (SiLU for
    ``swiglu``, GELU in its tanh form for ``geglu``), down(act(up(x)))
    for the others (``relu2``: the squared ReLU; ``gelu`` in its tanh
    form)."""
    if kind in GATED:
        g = dense(x, p["w_gate"], ctx=ctx, name=f"{name}.gate")
        u = dense(x, p["w_up"], ctx=ctx, name=f"{name}.up")
        h = act_fn("silu" if kind == "swiglu" else "gelu")(g) * u
    else:
        h = act_fn(kind)(dense(x, p["w_up"], ctx=ctx, name=f"{name}.up"))
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
    unembedding; an untied head is a plain ``dense`` of its own weight)."""
    return dense(x, table.t().to(x.dtype), ctx=ctx, name=name)


@functools.lru_cache(maxsize=None)
def embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype``: the factor the reference casts to
    the activations' dtype before the product."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))
