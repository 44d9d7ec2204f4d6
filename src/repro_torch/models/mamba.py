"""Mamba-2 (state-space duality, SSD) and the SSM language model
(mamba2-370m), after Dao & Gu 2024 (arXiv:2405.21060).

Counterpart of ``repro.models.mamba``: ``SSMConfig``, ``SSMLMConfig``, the
mixer (its in and out projections dithered through
``repro_torch.core.dithered.dense``, the causal depthwise conv, the chunked
SSD scan and the gated RMSNorm), the O(1)-state decode step and the LM
(``init_ssm_lm``, ``forward``, ``loss_fn``, ``init_cache``,
``decode_step``, ``prefill``). The scan's einsums are plain
``torch.einsum``, as they are plain JAX in the reference; the state
recurrence stays exact (no dither).

The chunked scan (:func:`_ssd_chunked`) pads S up to a multiple of the
chunk Q (dt = 0 there: decay 1 and no state contribution), keeps the heads
factored as (groups, heads a group) so that B and C are never repeated to
the H heads, and runs the cross-chunk recurrence as a loop over the nc
chunks. One difference from the reference, which changes no forward value:
the within-chunk decay L[i, j] = exp(cum_i - cum_j) is computed as
``exp(where(i >= j, cum_i - cum_j, -inf))``. The reference takes
``where(i >= j, exp(cum_i - cum_j), 0)``, whose masked entries (i < j)
overflow to inf once a chunk's summed decay passes ~88 (mamba2-370m's and
hymba-1.5b's widths at chunk 256), and the where's gradient then multiplies
a zero cotangent by inf: NaN. Both give the same L; the port's gradient
equals the reference's wherever that one is finite, and stays finite where
it is not.

The LM's blocks are pre-norm residual mixers, x + mixer(rms(x)), looped
over an ``nn.ModuleList`` under one dither tag, ``L`` (``L.ssm.in``,
``L.ssm.out``), as the reference's scan; decoding names them per layer
(``L{i}.ssm.*``). With ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (mamba2-370m's config turns it off, as the
reference's). Prefill runs the prompt token by token through the decode
state, as the reference does, so that serving's numbers are the decode
loop's.

Parameters (``SSMLM.named_parameters()``): ``embed.table`` (V, d),
``layers.{i}.mixer.{in_proj,conv_w,conv_b,A_log,dt_bias,D,norm,out_proj}``
(conv_w laid out (d_conv, conv_dim) as the reference's), ``layers.{i}.ln``,
``head.ln_f``; the unembedding is tied to the table.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.dithered import dense
from repro_torch.core.policy import DitherCtx
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import _rerun_marked

LAYER_TAG = "L"  # the reference's scan tag


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int  # expand * d_model
    head_dim: int  # P
    d_state: int  # N
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    # dtype of the within-chunk einsums' operands (f32 accumulation)
    intra_dtype: str = "f32"

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def d_in_proj(self) -> int:
        return (2 * self.d_inner + 2 * self.n_groups * self.d_state
                + self.n_heads)


def init_mamba_mixer(ini: L.Init, cfg: SSMConfig) -> nn.ParameterDict:
    """The mixer's parameters, drawn as the reference's: A = -exp(A_log)
    with A_log = log(linspace(1, 16, H)); the dt bias puts softplus(dt) in
    [dt_min, dt_max] (log-uniform)."""
    H = cfg.n_heads
    p = nn.ParameterDict({
        "in_proj": ini.normal(cfg.d_model, cfg.d_in_proj, fan_in=cfg.d_model),
        "conv_w": ini.normal(cfg.d_conv, cfg.conv_dim,
                             stddev=1.0 / np.sqrt(cfg.d_conv)),
        "conv_b": ini.zeros(cfg.conv_dim),
        "A_log": ini.const(torch.log(torch.linspace(1.0, 16.0, H)))})
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt = torch.exp(ini.uniform(H) * (hi - lo) + lo)
    p["dt_bias"] = ini.const(dt + torch.log(-torch.expm1(-dt)))
    p["D"] = ini.zeros(H)
    p["norm"] = ini.ones(cfg.d_inner)
    p["out_proj"] = ini.normal(cfg.d_inner, cfg.d_model, fan_in=cfg.d_inner)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, C), w (K, C) -> (B, S, C): channel c
    at s sums x[s - K + 1 + k, c] w[k, c] over k (zeros left of 0)."""
    K, C = w.shape
    xt = F.pad(x.transpose(1, 2), (K - 1, 0))
    y = F.conv1d(xt, w.t()[:, None, :].to(x.dtype), groups=C)
    return y.transpose(1, 2) + b


def _pad_seq(a: torch.Tensor, pad: int) -> torch.Tensor:
    """a (B, S, ...) with ``pad`` zero rows appended along S."""
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])], 1)


def _ssd_chunked(x, dt, A, Bm, Cm, cfg: SSMConfig,
                 h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x (B, S, H, P), dt (B, S, H) f32, A (H,) f32, Bm and Cm (B, S, G, N).
    Returns (y (B, S, H, P) f32, the final state (B, H, N, P) f32).
    """
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.chunk, S)
    S_orig = S
    if S % Q != 0:  # dt = 0 in the tail: decay 1, no state contribution
        pad = Q - S % Q
        x, dt, Bm, Cm = (_pad_seq(a, pad) for a in (x, dt, Bm, Cm))
        S = S + pad
    nc = S // Q
    rep = H // G
    f32 = torch.float32
    op = torch.bfloat16 if cfg.intra_dtype == "bf16" else f32

    xc = x.reshape(Bsz, nc, Q, G, rep, Pd)
    dtc = dt.reshape(Bsz, nc, Q, G, rep)
    Bg = Bm.reshape(Bsz, nc, Q, G, N)
    Cg = Cm.reshape(Bsz, nc, Q, G, N)

    dA = dtc * A.reshape(G, rep)  # (B, nc, Q, G, rep), negative
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay

    # within a chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, 0 above; the
    # exponent is masked before the exp, so no masked entry overflows
    diff = cum[:, :, :, None] - cum[:, :, None]  # (B, nc, Q, Q, G, rep)
    above = torch.ones(Q, Q, dtype=torch.bool, device=x.device).triu(1)
    Lmat = torch.exp(diff.masked_fill(above[:, :, None, None], -math.inf))
    scores = torch.einsum("bcign,bcjgn->bcijg", Cg.to(op), Bg.to(op)).to(f32)
    M = scores[..., None] * Lmat * dtc[:, :, None]
    y_intra = torch.einsum("bcijgr,bcjgrp->bcigrp", M.to(op),
                           xc.to(op)).to(f32)

    # each chunk's state
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)  # (B, nc, Q, G, rep)
    states = torch.einsum("bcjgr,bcjgn,bcjgrp->bcgrnp", decay_to_end * dtc,
                          Bg.to(f32), xc.to(f32))

    # the recurrence across chunks
    chunk_decay = torch.exp(torch.sum(dA, dim=2))  # (B, nc, G, rep)
    h = (torch.zeros(Bsz, G, rep, N, Pd, dtype=f32, device=x.device)
         if h0 is None else h0.reshape(Bsz, G, rep, N, Pd))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, 1)  # (B, nc, G, rep, N, P)

    # what earlier chunks contribute: C grouped, the per-head decay on the
    # output
    y_inter = torch.einsum("bcign,bcgrnp->bcigrp", Cg.to(op),
                           h_prev.to(op)).to(f32)
    y_inter = y_inter * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    return y[:, :S_orig], h.reshape(Bsz, H, N, Pd)


def _split_in(zxbcdt: torch.Tensor, cfg: SSMConfig):
    """(z, x, B, C, dt) of the in-projection's output."""
    GN = cfg.n_groups * cfg.d_state
    return torch.split(zxbcdt, [cfg.d_inner, cfg.d_inner, GN, GN,
                                cfg.n_heads], dim=-1)


def _dt_and_A(p: nn.ParameterDict, dt: torch.Tensor):
    """(softplus(dt + dt_bias), A = -exp(A_log)), both f32."""
    f32 = torch.float32
    return (F.softplus(dt.to(f32) + p["dt_bias"].to(f32)),
            -torch.exp(p["A_log"].to(f32)))


def mamba_mixer(p: nn.ParameterDict, x: torch.Tensor, cfg: SSMConfig, *,
                ctx: Optional[DitherCtx] = None, name: str = "ssm"
                ) -> torch.Tensor:
    """The Mamba-2 mixer for training and the forward. x (B, S, d_model);
    the dithered products ``{name}.in`` and ``{name}.out``."""
    B, S, _ = x.shape
    H, Pd, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    z, xs, Bm, Cm, dt = _split_in(
        dense(x, p["in_proj"], ctx=ctx, name=f"{name}.in"), cfg)
    conv_out = F.silu(_causal_conv(torch.cat([xs, Bm, Cm], -1), p["conv_w"],
                                   p["conv_b"]))
    xs, Bm, Cm = torch.split(conv_out, [cfg.d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, Pd)
    dt, A = _dt_and_A(p, dt)
    y, _ = _ssd_chunked(xs, dt, A, Bm.reshape(B, S, G, N),
                        Cm.reshape(B, S, G, N), cfg)
    y = y + p["D"].to(torch.float32)[None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(B, S, cfg.d_inner).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm"])
    return dense(y, p["out_proj"], ctx=ctx, name=f"{name}.out")


class MambaCache:
    """A layer's decode state: {"conv": the last d_conv - 1 inputs of the
    conv (B, d_conv - 1, conv_dim) in the model's dtype, "state": the SSM
    state (B, H, N, P) f32}."""

    @staticmethod
    def init(cfg: SSMConfig, batch: int, dtype: torch.dtype,
             device=None) -> Dict[str, torch.Tensor]:
        return {"conv": torch.zeros(batch, cfg.d_conv - 1, cfg.conv_dim,
                                    dtype=dtype, device=device),
                "state": torch.zeros(batch, cfg.n_heads, cfg.d_state,
                                     cfg.head_dim, dtype=torch.float32,
                                     device=device)}


def mamba_decode_step(p: nn.ParameterDict, x: torch.Tensor, cache,
                      cfg: SSMConfig, *, name: str = "ssm"):
    """One token through the mixer, no dither context. x (B, 1, d_model).
    Returns (y (B, 1, d_model), the new cache)."""
    B = x.shape[0]
    H, Pd, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    f32 = torch.float32
    conv_state, h = cache["conv"], cache["state"]
    z, xs, Bm, Cm, dt = _split_in(dense(x[:, 0], p["in_proj"],
                                        name=f"{name}.in"), cfg)
    window = torch.cat([conv_state, torch.cat([xs, Bm, Cm], -1)[:, None]], 1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32), p["conv_w"].to(f32))
    conv_out = F.silu(conv_out + p["conv_b"].to(f32))
    new_conv = window[:, 1:].to(conv_state.dtype)

    xs, Bm, Cm = torch.split(conv_out, [cfg.d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, Pd)
    Bm = torch.repeat_interleave(Bm.reshape(B, G, N), H // G, dim=1)
    Cm = torch.repeat_interleave(Cm.reshape(B, G, N), H // G, dim=1)
    dt, A = _dt_and_A(p, dt)  # (B, H)
    decay = torch.exp(dt * A)
    h_new = h * decay[:, :, None, None] + (
        dt[:, :, None, None] * Bm[..., None] * xs[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", Cm, h_new)
    y = y + p["D"].to(f32)[None, :, None] * xs
    y = y.reshape(B, cfg.d_inner).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm"])
    y = dense(y, p["out_proj"], name=f"{name}.out")
    return y[:, None, :], {"conv": new_conv, "state": h_new}


# ---------------------------------------------------------------------------
# the SSM language model (mamba2-370m)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SSMLMConfig:
    name: str
    n_layers: int
    vocab: int
    ssm: SSMConfig
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = True
    remat: bool = True

    @property
    def d_model(self) -> int:
        return self.ssm.d_model

    @property
    def param_count(self) -> int:
        c = self.ssm
        per_layer = (c.d_model * c.d_in_proj + c.d_conv * c.conv_dim
                     + c.d_inner * c.d_model + 3 * c.n_heads + 2 * c.d_inner
                     + c.d_model)
        emb = self.vocab * c.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb

    @property
    def active_param_count(self) -> int:
        return self.param_count


class SSMBlock(nn.Module):
    """x + mixer(rms(x))."""

    def __init__(self, cfg: SSMLMConfig, ini: L.Init):
        super().__init__()
        self.cfg = cfg
        self.mixer = init_mamba_mixer(ini, cfg.ssm)
        self.ln = ini.ones(cfg.d_model)

    def forward(self, x: torch.Tensor, ctx: Optional[DitherCtx]):
        return x + mamba_mixer(self.mixer, L.rms_norm(x, self.ln),
                               self.cfg.ssm, ctx=ctx, name=f"{LAYER_TAG}.ssm")


class SSMLM(nn.Module):
    def __init__(self, cfg: SSMLMConfig, ini: L.Init):
        super().__init__()
        self.cfg = cfg
        self.embed = L.init_embedding(ini, cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(SSMBlock(cfg, ini)
                                    for _ in range(cfg.n_layers))
        self.head = nn.ParameterDict({"ln_f": ini.ones(cfg.d_model)})


def init_ssm_lm(cfg: SSMLMConfig, *, seed: int = 0,
                device: Optional[torch.device] = None) -> SSMLM:
    """A model of ``cfg`` drawn on ``device`` (CUDA unless named) from a
    generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return SSMLM(cfg, L.Init(gen, dev, cfg.dtype))


def run_blocks(blocks, remat: bool, x: torch.Tensor, *args):
    """x through ``blocks`` in turn, each called as block(x, *args) with
    the dither context last; under ``torch.utils.checkpoint`` with
    ``remat`` while gradients are recorded (the rerun's context marked
    ``recompute``)."""
    for block in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_rerun_marked(block), x, *args,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, *args)
    return x


def forward(net: SSMLM, tokens: torch.Tensor, *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in the model's dtype."""
    x = run_blocks(net.layers, net.cfg.remat, L.embed(net.embed["table"],
                                                      tokens), ctx)
    x = L.rms_norm(x, net.head["ln_f"])
    return L.unembed(net.embed["table"], x, ctx=ctx)


def nll_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy in f32, the mean over every position."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.sum(nll) / math.prod(labels.shape)


def loss_fn(net: SSMLM, batch: Dict[str, torch.Tensor], *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    return nll_mean(forward(net, batch["tokens"], ctx=ctx), batch["labels"])


def init_cache(cfg: SSMLMConfig, batch: int, max_len: int, *,
               device: Optional[torch.device] = None) -> List[Dict]:
    """Zero decode states, one a layer (O(1) in ``max_len``)."""
    del max_len
    dev = resolve_device(device)
    return [MambaCache.init(cfg.ssm, batch, cfg.dtype, dev)
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def decode_step(net: SSMLM, cache, token: torch.Tensor, t, *, t_host=None):
    """One token (B, 1) through every layer's decode state; t is unused
    (the state carries the position). Returns (logits (B, 1, V), the new
    cache)."""
    del t, t_host
    x = L.embed(net.embed["table"], token)
    new_cache = []
    for i, (block, c) in enumerate(zip(net.layers, cache)):
        y, c = mamba_decode_step(block.mixer, L.rms_norm(x, block.ln), c,
                                 net.cfg.ssm, name=f"L{i}.ssm")
        x = x + y
        new_cache.append(c)
    x = L.rms_norm(x, net.head["ln_f"])
    return L.unembed(net.embed["table"], x), new_cache


@torch.no_grad()
def prefill(net: SSMLM, tokens: torch.Tensor, max_len: int):
    """The prompt (B, S) token by token through the decode state. Returns
    (logits (B, S, V), cache, t = S - 1)."""
    B, S = tokens.shape
    cache = init_cache(net.cfg, B, max_len, device=tokens.device)
    logits = []
    for s in range(S):
        lg, cache = decode_step(net, cache, tokens[:, s:s + 1], 0)
        logits.append(lg[:, 0])
    return torch.stack(logits, 1), cache, S - 1
