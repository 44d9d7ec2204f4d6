"""The Whisper-style encoder-decoder (whisper-small, arXiv:2212.04356):
training and decoding.

Counterpart of ``repro.models.encdec``: ``EncDecConfig``, ``init_encdec``,
``encode``, ``decode_train``, ``forward`` and ``loss_fn``, and for serving
``init_cache``, ``precompute_cross_kv``, ``decode_step`` and ``prefill``.
As in the reference the conv / mel frontend is a stub: the encoder takes
precomputed frame embeddings (B, n_frames, d_model), cast to the model's
dtype, with the sinusoidal positions added in that dtype. The encoder's
blocks are bidirectional pre-LN blocks (layer norm with a bias, attention
with no mask, a GELU MLP); the decoder's add a learned position table
(its index clipped at ``max_target - 1``), causal self-attention and
cross-attention over the encoder's output, whose keys and values are
dithered products of that output (their gradients are the only way the
loss reaches the encoder). No rotary embedding (rope theta 0). The
unembedding is tied to the token table (``lm_head``).

Every projection is dithered through ``repro_torch.core.dithered.dense``
under the reference's scan names, one dither stream a name for every block
of a stack: ``enc.attn.{q,k,v,o}``, ``enc.mlp.{up,down}``,
``dec.attn.*``, ``dec.xattn.*``, ``dec.mlp.*`` and ``lm_head``. With
``cfg.remat`` each block runs under ``torch.utils.checkpoint``
(``mamba.run_blocks``: the rerun's context is marked ``recompute``, as the
decoder LMs' blocks).

Parameters (``EncDec.named_parameters()``): ``enc.{i}.attn.{wq,wk,wv,wo}``,
``enc.{i}.mlp.{w_up,w_down}``, ``enc.{i}.{ln1_s,ln1_b,ln2_s,ln2_b}``, the
decoder's ``dec.{i}.*`` of the same names and ``dec.{i}.xattn.{wq,wk,wv,
wo}``, ``dec.{i}.{lnx_s,lnx_b}``; ``embed.table`` (V, d);
``head.dec_pos`` (max_target, d), ``head.{ln_enc_s,ln_enc_b,ln_dec_s,
ln_dec_b}``: the reference's tree with its stacks ``enc`` and ``dec``
split a block each (``repro_torch.convert.lm_params_from_jax``).

Serving: ``prefill`` runs the encoder once, computes each decoder layer's
cross keys and values once (``precompute_cross_kv``) and feeds the prompt
through ``decode_step`` token by token, as the reference does. The
serving engine refuses the family (each request needs its own encoder
features): ``repro_torch.serve.greedy_generate(model, net, prompt, n,
frames=...)`` serves it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.dithered import dense
from repro_torch.core.policy import DitherCtx
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.mamba import nll_mean, run_blocks
from repro_torch.models.transformer import _cache_index


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int  # a stack: the encoder's and the decoder's
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_frames: int = 1500  # encoder positions (the mel frontend's length)
    max_target: int = 448
    act: str = "gelu"
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @property
    def param_count(self) -> int:
        d, f = self.d_model, self.d_ff
        attn = 4 * d * d
        mlp = 2 * d * f
        enc_layer = attn + mlp + 4 * d
        dec_layer = 2 * attn + mlp + 6 * d
        return (self.n_layers * (enc_layer + dec_layer) + self.vocab * d
                + self.max_target * d + 2 * d)

    @property
    def active_param_count(self) -> int:
        return self.param_count


def _sinusoid(n_pos: int, d: int) -> np.ndarray:
    """The encoder's sinusoidal positions (n_pos, d), f32: sin and cos
    halves, the reference's table to the bit."""
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = 1.0 / (10000 ** (dim / max(d // 2 - 1, 1)))
    ang = pos * inv
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _sinusoid_on(n_pos: int, d: int, device: torch.device) -> torch.Tensor:
    """:func:`_sinusoid` on ``device``, copied there once."""
    return torch.from_numpy(_sinusoid(n_pos, d)).to(device)


def _ln(x: torch.Tensor, owner: nn.Module, name: str) -> torch.Tensor:
    """Layer norm by the scale and bias ``{name}_s`` / ``{name}_b`` of a
    block or of the head."""
    return L.layer_norm(x, getattr(owner, f"{name}_s"),
                        getattr(owner, f"{name}_b"))


class EncDecBlock(nn.Module):
    """An encoder block, x + attn(ln1(x)) then + mlp(ln2(.)), or, with
    ``cross``, a decoder block, which adds + xattn(lnx(.), enc_out) between
    the two."""

    def __init__(self, cfg: EncDecConfig, ini: L.Init, cross: bool):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.attn = L.init_attention(ini, d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd)
        names = ("ln1", "ln2")
        if cross:
            self.xattn = L.init_attention(ini, d, cfg.n_heads,
                                          cfg.n_kv_heads, cfg.hd)
            names += ("lnx",)
        self.mlp = L.init_mlp(ini, d, cfg.d_ff, cfg.act)
        for n in names:
            setattr(self, f"{n}_s", ini.ones(d))
            setattr(self, f"{n}_b", ini.zeros(d))

    def forward(self, x: torch.Tensor, pos_b: torch.Tensor,
                mask: Optional[torch.Tensor],
                enc_out: Optional[torch.Tensor], ctx: Optional[DitherCtx]):
        cfg = self.cfg
        tag = "enc" if enc_out is None else "dec"
        y, _ = L.attention(self.attn, _ln(x, self, "ln1"), pos_b, mask,
                           cfg.n_heads, cfg.n_kv_heads, cfg.hd, 0.0, ctx=ctx,
                           name=f"{tag}.attn")
        x = x + y
        if enc_out is not None:
            x = x + L.cross_attention(self.xattn, _ln(x, self, "lnx"),
                                      enc_out, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.hd, ctx=ctx, name="dec.xattn")
        return x + L.mlp(self.mlp, _ln(x, self, "ln2"), cfg.act, ctx=ctx,
                         name=f"{tag}.mlp")


class EncDec(nn.Module):
    """``enc`` and ``dec`` (ModuleLists of blocks), ``embed`` (the token
    table, tied to the unembedding) and ``head`` (the decoder's position
    table and the two stacks' final norms)."""

    def __init__(self, cfg: EncDecConfig, ini: L.Init):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.enc = nn.ModuleList(EncDecBlock(cfg, ini, cross=False)
                                 for _ in range(cfg.n_layers))
        self.dec = nn.ModuleList(EncDecBlock(cfg, ini, cross=True)
                                 for _ in range(cfg.n_layers))
        self.embed = L.init_embedding(ini, cfg.vocab, d)
        self.head = nn.ParameterDict({
            "dec_pos": ini.normal(cfg.max_target, d, stddev=0.01),
            "ln_enc_s": ini.ones(d), "ln_enc_b": ini.zeros(d),
            "ln_dec_s": ini.ones(d), "ln_dec_b": ini.zeros(d)})


def init_encdec(cfg: EncDecConfig, *, seed: int = 0,
                device: Optional[torch.device] = None) -> EncDec:
    """A model of ``cfg`` with parameters drawn on ``device`` (CUDA unless
    named) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return EncDec(cfg, L.Init(gen, dev, cfg.dtype))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def encode(net: EncDec, frames: torch.Tensor, *,
           ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """frames (B, n_frames, d_model), precomputed embeddings (the frontend
    stub) -> the encoder's output (B, n_frames, d_model) in the model's
    dtype."""
    cfg = net.cfg
    B, S, _ = frames.shape
    pos = _sinusoid_on(S, cfg.d_model, frames.device)
    x = frames.to(cfg.dtype) + pos[None].to(cfg.dtype)
    x = run_blocks(net.enc, cfg.remat, x, _positions(B, S, frames.device),
                   None, None, ctx)
    return _ln(x, net.head, "ln_enc")


def _dec_pos(net: EncDec, x: torch.Tensor, pos_idx: torch.Tensor
             ) -> torch.Tensor:
    """x plus the learned positions of ``pos_idx``, clipped to the table."""
    table = net.head["dec_pos"]
    idx = torch.clamp(pos_idx, 0, table.shape[0] - 1)
    return x + table[idx].to(x.dtype)


def decode_train(net: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor,
                 *, ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """The teacher-forced decoder: tokens (B, S) over enc_out -> logits (B,
    S, V) in the model's dtype."""
    cfg = net.cfg
    B, S = tokens.shape
    x = _dec_pos(net, L.embed(net.embed["table"], tokens),
                 torch.arange(S, device=tokens.device))
    pos_b = _positions(B, S, tokens.device)
    x = run_blocks(net.dec, cfg.remat, x, pos_b,
                   L.attention_mask(pos_b, pos_b), enc_out, ctx)
    x = _ln(x, net.head, "ln_dec")
    return L.unembed(net.embed["table"], x, ctx=ctx)


def forward(net: EncDec, batch: Dict[str, torch.Tensor], *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """The batch's ``frames`` through the encoder and its ``tokens`` through
    the decoder -> logits (B, S, V) in the model's dtype."""
    enc_out = encode(net, batch["frames"], ctx=ctx)
    return decode_train(net, batch["tokens"], enc_out, ctx=ctx)


def loss_fn(net: EncDec, batch: Dict[str, torch.Tensor], *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    return nll_mean(forward(net, batch, ctx=ctx), batch["labels"])


# ---------------------------------------------------------------------------
# serving: the encoder once (prefill); the decoder steps with its own K/V
# and the encoder's
# ---------------------------------------------------------------------------

def init_cache(cfg: EncDecConfig, batch: int, max_len: int, *,
               device: Optional[torch.device] = None) -> List[Dict]:
    """Per decoder layer {"self": zero (K, V) buffers (batch, max_len, KV,
    hd), "cross": zero (K, V) (batch, n_frames, KV, hd)}, in the model's
    dtype."""
    dev = resolve_device(device)
    return [{"self": _zero_kv(cfg, batch, max_len, dev),
             "cross": _zero_kv(cfg, batch, cfg.n_frames, dev)}
            for _ in range(cfg.n_layers)]


def _zero_kv(cfg: EncDecConfig, batch: int, n: int, device):
    return tuple(torch.zeros(batch, n, cfg.n_kv_heads, cfg.hd,
                             dtype=cfg.dtype, device=device)
                 for _ in range(2))


@torch.no_grad()
def precompute_cross_kv(net: EncDec, enc_out: torch.Tensor):
    """Each decoder layer's cross-attention keys and values of enc_out (B,
    S, d): a list of (K, V), each (B, S, KV, hd)."""
    cfg = net.cfg
    B, S = enc_out.shape[:2]
    return [tuple(dense(enc_out, block.xattn[w]).reshape(
        B, S, cfg.n_kv_heads, cfg.hd) for w in ("wk", "wv"))
        for block in net.dec]


@torch.no_grad()
def decode_step(net: EncDec, cache, token: torch.Tensor, t, *, t_host=None):
    """One token (B, 1) at t (0-d, or per slot (B,)) through the decoder:
    self-attention over the layer's buffer, cross-attention over its
    precomputed encoder K/V. Returns (logits (B, 1, V), the new cache);
    ``t_host`` is the engine's and unused here."""
    cfg = net.cfg
    t = _cache_index(t, token.device)
    x = L.embed(net.embed["table"], token)
    # clipped below too: a per-slot decode marks inactive slots with t < 0
    x = _dec_pos(net, x, t[None, None] if t.dim() == 0 else t[:, None])
    new_cache = []
    for i, (block, c) in enumerate(zip(net.dec, cache)):
        y, kv = L.cached_attention(block.attn, _ln(x, block, "ln1"), t,
                                   c["self"], cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, 0.0, rope=None, name=f"dec{i}.attn")
        x = x + y
        x = x + L.cross_attention_cached(block.xattn, _ln(x, block, "lnx"),
                                         c["cross"], cfg.n_heads, cfg.hd,
                                         name=f"dec{i}.xattn")
        x = x + L.mlp(block.mlp, _ln(x, block, "ln2"), cfg.act,
                      name=f"dec{i}.mlp")
        new_cache.append({"self": kv, "cross": c["cross"]})
    x = _ln(x, net.head, "ln_dec")
    return L.unembed(net.embed["table"], x), new_cache


@torch.no_grad()
def prefill(net: EncDec, tokens: torch.Tensor, max_len: int, frames):
    """The encoder over ``frames`` (B, n_frames, d_model; a tensor or an
    array), each layer's cross K/V once, then the prompt tokens (B, S)
    through :func:`decode_step` one by one. Returns (logits (B, S, V), the
    cache, t = S - 1)."""
    B, S = tokens.shape
    frames = torch.as_tensor(frames, device=tokens.device)
    cache = [{"self": _zero_kv(net.cfg, B, max_len, tokens.device),
              "cross": kv}
             for kv in precompute_cross_kv(net, encode(net, frames))]
    logits = []
    for s in range(S):
        lg, cache = decode_step(net, cache, tokens[:, s:s + 1], s)
        logits.append(lg[:, 0])
    return torch.stack(logits, 1), cache, S - 1
