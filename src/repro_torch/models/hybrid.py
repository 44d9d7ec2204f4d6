"""The hybrid-head LM (hymba-1.5b, arXiv:2411.13676): every layer runs an
attention branch and a Mamba-2 branch in parallel on the same input,
normalises each branch's output and averages the two, then an MLP.
Sliding-window attention on every layer but three (the first, the middle
and the last are global), and learnable meta tokens prepended to the
sequence.

Counterpart of ``repro.models.hybrid``: ``HybridConfig``, ``init_hybrid_lm``,
the block, ``forward`` and ``loss_fn``, and for serving ``cache_buf_len``,
``init_cache``, ``decode_step_x``, ``decode_step``, ``bootstrap_cache`` and
``prefill``. Every projection (attention q/k/v/o, the mixer's in and out,
the MLP) is dithered through ``repro_torch.core.dithered.dense`` under the
one block tag ``L`` (``L.attn.q``, ``L.ssm.in``, ``L.mlp.gate``, ...), as the
reference's scan; decoding names them per layer (``L{i}.*``).

The meta tokens take positions 0 .. M - 1 and text token s position M + s.
A local layer's mask keeps the last ``window`` positions and the M meta
positions (``layers.attention_mask``'s ``prefix_len``); its decode buffer
pins the meta positions in its first M slots, ahead of a ring of
``window`` slots. ``forward`` drops the meta positions before the head.
Decoding starts from :func:`bootstrap_cache`, the meta tokens replayed
through the decode step; ``prefill`` then feeds the prompt token by token,
as the reference does, and returns t = M + S - 1.

Parameters (``HybridLM.named_parameters()``): ``embed.table``,
``layers.{i}.attn.{wq,wk,wv,wo}``, ``layers.{i}.mixer.*`` (the Mamba-2
mixer's, ``repro_torch.models.mamba``), ``layers.{i}.mlp.{w_gate,w_up,
w_down}``, ``layers.{i}.{ln1,ln2,norm_attn,norm_ssm}``, ``head.ln_f``,
``head.meta_tokens`` (M, d); the unembedding is tied to the table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.policy import DitherCtx
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.transformer import _cache_index

LAYER_TAG = "L"


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 64
    d_state: int = 16
    expand: int = 2
    window: int = 1024
    n_meta_tokens: int = 128
    rope_theta: float = 10_000.0
    act: str = "swiglu"
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = True
    remat: bool = True

    @property
    def ssm(self) -> M.SSMConfig:
        return M.SSMConfig(d_model=self.d_model,
                           d_inner=self.expand * self.d_model,
                           head_dim=self.head_dim, d_state=self.d_state)

    def global_layers(self) -> Tuple[int, ...]:
        return (0, self.n_layers // 2, self.n_layers - 1)

    def layer_is_local(self, i: int) -> bool:
        return i not in self.global_layers()

    def layer_window(self, i: int) -> Optional[int]:
        return self.window if self.layer_is_local(i) else None

    def layer_prefix(self, i: int) -> int:
        """The pinned meta positions of layer ``i``'s window (0: global)."""
        return self.n_meta_tokens if self.layer_is_local(i) else 0

    @property
    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        c = self.ssm
        ssm = (d * c.d_in_proj + c.d_conv * c.conv_dim + c.d_inner * d
               + 3 * c.n_heads + 2 * c.d_inner)
        nff = 3 if self.act in L.GATED else 2
        per_layer = attn + ssm + nff * d * self.d_ff + 4 * d
        return (self.n_layers * per_layer + self.vocab * d + d
                + self.n_meta_tokens * d)

    @property
    def active_param_count(self) -> int:
        return self.param_count


class HybridBlock(nn.Module):
    """x + 0.5 (rms(attn(h)) + rms(ssm(h))), h = rms(x); then + mlp(rms(.))."""

    def __init__(self, cfg: HybridConfig, ini: L.Init):
        super().__init__()
        self.cfg = cfg
        self.attn = L.init_attention(ini, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.head_dim)
        self.mixer = M.init_mamba_mixer(ini, cfg.ssm)
        self.mlp = L.init_mlp(ini, cfg.d_model, cfg.d_ff, cfg.act)
        for n in ("ln1", "ln2", "norm_attn", "norm_ssm"):
            setattr(self, n, ini.ones(cfg.d_model))

    def mix(self, x, attn_y, ssm_y, ctx, tag):
        """The branches' mean, then the MLP, on the residual x."""
        cfg = self.cfg
        x = x + 0.5 * (L.rms_norm(attn_y, self.norm_attn)
                       + L.rms_norm(ssm_y, self.norm_ssm))
        return x + L.mlp(self.mlp, L.rms_norm(x, self.ln2), cfg.act, ctx=ctx,
                         name=f"{tag}.mlp")

    def forward(self, x: torch.Tensor, pos_b: torch.Tensor,
                mask: torch.Tensor, ctx: Optional[DitherCtx]):
        cfg = self.cfg
        h = L.rms_norm(x, self.ln1)
        attn_y, _ = L.attention(self.attn, h, pos_b, mask, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim, cfg.rope_theta,
                                ctx=ctx, name=f"{LAYER_TAG}.attn")
        ssm_y = M.mamba_mixer(self.mixer, h, cfg.ssm, ctx=ctx,
                              name=f"{LAYER_TAG}.ssm")
        return self.mix(x, attn_y, ssm_y, ctx, LAYER_TAG)


class HybridLM(nn.Module):
    def __init__(self, cfg: HybridConfig, ini: L.Init):
        super().__init__()
        self.cfg = cfg
        self.embed = L.init_embedding(ini, cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(HybridBlock(cfg, ini)
                                    for _ in range(cfg.n_layers))
        self.head = nn.ParameterDict({
            "ln_f": ini.ones(cfg.d_model),
            "meta_tokens": ini.normal(cfg.n_meta_tokens, cfg.d_model,
                                      stddev=0.02)})


def init_hybrid_lm(cfg: HybridConfig, *, seed: int = 0,
                   device: Optional[torch.device] = None) -> HybridLM:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return HybridLM(cfg, L.Init(gen, dev, cfg.dtype))


def _masks(cfg: HybridConfig, pos_b: torch.Tensor) -> Dict:
    """{window: mask}: the local layers' (last ``window`` positions and the
    meta prefix) and the global layers' (causal)."""
    return {w: L.attention_mask(pos_b, pos_b, window=w,
                                prefix_len=cfg.n_meta_tokens if w else 0)
            for w in {cfg.layer_window(i) for i in range(cfg.n_layers)}}


def forward(net: HybridLM, tokens: torch.Tensor, *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in the model's dtype (the meta
    positions dropped)."""
    cfg = net.cfg
    x = L.embed(net.embed["table"], tokens)
    B = x.shape[0]
    meta = net.head["meta_tokens"][None].expand(
        B, cfg.n_meta_tokens, cfg.d_model).to(x.dtype)
    x = torch.cat([meta, x], 1)
    S_tot = x.shape[1]
    pos_b = torch.arange(S_tot, device=x.device)[None, :].expand(B, S_tot)
    masks = _masks(cfg, pos_b)
    for i, block in enumerate(net.layers):
        x = M.run_blocks([block], cfg.remat, x, pos_b,
                         masks[cfg.layer_window(i)], ctx)
    x = L.rms_norm(x[:, cfg.n_meta_tokens:], net.head["ln_f"])
    return L.unembed(net.embed["table"], x, ctx=ctx)


def loss_fn(net: HybridLM, batch: Dict[str, torch.Tensor], *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    return M.nll_mean(forward(net, batch["tokens"], ctx=ctx), batch["labels"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def cache_buf_len(cfg: HybridConfig, i: int, max_len: int) -> int:
    """Layer ``i``'s KV buffer: the meta prefix and a ring of ``window``
    slots (local), or every position (global)."""
    total = max_len + cfg.n_meta_tokens
    if cfg.layer_is_local(i):
        return min(cfg.window + cfg.n_meta_tokens, total)
    return total


def init_cache(cfg: HybridConfig, batch: int, max_len: int, *,
               device: Optional[torch.device] = None) -> List[Dict]:
    """Per layer {"kv": zero (K, V) buffers (B, S_buf, KV, hd), "ssm": a
    zero Mamba state}, in the model's dtype."""
    dev = resolve_device(device)
    return [{"kv": tuple(torch.zeros(batch, cache_buf_len(cfg, i, max_len),
                                     cfg.n_kv_heads, cfg.head_dim,
                                     dtype=cfg.dtype,
                                     device=dev) for _ in range(2)),
             "ssm": M.MambaCache.init(cfg.ssm, batch, cfg.dtype, dev)}
            for i in range(cfg.n_layers)]


@torch.no_grad()
def decode_step_x(net: HybridLM, cache, x: torch.Tensor, t):
    """One embedded position x (B, 1, d) at t (0-d, or per slot (B,), t < 0
    an inactive slot) through every layer. Returns (hidden (B, 1, d), the
    new cache); the caller norms and unembeds."""
    cfg = net.cfg
    t = _cache_index(t, x.device)
    rope = L.rope_table(L.decode_positions(t), cfg.head_dim, cfg.rope_theta)
    new_cache = []
    for i, (block, c) in enumerate(zip(net.layers, cache)):
        h = L.rms_norm(x, block.ln1)
        attn_y, kv = L.cached_attention(
            block.attn, h, t, c["kv"], cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.rope_theta, rope=rope, window=cfg.layer_window(i),
            prefix=cfg.layer_prefix(i), name=f"L{i}.attn")
        ssm_y, ssm = M.mamba_decode_step(block.mixer, h, c["ssm"], cfg.ssm,
                                         name=f"L{i}.ssm")
        x = block.mix(x, attn_y, ssm_y, None, f"L{i}")
        new_cache.append({"kv": kv, "ssm": ssm})
    return x, new_cache


@torch.no_grad()
def decode_step(net: HybridLM, cache, token: torch.Tensor, t, *,
                t_host=None):
    """One token (B, 1) at t over (meta + text): text starts at
    ``n_meta_tokens``. Returns (logits (B, 1, V), the new cache);
    ``t_host`` is the engine's (a paged cache's) and unused here."""
    x, new_cache = decode_step_x(net, cache, L.embed(net.embed["table"],
                                                     token), t)
    x = L.rms_norm(x, net.head["ln_f"])
    return L.unembed(net.embed["table"], x), new_cache


@torch.no_grad()
def bootstrap_cache(net: HybridLM, batch: int, max_len: int):
    """A fresh decode cache with the meta tokens replayed in through the
    decode step at positions 0 .. M - 1 (the local layers pin them)."""
    cfg = net.cfg
    dev = net.head["meta_tokens"].device
    cache = init_cache(cfg, batch, max_len, device=dev)
    meta = net.head["meta_tokens"].to(cfg.dtype)
    for i in range(cfg.n_meta_tokens):
        x = meta[i][None, None].expand(batch, 1, cfg.d_model)
        _, cache = decode_step_x(net, cache, x, i)
    return cache


@torch.no_grad()
def prefill(net: HybridLM, tokens: torch.Tensor, max_len: int):
    """The prompt (B, S) through the decode path after the meta bootstrap.
    Returns (logits (B, S, V), cache, t = n_meta_tokens + S - 1)."""
    B, S = tokens.shape
    n_meta = net.cfg.n_meta_tokens
    cache = bootstrap_cache(net, B, max_len)
    logits = []
    for s in range(S):
        lg, cache = decode_step(net, cache, tokens[:, s:s + 1], n_meta + s)
        logits.append(lg[:, 0])
    return torch.stack(logits, 1), cache, n_meta + S - 1
