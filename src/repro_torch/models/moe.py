"""The mixture-of-experts layer (dbrx-style 16 experts top-4, moonshot's
64 top-6 with shared experts).

Counterpart of ``repro.models.moe`` with its ``einsum`` dispatch: (T, E, C)
one-hot masks route each token's top-k choices into per-expert buffers of
a fixed capacity C = max(1, int(capacity_factor T k / E)); a choice past
its expert's capacity is dropped. The expert FFNs are batched
``dithered_einsum`` products over the expert axis (the kernel variant's
``batched`` form: one NSD launch over the whole cotangent, then the pack
kernel and two int8 products an expert), the router and the shared experts
dithered denses, so dithered backprop covers every weight of the layer.
The layer also returns the switch-style load-balance loss,
``aux_loss_coef`` E sum_e density_e density_proxy_e.

Names (``moe_layer(..., name)``): the router is ``moe.router`` under every
block, as in the reference; the expert products ``{name}.gate``, ``.up``
and ``.down``, the shared experts ``{name}.sgate``, ``.sup`` and
``.sdown``.

Not ported (ROADMAP.md section 1, item 7.2, ``torch.distributed``): the
expert-parallel ``a2a`` dispatch and its int8 hops (``a2a_int8``). On one
card ``dispatch="auto"`` resolves to ``einsum``, as the reference's does
with no mesh installed; ``dispatch="a2a"`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dithered import dense, dithered_einsum
from repro_torch.core.policy import DitherCtx
from repro_torch.models.layers import Init, act_fn

A2A_TODO = "ROADMAP.md section 1, item 7.2 (torch.distributed)"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # DeepSeek-style always-on shared experts
    capacity_factor: float = 1.25
    dispatch: str = "auto"  # auto | einsum | a2a
    aux_loss_coef: float = 0.01
    act: str = "swiglu"
    # int8 payloads on the expert-parallel a2a hops (not ported: item 7.2)
    a2a_int8: bool = False


def init_moe(ini: Init, d_model: int, cfg: MoEConfig) -> nn.ParameterDict:
    """router (d, E); w_gate and w_up (E, d, f), w_down (E, f, d); with
    shared experts ws_gate and ws_up (d, f n_shared), ws_down (f n_shared,
    d)."""
    E, f = cfg.n_experts, cfg.d_ff_expert
    p = nn.ParameterDict({
        "router": ini.normal(d_model, E, fan_in=d_model),
        "w_gate": ini.normal(E, d_model, f, fan_in=d_model),
        "w_up": ini.normal(E, d_model, f, fan_in=d_model),
        "w_down": ini.normal(E, f, d_model, fan_in=f)})
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["ws_gate"] = ini.normal(d_model, fs, fan_in=d_model)
        p["ws_up"] = ini.normal(d_model, fs, fan_in=d_model)
        p["ws_down"] = ini.normal(fs, d_model, fan_in=fs)
    return p


def _act(cfg: MoEConfig):
    return act_fn("silu" if cfg.act == "swiglu" else "gelu")


def _routing(p, x2d: torch.Tensor, cfg: MoEConfig,
             ctx: Optional[DitherCtx]):
    """The router's top-k: (choices (T, k), renormalised probabilities
    (T, k) f32, aux loss). Ties go to the lower expert index, as in
    ``jax.lax.top_k`` (a stable descending sort)."""
    logits = dense(x2d, p["router"], ctx=ctx, name="moe.router")
    probs_full = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_i = torch.sort(probs_full, dim=-1, descending=True,
                              stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)  # renormalise
    E = logits.shape[-1]
    density = torch.mean(F.one_hot(top_i[:, 0], E).to(torch.float32), dim=0)
    density_proxy = torch.mean(probs_full, dim=0)
    aux = torch.sum(density * density_proxy) * E * cfg.aux_loss_coef
    return top_i, top_p, aux


def _expert_ffn(p, xe: torch.Tensor, cfg: MoEConfig,
                ctx: Optional[DitherCtx], name: str) -> torch.Tensor:
    """The experts' FFNs batched over the expert axis: xe (E, C, d) ->
    (E, C, d)."""
    g = dithered_einsum("ecd,edf->ecf", xe, p["w_gate"], ctx=ctx,
                        name=f"{name}.gate")
    u = dithered_einsum("ecd,edf->ecf", xe, p["w_up"], ctx=ctx,
                        name=f"{name}.up")
    return dithered_einsum("ecf,efd->ecd", _act(cfg)(g) * u, p["w_down"],
                           ctx=ctx, name=f"{name}.down")


def _shared_ffn(p, x2d: torch.Tensor, cfg: MoEConfig,
                ctx: Optional[DitherCtx], name: str) -> torch.Tensor:
    g = dense(x2d, p["ws_gate"], ctx=ctx, name=f"{name}.sgate")
    u = dense(x2d, p["ws_up"], ctx=ctx, name=f"{name}.sup")
    return dense(_act(cfg)(g) * u, p["ws_down"], ctx=ctx,
                 name=f"{name}.sdown")


def _positions_in_expert(choices: torch.Tensor, n_experts: int
                         ) -> torch.Tensor:
    """For the flattened choices (N,), token-major, the position of each
    among the earlier picks of the same expert (0-based)."""
    onehot = F.one_hot(choices, n_experts)  # (N, E)
    pos = torch.cumsum(onehot, dim=0) * onehot  # 1-based at the pick
    return torch.sum(pos, dim=-1) - 1


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Each expert's buffer length for ``n_tokens`` tokens (the reference's
    expression, evaluated as it evaluates it)."""
    return max(1, int(cfg.capacity_factor * n_tokens * cfg.top_k
                      / cfg.n_experts))


def dispatch_masks(top_i: torch.Tensor, top_p: torch.Tensor, cap: int,
                   n_experts: int, dtype: torch.dtype):
    """(dispatch, combine) (T, k, E, C) in ``dtype`` and ``keep`` (T k,):
    choice (t, j) lands in slot ``pos`` of its expert while pos < cap;
    combine weighs it by its renormalised probability."""
    T, k = top_i.shape
    flat = top_i.reshape(-1)
    pos = _positions_in_expert(flat, n_experts)
    keep = pos < cap
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    disp = (F.one_hot(flat, n_experts).to(dtype)[:, :, None]
            * F.one_hot(slot, cap + 1).to(dtype)[:, None, :-1])
    disp = disp.reshape(T, k, n_experts, cap)
    combine = disp * top_p.to(dtype)[:, :, None, None]
    return disp, combine, keep


def moe_einsum(p, x2d: torch.Tensor, cfg: MoEConfig,
               ctx: Optional[DitherCtx], name: str = "moe"):
    """The dense-dispatch layer on x2d (T, d) -> (out (T, d), aux)."""
    T = x2d.shape[0]
    cap = capacity(cfg, T)
    top_i, top_p, aux = _routing(p, x2d, cfg, ctx)
    disp, combine, _ = dispatch_masks(top_i, top_p, cap, cfg.n_experts,
                                      x2d.dtype)
    xe = torch.einsum("tkec,td->ecd", disp, x2d)
    he = _expert_ffn(p, xe, cfg, ctx, name)
    out = torch.einsum("tkec,ecd->td", combine, he)
    if cfg.n_shared:
        out = out + _shared_ffn(p, x2d, cfg, ctx, name)
    return out, aux


def resolve_dispatch(cfg: MoEConfig) -> str:
    """``auto`` is ``einsum`` on one card (no expert-parallel mesh);
    ``a2a`` is not ported."""
    if cfg.dispatch == "a2a":
        raise NotImplementedError(
            f"MoE dispatch 'a2a' (expert parallelism, int8 hops "
            f"a2a_int8={cfg.a2a_int8}) is not ported yet: {A2A_TODO}")
    if cfg.dispatch not in ("auto", "einsum"):
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")
    return "einsum"


def moe_layer(p, x: torch.Tensor, cfg: MoEConfig, ctx: Optional[DitherCtx],
              name: str = "moe") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss)."""
    resolve_dispatch(cfg)
    B, S, d = x.shape
    out, aux = moe_einsum(p, x.reshape(B * S, d), cfg, ctx, name)
    return out.reshape(B, S, d), aux
