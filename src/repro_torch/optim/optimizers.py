"""Optimizers: SGD with momentum (the paper's recipe) and AdamW (the LM
default). Counterpart of ``repro.optim.optimizers``.

    sgd:    mu <- momentum * mu + g + weight_decay * w;   w <- w - lr * mu
    adamw:  mu <- b1 mu + (1 - b1) g;   nu <- b2 nu + (1 - b2) g^2
            w  <- w - lr (mu / bc1 / (sqrt(nu / bc2) + eps) + weight_decay w)

with bc1 = 1 - b1^t and bc2 = 1 - b2^t at t = step + 1, an optional clip of
the gradients' global norm first, and the learning rate of
:func:`schedule_lr` (constant, cosine with linear warmup, or step decay).
bf16 and f16 parameters keep an f32 master copy in the state, updated in f32
and cast back; f32 parameters are updated directly. The arithmetic is the
reference's, in f32; the port updates parameters, masters and moments in
place (the reference returns new arrays), which keeps a 2.5 B-parameter
model's AdamW state at one copy.

Not ported yet: the reference's moment codecs (``OptConfig.mu_codec`` /
``nu_codec``, ROADMAP.md section 1, item 1). They are set only by the
``quant:`` section of ``--program``, which ``repro_torch.launch.program``
refuses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | sgd
    lr: float = 1e-3
    momentum: float = 0.9  # sgd
    b1: float = 0.9  # adamw
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    schedule: str = "constant"  # constant | cosine | step
    warmup_steps: int = 0
    total_steps: int = 10_000
    step_decay_every: int = 100  # paper: lr-decay 0.1/100
    step_decay_rate: float = 0.1
    min_lr_ratio: float = 0.1

    def __post_init__(self):
        if self.name not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {self.name!r}")
        if self.schedule not in ("constant", "cosine", "step"):
            raise ValueError(f"unknown lr schedule {self.schedule!r}")


def schedule_lr(cfg: OptConfig, step: int) -> float:
    """The learning rate of step ``step``, in the reference's f32
    arithmetic."""
    s = _F32(step)
    warm = (min(_F32(1.0), (s + _F32(1)) / _F32(max(cfg.warmup_steps, 1)))
            if cfg.warmup_steps > 0 else _F32(1.0))
    if cfg.schedule == "cosine":
        t = (s - _F32(cfg.warmup_steps)) / _F32(
            max(cfg.total_steps - cfg.warmup_steps, 1))
        t = min(max(t, _F32(0.0)), _F32(1.0))
        lo = _F32(cfg.min_lr_ratio)
        mult = lo + (_F32(1) - lo) * _F32(0.5) * (
            _F32(1) + np.cos(_F32(np.pi) * t))
    elif cfg.schedule == "step":
        mult = _F32(cfg.step_decay_rate) ** _F32(
            math.floor(step / cfg.step_decay_every))
    else:
        mult = _F32(1.0)
    return float(_F32(cfg.lr) * warm * mult)


def _needs_master(p: torch.Tensor) -> bool:
    return p.dtype in (torch.bfloat16, torch.float16)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm`` (the sum of squares in f32); returns them and the norm
    before scaling, a 0-d tensor (no host sync)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g in grads.values():
        g.copy_((g.to(torch.float32) * scale).to(g.dtype))
    return grads, gn


def init_opt_state(params: Dict[str, torch.Tensor], cfg: OptConfig) -> Dict:
    """``step``, f32 ``master`` copies of the bf16/f16 parameters, and the
    moments: ``mu`` (both), ``nu`` (adamw), f32 zeros."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()}

    state = {"step": 0,
             "master": {n: p.detach().to(torch.float32).clone()
                        for n, p in params.items() if _needs_master(p)},
             "mu": zeros()}
    if cfg.name == "adamw":
        state["nu"] = zeros()
    return state


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor], state: Dict,
                  cfg: OptConfig,
                  grads: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """One optimizer step, in place, from ``grads`` (by parameter name, of
    any float dtype: the trainer's f32 accumulation) or, when None, each
    parameter's ``.grad``. Returns the metrics: ``lr`` (a float) and, with a
    clip, ``grad_norm`` (0-d)."""
    step = state["step"]
    lr = schedule_lr(cfg, step)
    metrics = {"lr": lr}
    if grads is None:
        grads = {n: p.grad for n, p in params.items()}
    if cfg.grad_clip is not None:
        grads, metrics["grad_norm"] = clip_by_global_norm(grads, cfg.grad_clip)
    if cfg.name == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        t = _F32(step + 1)
        bc1 = float(_F32(1) - _F32(b1) ** t)
        bc2 = float(_F32(1) - _F32(b2) ** t)
    for name, p in params.items():
        w = state["master"].get(name, p)
        g = grads[name].to(torch.float32)
        mu = state["mu"][name]
        if cfg.name == "sgd":
            mu.mul_(cfg.momentum).add_(g).add_(w, alpha=cfg.weight_decay)
            w.sub_(lr * mu)
        else:
            mu.mul_(b1).add_((1 - b1) * g)
            nu = state["nu"][name]
            nu.mul_(b2).add_((1 - b2) * torch.square(g))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if cfg.weight_decay:
                upd.add_(cfg.weight_decay * w)
            w.sub_(lr * upd)
        if w is not p:
            p.copy_(w)
    state["step"] = step + 1
    return metrics
