"""SGD with momentum and a step schedule: the paper's training recipe
(counterpart of the ``sgd`` branch of ``repro.optim.optimizers``).

    mu <- momentum * mu + g + weight_decay * w
    w  <- w - lr * mu,     lr = lr0 * rate ** floor(step / every)

Parameters and moments are updated in place (the reference returns new
arrays); the arithmetic is the same, in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 5e-4
    step_decay_every: int = 100
    step_decay_rate: float = 0.1


def schedule_lr(cfg: OptConfig, step: int) -> float:
    return cfg.lr * cfg.step_decay_rate ** math.floor(
        step / cfg.step_decay_every)


def init_opt_state(params: Dict[str, torch.Tensor]) -> Dict:
    return {"step": 0,
            "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}}


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor], state: Dict,
                  cfg: OptConfig) -> float:
    """One SGD-momentum step from each parameter's ``.grad``; returns the
    learning rate used."""
    lr = schedule_lr(cfg, state["step"])
    for name, w in params.items():
        mu = state["mu"][name]
        mu.mul_(cfg.momentum).add_(w.grad.to(torch.float32)).add_(
            w.to(torch.float32), alpha=cfg.weight_decay)
        w.sub_((lr * mu).to(w.dtype))
    state["step"] += 1
    return lr
