"""The LM training loop: the policy program each step, gradient
accumulation, AdamW, the loss history.

Counterpart of ``repro.train.trainer``'s single-device loop. Each step
resolves the program's phase policy (``PolicyProgram.phase_policy_at``) and
builds a ``DitherCtx`` only when the step dithers somewhere
(``step_enabled``), keyed as the reference keys it: the base key
``fold_in(seed, 0xD17E)``, folded with the step and the worker
(``DitherCtx``), and micro-batch i's stream ``fold_in(key, i)``
(``DitherCtx.with_key``), i = 0 included when nothing accumulates. With
``grad_accum`` n > 1 the batch splits into n micro-batches along its first
axis and their gradients are averaged in f32. The step's spans are
``torch.profiler.record_function`` ranges ``step/grad`` and
``step/update``.

Not ported yet (ROADMAP.md section 1, items 3-5 and 7): checkpoints and the
preemption guard, the sparsity controller, the obs run directory and
monitors, and the gradient comm reducer.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.core.policy import DitherCtx, DitherPolicy, fold_in
from repro_torch.core.schedule import PolicyProgram, as_program
from repro_torch.device import resolve_device
from repro_torch.memory.policy import MemoryPolicy, as_memory_policy
from repro_torch.models.api import Model
from repro_torch.optim.optimizers import OptConfig, apply_updates, init_opt_state

log = logging.getLogger("repro_torch.trainer")
STEP_SALT = 0xD17E  # the reference trainer's fold of its dither base key


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    seed: int = 0


class Trainer:
    """Trains ``model`` (a ``repro_torch.models.api.Model``) on ``device``
    (CUDA unless named) under ``policy`` (a DitherPolicy, a PolicyProgram
    or None for plain backprop) and ``memory_policy`` (a MemoryPolicy, its
    spec string or None)."""

    def __init__(self, model: Model, opt_cfg: OptConfig, tcfg: TrainerConfig,
                 policy: Union[None, DitherPolicy, PolicyProgram] = None,
                 memory_policy: Union[None, str, MemoryPolicy] = None,
                 device: Optional[torch.device] = None):
        if tcfg.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {tcfg.grad_accum}")
        self.model, self.opt_cfg, self.tcfg = model, opt_cfg, tcfg
        self.program = as_program(policy)
        self.memory_policy = as_memory_policy(memory_policy)
        self.device = resolve_device(device)
        self.base_key = fold_in(tcfg.seed, STEP_SALT)
        self.history: list = []
        self.net: Optional[nn.Module] = None
        self.params: Dict[str, torch.Tensor] = {}
        self.opt_state: Optional[Dict[str, Any]] = None

    def init_params(self) -> nn.Module:
        """The model's parameters drawn from the trainer's seed."""
        return self.model.init(self.tcfg.seed, self.device)

    def step_ctx(self, step: int) -> Optional[DitherCtx]:
        """Step ``step``'s dither context, or None when it dithers nowhere."""
        if self.program is None:
            return None
        phase = self.program.phase_policy_at(step)
        if not self.program.step_enabled(phase):
            return None
        return DitherCtx(phase, seed=self.base_key, step=step,
                         program=self.program, memory=self.memory_policy,
                         device=self.device)

    def _micro_loss(self, batch, ctx: Optional[DitherCtx], i: int):
        c = ctx.with_key(fold_in(ctx.key, i)) if ctx is not None else None
        return self.model.loss(self.net, batch, ctx=c)

    def grads(self, batch: Dict[str, torch.Tensor], step: int
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """Step ``step``'s loss on ``batch`` (0-d, detached) and its
        gradients: None when they land in the parameters' ``.grad`` (one
        micro-batch), else the f32 average over the micro-batches by
        parameter name (a bf16 parameter's ``.grad`` cannot hold f32)."""
        ctx = self.step_ctx(step)
        n = self.tcfg.grad_accum
        for p in self.params.values():
            p.grad = None
        with record_function("step/grad"):
            if n == 1:
                loss = self._micro_loss(batch, ctx, 0)
                loss.backward()
                return loss.detach(), None
            names, params = zip(*self.params.items())
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss_acc = torch.zeros((), device=self.device)
            for i in range(n):
                micro = {k: _micro(v, n, i) for k, v in batch.items()}
                lv = self._micro_loss(micro, ctx, i)
                for a, g in zip(acc, torch.autograd.grad(lv, params)):
                    a.add_(g / n)
                loss_acc = loss_acc + lv.detach() / n
            return loss_acc, dict(zip(names, acc))

    def train_step(self, batch: Dict[str, torch.Tensor], step: int
                   ) -> Dict[str, Any]:
        """One optimizer step: gradients, then the update. Returns the
        metrics (``loss`` 0-d, ``lr``, ``grad_norm`` with a clip)."""
        loss, grads = self.grads(batch, step)
        with record_function("step/update"):
            metrics = apply_updates(self.params, self.opt_state, self.opt_cfg,
                                    grads=grads)
        metrics["loss"] = loss
        return metrics

    def fit(self, batch_iter: Iterator, params: Optional[nn.Module] = None,
            opt_state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Train from ``opt_state["step"]`` (0 for a new state) to
        ``total_steps``; ``params`` and ``opt_state`` default to a fresh
        draw and state. Returns the parameters, the state and the loss
        history (a row ``{"step", "loss"}`` every ``log_every`` steps)."""
        self.net = params if params is not None else self.init_params()
        self.params = dict(self.net.named_parameters())
        self.opt_state = (opt_state if opt_state is not None
                          else init_opt_state(self.params, self.opt_cfg))
        t0 = time.time()
        for step in range(self.opt_state["step"], self.tcfg.total_steps):
            batch = next(batch_iter)
            if isinstance(batch, tuple):  # (step, batch) loaders
                batch = batch[1]
            metrics = self.train_step(batch, step)
            if self.tcfg.log_every and (step + 1) % self.tcfg.log_every == 0:
                loss = float(metrics["loss"])
                self.history.append({"step": step + 1, "loss": loss})
                log.info("step %d loss %.4f (%.2f s)", step + 1, loss,
                         time.time() - t0)
        return {"params": self.net, "opt_state": self.opt_state,
                "history": self.history}


def _micro(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``n`` along the first axis."""
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split into {n} "
                         f"micro-batches")
    m = x.shape[0] // n
    return x[i * m:(i + 1) * m]
