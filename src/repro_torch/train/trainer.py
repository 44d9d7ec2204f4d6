"""The LM training loop: the policy program each step, gradient
accumulation, AdamW, the sparsity controller, observability, the loss
history.

Counterpart of ``repro.train.trainer``'s single-device loop. Each step
resolves the program's phase policy (``PolicyProgram.phase_policy_at``) and
builds a ``DitherCtx`` only when the step dithers somewhere
(``step_enabled``), keyed as the reference keys it: the base key
``fold_in(seed, 0xD17E)``, folded with the step and the worker
(``DitherCtx``), and micro-batch i's stream ``fold_in(key, i)``
(``DitherCtx.with_key``), i = 0 included when nothing accumulates. With
``grad_accum`` n > 1 the batch splits into n micro-batches along its first
axis and their gradients are averaged in f32. Inside a step,
``step/grad`` and ``step/update`` are profiler ranges
(``repro_torch.obs.annotate``).

A program with a ``controller:`` clause runs its ``ControllerDriver``: the
layer names found before step 0 (one no-grad forward), the state handed to
each step's context, a tick after each step. With ``obs`` (a
``repro_torch.obs.RunObs``) each step records the spans ``data``,
``dispatch``, ``controller`` and, in ``obs.on_step``, ``monitor``, and its
metrics as host floats (the one host sync a step that obs adds; without obs
the loop adds none), and ``fit`` ends with ``obs.finish()``.

Checkpoints: with ``ckpt_every`` and ``ckpt_dir`` set, ``fit`` saves the
tree ``params``, ``opt`` and (with a controller) ``ctrl``, under the
reference's key names, every ``ckpt_every`` steps through a
``repro_torch.train.CheckpointManager`` (async, keeping the newest
three), and waits for the last write before it returns.
:meth:`Trainer.restore_or_init` draws the parameters and resumes from the
latest checkpoint in place; the controller's subtree is restored once its
layer names are found on the first batch (``_init_ctrl_state``), and a
checkpoint without one leaves the scales at their start values. When
``guard`` (a ``PreemptionGuard``, not installed on SIGTERM: the launcher
decides) has been triggered, the loop checkpoints at the next step boundary
and stops. With ``obs`` the saves run under the span ``checkpoint``.

Not ported yet (ROADMAP.md section 1, item 7.5): the gradient comm reducer
(its error-feedback residuals would join the tree as ``comm``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.core.policy import DitherCtx, DitherPolicy, fold_in
from repro_torch.core.schedule import ControllerDriver, PolicyProgram, as_program
from repro_torch.device import resolve_device
from repro_torch.memory.policy import MemoryPolicy, as_memory_policy
from repro_torch.models.api import Model
from repro_torch.obs.trace import annotate
from repro_torch.optim.optimizers import OptConfig, apply_updates, init_opt_state
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import PreemptionGuard
from repro_torch.utils import get_logger

log = get_logger("repro_torch.trainer")
STEP_SALT = 0xD17E  # the reference trainer's fold of its dither base key


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    ckpt_every: int = 0  # 0 = off
    ckpt_dir: str = ""
    seed: int = 0


class Trainer:
    """Trains ``model`` (a ``repro_torch.models.api.Model``) on ``device``
    (CUDA unless named) under ``policy`` (a DitherPolicy, a PolicyProgram
    or None for plain backprop) and ``memory_policy`` (a MemoryPolicy, its
    spec string or None); ``obs`` (a ``repro_torch.obs.RunObs``) records
    the run into its run directory."""

    def __init__(self, model: Model, opt_cfg: OptConfig, tcfg: TrainerConfig,
                 policy: Union[None, DitherPolicy, PolicyProgram] = None,
                 memory_policy: Union[None, str, MemoryPolicy] = None,
                 device: Optional[torch.device] = None, obs=None):
        if tcfg.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {tcfg.grad_accum}")
        self.model, self.opt_cfg, self.tcfg = model, opt_cfg, tcfg
        self.program = as_program(policy)
        self.memory_policy = as_memory_policy(memory_policy)
        self.device = resolve_device(device)
        self.base_key = fold_in(tcfg.seed, STEP_SALT)
        # the sparsity controller's host protocol (no-ops without one)
        self._ctrl = ControllerDriver(self.program)
        self.obs = obs
        self.guard = PreemptionGuard(install=False)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_every and tcfg.ckpt_dir else None)
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
                         device=self.device, ctrl=self._ctrl.state or None)

    def _init_ctrl_state(self, batch) -> None:
        """Find the layer names on the first batch and build the
        controller's state (once; no-op without a controller)."""
        if not self._ctrl.active or self._ctrl.ready:
            return
        names = self._ctrl.ensure_init(
            lambda net, b, ctx: self.model.loss(net, b, ctx=ctx), self.net,
            batch, device=self.device)
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            # the main restore ran before the layer names existed
            try:
                self._ctrl.state = self.ckpt.restore(
                    {"ctrl": self._ctrl.state})["ctrl"]
                log.info("restored controller state")
            except KeyError:
                pass  # the checkpoint predates the controller
        log.info("sparsity controller: %d layers under control", len(names))

    def _ckpt_tree(self) -> Dict[str, Any]:
        tree = {"params": self.params, "opt": self.opt_state}
        if self._ctrl.state:
            tree["ctrl"] = self._ctrl.state
        return tree

    def _save(self, step: int, sp) -> None:
        with sp("checkpoint"):
            self.ckpt.save(step, self._ckpt_tree())

    def restore_or_init(self) -> Tuple[nn.Module, Dict[str, Any]]:
        """Fresh parameters and optimizer state, overwritten in place by
        the latest checkpoint's when there is one (the controller's state
        waits for ``_init_ctrl_state``)."""
        self.net = self.init_params()
        self.params = dict(self.net.named_parameters())
        self.opt_state = init_opt_state(self.params, self.opt_cfg)
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(
                {"params": self.params, "opt": self.opt_state}, inplace=True)
            self.opt_state = state["opt"]
            log.info("restored checkpoint at step %d", self.opt_state["step"])
        return self.net, self.opt_state

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
        with annotate("step/grad"):
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
        with annotate("step/update"):
            metrics = apply_updates(self.params, self.opt_state, self.opt_cfg,
                                    grads=grads)
        metrics["loss"] = loss
        return metrics

    def fit(self, batch_iter: Iterator, params: Optional[nn.Module] = None,
            opt_state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Train from ``opt_state["step"]`` (0 for a new state) to
        ``total_steps``; without ``params`` the parameters and state come
        from :meth:`restore_or_init`. Returns the parameters, the state and
        the loss history (a row ``{"step", "loss"}`` every ``log_every``
        steps)."""
        if params is None:
            self.restore_or_init()
        else:
            self.net = params
            self.params = dict(self.net.named_parameters())
            self.opt_state = (opt_state if opt_state is not None
                              else init_opt_state(self.params, self.opt_cfg))
        obs = self.obs
        if obs is not None:
            sp = obs.span
        else:
            def sp(name):
                return contextlib.nullcontext()
        t0 = time.time()
        for step in range(self.opt_state["step"], self.tcfg.total_steps):
            if obs is not None:
                obs.set_step(step)
            if self.guard.should_stop:
                log.info("preemption: checkpointing at step %d and stopping",
                         step)
                if self.ckpt is not None:
                    self._save(step, sp)
                break
            with sp("data"):
                batch = next(batch_iter)
                if isinstance(batch, tuple):  # (step, batch) loaders
                    batch = batch[1]
            self._init_ctrl_state(batch)
            with sp("dispatch"):
                metrics = self.train_step(batch, step)
            # fold the step's per-layer telemetry into the log-scales
            with sp("controller"):
                self._ctrl.tick()
            if obs is not None:
                # float() waits for the step: obs is opt-in, and the
                # monitors and the run log need host numbers
                obs.on_step(step + 1, {k: float(v) for k, v in metrics.items()})
            if self.tcfg.log_every and (step + 1) % self.tcfg.log_every == 0:
                loss = float(metrics["loss"])
                self.history.append({"step": step + 1, "loss": loss})
                log.info("step %d loss %.4f (%.2f s)", step + 1, loss,
                         time.time() - t0)
            if self.ckpt is not None and (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(step + 1, sp)
        if self.ckpt is not None:
            self.ckpt.wait()
        if obs is not None:
            obs.finish()
        return {"params": self.net, "opt_state": self.opt_state,
                "history": self.history}


def _micro(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``n`` along the first axis."""
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split into {n} "
                         f"micro-batches")
    m = x.shape[0] // n
    return x[i * m:(i + 1) * m]
