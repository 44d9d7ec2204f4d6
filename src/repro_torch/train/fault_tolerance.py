"""Fault tolerance and elasticity: preemption, stragglers, restart plans and
SSGD that loses and gains nodes.

Counterpart of ``repro.train.fault_tolerance``. The cluster's own signals
(preemption notices, chip health) enter through the narrow
:class:`HealthSource` interface, so the logic runs and is tested offline.

* Restart: the trainer is a function of (checkpoint, data position); data
  is indexed by step, so a resume is exact.
* Node failure: :func:`make_restart_plan` keeps model-parallel groups
  whole, rounds the data axis down to a power of two, and scales gradient
  accumulation to hold the global batch.
* Stragglers: hosts slower than ``factor`` x the median for ``patience``
  steps in a row are reported for replacement.
* Preemption: SIGTERM sets a flag; the training loop checkpoints at the
  next step boundary and stops.
* Elastic SSGD: :class:`ElasticSSGD` resizes the simulated node set of
  ``repro_torch.distributed.make_ssgd_step`` through the checkpoint tree.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.comm.compression import CommPolicy, init_comm_state
from repro_torch.core.policy import DitherPolicy
from repro_torch.device import resolve_device
from repro_torch.distributed.ssgd import (SSGDConfig, make_ssgd_step,
                                          shard_batch)
from repro_torch.models.cnn import CNN
from repro_torch.optim.optimizers import OptConfig, init_opt_state
from repro_torch.train.checkpoint import CheckpointManager


# --------------------------------------------------------------------------
# preemption
# --------------------------------------------------------------------------

class PreemptionGuard:
    """SIGTERM -> checkpoint and stop at the next step boundary."""

    def __init__(self, install: bool = True):
        self._flag = threading.Event()
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:
                pass  # not on the main thread: signals cannot be installed

    def _handler(self, signum, frame):
        self._flag.set()

    def trigger(self) -> None:
        """Raise the flag by hand (drills and tests)."""
        self._flag.set()

    @property
    def should_stop(self) -> bool:
        return self._flag.is_set()


# --------------------------------------------------------------------------
# stragglers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerConfig:
    factor: float = 1.5  # slower than factor * median = suspect
    patience: int = 5  # consecutive suspect steps before reporting


class StragglerDetector:
    def __init__(self, n_hosts: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.n = n_hosts
        self._strikes = [0] * n_hosts

    def observe(self, step_times: Sequence[float]) -> List[int]:
        """Feed per-host step durations; returns the hosts flagged this
        round. A strike counts a step slower than ``factor`` x the median
        (one healthy step clears them)."""
        vals = sorted(step_times)
        med = vals[len(vals) // 2]
        flagged = []
        for i, v in enumerate(step_times):
            if v > self.cfg.factor * med:
                self._strikes[i] += 1
                if self._strikes[i] >= self.cfg.patience:
                    flagged.append(i)
            else:
                self._strikes[i] = 0
        return flagged


# --------------------------------------------------------------------------
# elastic re-mesh
# --------------------------------------------------------------------------

def plan_elastic_mesh(n_alive_chips: int, model_parallel: int
                      ) -> Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """The largest (data, model) mesh after failures: ``model_parallel``
    kept whole (a model-parallel shard is useless without its peers), the
    data axis rounded down to a power of two. None when not one whole
    model-parallel group survives."""
    if n_alive_chips < model_parallel:
        return None
    data = n_alive_chips // model_parallel
    p = 1
    while p * 2 <= data:
        p *= 2
    return (p, model_parallel), ("data", "model")


@dataclasses.dataclass
class RestartPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    restore_step: Optional[int]
    grad_accum_scale: int  # multiply accumulation steps by this


def make_restart_plan(n_alive_chips: int, model_parallel: int,
                      original_data_parallel: int,
                      latest_step: Optional[int]) -> Optional[RestartPlan]:
    plan = plan_elastic_mesh(n_alive_chips, model_parallel)
    if plan is None:
        return None
    (data, _), axes = plan
    scale = max(1, original_data_parallel // data)
    return RestartPlan(mesh_shape=plan[0], mesh_axes=axes,
                       restore_step=latest_step, grad_accum_scale=scale)


# --------------------------------------------------------------------------
# elastic synchronous SGD: node join and leave with state migration
# --------------------------------------------------------------------------

def snap_pods(pods: int, n_nodes: int) -> int:
    """The largest pod count <= ``pods`` that divides ``n_nodes`` (their
    gcd): a hier or butterfly reduce needs N = pods * per_pod exactly."""
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    return max(1, math.gcd(max(pods, 1), n_nodes))


class ElasticSSGD:
    """Elastic driver over ``repro_torch.distributed.make_ssgd_step``.

    Runs synchronous SGD of ``model`` (a ``repro_torch.models.cnn.CNN``,
    its parameters on ``device``) over ``n_nodes`` simulated nodes, and
    :meth:`resize` lets nodes join or leave between steps: it migrates the
    whole training state, the checkpoint tree ``params``, ``opt``, ``comm``
    (the error-feedback residuals of ``topk_ef`` leaves, kept per leaf on
    the nodes' mean, so independent of the node count) and ``ctrl`` (the
    sparsity controller's log-scales), through a save at the old size, a
    rebuild of the step for the new one, and a restore.

    The dither scale follows ``SSGDConfig.s_for_n`` at the current node
    count, and a hier or butterfly policy's pod count snaps to it
    (:func:`snap_pods`). The reference's ``phase_step`` (a policy
    program's phase) has no counterpart: the port's SSGD step takes a
    plain ``DitherPolicy``.
    """

    def __init__(self, model: CNN, opt_cfg: OptConfig,
                 base_policy: DitherPolicy,
                 comm_policy: Optional[CommPolicy] = None, *,
                 ckpt_dir: str, n_nodes: int, s_schedule: str = "sqrt",
                 s_base: float = 1.0, grad_accum: int = 1,
                 memory=None, device: Optional[torch.device] = None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.base_policy = base_policy
        self.comm_policy = comm_policy
        self.s_schedule = s_schedule
        self.s_base = s_base
        self.grad_accum = grad_accum
        self.memory = memory
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir)
        self.opt_state: Optional[Dict] = None
        self.comm_state: Dict = {}
        self.ctrl_state: Dict = {}
        self.n_nodes = 0
        self._rebuild(n_nodes)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _rebuild(self, n_nodes: int) -> None:
        comm = self.comm_policy
        if comm is not None and comm.pods > 1:
            comm = comm.replace(pods=snap_pods(comm.pods, n_nodes))
        dcfg = SSGDConfig(n_nodes=n_nodes, s_schedule=self.s_schedule,
                          s_base=self.s_base)
        self.step_fn, self.policy = make_ssgd_step(
            self.model, self.opt_cfg, dcfg, self.base_policy, comm,
            memory=self.memory, grad_accum=self.grad_accum,
            device=self.device)
        self.n_nodes = n_nodes
        self.active_comm_policy = comm

    # ------------------------------------------------------------- lifecycle
    def init(self) -> None:
        """Fresh optimizer and comm state, or the latest checkpoint's."""
        self.opt_state = init_opt_state(self.params, self.opt_cfg)
        self.comm_state = (init_comm_state(self.params, self.comm_policy)
                           if self.comm_policy is not None else {})
        if self.ckpt.latest_step() is not None:
            self._restore()

    def _ckpt_tree(self) -> Dict:
        tree = {"params": self.params, "opt": self.opt_state}
        if self.comm_state:
            tree["comm"] = self.comm_state
        if self.ctrl_state:
            tree["ctrl"] = self.ctrl_state
        return tree

    def save(self) -> int:
        """Checkpoint the state at its step and wait for the write."""
        step = int(self.opt_state["step"])
        self.ckpt.save(step, self._ckpt_tree())
        self.ckpt.wait()
        return step

    def _restore(self) -> None:
        try:
            state = self.ckpt.restore(self._ckpt_tree(), inplace=True)
        except KeyError:
            # the checkpoint predates a subtree: restore what it has, keep
            # the rest as it is
            state = self.ckpt.restore(
                {"params": self.params, "opt": self.opt_state}, inplace=True)
        self.opt_state = state["opt"]
        self.comm_state = state.get("comm", self.comm_state)
        self.ctrl_state = state.get("ctrl", self.ctrl_state)

    def resize(self, n_nodes: int) -> None:
        """Nodes join (grow) or leave (shrink): the state goes through the
        checkpoint, the path a real elastic restart takes (the survivors
        restore from disk at the new size). A no-op at the same size."""
        if n_nodes == self.n_nodes:
            return
        self.save()
        self._rebuild(n_nodes)
        self._restore()

    def step(self, batch: Dict[str, torch.Tensor], seed: int) -> Dict:
        """One synchronous step on ``batch`` (leaves with a flat batch axis
        that splits over the current node count) under the run's ``seed``;
        returns the step's metrics."""
        metrics, self.comm_state = self.step_fn(
            self.opt_state, shard_batch(batch, self.n_nodes), seed,
            self.comm_state or None, ctrl=self.ctrl_state or None)
        return metrics


# --------------------------------------------------------------------------
# health source interface (the cluster's wiring)
# --------------------------------------------------------------------------

class HealthSource:
    """Override per cluster: the alive chip count and per-host step times."""

    def alive_chips(self) -> int:
        raise NotImplementedError

    def step_times(self) -> Dict[int, float]:
        raise NotImplementedError


class StaticHealthSource(HealthSource):
    """An offline implementation that a drill or a test feeds."""

    def __init__(self, chips: int):
        self._chips = chips
        self._times: Dict[int, float] = {}

    def fail(self, n: int) -> None:
        self._chips -= n

    def alive_chips(self) -> int:
        return self._chips

    def set_step_time(self, host: int, t: float) -> None:
        self._times[host] = t

    def step_times(self) -> Dict[int, float]:
        return dict(self._times)
