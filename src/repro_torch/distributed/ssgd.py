"""Synchronous SGD with per-node dithered backprop (paper section 3.6 / 4.3).

Counterpart of ``repro.distributed.ssgd``. The paper's argument: NSD noise
is zero-mean with bounded variance, so with N data-parallel nodes the
server-side average cancels most of it, and the dither scale ``s`` can grow
with N (more sparsity per node) at constant accuracy. Without a mesh the
experiment is simulated: the N nodes run in turn on one device, each on
its own sub-batch with its own dither stream (``DitherCtx(...,
worker=w)``), and their gradients are reduced and applied to the one
shared model. With a :class:`repro_torch.launch.mesh.NodeMesh`
(``make_ssgd_step(..., mesh=)``) rank r is node r: it computes node r's
gradients alone, on its own sub-batch, reduces them over
``torch.distributed`` (``reducer(policy, mesh)``) and applies the same
update to its copy of the model, which stays the simulation's bit for bit.

The reduce is one call: :func:`make_ssgd_step` builds a
``repro_torch.comm.reducer`` from the optional ``CommPolicy``, and the step
routes the stacked (n, ...) node gradients through ``Reducer.reduce``
(``ps``, ``ring``, ``hier`` or ``butterfly``, overlap-bucketed with
``bucket_bytes > 0``; per-leaf keys, wire telemetry, error feedback).

Trace spans ``ssgd/grad``, ``ssgd/reduce`` and ``ssgd/update`` wrap the
three phases (``repro_torch.obs.annotate``, a
``torch.profiler.record_function`` range, as the reference's ``annotate``
names its scopes); ``chip_smoke.py`` times the step's phases through them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.comm.compression import TOPO_PS, CommPolicy
from repro_torch.comm.reduce_base import node_mean
from repro_torch.comm.reducer import reducer as comm_reducer
from repro_torch.core.policy import DitherCtx, DitherPolicy, fold_in
from repro_torch.device import resolve_device
from repro_torch.memory.policy import as_memory_policy
from repro_torch.models.cnn import CNN, loss_fn
from repro_torch.obs.trace import annotate
from repro_torch.optim.optimizers import OptConfig, apply_updates

__all__ = ["SSGDConfig", "SSGDStep", "make_ssgd_step", "shard_batch"]


@dataclasses.dataclass(frozen=True)
class SSGDConfig:
    n_nodes: int = 4
    s_schedule: str = "sqrt"  # fixed | linear | sqrt: how s scales with N
    s_base: float = 1.0

    def s_for_n(self) -> float:
        if self.s_schedule == "fixed":
            return self.s_base
        if self.s_schedule == "linear":
            return self.s_base * self.n_nodes
        return self.s_base * math.sqrt(self.n_nodes)


class SSGDStep:
    """One SSGD step: N per-node dithered gradients -> reduce -> update.

        step(opt_state, batch, seed, comm_state=None, ctrl=None)
            -> (metrics, comm_state)

    ``batch`` leaves carry a leading (n_nodes, per_node_batch, ...) axis
    (:func:`shard_batch`), or over a mesh this rank's (per_node_batch,
    ...) sub-batch; ``seed`` is the run's int seed, from which node
    w's dither stream at step ``opt_state["step"]`` and the reduce's pack
    keys derive. The model's parameters and ``opt_state`` are updated in
    place. ``metrics`` holds 0-d tensors: ``loss`` (the nodes' mean; over a
    mesh the ranks' losses gathered, in node order), ``lr``
    and, with a comm policy, ``comm_wire_bytes`` and ``comm_dense_bytes``
    (plus ``comm_error_bound`` and the ``comm_wire_ici_bytes`` /
    ``comm_wire_dcn_bytes`` / ``comm_peak_dcn_bytes`` split on the
    all-reduce topologies). ``comm_state`` carries the
    error-feedback residuals of ``topk_ef`` leaves (the reducer's
    ``init_state``). ``ctrl`` is the sparsity controller's ``{layer:
    log-scale}`` state, handed to every node's ``DitherCtx`` as the
    reference's step takes it (``ElasticSSGD`` carries it through resizes).
    """

    def __init__(self, model: CNN, opt_cfg: OptConfig, dcfg: SSGDConfig,
                 policy: DitherPolicy, comm_policy: Optional[CommPolicy],
                 memory, grad_accum: int, device: torch.device, mesh=None):
        self.model, self.opt_cfg, self.dcfg = model, opt_cfg, dcfg
        self.policy, self.memory = policy, memory
        self.grad_accum, self.device, self.mesh = grad_accum, device, mesh
        if mesh is not None and mesh.size != dcfg.n_nodes:
            raise ValueError(
                f"the mesh has {mesh.size} ranks but SSGDConfig.n_nodes is "
                f"{dcfg.n_nodes}: rank r runs node r")
        self.reducer = None
        if comm_policy is not None:
            if comm_policy.topology != TOPO_PS and dcfg.n_nodes == 1:
                # a one-node all-reduce has no wire: measure the ps-shaped
                # compression instead, as the reference does
                comm_policy = comm_policy.replace(topology=TOPO_PS)
            self.reducer = comm_reducer(comm_policy, mesh,
                                        n_nodes=dcfg.n_nodes)

    def node_ctx(self, seed: int, step: int, worker: int, micro: int
                 ) -> DitherCtx:
        """Node ``worker``'s dither context for micro-batch ``micro``: the
        run's seed, folded with the micro-batch index when the step
        accumulates (the reference's per-micro key). The seam through which
        a test hands a node the reference's draws."""
        if self.grad_accum > 1:
            seed = fold_in(seed, micro)
        return DitherCtx(self.policy, seed=seed, step=step, worker=worker,
                         device=self.device, memory=self.memory)

    def one_node(self, batch: Dict[str, torch.Tensor], seed: int, step: int,
                 worker: int, ctrl=None
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Node ``worker``'s loss and gradients (in ``named_parameters``
        order) on its sub-batch, averaged over the ``grad_accum``
        micro-batches."""
        params = [p for _, p in self.model.named_parameters()]
        ga = self.grad_accum
        loss_w, grads_w = None, None
        for i in range(ga):
            nb = batch
            if ga > 1:
                m = nb["labels"].shape[0] // ga
                nb = {k: v[i * m:(i + 1) * m] for k, v in nb.items()}
            ctx = self.node_ctx(seed, step, worker, i)
            if ctrl is not None:
                ctx = dataclasses.replace(ctx, ctrl=ctrl)
            loss = loss_fn(self.model, nb, ctx=ctx)
            g = torch.autograd.grad(loss, params)
            loss = loss.detach()
            loss_w = loss if loss_w is None else loss_w + loss
            grads_w = g if grads_w is None else tuple(
                a + b for a, b in zip(grads_w, g))
        if ga > 1:
            loss_w = loss_w * (1.0 / ga)
            grads_w = tuple(x * (1.0 / ga) for x in grads_w)
        return loss_w, grads_w

    def node_grads(self, batch: Dict[str, torch.Tensor], seed: int, step: int,
                   ctrl=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Every node's loss (n,) and gradients {name: (n, ...)}, averaged
        over the ``grad_accum`` micro-batches of its sub-batch. Over a mesh,
        this rank's node alone: its loss (0-d) and gradients {name: leaf}."""
        names = [name for name, _ in self.model.named_parameters()]
        if self.mesh is not None:
            loss, g = self.one_node(batch, seed, step, self.mesh.index, ctrl)
            return loss, dict(zip(names, g))
        losses, grads = [], {name: [] for name in names}
        for w in range(self.dcfg.n_nodes):
            loss_w, grads_w = self.one_node({k: v[w] for k, v in batch.items()},
                                            seed, step, w, ctrl)
            losses.append(loss_w)
            for name, x in zip(names, grads_w):
                grads[name].append(x)
        return torch.stack(losses), {k: torch.stack(v)
                                     for k, v in grads.items()}

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in node order (over a mesh)."""
        from repro_torch.comm.p2p import Exchange

        return torch.stack(Exchange(self.mesh, x.device).all_gather(x))

    def __call__(self, opt_state: Dict, batch: Dict[str, torch.Tensor],
                 seed: int, comm_state=None, ctrl=None):
        step = opt_state["step"]
        with annotate("ssgd/grad"):
            losses, grads = self.node_grads(batch, seed, step, ctrl)
        metrics = {}
        if self.reducer is not None:
            with annotate("ssgd/reduce"):
                grads, tele, comm_state = self.reducer.reduce(
                    grads, seed, step, comm_state)
            metrics = {"comm_wire_bytes": tele.wire_bytes,
                       "comm_dense_bytes": tele.dense_bytes}
            if self.reducer.topology != TOPO_PS:
                metrics.update(comm_error_bound=tele.error_bound,
                               comm_wire_ici_bytes=tele.wire_ici_bytes,
                               comm_wire_dcn_bytes=tele.wire_dcn_bytes,
                               comm_peak_dcn_bytes=tele.peak_dcn_bytes)
        else:
            # no wire: the plain server-side average of the node gradients
            grads = {k: node_mean(self._gather(g) if self.mesh is not None
                                  else g) for k, g in grads.items()}
        with annotate("ssgd/update"):
            params = dict(self.model.named_parameters())
            for name, p in params.items():
                p.grad = grads[name]
            lr = apply_updates(params, opt_state, self.opt_cfg)["lr"]
        if self.mesh is not None:
            losses = self._gather(losses)
        metrics.update(loss=losses.mean(), lr=lr)
        return metrics, comm_state


def make_ssgd_step(model: CNN, opt_cfg: OptConfig, dcfg: SSGDConfig,
                   policy: DitherPolicy,
                   comm_policy: Optional[CommPolicy] = None, *,
                   memory=None, grad_accum: int = 1,
                   device: Optional[torch.device] = None, mesh=None
                   ) -> Tuple[SSGDStep, DitherPolicy]:
    """The SSGD step of ``model`` (its parameters on ``device``: CUDA unless
    the caller names one) and the dither policy it runs: ``policy`` with
    ``s = dcfg.s_for_n()``.

    With ``comm_policy`` the node gradients cross the wire through the
    reducer it selects (``ps``, ``ring``, ``hier`` or ``butterfly``; a
    one-node all-reduce runs as ``ps``). ``grad_accum`` > 1 accumulates that many micro-batches per node
    before the reduce, each with its own dither stream, so gradients are
    packed once per step. ``memory`` (a ``MemoryPolicy`` or its spec
    string) selects every node's residual codecs. With ``mesh`` (a
    :class:`repro_torch.launch.mesh.NodeMesh` of ``dcfg.n_nodes`` ranks)
    this process is node ``mesh.index``: the step takes its sub-batch and
    reduces over the mesh (``comm_policy`` None: the gathered gradients'
    plain mean).
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    policy = policy.replace(s=dcfg.s_for_n())
    step = SSGDStep(model, opt_cfg, dcfg, policy, comm_policy,
                    as_memory_policy(memory), grad_accum,
                    resolve_device(device), mesh)
    return step, policy


def shard_batch(batch: Dict[str, torch.Tensor], n_nodes: int
                ) -> Dict[str, torch.Tensor]:
    """(B, ...) leaves -> (n_nodes, B / n_nodes, ...)."""
    def reshape(x):
        b = x.shape[0]
        if b % n_nodes:
            raise ValueError(f"batch {b} does not split over {n_nodes} nodes")
        return x.reshape((n_nodes, b // n_nodes) + tuple(x.shape[1:]))

    return {k: reshape(v) for k, v in batch.items()}
