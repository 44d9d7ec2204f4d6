"""One front door for the compressed gradient reduces.

Counterpart of ``repro.comm.reducer``:

    red = comm.reducer(policy, n_nodes=N)
    grads_mean, telemetry, state = red.reduce(grads, key, step, state)

* ``grads`` is a dict of gradient leaves keyed by the reference's parameter
  names (``fc0_w``, ``c3_w``, ``bn2_g``, ...), each with a leading
  (n_nodes, ...) axis (one node is the degenerate case). Leaves are visited in sorted name order, the order the
  reference flattens its dicts in, so the f32 byte totals add up in its
  order.
* Keys are owned here and shared by every topology: a pack of leaf
  ``name`` dithers with the stream key
  ``fold_in(fold_in(fold_in(key, step), name_salt(name)), *path)``, path
  ``(worker,)`` for the parameter server's per-node pack and ``(salt, a,
  b)`` for a ring hop, ``(salt, a, b, c)`` for a hierarchy or butterfly
  hop; the reference folds the same indices with
  ``jax.random.fold_in``. :meth:`Reducer.pack_noise` is that derivation
  and the one seam: a test that overrides it hands each pack the
  reference's own unit draw, which takes the NSD kernel's fed-noise route.
* ``telemetry`` is one :class:`ReducerTelemetry`; ``state`` carries the
  error-feedback residuals of ``topk_ef`` leaves (node-count independent).
  Under ``collect_stats`` each reduce appends one row to the comm stream
  (``repro_torch.comm.telemetry``).

Topologies: ``ps`` (:class:`_StackedPSReducer`); ``ring``, ``hier`` and
``butterfly`` (:class:`_AllReduceReducer`, the per-topology config built
from the policy's ``s`` and ``pods``). ``bucket_bytes > 0`` wraps the
reducer in the overlap scheduler (``repro_torch.comm.overlap``), bit-exact
with the blocking reduce. Not ported: the reference's flat
single-participant reducer over unstacked leaves (the SSGD step always
stacks; ROADMAP.md section 1, item 7.5).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.comm import butterfly as bfly_mod
from repro_torch.comm import hierarchy as hier_mod
from repro_torch.comm import ring as ring_mod
from repro_torch.comm import telemetry as comm_tele
from repro_torch.comm.compression import (MODE_DENSE, MODE_TOPK_EF,
                                          TOPO_BUTTERFLY, TOPO_HIER, TOPO_PS,
                                          TOPO_RING, CommPolicy,
                                          ErrorFeedbackState, _as_f32,
                                          compress_leaf, init_comm_state,
                                          topk_error_feedback)
from repro_torch.comm.reduce_base import hop_key, node_mean
from repro_torch.core.policy import name_salt
from repro_torch.quant import wire

__all__ = ["Reducer", "ReducerTelemetry", "reducer"]


class ReducerTelemetry(NamedTuple):
    """One reduce's accounting, the same fields for every topology.

    0-d f32 tensors unless noted. A field a topology does not measure reads
    0 (``error_bound`` for ps, the ICI/DCN split and ``peak_dcn_bytes`` for
    ps and the ring). Over the leaves of one reduce the bytes and
    ``peak_dcn_bytes`` add up and ``error_bound`` takes the max; an
    overlap-bucketed reduce folds its buckets with :meth:`accumulate`.
    """

    wire_bytes: torch.Tensor
    dense_bytes: torch.Tensor
    error_bound: torch.Tensor
    wire_ici_bytes: torch.Tensor
    wire_dcn_bytes: torch.Tensor
    peak_dcn_bytes: torch.Tensor
    n_hops: int = 0  # total link traversals
    packs_per_segment: int = 0  # sequential re-quantizations
    pods: int = 1
    per_pod: int = 1
    n_buckets: int = 1  # 1 = the blocking reduce

    @property
    def ratio(self) -> torch.Tensor:
        return self.wire_bytes / torch.clamp(self.dense_bytes, min=1.0)

    def accumulate(self, other: "ReducerTelemetry") -> "ReducerTelemetry":
        """Fold another bucket's telemetry in."""
        return ReducerTelemetry(
            wire_bytes=self.wire_bytes + other.wire_bytes,
            dense_bytes=self.dense_bytes + other.dense_bytes,
            error_bound=torch.maximum(self.error_bound, other.error_bound),
            wire_ici_bytes=self.wire_ici_bytes + other.wire_ici_bytes,
            wire_dcn_bytes=self.wire_dcn_bytes + other.wire_dcn_bytes,
            peak_dcn_bytes=torch.maximum(self.peak_dcn_bytes,
                                         other.peak_dcn_bytes),
            n_hops=self.n_hops + other.n_hops,
            packs_per_segment=max(self.packs_per_segment,
                                  other.packs_per_segment),
            pods=max(self.pods, other.pods),
            per_pod=max(self.per_pod, other.per_pod),
            n_buckets=self.n_buckets + other.n_buckets)


class Reducer:
    """Protocol: ``reduce(grads, key, step, state)`` for one topology.

    Subclasses implement ``_reduce``; this base owns state init, the pack
    keys and the ``collect_stats`` emission (one comm row per reduce).
    """

    topology: str = TOPO_PS

    def __init__(self, policy: CommPolicy, n_nodes: int = 1):
        self.policy = policy
        self.n_nodes = int(n_nodes)

    def init_state(self, params_or_grads: Dict[str, torch.Tensor]
                   ) -> Dict[str, ErrorFeedbackState]:
        """Zero EF residuals for the leaves the policy routes through
        topk_ef, shaped like a leaf (not the node axis)."""
        return init_comm_state({n: g[0] for n, g in params_or_grads.items()},
                               self.policy)

    def pack_noise(self, key: int, step: int, name: str, path: Tuple[int, ...],
                   shape: Tuple[int, ...]) -> Union[int, torch.Tensor]:
        """What one pack of leaf ``name`` dithers with: the stream key of
        (key, step, leaf, *path), or, in a subclass or an instance that
        overrides this method, a unit draw of ``shape``."""
        return hop_key(key, step, name_salt(name), *path)

    def reduce(self, grads: Dict[str, torch.Tensor], key: int, step: int,
               state: Optional[Dict[str, ErrorFeedbackState]] = None
               ) -> Tuple[Dict[str, torch.Tensor], ReducerTelemetry,
                          Dict[str, ErrorFeedbackState]]:
        grads, tele, state = self._reduce(grads, key, int(step),
                                          dict(state or {}))
        if self.policy.collect_stats:
            comm_tele.emit(tele.wire_bytes, tele.dense_bytes)
        return grads, tele, state

    def _reduce(self, grads, key, step, state):
        raise NotImplementedError


def _zeros(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32,
                       device=next(iter(grads.values())).device)


class _StackedPSReducer(Reducer):
    """Parameter-server shape over stacked (n_nodes, ...) gradients: every
    node compresses its leaf with its own (leaf, worker) key, then the
    server averages. ``topk_ef`` leaves keep their residual server-side, on
    the averaged gradient (node-count independent)."""

    def _reduce(self, grads, key, step, state):
        n, policy = self.n_nodes, self.policy
        wire_total, dense_total = _zeros(grads), _zeros(grads)
        out = {}
        for name, g_nodes in sorted(grads.items()):
            size = g_nodes.numel() // n
            mode = policy.mode_for(name, size)
            dense_bytes = float(4 * size * n)
            dense_total = dense_total + dense_bytes
            if mode == MODE_DENSE:
                wire_total = wire_total + dense_bytes
                out[name] = node_mean(g_nodes)
                continue
            if mode == MODE_TOPK_EF:
                out[name], state[name] = topk_error_feedback(
                    node_mean(g_nodes), state.get(name), policy.topk_frac)
                k = max(1, int(policy.topk_frac * size))
                # every node ships (int32 index, f32 value) per kept element
                wire_total = wire_total + float(n * (8 * k + wire.HEADER_BYTES))
                continue
            g_hat, wires = [], None
            for w in range(n):
                gh, nbytes, _ = compress_leaf(
                    g_nodes[w], self.pack_noise(key, step, name, (w,),
                                                tuple(g_nodes.shape[1:])),
                    mode, policy)
                g_hat.append(gh)
                b = _as_f32(nbytes)
                wires = b if wires is None else wires + b
            wire_total = wire_total + wires
            out[name] = node_mean(g_hat)
        zero = torch.zeros_like(wire_total)
        return out, ReducerTelemetry(
            wire_bytes=wire_total, dense_bytes=dense_total, error_bound=zero,
            wire_ici_bytes=zero, wire_dcn_bytes=zero, peak_dcn_bytes=zero,
            n_hops=n, packs_per_segment=1, per_pod=n), state


_SIM_FNS = {
    TOPO_RING: ring_mod.ring_allreduce_nsd,
    TOPO_HIER: hier_mod.hier_allreduce_nsd,
    TOPO_BUTTERFLY: bfly_mod.butterfly_allreduce_nsd,
}


class _AllReduceReducer(Reducer):
    """ring, hier or butterfly over stacked (n_nodes, ...) gradients: every
    compressible leaf through the topology's compressed all-reduce (its
    wire format is packed NSD, so int8 and topk_ef leaves travel as nsd).
    Dense leaves average exactly, with the same topology's dense bytes as
    both wire and dense bytes."""

    def __init__(self, policy: CommPolicy, n_nodes: int = 1):
        super().__init__(policy, n_nodes)
        self.topology = policy.topology
        if self.topology == TOPO_RING:
            self.cfg = ring_mod.RingConfig(s=policy.s)
        elif self.topology == TOPO_HIER:
            self.cfg = hier_mod.HierConfig(pods=policy.pods, s=policy.s)
        else:
            self.cfg = bfly_mod.ButterflyConfig(pods=policy.pods, s=policy.s)
        if self.topology != TOPO_RING and n_nodes % policy.pods != 0:
            raise ValueError(
                f"n_nodes ({n_nodes}) must be divisible by policy.pods "
                f"({policy.pods}) for the {self.topology!r} topology")

    def _topo_dense_bytes(self, size: int) -> int:
        n, pods = self.n_nodes, self.policy.pods
        if self.topology == TOPO_HIER:
            return hier_mod.dense_reduce_bytes(size, pods, n // pods)
        if self.topology == TOPO_BUTTERFLY:
            return bfly_mod.dense_reduce_bytes(size, pods, n // pods)
        return ring_mod.dense_reduce_bytes(size, n)

    def _reduce(self, grads, key, step, state):
        n = self.n_nodes
        zero = _zeros(grads)
        wire_b = dense_b = bound = ici = dcn = peak = zero
        n_hops = packs = 0
        pods, per_pod = 1, 1
        out = {}
        for name, g_nodes in sorted(grads.items()):
            size = g_nodes.numel() // n
            if self.policy.mode_for(name, size) == MODE_DENSE:
                db = float(self._topo_dense_bytes(size))
                wire_b = wire_b + db
                dense_b = dense_b + db
                out[name] = node_mean(g_nodes)
                continue

            def noise(*args, name=name):
                return self.pack_noise(key, step, name, args[:-1], args[-1])

            out[name], tele = _SIM_FNS[self.topology](
                g_nodes, hop_key(key, step, name_salt(name)), self.cfg,
                noise=noise)
            wire_b = wire_b + tele.wire_bytes
            dense_b = dense_b + tele.dense_bytes
            bound = torch.maximum(bound, tele.error_bound)
            if self.topology != TOPO_RING:
                ici = ici + tele.wire_ici_bytes
                dcn = dcn + tele.wire_dcn_bytes
                peak = peak + tele.peak_dcn_bytes
                pods = max(pods, tele.pods)
                per_pod = max(per_pod, tele.per_pod)
            else:
                per_pod = max(per_pod, n)
            n_hops += tele.n_hops
            packs = max(packs, tele.packs_per_segment)
        return out, ReducerTelemetry(
            wire_bytes=wire_b, dense_bytes=dense_b, error_bound=bound,
            wire_ici_bytes=ici, wire_dcn_bytes=dcn, peak_dcn_bytes=peak,
            n_hops=n_hops, packs_per_segment=packs, pods=pods,
            per_pod=per_pod), state


def reducer(policy: CommPolicy, *, n_nodes: int = 1) -> Reducer:
    """The Reducer a CommPolicy selects, over (n_nodes, ...) leaves; with
    ``policy.bucket_bytes > 0`` wrapped in the overlap scheduler, whose
    result is the blocking reduce's bit for bit."""
    if policy.topology == TOPO_PS:
        red = _StackedPSReducer(policy, n_nodes)
    else:
        red = _AllReduceReducer(policy, n_nodes)
    if policy.bucket_bytes > 0:
        from repro_torch.comm.overlap import OverlapReducer
        red = OverlapReducer(red, policy.bucket_bytes)
    return red
