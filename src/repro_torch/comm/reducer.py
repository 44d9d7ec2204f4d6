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
  b)`` for a ring hop; the reference folds the same indices with
  ``jax.random.fold_in``. :meth:`Reducer.pack_noise` is that derivation
  and the one seam: a test that overrides it hands each pack the
  reference's own unit draw, which takes the NSD kernel's fed-noise route.
* ``telemetry`` is one :class:`ReducerTelemetry`; ``state`` carries the
  error-feedback residuals of ``topk_ef`` leaves (node-count independent).
  Under ``collect_stats`` each reduce appends one row to the comm stream
  (``repro_torch.comm.telemetry``).

``hier``, ``butterfly`` and overlap bucketing (``bucket_bytes > 0``) are not
ported: :func:`reducer` raises ``NotImplementedError`` for them
(``ROADMAP.md`` section 1, item 7). Nor is the reference's flat
single-participant reducer over unstacked leaves: the SSGD step always
stacks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.comm import telemetry as comm_tele
from repro_torch.comm.compression import (MODE_DENSE, MODE_TOPK_EF, TOPO_PS,
                                          TOPO_RING, CommPolicy,
                                          ErrorFeedbackState, _as_f32,
                                          compress_leaf, init_comm_state,
                                          topk_error_feedback)
from repro_torch.comm.reduce_base import ReduceTelemetry, hop_key
from repro_torch.comm.ring import (RingConfig, dense_reduce_bytes,
                                   ring_allreduce_nsd)
from repro_torch.core.policy import name_salt
from repro_torch.quant import wire

__all__ = ["Reducer", "ReducerTelemetry", "reducer"]

NOT_PORTED = ("is not ported yet (ROADMAP.md section 1, item 7: hierarchy, "
              "butterfly and overlap)")


# One reduce's accounting, the same fields for every topology (the flat
# ring's); ``error_bound`` reads 0 for ps.
ReducerTelemetry = ReduceTelemetry


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
                out[name] = g_nodes.mean(0)
                continue
            if mode == MODE_TOPK_EF:
                out[name], state[name] = topk_error_feedback(
                    g_nodes.mean(0), state.get(name), policy.topk_frac)
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
            out[name] = torch.stack(g_hat).mean(0)
        return out, ReducerTelemetry(
            wire_bytes=wire_total, dense_bytes=dense_total,
            error_bound=torch.zeros_like(wire_total), n_hops=n,
            packs_per_segment=1), state


class _AllReduceReducer(Reducer):
    """The ring over stacked (n_nodes, ...) gradients: every compressible
    leaf through ``ring_allreduce_nsd`` (its wire format is packed NSD, so
    int8 and topk_ef leaves travel as nsd). Dense leaves average exactly,
    with the dense ring's bytes as both wire and dense bytes."""

    topology = TOPO_RING

    def __init__(self, policy: CommPolicy, n_nodes: int = 1):
        super().__init__(policy, n_nodes)
        self.cfg = RingConfig(s=policy.s)

    def _reduce(self, grads, key, step, state):
        n = self.n_nodes
        wire_total, dense_total = _zeros(grads), _zeros(grads)
        bound = _zeros(grads)
        n_hops = packs = 0
        out = {}
        for name, g_nodes in sorted(grads.items()):
            size = g_nodes.numel() // n
            if self.policy.mode_for(name, size) == MODE_DENSE:
                db = float(dense_reduce_bytes(size, n))
                wire_total = wire_total + db
                dense_total = dense_total + db
                out[name] = g_nodes.mean(0)
                continue

            def noise(salt, a, b, shape, name=name):
                return self.pack_noise(key, step, name, (salt, a, b), shape)

            out[name], tele = ring_allreduce_nsd(
                g_nodes, hop_key(key, step, name_salt(name)), self.cfg,
                noise=noise)
            wire_total = wire_total + tele.wire_bytes
            dense_total = dense_total + tele.dense_bytes
            bound = torch.maximum(bound, tele.error_bound)
            n_hops += tele.n_hops
            packs = max(packs, tele.packs_per_segment)
        return out, ReducerTelemetry(
            wire_bytes=wire_total, dense_bytes=dense_total, error_bound=bound,
            n_hops=n_hops, packs_per_segment=packs), state


def reducer(policy: CommPolicy, *, n_nodes: int = 1) -> Reducer:
    """The Reducer a CommPolicy selects, over (n_nodes, ...) leaves."""
    if policy.topology not in (TOPO_PS, TOPO_RING):
        raise NotImplementedError(f"comm topology {policy.topology!r} "
                                  f"{NOT_PORTED}")
    if policy.bucket_bytes > 0:
        raise NotImplementedError(f"overlap bucketing (bucket_bytes="
                                  f"{policy.bucket_bytes}) {NOT_PORTED}")
    if policy.topology == TOPO_PS:
        return _StackedPSReducer(policy, n_nodes)
    return _AllReduceReducer(policy, n_nodes)
