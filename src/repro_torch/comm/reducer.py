"""One front door for the compressed gradient reduces.

Counterpart of ``repro.comm.reducer``:

    red = comm.reducer(policy, n_nodes=N)          # N nodes in one process
    red = comm.reducer(policy, mesh)               # one node per process
    grads_mean, telemetry, state = red.reduce(grads, key, step, state)

* ``grads`` is a dict of gradient leaves keyed by the reference's parameter
  names (``fc0_w``, ``c3_w``, ``bn2_g``, ...). Without a mesh each has a
  leading (n_nodes, ...) axis (one node is the degenerate case) and the
  reduce simulates the nodes in turn; with a
  :class:`repro_torch.launch.mesh.NodeMesh` each is this rank's own leaf,
  and the rank runs its share of the reduce over ``torch.distributed``
  (``ring``, ``hier`` and ``butterfly`` through their process reduces,
  ``ps`` and dense leaves through gathers), ending with the simulation's
  mean and telemetry bit for bit. Leaves are visited in sorted name order,
  the order the reference flattens its dicts in, so the f32 byte totals
  add up in its order.
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
single-participant reducer over unstacked leaves without a mesh (the SSGD
step always stacks; ROADMAP.md section 1, item 7.5).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.comm import butterfly as bfly_mod
from repro_torch.comm import hierarchy as hier_mod
from repro_torch.comm import ring as ring_mod
from repro_torch.comm import telemetry as comm_tele
from repro_torch.comm.compression import (MODE_DENSE, MODE_NSD, MODE_TOPK_EF,
                                          TOPO_BUTTERFLY, TOPO_HIER, TOPO_PS,
                                          TOPO_RING, CommPolicy,
                                          ErrorFeedbackState, _as_f32,
                                          compress_leaf, init_comm_state,
                                          topk_error_feedback)
from repro_torch.comm.p2p import Exchange
from repro_torch.comm.reduce_base import hop_key, node_mean
from repro_torch.core import nsd
from repro_torch.core.policy import name_salt
from repro_torch.quant import codecs as qc
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

    def __init__(self, policy: CommPolicy, n_nodes: int = 1, mesh=None,
                 pod_axis: str = "pods", node_axis: str = "nodes"):
        self.policy = policy
        self.n_nodes = int(n_nodes)
        self.mesh, self.pod_axis, self.node_axis = mesh, pod_axis, node_axis

    def init_state(self, params_or_grads: Dict[str, torch.Tensor]
                   ) -> Dict[str, ErrorFeedbackState]:
        """Zero EF residuals for the leaves the policy routes through
        topk_ef, shaped like a leaf (not the node axis; a mesh reducer's
        leaves are already one node's)."""
        if self.mesh is None:
            params_or_grads = {n: g[0] for n, g in params_or_grads.items()}
        return init_comm_state(params_or_grads, self.policy)

    def _leaf_size(self, g: torch.Tensor) -> int:
        """Elements of one node's leaf."""
        return g.numel() if self.mesh is not None else g.numel() // self.n_nodes

    def _nodes(self, g: torch.Tensor, ex: Optional[Exchange]):
        """The n nodes' leaves, in node order: the stack's rows, or every
        rank's leaf gathered over the mesh."""
        return ex.all_gather(g) if ex is not None else g

    def _exchange(self, grads) -> Optional[Exchange]:
        if self.mesh is None:
            return None
        return Exchange(self.mesh, next(iter(grads.values())).device)

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
        ex = self._exchange(grads)
        wire_total, dense_total = _zeros(grads), _zeros(grads)
        out = {}
        for name, g_nodes in sorted(grads.items()):
            size = self._leaf_size(g_nodes)
            shape = tuple(g_nodes.shape[1:] if ex is None else g_nodes.shape)
            mode = policy.mode_for(name, size)
            dense_bytes = float(4 * size * n)
            dense_total = dense_total + dense_bytes
            if mode == MODE_DENSE:
                wire_total = wire_total + dense_bytes
                out[name] = node_mean(self._nodes(g_nodes, ex))
                continue
            if mode == MODE_TOPK_EF:
                out[name], state[name] = topk_error_feedback(
                    node_mean(self._nodes(g_nodes, ex)), state.get(name),
                    policy.topk_frac)
                k = max(1, int(policy.topk_frac * size))
                # every node ships (int32 index, f32 value) per kept element
                wire_total = wire_total + float(n * (8 * k + wire.HEADER_BYTES))
                continue
            if ex is None:
                comp = [compress_leaf(g_nodes[w], self.pack_noise(
                            key, step, name, (w,), shape), mode, policy)[:2]
                        for w in range(n)]
            else:
                comp = self._mesh_compress(ex, name, g_nodes, key, step, mode)
            wires = None
            for _, nbytes in comp:
                b = _as_f32(nbytes)
                wires = b if wires is None else wires + b
            wire_total = wire_total + wires
            out[name] = node_mean([gh for gh, _ in comp])
        zero = torch.zeros_like(wire_total)
        return out, ReducerTelemetry(
            wire_bytes=wire_total, dense_bytes=dense_total, error_bound=zero,
            wire_ici_bytes=zero, wire_dcn_bytes=zero, peak_dcn_bytes=zero,
            n_hops=n, packs_per_segment=1, per_pod=n), state

    def _mesh_compress(self, ex: Exchange, name: str, g: torch.Tensor,
                       key: int, step: int, mode: str):
        """Every node's (g_hat, wire bytes) of leaf ``name`` over the mesh:
        this rank compresses its own leaf with its (leaf, worker) key and
        the ranks swap what crosses the wire, nsd packs point to point (two
        messages each, ``repro_torch.comm.p2p``), int8 codes and Delta by
        an all-gather; every rank decodes the n of them in node order."""
        me, n, ranks = self.mesh.index, self.n_nodes, self.mesh.ranks
        noise = self.pack_noise(key, step, name, (me,), tuple(g.shape))
        if mode == MODE_NSD:
            p = wire.pack_nsd(g, noise, self.policy.s)
            others = [w for w in range(n) if w != me]
            got = ex.swap([(ranks[w], (me,), p) for w in others],
                          [(ranks[w], (w,), tuple(g.shape)) for w in others],
                          dtype=g.dtype)
            packs = dict(zip(others, got))
            packs[me] = p
            return [(wire.unpack_nsd(packs[w]), packs[w].wire_bytes())
                    for w in range(n)]
        # int8: the dense int8 codes and the f32 Delta cross
        q = qc.nsd_int8(g, noise, self.policy.s)
        codes = ex.all_gather(torch.cat([q.k.reshape(-1).view(torch.uint8),
                                         q.delta.reshape(1).view(torch.uint8)]))
        nbytes = g.numel() + 4 + wire.HEADER_BYTES
        return [(nsd.QuantizedGrad(
                    k=c[:g.numel()].view(torch.int8).reshape(g.shape),
                    delta=c[g.numel():].clone().view(torch.float32).reshape(()))
                 .dequantize(g.dtype), nbytes) for c in codes]


_SIM_FNS = {
    TOPO_RING: ring_mod.ring_allreduce_nsd,
    TOPO_HIER: hier_mod.hier_allreduce_nsd,
    TOPO_BUTTERFLY: bfly_mod.butterfly_allreduce_nsd,
}
# this rank's share over a mesh: fn(local, key, mesh, cfg, ex, noise, ...)
# -> (mean, tele(records)), the simulation's bit for bit once the records of
# the reduce's one exchange are gathered
_MESH_FNS = {
    TOPO_RING: ring_mod.ring_share,
    TOPO_HIER: hier_mod.hier_share,
    TOPO_BUTTERFLY: bfly_mod.butterfly_share,
}


class _AllReduceReducer(Reducer):
    """ring, hier or butterfly over stacked (n_nodes, ...) gradients, or
    over a mesh each rank's own: every compressible leaf through the
    topology's compressed all-reduce (its wire format is packed NSD, so
    int8 and topk_ef leaves travel as nsd). Dense leaves average exactly
    (over a mesh, the gathered leaves in rank order), with the same
    topology's dense bytes as both wire and dense bytes."""

    def __init__(self, policy: CommPolicy, n_nodes: int = 1, mesh=None,
                 pod_axis: str = "pods", node_axis: str = "nodes"):
        super().__init__(policy, n_nodes, mesh, pod_axis, node_axis)
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
        if mesh is not None and self.topology != TOPO_RING:
            hier_mod._mesh_axes(mesh, policy.pods, pod_axis, node_axis)

    def _topo_dense_bytes(self, size: int) -> int:
        n, pods = self.n_nodes, self.policy.pods
        if self.topology == TOPO_HIER:
            return hier_mod.dense_reduce_bytes(size, pods, n // pods)
        if self.topology == TOPO_BUTTERFLY:
            return bfly_mod.dense_reduce_bytes(size, pods, n // pods)
        return ring_mod.dense_reduce_bytes(size, n)

    def _allreduce(self, g, k0, noise, ex: Optional[Exchange]):
        """(mean, tele(records)) of one compressed leaf: the simulation's
        telemetry as it is, or this rank's share's, replayed from the
        records of ``ex`` (gathered once, after the reduce's last leaf)."""
        if ex is None:
            mean, tele = _SIM_FNS[self.topology](g, k0, self.cfg, noise=noise)
            return mean, lambda records: tele
        axes = (() if self.topology == TOPO_RING else
                (self.pod_axis, self.node_axis))
        return _MESH_FNS[self.topology](g, k0, self.mesh, self.cfg, ex,
                                        noise, *axes)

    def _reduce(self, grads, key, step, state):
        n = self.n_nodes
        ex = self._exchange(grads)
        # per leaf in name order: its dense bytes, or its telemetry's replay
        parts = []
        out = {}
        for name, g_nodes in sorted(grads.items()):
            size = self._leaf_size(g_nodes)
            if self.policy.mode_for(name, size) == MODE_DENSE:
                parts.append(float(self._topo_dense_bytes(size)))
                out[name] = node_mean(self._nodes(g_nodes, ex))
                continue

            def noise(*args, name=name):
                return self.pack_noise(key, step, name, args[:-1], args[-1])

            if ex is not None:
                ex.scope = name
            out[name], tele_of = self._allreduce(
                g_nodes, hop_key(key, step, name_salt(name)), noise, ex)
            parts.append(tele_of)

        records = (ex.records() if ex is not None and any(map(callable, parts))
                   else {})
        zero = _zeros(grads)
        wire_b = dense_b = bound = ici = dcn = peak = zero
        n_hops = packs = 0
        pods, per_pod = 1, 1
        for part in parts:
            if isinstance(part, float):
                wire_b = wire_b + part
                dense_b = dense_b + part
                continue
            tele = part(records)
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


def _mesh_size(mesh, pod_axis: str, node_axis: str) -> int:
    """The mesh's data-parallel extent: pod axis x node axis."""
    n = int(mesh.shape[node_axis])
    if pod_axis in mesh.shape:
        n *= int(mesh.shape[pod_axis])
    return n


def reducer(policy: CommPolicy, mesh=None, *, n_nodes: Optional[int] = None,
            stacked: Optional[bool] = None, pod_axis: str = "pods",
            node_axis: str = "nodes") -> Reducer:
    """The Reducer a CommPolicy selects; with ``policy.bucket_bytes > 0``
    wrapped in the overlap scheduler, whose result is the blocking reduce's
    bit for bit.

    Without ``mesh`` it reduces stacked (n_nodes, ...) leaves (``n_nodes``
    defaults to 1) in one process. With a
    :class:`repro_torch.launch.mesh.NodeMesh` each rank hands it its own
    leaves: ``n_nodes`` defaults to the mesh's extent (pods x nodes) and
    must equal it, ``stacked=True`` raises (a mesh reduce never takes a
    stack), and ``hier`` / ``butterfly`` need the mesh's pod axis at
    ``policy.pods``. ``stacked=False`` names the reference's flat
    single-participant reducer, which is not ported: it raises, with or
    without a mesh.
    """
    if stacked is False:
        raise NotImplementedError(
            "stacked=False selects the reference's flat single-participant "
            "reducer, which is not ported (ROADMAP.md section 1, item 7.5); "
            "pass stacked (n_nodes, ...) leaves, or each rank's own leaves "
            "with a mesh")
    if mesh is not None:
        extent = _mesh_size(mesh, pod_axis, node_axis)
        if n_nodes is None:
            n_nodes = extent
        if n_nodes != extent:
            raise ValueError(
                f"n_nodes ({n_nodes}) != the mesh's extent ({extent}): a "
                "mismatched mesh would leave gradients out of the reduce")
        if stacked:
            raise ValueError("a mesh reduce takes each rank's own leaves, "
                             "not a stack of the nodes' (stacked=True)")
    elif n_nodes is None:
        n_nodes = 1
    if policy.topology == TOPO_PS:
        red = _StackedPSReducer(policy, n_nodes, mesh, pod_axis, node_axis)
    else:
        red = _AllReduceReducer(policy, n_nodes, mesh, pod_axis, node_axis)
    if policy.bucket_bytes > 0:
        from repro_torch.comm.overlap import OverlapReducer
        red = OverlapReducer(red, policy.bucket_bytes)
    return red
