"""Two-level compressed all-reduce: an intra-pod NSD ring and an inter-pod
binomial tree.

Counterpart of the simulation in ``repro.comm.hierarchy`` (``tree_rounds``,
``HierConfig``, ``HierTelemetry``, ``dense_reduce_bytes``,
``hier_allreduce_nsd``, ``allreduce_hier``). The flat ring re-dithers each
segment N - 1 times; real deployments are not flat: nodes in a pod share a
fast axis (ICI) and pods talk over a slow one (DCN). For N = G pods of P
nodes:

  phase 1  intra-pod ring reduce-scatter: P - 1 hops over ICI, re-dithered
           per hop as in the flat ring. Node (g, p) ends up owning segment
           c = (p + 1) mod P of pod g's partial sum.
  phase 2  inter-pod binomial-tree reduce: ceil(log2 G) rounds over DCN; in
           round r the owner in pod g with g mod 2^(r+1) == 2^r packs its
           partial and sends it to pod g - 2^r, which adds it.
  phase 3  the root pod's owner packs the finished segment once; the pack
           goes back down the tree verbatim (G - 1 DCN hops) ...
  phase 4  ... and around each pod's ring (P - 1 ICI hops a pod), so every
           node reconstructs the same value.

A segment crosses (P - 1) + ceil(log2 G) + 1 sequential packs (the flat
ring: N), and the error bound sums the Deltas of every pack that lands in
it, divided by N. Telemetry splits the measured wire bytes by link class
and records ``peak_dcn_bytes``, the busiest pod's DCN line (sent plus
received), which the butterfly (``repro_torch.comm.butterfly``) cuts.

:func:`hier_allreduce_nsd` simulates the nodes on one device. Every pack
is one NSD and one wire compact launch and every unpack one wire expand
launch (``repro_torch.quant.wire``). :func:`make_hier_allreduce` (the
reference's shard_map program over a (pods, nodes) mesh) runs one node per
process over a :class:`repro_torch.launch.mesh.NodeMesh`: the ring hops
within a pod, the tree's hops between the same node index of two pods.
Only a rank whose pack crosses a link makes it (the reference's SPMD
program packs on every device and sends zeros from the others): per
compressed leaf a rank packs P times and unpacks P - 1 + P times, plus
once per tree round in which it receives. Its mean and telemetry are the
simulation's bit for bit.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.comm.reduce_base import (Ledger, hop_key, pack_table,
                                          record_table, ring_shares, seg_len,
                                          segment)
from repro_torch.quant import wire

_INTRA_SALT = 0x1C1A  # intra-pod ring reduce-scatter packs
_TREE_UP_SALT = 0x7EE0  # inter-pod tree-reduce packs
_TREE_DOWN_SALT = 0xB0AD  # the single broadcast pack per segment

# noise(salt, *indices, shape) -> what one pack dithers with: its stream key
# (by default hop_key(key, salt, *indices)) or a unit draw of ``shape``
HopNoise = Callable[..., Union[int, torch.Tensor]]


def tree_rounds(pods: int) -> int:
    """ceil(log2(pods)): rounds of the binomial tree over the pod axis."""
    return (pods - 1).bit_length() if pods > 1 else 0


@dataclasses.dataclass(frozen=True)
class HierConfig:
    """Two-level reduce: N nodes = pods x (N // pods)."""

    pods: int = 2
    s: float = 1.0  # NSD scale of the on-wire quantization

    def __post_init__(self):
        if self.pods < 1:
            raise ValueError(f"pods must be >= 1, got {self.pods}")


class HierTelemetry(NamedTuple):
    """A reduce's accounting with the split by link class."""

    wire_bytes: torch.Tensor  # f32 0-d: total bytes crossing all links
    dense_bytes: torch.Tensor  # f32 0-d: the same exchange at dense f32
    error_bound: torch.Tensor  # f32 0-d: max pointwise |result - mean| bound
    n_hops: int  # total link traversals (both classes)
    packs_per_segment: int  # sequential re-quantizations
    wire_ici_bytes: torch.Tensor  # f32 0-d: intra-pod (fast axis) bytes
    wire_dcn_bytes: torch.Tensor  # f32 0-d: inter-pod (slow axis) bytes
    pods: int = 1  # G
    per_pod: int = 1  # P
    # f32 0-d: the most DCN bytes through one pod's line (sent + received)
    peak_dcn_bytes: Union[torch.Tensor, float] = 0.0

    @property
    def ratio(self) -> torch.Tensor:
        return self.wire_bytes / torch.clamp(self.dense_bytes, min=1.0)


def _hier_shape(n: int, pods: int) -> Tuple[int, int]:
    if n % pods != 0:
        raise ValueError(
            f"node count ({n}) must be divisible by the pod count ({pods}); "
            "ragged pods would leave some gradients out of the reduce")
    return pods, n // pods


def _zero_telemetry(device) -> HierTelemetry:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return HierTelemetry(zero, zero, zero, 0, 0, zero, zero, 1, 1, zero)


def _hop_counts(g: int, p: int) -> Tuple[int, int]:
    """(ici segment-hops, dcn segment-hops) of the whole exchange."""
    ici = 2 * g * p * (p - 1)  # reduce-scatter + gather forwarding
    dcn = 2 * p * (g - 1)  # tree up + tree down, per segment owner line
    return ici, dcn


def dense_reduce_bytes(size: int, pods: int, per_pod: int) -> int:
    """Bytes the same two-level exchange would move at dense f32."""
    ici, dcn = _hop_counts(pods, per_pod)
    return (ici + dcn) * seg_len(size, per_pod, wire.DEFAULT_CHUNK) * 4


def _default_noise(key: int) -> HopNoise:
    def noise(*args):
        return hop_key(key, *args[:-1])
    return noise


def intra_ledger(led: Ledger, G: int, Pn: int) -> None:
    """Phase 1's charges: each pod's ring packs over one ICI hop, in (hop,
    pod, node) order."""
    for step in range(Pn - 1):
        for g in range(G):
            for p in range(Pn):
                led.charge((_INTRA_SALT, step, g, p),
                           seg=ring_shares(p, Pn, step)[0], link="ici")


def hier_ledger(G: int, Pn: int) -> Ledger:
    """The hierarchy's accounting in the simulation's order: phase 1, the
    tree's packs (round, pod, segment), then each segment's broadcast pack
    over G - 1 DCN and G (P - 1) ICI hops, with its line traffic down the
    tree."""
    led = Ledger()
    intra_ledger(led, G, Pn)
    rounds = tree_rounds(G)
    for r in range(rounds):
        stride = 1 << r
        for g in range(G):
            if g % (2 * stride) != stride:
                continue
            for c in range(Pn):
                pid = (_TREE_UP_SALT, r, g, c)
                led.charge(pid, seg=c, link="dcn")
                led.line(pid, g, g - stride)
    for c in range(Pn):
        pid = (_TREE_DOWN_SALT, 0, 0, c)
        led.charge(pid, seg=c, link="dcn", hops=G - 1)
        led.charge(pid, link="ici", hops=G * (Pn - 1))
        for r in range(rounds - 1, -1, -1):
            stride = 1 << r
            for src in range(0, G, 2 * stride):
                if src + stride < G:
                    led.line(pid, src, src + stride)
    return led


def two_level_telemetry(led: Ledger, table, table_dev, G: int, Pn: int,
                        size: int, dense_bytes: int, n_hops: int, dev
                        ) -> HierTelemetry:
    """A two-level reduce's telemetry from its ledger and a pack table on
    ``table_dev`` (the simulation's packs on the device, a process
    reduce's gathered records on the CPU), on ``dev``."""
    n = G * Pn
    ctr, traffic = led.replay(table, Pn, G, table_dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dense = torch.full((), float(dense_bytes), dtype=torch.float32, device=dev)
    return HierTelemetry(
        wire_bytes=ctr.wire_total.to(dev), dense_bytes=dense,
        error_bound=ctr.bound.to(dev).max() / n, n_hops=n_hops,
        packs_per_segment=(Pn - 1) + tree_rounds(G) + 1,
        wire_ici_bytes=ctr.wire["ici"].to(dev),
        wire_dcn_bytes=ctr.wire["dcn"].to(dev), pods=G, per_pod=Pn,
        peak_dcn_bytes=torch.stack(traffic).max().to(dev) if G > 1 else zero)


def intra_reduce_scatter(grads: torch.Tensor, G: int, Pn: int, s: float,
                         noise: HopNoise, packs: dict
                         ) -> Tuple[List[List[torch.Tensor]], int]:
    """Phase 1 (the hierarchy's and the butterfly's): each pod's ring
    reduce-scatter of the (N, size) f32 gradients, pod-major; its packs go
    into ``packs`` by id. Returns ``part[g][c]``, pod g's sum of segment c
    as its owner (c - 1) % P holds it, and the segment length. All packs
    of a hop read the accumulators as the hop before left them."""
    # acc[g * Pn + p, c]: node (g, p)'s value of its pod's segment c
    acc, seg = segment(grads, Pn, wire.DEFAULT_CHUNK)
    for step in range(Pn - 1):
        packed = []
        for g in range(G):
            for p in range(Pn):
                c = ring_shares(p, Pn, step)[0]
                pid = (_INTRA_SALT, step, g, p)
                packs[pid] = pk = wire.pack_nsd(acc[g * Pn + p, c],
                                                noise(*pid, (seg,)), s)
                packed.append((g, p, c, pk))
        for g, p, c, pk in packed:
            acc[g * Pn + (p + 1) % Pn, c] += wire.unpack_nsd(pk)
    return [[acc[g * Pn + (c - 1) % Pn, c] for c in range(Pn)]
            for g in range(G)], seg


def hier_allreduce_nsd(grads: torch.Tensor, key: int,
                       cfg: HierConfig = HierConfig(), *,
                       noise: Optional[HopNoise] = None
                       ) -> Tuple[torch.Tensor, HierTelemetry]:
    """Simulated two-level compressed all-reduce of N stacked gradients.

    grads: (N, *shape), pod-major (node i lives in pod i // per_pod);
    ``key`` the reduce's stream key. Pack (salt, a, b, c) dithers with
    ``noise(salt, a, b, c, shape)``, by default the stream key
    ``hop_key(key, salt, a, b, c)``: (INTRA_SALT, hop, pod, node),
    (TREE_UP_SALT, round, pod, segment), (TREE_DOWN_SALT, 0, 0, segment).
    Returns (mean over nodes, telemetry). N == 1 returns the one gradient
    (no wire).
    """
    n = grads.shape[0]
    shape, dtype, dev = grads.shape[1:], grads.dtype, grads.device
    if n == 1:
        return grads[0], _zero_telemetry(dev)
    G, Pn = _hier_shape(n, cfg.pods)
    if noise is None:
        noise = _default_noise(key)
    flat = grads.to(torch.float32).reshape(n, -1)
    size = flat.shape[1]
    packs = {}
    part, seg = intra_reduce_scatter(flat, G, Pn, cfg.s, noise, packs)

    # phase 2: inter-pod binomial tree reduce (a pack per combine)
    rounds = tree_rounds(G)
    for r in range(rounds):
        stride = 1 << r
        for g in range(G):
            if g % (2 * stride) != stride:
                continue
            dst = g - stride
            for c in range(Pn):
                pid = (_TREE_UP_SALT, r, g, c)
                packs[pid] = pk = wire.pack_nsd(part[g][c],
                                                noise(*pid, (seg,)), cfg.s)
                part[dst][c] = part[dst][c] + wire.unpack_nsd(pk)

    # phases 3 and 4: the root packs once; the pack goes down the tree (G - 1
    # DCN hops) and around each pod's ring (P - 1 ICI hops a pod) verbatim
    finals = []
    for c in range(Pn):
        pid = (_TREE_DOWN_SALT, 0, 0, c)
        packs[pid] = pk = wire.pack_nsd(part[0][c], noise(*pid, (seg,)), cfg.s)
        finals.append(wire.unpack_nsd(pk))

    total = torch.cat(finals)
    mean = (total[:size] / n).reshape(shape).to(dtype)
    return mean, _telemetry(pack_table(packs), dev, G, Pn, size, dev)


def _telemetry(table, table_dev, G: int, Pn: int, size: int, dev
               ) -> HierTelemetry:
    ici_hops, dcn_hops = _hop_counts(G, Pn)
    return two_level_telemetry(hier_ledger(G, Pn), table, table_dev, G, Pn,
                               size, dense_reduce_bytes(size, G, Pn),
                               ici_hops + dcn_hops, dev)


def _mesh_axes(mesh, pods: int, pod_axis: str, node_axis: str
               ) -> Tuple[int, int]:
    """(G, P) of a 2-D (pod, node) mesh of ``pods`` pods; a real error
    when an axis is missing or the pod counts differ."""
    missing = [a for a in (pod_axis, node_axis) if a not in mesh.shape]
    if missing:
        raise ValueError(
            f"hierarchical reduce needs a 2-D ({pod_axis!r}, {node_axis!r}) "
            f"mesh; this mesh has axes {tuple(mesh.shape)} (missing "
            f"{missing}); build one with repro_torch.launch.mesh."
            f"make_node_mesh(NodeTopology(pods=..., nodes_per_pod=...))")
    if pods != mesh.shape[pod_axis]:
        raise ValueError(f"pods ({pods}) != mesh {pod_axis!r} axis size "
                         f"({mesh.shape[pod_axis]})")
    return mesh.shape[pod_axis], mesh.shape[node_axis]


def mesh_phase1(flat: torch.Tensor, mesh, g: int, me: int, Pn: int, s: float,
                noise: HopNoise, ex) -> Tuple[torch.Tensor, int]:
    """Phase 1 on rank (g, me): its pod's ring reduce-scatter over point to
    point hops. Returns its (P, seg) accumulators (segment (me + 1) % P
    finished) and seg."""
    acc, seg = segment(flat, Pn, wire.DEFAULT_CHUNK)
    right, left = mesh.rank_of(g, (me + 1) % Pn), mesh.rank_of(g, (me - 1) % Pn)
    for step in range(Pn - 1):
        c_send, c_recv = ring_shares(me, Pn, step)
        pid = (_INTRA_SALT, step, g, me)
        pk = wire.pack_nsd(acc[c_send], noise(*pid, (seg,)), s)
        (pk_in,) = ex.swap([(right, pid, pk)],
                           [(left, (_INTRA_SALT, step, g, (me - 1) % Pn), (seg,))])
        acc[c_recv] += wire.unpack_nsd(pk_in)
    return acc, seg


def ring_forward(ex, mesh, g: int, me: int, Pn: int, own: list, salt: int,
                 idx: Tuple[int, ...], shapes, unpack) -> list:
    """Phase 4 on rank (g, me): the finished packs of segment (me + 1) % P
    (``own``, ids ``(salt, *idx[i], segment)``) ride around the pod ring
    verbatim; returns each segment's ``unpack(packs)``, in segment order."""
    right, left = mesh.rank_of(g, (me + 1) % Pn), mesh.rank_of(g, (me - 1) % Pn)
    c_own = (me + 1) % Pn
    out = [None] * Pn
    out[c_own] = unpack(own)
    cur, c_cur = own, c_own
    for h in range(1, Pn):
        c = (me - h + 1) % Pn  # what the left neighbour held a hop ago
        cur = ex.swap([(right, (salt, *i, c_cur), pk) for i, pk in zip(idx, cur)],
                      [(left, (salt, *i, c), shp) for i, shp in zip(idx, shapes)])
        c_cur = c
        out[c] = unpack(cur)
    return out


def hier_share(local: torch.Tensor, key: int, mesh, cfg: HierConfig, ex,
               noise: Optional[HopNoise] = None, pod_axis: str = "pods",
               node_axis: str = "nodes"
               ) -> Tuple[torch.Tensor, Callable[[dict], HierTelemetry]]:
    """Rank (pod, node)'s share of the two-level reduce over ``mesh``, its
    hops through ``ex`` under ``ex.scope``.

    ``local`` is this rank's own gradient; ``key`` and ``noise`` as in
    :func:`hier_allreduce_nsd`. Returns its mean, bit for bit on every
    rank, and ``tele(records)`` (as ``ring.ring_share``).
    """
    G, Pn = _mesh_axes(mesh, cfg.pods, pod_axis, node_axis)
    shape, dtype, dev = local.shape, local.dtype, local.device
    n = G * Pn
    if n == 1:
        return local, lambda records: _zero_telemetry(dev)
    if noise is None:
        noise = _default_noise(key)
    g, me = mesh.pod, mesh.node
    flat = local.to(torch.float32).reshape(-1)
    size = flat.shape[0]
    scope = ex.scope
    acc, seg = mesh_phase1(flat, mesh, g, me, Pn, cfg.s, noise, ex)
    c_own = (me + 1) % Pn
    part = acc[c_own]

    # phase 2: the tree up over the pod axis, node index me of each pod
    rounds = tree_rounds(G)
    for r in range(rounds):
        stride = 1 << r
        if g % (2 * stride) == stride:
            pid = (_TREE_UP_SALT, r, g, c_own)
            pk = wire.pack_nsd(part, noise(*pid, (seg,)), cfg.s)
            ex.swap([(mesh.rank_of(g - stride, me), pid, pk)], [])
        elif g % (2 * stride) == 0 and g + stride < G:
            (pk_in,) = ex.swap([], [(mesh.rank_of(g + stride, me),
                                     (_TREE_UP_SALT, r, g + stride, c_own),
                                     (seg,))])
            part = part + wire.unpack_nsd(pk_in)

    # phase 3: pod 0 packs the finished segment; down the tree the
    # receivers adopt the pack
    pid = (_TREE_DOWN_SALT, 0, 0, c_own)
    pk = wire.pack_nsd(part, noise(*pid, (seg,)), cfg.s) if g == 0 else None
    for r in range(rounds - 1, -1, -1):
        stride = 1 << r
        if g % (2 * stride) == 0 and g + stride < G:
            ex.swap([(mesh.rank_of(g + stride, me), pid, pk)], [])
        elif g % (2 * stride) == stride:
            (pk,) = ex.swap([], [(mesh.rank_of(g - stride, me), pid, (seg,))])

    # phase 4: the final pack around the pod ring
    out = ring_forward(ex, mesh, g, me, Pn, [pk], _TREE_DOWN_SALT, [(0, 0)],
                       [(seg,)], lambda pks: wire.unpack_nsd(pks[0]))
    total = torch.cat(out)
    mean = (total[:size] / n).reshape(shape).to(dtype)
    return mean, lambda records: _telemetry(
        record_table(records.get(scope, {})), "cpu", G, Pn, size, dev)


def hier_allreduce_mesh(local: torch.Tensor, key: int, mesh,
                        cfg: HierConfig = HierConfig(), *,
                        noise: Optional[HopNoise] = None,
                        pod_axis: str = "pods", node_axis: str = "nodes"
                        ) -> Tuple[torch.Tensor, HierTelemetry]:
    """:func:`hier_share` on an exchange of its own: this rank's mean and
    telemetry, bit for bit on every rank."""
    from repro_torch.comm.p2p import Exchange

    _mesh_axes(mesh, cfg.pods, pod_axis, node_axis)  # before any exchange
    ex = Exchange(mesh, local.device)
    mean, tele = hier_share(local, key, mesh, cfg, ex, noise, pod_axis,
                            node_axis)
    return mean, tele(ex.records())


def make_hier_allreduce(mesh, cfg: HierConfig = HierConfig(),
                        pod_axis: str = "pods", node_axis: str = "nodes"):
    """Deprecated, as in the reference: reduces go through
    ``repro_torch.comm.reducer(policy, mesh)``. ``fn(local, key, *,
    noise=None) -> (mean, telemetry)``, this rank's share of the two-level
    reduce over ``mesh`` (checked here against ``cfg``)."""
    warnings.warn("make_hier_allreduce is deprecated; use "
                  "repro_torch.comm.reducer(policy, mesh)",
                  DeprecationWarning, stacklevel=2)
    _mesh_axes(mesh, cfg.pods, pod_axis, node_axis)

    def fn(local, key, *, noise=None):
        return hier_allreduce_mesh(local, key, mesh, cfg, noise=noise,
                                   pod_axis=pod_axis, node_axis=node_axis)

    return fn


def allreduce_hier(grads: torch.Tensor, key: int,
                   cfg: HierConfig = HierConfig(), mesh=None,
                   pod_axis: str = "pods", node_axis: str = "nodes"
                   ) -> Tuple[torch.Tensor, HierTelemetry]:
    """Deprecated, as in the reference: reduces go through
    ``repro_torch.comm.reducer``. Without a mesh, the simulation of the
    stacked (N, ...) ``grads``; with one, this rank's share of the process
    reduce, ``grads`` being this rank's own gradient."""
    warnings.warn("allreduce_hier is deprecated; use "
                  "repro_torch.comm.reducer(policy, ...)",
                  DeprecationWarning, stacklevel=2)
    if mesh is not None:
        return hier_allreduce_mesh(grads, key, mesh, cfg, pod_axis=pod_axis,
                                   node_axis=node_axis)
    return hier_allreduce_nsd(grads, key, cfg)
