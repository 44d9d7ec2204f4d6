"""Butterfly (recursive-halving) inter-pod stage of the two-level reduce.

Counterpart of the simulation in ``repro.comm.butterfly``
(``butterfly_rounds``, ``ButterflyConfig``, ``ButterflyTelemetry``,
``_piece_len``, ``butterfly_allreduce_nsd``, ``allreduce_butterfly``). The
hierarchy's binomial tree funnels every segment through pod 0, whose DCN
line carries ceil(log2 G) packs up and the broadcast down. This replaces
its phases 2 and 3, keeping the intra-pod ring (phases 1 and 4) pack for
pack:

  phase 2a  recursive-halving reduce-scatter over the pods: m =
            floor(log2 G) rounds; in round r pod g pairs with g XOR
            2^(m-1-r), keeps the half of its live range that bit (m-1-r)
            of g selects and sends the other half as a fresh pack. After
            m rounds pod g owns piece g of the segment, reduced over the
            pods. A ragged pod count folds pods g >= G2 = 2^m into g - G2
            with one pack before the rounds (the pre-fold) and sends them
            the finished packs after (the post-fold).
  phase 2b  each pod packs its piece once; recursive doubling forwards the
            piece packs verbatim, so every pod ends with the same G2 packs.
  phase 4   the pack set rides around each pod's ring verbatim; every node
            unpacks the same packs.

A segment crosses (P - 1) + ceil(log2 G) + 1 sequential packs, as in the
tree; the busiest DCN line (``peak_dcn_bytes``) carries ~2B(1 - 1/G2) each
way against the tree root's ~2 log2(G) B. With pods == 1 it is the
hierarchy's one-pod path, pack for pack.

:func:`butterfly_allreduce_nsd` simulates the nodes on one device; every
pack is one NSD and one wire compact launch, every unpack one wire expand
launch. :func:`make_butterfly_allreduce` (the reference's shard_map
program) runs one node per process over a
:class:`repro_torch.launch.mesh.NodeMesh`, every halving and doubling round
a pairwise exchange between the same node index of two pods; only the
ranks whose pack crosses a link make it. Its mean and telemetry are the
simulation's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm.hierarchy import (_TREE_DOWN_SALT, HierTelemetry,
                                        HopNoise, _default_noise,
                                        _hier_shape, _mesh_axes,
                                        _zero_telemetry, intra_ledger,
                                        intra_reduce_scatter, mesh_phase1,
                                        ring_forward, two_level_telemetry)
from repro_torch.comm.reduce_base import (Ledger, pack_table, record_table,
                                          seg_len)
from repro_torch.quant import wire

_FOLD_SALT = 0xF01D  # the ragged pods' pre-fold packs
_HALVE_SALT = 0xBF1F  # recursive-halving reduce-scatter packs

__all__ = ["ButterflyConfig", "ButterflyTelemetry", "allreduce_butterfly",
           "butterfly_allreduce_mesh", "butterfly_allreduce_nsd",
           "butterfly_rounds", "butterfly_share", "dense_reduce_bytes",
           "make_butterfly_allreduce"]


def butterfly_rounds(pods: int) -> int:
    """floor(log2(pods)): halving/doubling rounds over the pod axis."""
    return pods.bit_length() - 1 if pods > 1 else 0


@dataclasses.dataclass(frozen=True)
class ButterflyConfig:
    """Butterfly two-level reduce: N nodes = pods x (N // pods)."""

    pods: int = 2
    s: float = 1.0  # NSD scale of the on-wire quantization

    def __post_init__(self):
        if self.pods < 1:
            raise ValueError(f"pods must be >= 1, got {self.pods}")


# the same accounting as the hierarchy's; ``peak_dcn_bytes`` is the
# butterfly's design target
ButterflyTelemetry = HierTelemetry


def _piece_len(seg: int, pods: int) -> Tuple[int, int, int]:
    """(m, G2, piece): rounds, power-of-two core, per-pod piece length."""
    m = butterfly_rounds(pods)
    g2 = 1 << m
    return m, g2, -(-seg // g2)


def _hop_counts(g: int, p: int) -> Tuple[int, int]:
    """(ici pack-transfers, dcn pack-transfers) of the whole exchange."""
    m, g2, _ = _piece_len(1, g)
    ici = 2 * g * p * (p - 1)  # phase 1 + phase-4 pack-set forwarding
    # halving sends + doubling sends (a transfer may carry 2^j packs) +
    # the pre- and post-folds, per segment owner line
    dcn = p * (2 * m * g2 + 2 * (g - g2))
    return ici, dcn


def dense_reduce_bytes(size: int, pods: int, per_pod: int) -> int:
    """Bytes the same butterfly exchange would move at dense f32: ICI as
    the hierarchy's, DCN 2 (G - 1) pieces of G2 per owner line."""
    seg = seg_len(size, per_pod, wire.DEFAULT_CHUNK)
    _, g2, piece = _piece_len(seg, pods)
    ici = 2 * pods * per_pod * (per_pod - 1) * seg
    dcn = 2 * (pods - 1) * per_pod * piece * g2
    return (ici + dcn) * 4


def butterfly_ledger(G: int, Pn: int) -> Ledger:
    """The butterfly's accounting in the simulation's order: phase 1, the
    pre-fold (pod, segment), the halving rounds (round, pod, segment), the
    piece packs' Deltas, the doubling rounds' forwards (each pod's pack set
    in the order it filled), the post-fold and phase 4's ring."""
    m, G2, _ = _piece_len(1, G)
    led = Ledger()
    intra_ledger(led, G, Pn)
    for g in range(G2, G):
        for c in range(Pn):
            pid = (_FOLD_SALT, 0, g, c)
            led.charge(pid, seg=c, link="dcn")
            led.line(pid, g, g - G2)
    for r in range(m):
        bit = m - 1 - r
        for g in range(G2):
            for c in range(Pn):
                pid = (_HALVE_SALT, r, g, c)
                led.charge(pid, seg=c, link="dcn")
                led.line(pid, g, g ^ (1 << bit))
    for g in range(G2):
        for c in range(Pn):
            led.charge((_TREE_DOWN_SALT, 0, g, c), seg=c, link="dcn", hops=0)
    # have[g][c]: the piece indices pod g holds, in the order they came
    have = [[{g: None} for _ in range(Pn)] for g in range(G2)]
    for j in range(m):
        snap = [[list(have[g][c]) for c in range(Pn)] for g in range(G2)]
        for g in range(G2):
            dst = g ^ (1 << j)
            for c in range(Pn):
                for idx in snap[g][c]:
                    pid = (_TREE_DOWN_SALT, 0, idx, c)
                    led.charge(pid, link="dcn")
                    led.line(pid, g, dst)
                    have[dst][c][idx] = None
    for g in range(G2, G):
        for c in range(Pn):
            for idx in have[g - G2][c]:
                pid = (_TREE_DOWN_SALT, 0, idx, c)
                led.charge(pid, link="dcn")
                led.line(pid, g - G2, g)
    for c in range(Pn):
        for idx in have[0][c]:
            led.charge((_TREE_DOWN_SALT, 0, idx, c), link="ici",
                       hops=G * (Pn - 1))
    return led


def _telemetry(table, table_dev, G: int, Pn: int, size: int, dev
               ) -> ButterflyTelemetry:
    ici_hops, dcn_hops = _hop_counts(G, Pn)
    return two_level_telemetry(butterfly_ledger(G, Pn), table, table_dev, G,
                               Pn, size, dense_reduce_bytes(size, G, Pn),
                               ici_hops + dcn_hops, dev)


def butterfly_allreduce_nsd(grads: torch.Tensor, key: int,
                            cfg: ButterflyConfig = ButterflyConfig(), *,
                            noise: Optional[HopNoise] = None
                            ) -> Tuple[torch.Tensor, ButterflyTelemetry]:
    """Simulated butterfly two-level all-reduce of N stacked gradients.

    grads: (N, *shape), pod-major (node i lives in pod i // per_pod);
    ``key`` the reduce's stream key; ``noise`` as in
    ``repro_torch.comm.hierarchy.hier_allreduce_nsd``, with the packs
    (INTRA_SALT, hop, pod, node), (FOLD_SALT, 0, pod, segment),
    (HALVE_SALT, round, pod, segment) and (TREE_DOWN_SALT, 0, pod,
    segment). Returns (mean over nodes, telemetry). N == 1 returns the one
    gradient (no wire).
    """
    n = grads.shape[0]
    shape, dtype, dev = grads.shape[1:], grads.dtype, grads.device
    if n == 1:
        return grads[0], _zero_telemetry(dev)
    G, Pn = _hier_shape(n, cfg.pods)
    m, G2, _ = _piece_len(1, G)
    if noise is None:
        noise = _default_noise(key)
    flat = grads.to(torch.float32).reshape(n, -1)
    size = flat.shape[1]
    packs = {}

    # phase 1: the hierarchy's intra-pod ring, the same packs and keys
    part, seg = intra_reduce_scatter(flat, G, Pn, cfg.s, noise, packs)
    _, _, piece = _piece_len(seg, G)
    seg2 = piece * G2
    if seg2 > seg:
        part = [[F.pad(v, (0, seg2 - seg)) for v in row] for row in part]

    # phase 2a pre-fold: ragged pods g >= G2 send their whole partial into
    # the power-of-two core with one pack
    for g in range(G2, G):
        dst = g - G2
        for c in range(Pn):
            pid = (_FOLD_SALT, 0, g, c)
            packs[pid] = pk = wire.pack_nsd(part[g][c], noise(*pid, (seg2,)),
                                            cfg.s)
            part[dst][c] = part[dst][c] + wire.unpack_nsd(pk)

    # phase 2a: recursive-halving reduce-scatter over the pods
    live = [[part[g][c] for c in range(Pn)] for g in range(G2)]
    for r in range(m):
        bit = m - 1 - r
        half = piece << bit  # the live width after this round
        sends = []
        for g in range(G2):
            keep = (g >> bit) & 1
            dst = g ^ (1 << bit)
            for c in range(Pn):
                block = live[g][c][(1 - keep) * half:(2 - keep) * half]
                pid = (_HALVE_SALT, r, g, c)
                packs[pid] = pk = wire.pack_nsd(block, noise(*pid, (half,)),
                                                cfg.s)
                sends.append((dst, c, keep, pk))
        nxt = [[None] * Pn for _ in range(G2)]
        for dst, c, keep, pk in sends:
            # the receiver keeps the half the sender sent (they differ in
            # just this round's bit, so their live ranges coincide)
            dkeep = 1 - keep
            kept = live[dst][c][dkeep * half:(dkeep + 1) * half]
            nxt[dst][c] = kept + wire.unpack_nsd(pk)
        live = nxt

    # phase 2b: each pod packs its piece once; recursive doubling and the
    # post-fold forward the piece packs verbatim, so every pod holds the
    # same set, which phase 4 rides around each pod's ring: every node
    # unpacks the same G2 packs
    vals = []
    for c in range(Pn):
        pieces = []
        for g in range(G2):
            pid = (_TREE_DOWN_SALT, 0, g, c)
            packs[pid] = pk = wire.pack_nsd(live[g][c], noise(*pid, (piece,)),
                                            cfg.s)
            pieces.append(wire.unpack_nsd(pk))
        vals.append(torch.cat(pieces)[:seg])

    total = torch.cat(vals)
    mean = (total[:size] / n).reshape(shape).to(dtype)
    return mean, _telemetry(pack_table(packs), dev, G, Pn, size, dev)


def butterfly_share(local: torch.Tensor, key: int, mesh,
                    cfg: ButterflyConfig, ex,
                    noise: Optional[HopNoise] = None, pod_axis: str = "pods",
                    node_axis: str = "nodes"
                    ) -> Tuple[torch.Tensor,
                               Callable[[dict], ButterflyTelemetry]]:
    """Rank (pod, node)'s share of the butterfly reduce over ``mesh``, its
    hops through ``ex`` under ``ex.scope``: ``local`` its own gradient,
    ``key`` and ``noise`` as in :func:`butterfly_allreduce_nsd`. Returns its
    mean, bit for bit on every rank, and ``tele(records)`` (as
    ``ring.ring_share``)."""
    G, Pn = _mesh_axes(mesh, cfg.pods, pod_axis, node_axis)
    shape, dtype, dev = local.shape, local.dtype, local.device
    n = G * Pn
    if n == 1:
        return local, lambda records: _zero_telemetry(dev)
    if noise is None:
        noise = _default_noise(key)
    m, G2, _ = _piece_len(1, G)
    g, me = mesh.pod, mesh.node
    flat = local.to(torch.float32).reshape(-1)
    size = flat.shape[0]
    scope = ex.scope

    def peer(pod):
        return mesh.rank_of(pod, me)

    acc, seg = mesh_phase1(flat, mesh, g, me, Pn, cfg.s, noise, ex)
    c_own = (me + 1) % Pn
    _, _, piece = _piece_len(seg, G)
    seg2 = piece * G2
    live = acc[c_own]
    if seg2 > seg:
        live = F.pad(live, (0, seg2 - seg))

    # phase 2a pre-fold: a ragged pod sends its partial into the core
    if g >= G2:
        pid = (_FOLD_SALT, 0, g, c_own)
        pk = wire.pack_nsd(live, noise(*pid, (seg2,)), cfg.s)
        ex.swap([(peer(g - G2), pid, pk)], [])
    elif g < G - G2:
        (pk_in,) = ex.swap([], [(peer(g + G2), (_FOLD_SALT, 0, g + G2, c_own),
                                 (seg2,))])
        live = live + wire.unpack_nsd(pk_in)

    have = {}
    if g < G2:
        # phase 2a: recursive halving with the partner pod of each round
        for r in range(m):
            bit = m - 1 - r
            half = piece << bit
            keep = (g >> bit) & 1
            dst = g ^ (1 << bit)
            pid = (_HALVE_SALT, r, g, c_own)
            pk = wire.pack_nsd(live[(1 - keep) * half:(2 - keep) * half],
                               noise(*pid, (half,)), cfg.s)
            (pk_in,) = ex.swap([(peer(dst), pid, pk)],
                               [(peer(dst), (_HALVE_SALT, r, dst, c_own),
                                 (half,))])
            live = live[keep * half:(keep + 1) * half] + wire.unpack_nsd(pk_in)

        # phase 2b: the piece packed once, then recursive doubling of the
        # pack set (ids (TREE_DOWN_SALT, 0, piece index, segment))
        pid = (_TREE_DOWN_SALT, 0, g, c_own)
        have[g] = wire.pack_nsd(live, noise(*pid, (piece,)), cfg.s)
        for j in range(m):
            dst = g ^ (1 << j)
            mine = sorted(have)
            theirs = [i for i in range(G2) if i >> j == dst >> j]
            got = ex.swap(
                [(peer(dst), (_TREE_DOWN_SALT, 0, i, c_own), have[i])
                 for i in mine],
                [(peer(dst), (_TREE_DOWN_SALT, 0, i, c_own), (piece,))
                 for i in theirs])
            have.update(zip(theirs, got))

    # phase 2b post-fold: the core forwards the finished set to the ragged
    # pods
    ids = list(range(G2))
    if g < G - G2:
        ex.swap([(peer(g + G2), (_TREE_DOWN_SALT, 0, i, c_own), have[i])
                 for i in ids], [])
    elif g >= G2:
        got = ex.swap([], [(peer(g - G2), (_TREE_DOWN_SALT, 0, i, c_own),
                            (piece,)) for i in ids])
        have = dict(zip(ids, got))

    # phase 4: the pack set around the pod ring; every node unpacks the
    # same G2 packs of each segment
    out = ring_forward(
        ex, mesh, g, me, Pn, [have[i] for i in ids], _TREE_DOWN_SALT,
        [(0, i) for i in ids], [(piece,)] * G2,
        lambda pks: torch.cat([wire.unpack_nsd(pk) for pk in pks])[:seg])
    total = torch.cat(out)
    mean = (total[:size] / n).reshape(shape).to(dtype)
    return mean, lambda records: _telemetry(
        record_table(records.get(scope, {})), "cpu", G, Pn, size, dev)


def butterfly_allreduce_mesh(local: torch.Tensor, key: int, mesh,
                             cfg: ButterflyConfig = ButterflyConfig(), *,
                             noise: Optional[HopNoise] = None,
                             pod_axis: str = "pods", node_axis: str = "nodes"
                             ) -> Tuple[torch.Tensor, ButterflyTelemetry]:
    """:func:`butterfly_share` on an exchange of its own: this rank's mean
    and telemetry, bit for bit on every rank."""
    from repro_torch.comm.p2p import Exchange

    _mesh_axes(mesh, cfg.pods, pod_axis, node_axis)  # before any exchange
    ex = Exchange(mesh, local.device)
    mean, tele = butterfly_share(local, key, mesh, cfg, ex, noise, pod_axis,
                                 node_axis)
    return mean, tele(ex.records())


def make_butterfly_allreduce(mesh, cfg: ButterflyConfig = ButterflyConfig(),
                             pod_axis: str = "pods", node_axis: str = "nodes"):
    """The reference's builder: ``fn(local, key, *, noise=None) -> (mean,
    telemetry)``, this rank's share of the butterfly over ``mesh``; the
    telemetry carries ``peak_dcn_bytes``."""
    _mesh_axes(mesh, cfg.pods, pod_axis, node_axis)

    def fn(local, key, *, noise=None):
        return butterfly_allreduce_mesh(local, key, mesh, cfg, noise=noise,
                                        pod_axis=pod_axis, node_axis=node_axis)

    return fn


def allreduce_butterfly(grads: torch.Tensor, key: int,
                        cfg: ButterflyConfig = ButterflyConfig(), mesh=None,
                        pod_axis: str = "pods", node_axis: str = "nodes"
                        ) -> Tuple[torch.Tensor, ButterflyTelemetry]:
    """The reference's dispatcher: without a mesh the simulation of the
    stacked (N, ...) ``grads``; with one, this rank's share of the process
    reduce, ``grads`` being this rank's own gradient."""
    if mesh is not None:
        return butterfly_allreduce_mesh(grads, key, mesh, cfg,
                                        pod_axis=pod_axis, node_axis=node_axis)
    return butterfly_allreduce_nsd(grads, key, cfg)
