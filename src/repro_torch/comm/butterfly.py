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

One process simulates the nodes on one device; every pack is one NSD and
one wire compact launch, every unpack one wire expand launch. The
reference's shard_map program, ``make_butterfly_allreduce``, waits for
ROADMAP.md section 1, item 7.2.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm.hierarchy import (_TREE_DOWN_SALT, HierTelemetry,
                                        HopNoise, _default_noise,
                                        _hier_shape, _zero_telemetry,
                                        intra_reduce_scatter, tree_rounds)
from repro_torch.comm.reduce_base import PackCounter, seg_len
from repro_torch.quant import wire

_FOLD_SALT = 0xF01D  # the ragged pods' pre-fold packs
_HALVE_SALT = 0xBF1F  # recursive-halving reduce-scatter packs

__all__ = ["ButterflyConfig", "ButterflyTelemetry", "allreduce_butterfly",
           "butterfly_allreduce_nsd", "butterfly_rounds",
           "dense_reduce_bytes"]


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
    ctr = PackCounter(Pn, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    traffic = [zero] * G

    def charge(pk, src, dst):
        b = pk.wire_bytes().to(torch.float32)
        traffic[src] = traffic[src] + b
        traffic[dst] = traffic[dst] + b

    # phase 1: the hierarchy's intra-pod ring, the same packs and keys
    part, seg = intra_reduce_scatter(flat, G, Pn, cfg.s, noise, ctr)
    _, _, piece = _piece_len(seg, G)
    seg2 = piece * G2
    if seg2 > seg:
        part = [[F.pad(v, (0, seg2 - seg)) for v in row] for row in part]

    # phase 2a pre-fold: ragged pods g >= G2 send their whole partial into
    # the power-of-two core with one pack
    for g in range(G2, G):
        dst = g - G2
        for c in range(Pn):
            pk = wire.pack_nsd(part[g][c], noise(_FOLD_SALT, 0, g, c, (seg2,)),
                               cfg.s)
            ctr.count(pk, seg=c, link="dcn")
            charge(pk, g, dst)
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
                pk = wire.pack_nsd(block,
                                   noise(_HALVE_SALT, r, g, c, (half,)),
                                   cfg.s)
                ctr.count(pk, seg=c, link="dcn")
                charge(pk, g, dst)
                sends.append((dst, c, keep, pk))
        nxt = [[None] * Pn for _ in range(G2)]
        for dst, c, keep, pk in sends:
            # the receiver keeps the half the sender sent (they differ in
            # just this round's bit, so their live ranges coincide)
            dkeep = 1 - keep
            kept = live[dst][c][dkeep * half:(dkeep + 1) * half]
            nxt[dst][c] = kept + wire.unpack_nsd(pk)
        live = nxt

    # phase 2b: each pod packs its piece once; recursive doubling forwards
    # the piece packs verbatim until every pod holds the same set
    finals = [[wire.pack_nsd(live[g][c],
                             noise(_TREE_DOWN_SALT, 0, g, c, (piece,)), cfg.s)
               for c in range(Pn)] for g in range(G2)]
    for g in range(G2):
        for c in range(Pn):
            ctr.count(finals[g][c], seg=c, link="dcn", hops=0)
    have = [[{g: finals[g][c]} for c in range(Pn)] for g in range(G2)]
    for j in range(m):
        stride = 1 << j
        snap = [[dict(have[g][c]) for c in range(Pn)] for g in range(G2)]
        for g in range(G2):
            dst = g ^ stride
            for c in range(Pn):
                for idx, pk in snap[g][c].items():
                    ctr.count(pk, link="dcn")
                    charge(pk, g, dst)
                    have[dst][c][idx] = pk

    # phase 2b post-fold: the ragged pods receive the finished pack set
    for g in range(G2, G):
        src = g - G2
        for c in range(Pn):
            for pk in have[src][c].values():
                ctr.count(pk, link="dcn")
                charge(pk, src, g)

    # phase 4: the pack set rides around each pod's ring verbatim; every
    # node unpacks the same G2 packs
    vals = []
    for c in range(Pn):
        for pk in have[0][c].values():
            ctr.count(pk, link="ici", hops=G * (Pn - 1))
        pieces = [wire.unpack_nsd(have[0][c][i]) for i in range(G2)]
        vals.append(torch.cat(pieces)[:seg])

    total = torch.cat(vals)
    mean = (total[:size] / n).reshape(shape).to(dtype)
    ici_hops, dcn_hops = _hop_counts(G, Pn)
    dense = torch.full((), float(dense_reduce_bytes(size, G, Pn)),
                       dtype=torch.float32, device=dev)
    return mean, ButterflyTelemetry(
        wire_bytes=ctr.wire_total, dense_bytes=dense,
        error_bound=ctr.bound.max() / n, n_hops=ici_hops + dcn_hops,
        packs_per_segment=(Pn - 1) + tree_rounds(G) + 1,
        wire_ici_bytes=ctr.wire["ici"], wire_dcn_bytes=ctr.wire["dcn"],
        pods=G, per_pod=Pn,
        peak_dcn_bytes=torch.stack(traffic).max() if G > 1 else zero)


def allreduce_butterfly(grads: torch.Tensor, key: int,
                        cfg: ButterflyConfig = ButterflyConfig(), mesh=None
                        ) -> Tuple[torch.Tensor, ButterflyTelemetry]:
    """The reference's dispatcher: the simulation (the port's only route;
    a mesh, for the shard_map program, is refused until ROADMAP.md section
    1, item 7.2)."""
    if mesh is not None:
        raise NotImplementedError(
            "allreduce_butterfly(mesh=...): the shard_map reduce is not "
            "ported yet (ROADMAP.md section 1, item 7.2)")
    return butterfly_allreduce_nsd(grads, key, cfg)
