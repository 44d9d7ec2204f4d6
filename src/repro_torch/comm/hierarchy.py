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

One process simulates the nodes on one device. Every pack is one NSD and
one wire compact launch and every unpack one wire expand launch
(``repro_torch.quant.wire``). The reference's shard_map program over a
(pods, nodes) mesh, ``make_hier_allreduce``, waits for ROADMAP.md section
1, item 7.2.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.comm.reduce_base import PackCounter, hop_key, seg_len, segment
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


def intra_reduce_scatter(grads: torch.Tensor, G: int, Pn: int, s: float,
                         noise: HopNoise, ctr: PackCounter
                         ) -> Tuple[List[List[torch.Tensor]], int]:
    """Phase 1 (the hierarchy's and the butterfly's): each pod's ring
    reduce-scatter of the (N, size) f32 gradients, pod-major. Returns
    ``part[g][c]``, pod g's sum of segment c as its owner (c - 1) % P holds
    it, and the segment length. All packs of a hop read the accumulators
    as the hop before left them."""
    # acc[g * Pn + p, c]: node (g, p)'s value of its pod's segment c
    acc, seg = segment(grads, Pn, wire.DEFAULT_CHUNK)
    for step in range(Pn - 1):
        packed = []
        for g in range(G):
            for p in range(Pn):
                c = (p - step) % Pn
                pk = wire.pack_nsd(acc[g * Pn + p, c],
                                   noise(_INTRA_SALT, step, g, p, (seg,)), s)
                ctr.count(pk, seg=c, link="ici")
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
    ctr = PackCounter(Pn, dev)
    part, seg = intra_reduce_scatter(flat, G, Pn, cfg.s, noise, ctr)

    # each pod's DCN line traffic (sent + received), for peak_dcn_bytes
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    traffic = [zero] * G

    # phase 2: inter-pod binomial tree reduce (a pack per combine)
    rounds = tree_rounds(G)
    for r in range(rounds):
        stride = 1 << r
        for g in range(G):
            if g % (2 * stride) != stride:
                continue
            dst = g - stride
            for c in range(Pn):
                pk = wire.pack_nsd(part[g][c],
                                   noise(_TREE_UP_SALT, r, g, c, (seg,)),
                                   cfg.s)
                ctr.count(pk, seg=c, link="dcn")
                b = pk.wire_bytes().to(torch.float32)
                traffic[g] = traffic[g] + b
                traffic[dst] = traffic[dst] + b
                part[dst][c] = part[dst][c] + wire.unpack_nsd(pk)

    # phases 3 and 4: the root packs once; the pack goes down the tree (G - 1
    # DCN hops) and around each pod's ring (P - 1 ICI hops a pod) verbatim
    finals = []
    for c in range(Pn):
        pk = wire.pack_nsd(part[0][c],
                           noise(_TREE_DOWN_SALT, 0, 0, c, (seg,)), cfg.s)
        ctr.count(pk, seg=c, link="dcn", hops=G - 1)
        ctr.count(pk, link="ici", hops=G * (Pn - 1))
        b = pk.wire_bytes().to(torch.float32)
        for r in range(rounds - 1, -1, -1):
            stride = 1 << r
            for src in range(0, G, 2 * stride):
                if src + stride < G:
                    traffic[src] = traffic[src] + b
                    traffic[src + stride] = traffic[src + stride] + b
        finals.append(wire.unpack_nsd(pk))

    total = torch.cat(finals)
    mean = (total[:size] / n).reshape(shape).to(dtype)
    ici_hops, dcn_hops = _hop_counts(G, Pn)
    dense = torch.full((), float(dense_reduce_bytes(size, G, Pn)),
                       dtype=torch.float32, device=dev)
    return mean, HierTelemetry(
        wire_bytes=ctr.wire_total, dense_bytes=dense,
        error_bound=ctr.bound.max() / n, n_hops=ici_hops + dcn_hops,
        packs_per_segment=(Pn - 1) + rounds + 1,
        wire_ici_bytes=ctr.wire["ici"], wire_dcn_bytes=ctr.wire["dcn"],
        pods=G, per_pod=Pn,
        peak_dcn_bytes=torch.stack(traffic).max() if G > 1 else zero)


def allreduce_hier(grads: torch.Tensor, key: int,
                   cfg: HierConfig = HierConfig(), mesh=None
                   ) -> Tuple[torch.Tensor, HierTelemetry]:
    """Deprecated, as in the reference: reduces go through
    ``repro_torch.comm.reducer``. The simulation (the port's only route; a
    mesh, for the shard_map program, is refused until ROADMAP.md section 1,
    item 7.2)."""
    warnings.warn("allreduce_hier is deprecated; use "
                  "repro_torch.comm.reducer(policy, ...)",
                  DeprecationWarning, stacklevel=2)
    if mesh is not None:
        raise NotImplementedError(
            "allreduce_hier(mesh=...): the shard_map reduce is not ported "
            "yet (ROADMAP.md section 1, item 7.2)")
    return hier_allreduce_nsd(grads, key, cfg)
