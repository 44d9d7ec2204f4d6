"""Compressed ring all-reduce: NSD gradients cross every hop in wire format.

Counterpart of the simulation in ``repro.comm.ring`` (``RingConfig``,
``dense_reduce_bytes``, ``ring_allreduce_nsd``). The classic ring moves
2(N-1)/N of the gradient over each link as dense f32; here every hop
carries the packed NSD representation instead:

  reduce-scatter   N-1 steps; at each, every node packs its current partial
                   sum of one segment (a fresh NSD pack with a per-(step,
                   node) key) and its right neighbour adds the unpacked
                   value to its own. All packs of a step read the
                   accumulators as they were before any add of that step.
  all-gather       each completed segment is packed once by its owner and
                   forwarded verbatim N-1 times.

Error accounting: segment c is packed N-1 times during reduce-scatter and
once at gather, so |result - dense mean| <= (sum of those N packs' Deltas)
/ N pointwise; ``error_bound`` reports that bound from the measured Deltas.
The ring packs the zero-padded segments, so each Delta = s * std is taken
over a segment with its padding.

:func:`ring_allreduce_nsd` simulates the N nodes in turn on one device:
each pack is one NSD and one wire compact launch, each unpack one wire
expand launch, N^2 of each per reduce. :func:`make_ring_allreduce` (the
reference's shard_map program) runs the same ring with one node per
process over a :class:`repro_torch.launch.mesh.NodeMesh`: each rank packs
the segments it owns (N packs: N - 1 in the reduce-scatter, one at the
gather), sends them to its right neighbour point to point
(``repro_torch.comm.p2p``) and unpacks what its left neighbour sends (2N -
1 unpacks). The same keys and the same hop math give every rank the
simulation's mean bit for bit, and the same ledger its telemetry.
Segments are cut in the wire's one chunk, 256 elements.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.comm.reduce_base import (Ledger, ReduceTelemetry, hop_key,
                                          pack_table, record_table,
                                          ring_shares, seg_len, segment)
from repro_torch.quant import wire

_REDUCE_SALT = 0x51D5
_GATHER_SALT = 0xA11C

# noise(salt, a, b, shape) -> what one pack dithers with: a stream key or a
# unit draw of the segment's shape
HopNoise = Callable[[int, int, int, Tuple[int, ...]],
                    Union[int, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RingConfig:
    s: float = 1.0  # NSD scale of the on-wire quantization


def dense_reduce_bytes(size: int, n: int) -> int:
    """Bytes the same N-node ring exchange would move at dense f32."""
    return 2 * n * (n - 1) * seg_len(size, n, wire.DEFAULT_CHUNK) * 4


def ring_ledger(n: int) -> Ledger:
    """The ring's accounting: every reduce-scatter pack over one hop, in
    (step, node) order, then each segment's gather pack over N - 1."""
    led = Ledger()
    for step in range(n - 1):
        for i in range(n):
            led.charge((_REDUCE_SALT, step, i), seg=ring_shares(i, n, step)[0])
    for c in range(n):
        led.charge((_GATHER_SALT, c, 0), seg=c, hops=n - 1)
    return led


def _telemetry(table, table_dev, n: int, size: int, dev) -> ReduceTelemetry:
    """The ring's telemetry from a pack table on ``table_dev`` (the
    simulation's on the device, a process reduce's records on the CPU)."""
    ctr, _ = ring_ledger(n).replay(table, n, 1, table_dev)
    dense = torch.full((), float(dense_reduce_bytes(size, n)),
                       dtype=torch.float32, device=dev)
    return ReduceTelemetry(wire_bytes=ctr.wire_total.to(dev), dense_bytes=dense,
                           error_bound=ctr.bound.to(dev).max() / n,
                           n_hops=2 * n * (n - 1), packs_per_segment=n)


def _zero(dev) -> ReduceTelemetry:
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return ReduceTelemetry(zero, zero, zero, 0, 0)


def ring_allreduce_nsd(grads: torch.Tensor, key: int, cfg: RingConfig = RingConfig(), *,
                       noise: Optional[HopNoise] = None
                       ) -> Tuple[torch.Tensor, ReduceTelemetry]:
    """Simulated compressed ring all-reduce of N stacked node gradients.

    grads: (N, *shape), the N node gradients stacked; ``key`` the
    reduce's stream key. Pack (salt, a, b) dithers with
    ``noise(salt, a, b, (seg,))``, by default the stream key
    ``hop_key(key, salt, a, b)``: (REDUCE_SALT, step, node) in the
    reduce-scatter, (GATHER_SALT, segment, 0) in the gather. Returns (mean
    over nodes, telemetry). N == 1 returns the one gradient (no wire).
    """
    n = grads.shape[0]
    shape, dtype, dev = grads.shape[1:], grads.dtype, grads.device
    if n == 1:
        return grads[0], _zero(dev)
    if noise is None:
        noise = _default_noise(key)

    flat = grads.to(torch.float32).reshape(n, -1)
    size = flat.shape[1]
    # acc[i, c]: node i's current value of ring segment c (segment's padded
    # copy of the gradients: the adds below are in place)
    acc, seg = segment(flat, n, wire.DEFAULT_CHUNK)
    packs = {}

    # reduce-scatter: segment c travels c -> c+1 -> ... -> c-1
    for step in range(n - 1):
        packed = []
        for i in range(n):
            c = ring_shares(i, n, step)[0]
            pid = (_REDUCE_SALT, step, i)
            packs[pid] = p = wire.pack_nsd(acc[i, c], noise(*pid, (seg,)), cfg.s)
            packed.append((c, p))
        for i, (c, p) in enumerate(packed):
            acc[(i + 1) % n, c] += wire.unpack_nsd(p)

    # all-gather: owner (c-1) % n packs segment c once, forwards it N-1 times
    gathered = []
    for c in range(n):
        pid = (_GATHER_SALT, c, 0)
        packs[pid] = p = wire.pack_nsd(acc[(c - 1) % n, c],
                                       noise(*pid, (seg,)), cfg.s)
        gathered.append(wire.unpack_nsd(p))

    total = torch.cat(gathered)
    mean = (total[:size] / n).reshape(shape).to(dtype)
    return mean, _telemetry(pack_table(packs), dev, n, size, dev)


def _default_noise(key: int) -> HopNoise:
    def noise(salt, a, b, _shape):
        return hop_key(key, salt, a, b)
    return noise


def ring_share(local: torch.Tensor, key: int, mesh, cfg: RingConfig, ex,
               noise: Optional[HopNoise] = None
               ) -> Tuple[torch.Tensor, Callable[[dict], ReduceTelemetry]]:
    """This rank's share of the compressed ring over every rank of
    ``mesh`` (pod-major order: position ``mesh.index``), its hops through
    ``ex`` (a :class:`repro_torch.comm.p2p.Exchange`) under ``ex.scope``.

    ``local`` is this rank's own gradient (never a stack of them); ``key``
    and ``noise`` as in :func:`ring_allreduce_nsd`. Returns the mean, the
    simulation's bit for bit, and ``tele(records)``, the telemetry replayed
    from ``ex.records()`` (gathered once the exchange's last hop is done).
    """
    n, me = mesh.size, mesh.index
    shape, dtype, dev = local.shape, local.dtype, local.device
    if n == 1:
        return local, lambda records: _zero(dev)
    if noise is None:
        noise = _default_noise(key)
    right = mesh.ranks[(me + 1) % n]
    left = mesh.ranks[(me - 1) % n]
    flat = local.to(torch.float32).reshape(-1)
    size = flat.shape[0]
    acc, seg = segment(flat, n, wire.DEFAULT_CHUNK)
    scope = ex.scope

    for step in range(n - 1):
        c_send, c_recv = ring_shares(me, n, step)
        pid = (_REDUCE_SALT, step, me)
        p = wire.pack_nsd(acc[c_send], noise(*pid, (seg,)), cfg.s)
        (p_in,) = ex.swap([(right, pid, p)],
                          [(left, (_REDUCE_SALT, step, (me - 1) % n), (seg,))])
        acc[c_recv] += wire.unpack_nsd(p_in)

    # gather: pack the finished segment once, forward what arrives verbatim
    c_own = (me + 1) % n
    pid = (_GATHER_SALT, c_own, 0)
    cur = wire.pack_nsd(acc[c_own], noise(*pid, (seg,)), cfg.s)
    out = [None] * n
    out[c_own] = wire.unpack_nsd(cur)
    for h in range(1, n):
        c = (me - h + 1) % n  # the left neighbour's previous segment
        (cur,) = ex.swap([(right, pid, cur)], [(left, (_GATHER_SALT, c, 0), (seg,))])
        pid = (_GATHER_SALT, c, 0)
        out[c] = wire.unpack_nsd(cur)

    total = torch.cat(out)
    mean = (total[:size] / n).reshape(shape).to(dtype)
    return mean, lambda records: _telemetry(
        record_table(records.get(scope, {})), "cpu", n, size, dev)


def ring_allreduce_mesh(local: torch.Tensor, key: int, mesh,
                        cfg: RingConfig = RingConfig(), *,
                        noise: Optional[HopNoise] = None
                        ) -> Tuple[torch.Tensor, ReduceTelemetry]:
    """:func:`ring_share` on an exchange of its own: this rank's mean and
    telemetry, both the simulation's bit for bit, on every rank."""
    from repro_torch.comm.p2p import Exchange

    ex = Exchange(mesh, local.device)
    mean, tele = ring_share(local, key, mesh, cfg, ex, noise=noise)
    return mean, tele(ex.records())


def make_ring_allreduce(mesh, axis_name: str = "nodes",
                        cfg: RingConfig = RingConfig()):
    """The reference's builder: ``fn(local, key, *, noise=None) -> (mean,
    wire_bytes, bound)``, this rank's share of the ring over ``mesh``
    (``axis_name`` must be one of its axes; the ring runs over all its
    ranks, pod-major)."""
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} have no "
                         f"{axis_name!r} axis")

    def fn(local, key, *, noise=None):
        mean, tele = ring_allreduce_mesh(local, key, mesh, cfg, noise=noise)
        return mean, tele.wire_bytes, tele.error_bound

    return fn
