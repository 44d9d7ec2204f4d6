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

One process simulates the N nodes in turn on one device (the reference's
``make_ring_allreduce``, a shard_map program over a mesh, is not ported).
Segments are cut in the wire's one chunk, 256 elements.
Each pack is one NSD and one wire compact launch, each unpack one wire
expand launch: N^2 of each per reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.comm.reduce_base import (PackCounter, ReduceTelemetry,
                                          hop_key, seg_len, segment)
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
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return grads[0], ReduceTelemetry(zero, zero, zero, 0, 0)
    if noise is None:
        def noise(salt, a, b, _shape):
            return hop_key(key, salt, a, b)

    flat = grads.to(torch.float32).reshape(n, -1)
    size = flat.shape[1]
    # acc[i, c]: node i's current value of ring segment c (segment's padded
    # copy of the gradients: the adds below are in place)
    acc, seg = segment(flat, n, wire.DEFAULT_CHUNK)
    ctr = PackCounter(n, dev)

    # reduce-scatter: segment c travels c -> c+1 -> ... -> c-1
    for step in range(n - 1):
        packed = []
        for i in range(n):
            c = (i - step) % n
            p = wire.pack_nsd(acc[i, c], noise(_REDUCE_SALT, step, i, (seg,)),
                              cfg.s)
            packed.append((c, p))
            ctr.count(p, seg=c)
        for i, (c, p) in enumerate(packed):
            acc[(i + 1) % n, c] += wire.unpack_nsd(p)

    # all-gather: owner (c-1) % n packs segment c once, forwards it N-1 times
    gathered = []
    for c in range(n):
        p = wire.pack_nsd(acc[(c - 1) % n, c],
                          noise(_GATHER_SALT, c, 0, (seg,)), cfg.s)
        ctr.count(p, seg=c, hops=n - 1)
        gathered.append(wire.unpack_nsd(p))

    total = torch.cat(gathered)
    mean = (total[:size] / n).reshape(shape).to(dtype)
    dense = torch.full((), float(dense_reduce_bytes(size, n)),
                       dtype=torch.float32, device=dev)
    return mean, ReduceTelemetry(wire_bytes=ctr.wire, dense_bytes=dense,
                                 error_bound=ctr.bound.max() / n,
                                 n_hops=2 * n * (n - 1), packs_per_segment=n)
