"""Shared machinery of the compressed reduces: segmenting, hop keys and the
wire and error accounting.

Counterpart of ``repro.comm.reduce_base``, for the reduces simulated in
one process and for their per-rank programs over a process mesh (the flat
ring, the hierarchy and the butterfly):

  * segmenting      a flat gradient is zero-padded and split into
                    chunk-aligned segments, one per ring position;
  * hop keys        every pack that crosses a link gets a fresh stream key
                    folded from (salt, *position indices), so re-dither
                    noise is independent across hops and nodes;
  * accounting      wire bytes are measured per pack (never estimated) and
                    the pointwise error bound is the running sum of the
                    Deltas of every pack whose quantization error lands in a
                    segment's final value (paper eqs. 5/6 and
                    |Q(x) - x| <= Delta pointwise);
  ledger            the order in which a reduce adds up its packs' bytes
                    and Deltas, written once per topology: the simulation
                    replays it on its packs, each rank of a process reduce
                    on every rank's (bytes, Delta) records, so the two
                    count the same f32 terms in the same order;
  rank shares       which segment a rank sends and receives at each step
                    of a ring.

Keys are the int stream keys of ``repro_torch.core.policy`` (a splitmix64
``fold_in`` chain standing in for the reference's ``jax.random.fold_in``
chain, one fold per fold). Counters are f32 tensors on the device, summed
in the reference's order; nothing here syncs with the host.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.policy import fold_in


class ReduceTelemetry(NamedTuple):
    """Per-reduce accounting.

    ``packs_per_segment`` is the sequential pack depth: how many times one
    segment's value is re-quantized on its way to the final mean (the flat
    ring's N). The error bound also sums the Deltas of packs from other
    nodes that merge into the segment.
    """

    wire_bytes: torch.Tensor  # f32 0-d: total bytes crossing all links
    dense_bytes: torch.Tensor  # f32 0-d: the same exchange at dense f32
    error_bound: torch.Tensor  # f32 0-d: max pointwise |result - mean| bound
    n_hops: int  # total link traversals
    packs_per_segment: int = 0  # sequential re-quantizations

    @property
    def ratio(self) -> torch.Tensor:
        return self.wire_bytes / torch.clamp(self.dense_bytes, min=1.0)


def seg_len(size: int, n: int, chunk: int) -> int:
    """Segment length: ceil(size / n) rounded up to a chunk multiple."""
    seg = -(-size // n)
    return -(-seg // chunk) * chunk


def segment(flat: torch.Tensor, n: int, chunk: int
            ) -> Tuple[torch.Tensor, int]:
    """Zero-pad the last axis of ``flat`` (size,) or (m, size) so it splits
    into n chunk-aligned segments: (n, seg) or (m, n, seg), and seg."""
    size = flat.shape[-1]
    seg = seg_len(size, n, chunk)
    padded = F.pad(flat, (0, n * seg - size))
    return padded.reshape(flat.shape[:-1] + (n, seg)), seg


def node_mean(nodes) -> torch.Tensor:
    """The mean over the nodes (a stacked (n, ...) tensor or a list of n
    tensors) as the reference's ``jnp.mean(g, axis=0)`` rounds it under
    XLA: the nodes summed in order, times the f32 reciprocal of n.
    ``Tensor.mean`` sums in another order and divides, a last bit apart."""
    acc = nodes[0]
    for g in nodes[1:]:
        acc = acc + g
    return acc * (1.0 / len(nodes))


def hop_key(key: int, salt: int, *indices: int) -> int:
    """A fresh per-pack stream key: (salt, i0, i1, ...) folded into ``key``."""
    k = fold_in(key, salt)
    for i in indices:
        k = fold_in(k, i)
    return k


class PackCounter:
    """Running wire bytes per link class (``ici``, the fast intra-pod axis;
    ``dcn``, the slow inter-pod one) and per-segment Delta sums, f32 on
    ``device``."""

    def __init__(self, n_segments: int, device):
        zero = torch.zeros((), dtype=torch.float32, device=device)
        self.wire = {"ici": zero, "dcn": zero}
        self.bound = torch.zeros((n_segments,), dtype=torch.float32,
                                 device=device)

    def count(self, nbytes: torch.Tensor, delta: torch.Tensor,
              seg: Optional[int] = None, link: str = "ici",
              hops: int = 1) -> None:
        """Record a pack of ``nbytes`` (0-d f32) crossing ``hops`` links of
        class ``link``; with ``seg``, charge its ``delta`` to that
        segment's error bound (None for a pack forwarded verbatim, charged
        when made)."""
        self.wire[link] = self.wire[link] + nbytes * hops
        if seg is not None:
            self.bound[seg] += delta

    @property
    def wire_total(self) -> torch.Tensor:
        return self.wire["ici"] + self.wire["dcn"]


Pid = Tuple[int, ...]  # a pack's id: the (salt, *indices) of its noise


def ring_shares(me: int, n: int, step: int) -> Tuple[int, int]:
    """(segment sent, segment received) by ring position ``me`` of ``n`` at
    reduce-scatter step ``step``: it packs its partial sum of segment
    (me - step) % n for its right neighbour and adds its left neighbour's
    pack into segment (me - 1 - step) % n. After n - 1 steps it owns the
    finished segment (me + 1) % n."""
    return (me - step) % n, (me - 1 - step) % n


class Ledger:
    """A reduce's accounting as data: the packs' charges (bytes over a link
    class, times a hop count, and the Delta into a segment's bound) and
    their DCN line traffic (bytes through two pods' lines), in the order
    the simulation counts them.

    :meth:`replay` adds them up from a table of each pack's (bytes,
    Delta): the simulation's own packs on the device (no host sync), or
    the host records that a process reduce gathers from every rank. The
    sums are f32 adds and products on either device, so the two give the
    same bits; only the final division by N is left to the caller, on the
    result's device (CUDA divides by a Python number as a product).
    """

    def __init__(self):
        self.charges: List[Tuple[Pid, Optional[int], str, int]] = []
        self.lines: List[Tuple[Pid, int, int]] = []

    def charge(self, pid: Pid, seg: Optional[int] = None, link: str = "ici",
               hops: int = 1) -> None:
        self.charges.append((pid, seg, link, hops))

    def line(self, pid: Pid, a: int, b: int) -> None:
        """The pack crosses between pods ``a`` and ``b``: its bytes go
        through both pods' DCN lines (sent and received)."""
        self.lines.append((pid, a, b))

    def replay(self, table: Dict[Pid, Tuple[torch.Tensor, torch.Tensor]],
               n_segments: int, pods: int, device
               ) -> Tuple[PackCounter, List[torch.Tensor]]:
        """(counter, per-pod DCN line bytes) from ``table``: pack id ->
        (0-d f32 bytes, 0-d f32 Delta) on ``device``."""
        ctr = PackCounter(n_segments, device)
        for pid, seg, link, hops in self.charges:
            ctr.count(*table[pid], seg=seg, link=link, hops=hops)
        traffic = [torch.zeros((), dtype=torch.float32, device=device)] * pods
        for pid, a, b in self.lines:
            nbytes = table[pid][0]
            traffic[a] = traffic[a] + nbytes
            traffic[b] = traffic[b] + nbytes
        return ctr, traffic


def pack_table(packs) -> Dict[Pid, Tuple[torch.Tensor, torch.Tensor]]:
    """A simulation's table for :meth:`Ledger.replay`: pack id -> (its
    measured wire bytes as f32, its Delta), on the packs' device."""
    return {pid: (p.wire_bytes().to(torch.float32), p.deltas[0])
            for pid, p in packs.items()}


def record_table(records: Dict[Pid, Tuple[int, float]]
                 ) -> Dict[Pid, Tuple[torch.Tensor, torch.Tensor]]:
    """A process reduce's table for :meth:`Ledger.replay` from the gathered
    host records (``repro_torch.comm.p2p.Exchange.records``), on the CPU:
    the int32 bytes cast to f32 as the simulation casts them."""
    return {pid: (torch.tensor(b, dtype=torch.int32).to(torch.float32),
                  torch.tensor(d, dtype=torch.float32))
            for pid, (b, d) in records.items()}
