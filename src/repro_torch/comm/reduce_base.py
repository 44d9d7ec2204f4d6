"""Shared machinery of the compressed reduces: segmenting, hop keys and the
wire and error accounting.

Counterpart of ``repro.comm.reduce_base`` for the simulated reduces (the
flat ring, the hierarchy and the butterfly; the shard_map paths wait for
ROADMAP.md section 1, item 7.2):

  * segmenting      a flat gradient is zero-padded and split into
                    chunk-aligned segments, one per ring position;
  * hop keys        every pack that crosses a link gets a fresh stream key
                    folded from (salt, *position indices), so re-dither
                    noise is independent across hops and nodes;
  * accounting      wire bytes are measured per pack (never estimated) and
                    the pointwise error bound is the running sum of the
                    Deltas of every pack whose quantization error lands in a
                    segment's final value (paper eqs. 5/6 and
                    |Q(x) - x| <= Delta pointwise).

Keys are the int stream keys of ``repro_torch.core.policy`` (a splitmix64
``fold_in`` chain standing in for the reference's ``jax.random.fold_in``
chain, one fold per fold). Counters are f32 tensors on the device, summed
in the reference's order; nothing here syncs with the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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

    def count(self, packed, seg: Optional[int] = None, link: str = "ici",
              hops: int = 1) -> None:
        """Record a pack crossing ``hops`` links of class ``link``; with
        ``seg``, charge its Delta (``deltas[0]``) to that segment's error
        bound (None for a pack forwarded verbatim, charged when made)."""
        self.wire[link] = (self.wire[link]
                           + packed.wire_bytes().to(torch.float32) * hops)
        if seg is not None:
            self.bound[seg] += packed.deltas[0]

    @property
    def wire_total(self) -> torch.Tensor:
        return self.wire["ici"] + self.wire["dcn"]
