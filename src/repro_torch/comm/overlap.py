"""Overlap bucketing: the gradient reduce cut into buckets in reverse layer
order.

Counterpart of ``repro.comm.overlap``. Backward produces gradients in
reverse layer order, so the last layers' gradients are ready while the
first layers still differentiate. The scheduler

  1. buckets the gradient leaves in reverse flatten order into
     ~``bucket_bytes`` buckets (:func:`plan_buckets`; a leaf larger than
     the target gets a bucket of its own, never split, because its pack
     keys derive from its name);
  2. reduces the buckets one after another.

The result is the blocking reduce's, bit for bit: every reducer keys a
leaf's packs by the leaf's name alone, never by its bucket. In the
reference the buckets are dataflow inside one jitted step, which XLA may
interleave with the backward; in the port they run one after another once
the backward is done, which computes what that dataflow computes. Launching
each bucket from gradient hooks on a side stream while the backward runs is
real overlap, a speed item (ROADMAP.md section 2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.comm.reducer import Reducer, ReducerTelemetry

__all__ = ["BucketPlan", "OverlapReducer", "plan_buckets"]


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """A static bucketing of a gradient dict: names and byte totals.

    ``buckets[0]`` holds the leaves backward finishes first (the reverse of
    flatten order), so index order is launch order.
    """

    buckets: Tuple[Tuple[str, ...], ...]
    bucket_bytes: Tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_bytes(self) -> int:
        return sum(self.bucket_bytes)


def plan_buckets(named_bytes: Sequence[Tuple[str, int]],
                 bucket_bytes: int) -> BucketPlan:
    """Greedy fill in reverse order (the backward's) into ~``bucket_bytes``
    buckets. A
    bucket closes when the next leaf would push it past the target, so
    every bucket but the last is at most the target unless one leaf alone
    exceeds it."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    order = list(reversed(named_bytes))
    buckets: List[Tuple[str, ...]] = []
    totals: List[int] = []
    cur: List[str] = []
    cur_bytes = 0
    for name, nbytes in order:
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(tuple(cur))
            totals.append(cur_bytes)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += int(nbytes)
    if cur:
        buckets.append(tuple(cur))
        totals.append(cur_bytes)
    return BucketPlan(buckets=tuple(buckets), bucket_bytes=tuple(totals))


class OverlapReducer(Reducer):
    """Any Reducer with reverse-layer-order bucket scheduling.

    ``reduce`` returns the wrapped reducer's blocking result bit for bit;
    the telemetry sums over the buckets (``error_bound`` and
    ``peak_dcn_bytes`` take the max) with ``n_buckets`` counting them. With
    ``collect_stats`` the wrapped reducer records one comm row a bucket.
    """

    def __init__(self, base: Reducer, bucket_bytes: int):
        self.base = base
        self.bucket_target = int(bucket_bytes)
        self.policy = base.policy
        self.n_nodes = base.n_nodes
        self.mesh = base.mesh
        self.topology = base.topology

    def init_state(self, params_or_grads):
        return self.base.init_state(params_or_grads)

    def plan_for(self, grads: Dict[str, torch.Tensor]) -> BucketPlan:
        """The schedule this gradient dict reduces under (bytes a node: a
        mesh reducer's leaves are already one node's)."""
        per = 1 if self.mesh is not None else max(self.n_nodes, 1)
        named = [(name, g.numel() * g.element_size() // per)
                 for name, g in sorted(grads.items())]
        return plan_buckets(named, self.bucket_target)

    def reduce(self, grads: Dict[str, torch.Tensor], key: int, step: int,
               state: Optional[Dict] = None):
        state = dict(state or {})
        out: Dict[str, torch.Tensor] = {}
        tele: Optional[ReducerTelemetry] = None
        for names in self.plan_for(grads).buckets:
            sub_out, t, state = self.base.reduce(
                {name: grads[name] for name in names}, key, step, state)
            out.update(sub_out)
            tele = t if tele is None else tele.accumulate(t)
        return {name: out[name] for name in sorted(grads)}, tele, state
