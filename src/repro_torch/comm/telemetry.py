"""Comm-side telemetry: bytes-on-wire counters and their price on a link.

Counterpart of ``repro.comm.telemetry``: every reduce (or ``compress_tree``)
under ``CommPolicy.collect_stats`` appends one row to the comm stream of
``repro_torch.obs.metrics`` under the policy's ``stats_tag`` (:data:`TAG`
by default); :func:`summary` reads the rows back per tag, :func:`totals`
folds the tags together, and :func:`wire_seconds` prices measured bytes on
the fast link of ``repro_torch.comm.pricing`` (NVLink on the H100
platform).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.comm.pricing import price_wire_bytes

from repro_torch.obs import metrics

TAG = "comm/"  # CommPolicy.stats_tag's default


class CommTelemetry(NamedTuple):
    """One tag's exchanges, added up."""

    wire_bytes: float
    dense_bytes: float
    n_records: int

    @property
    def ratio(self) -> float:
        return (self.wire_bytes / self.dense_bytes
                if self.dense_bytes else float("nan"))


def emit(tag: str, wire_bytes: torch.Tensor, dense_bytes: torch.Tensor
         ) -> None:
    """Record one exchange's byte counts (0-d f32 device tensors)."""
    metrics.emit_comm(tag, wire_bytes, dense_bytes)


def reset() -> None:
    metrics.reset()


def summary() -> Dict[str, CommTelemetry]:
    return {tag: CommTelemetry(wire_bytes=row["wire_bytes"],
                               dense_bytes=row["dense_bytes"],
                               n_records=row["n_records"])
            for tag, row in metrics.comm_summary().items()}


def totals() -> CommTelemetry:
    """Every tag folded together."""
    wire = dense = 0.0
    n = 0
    for t in summary().values():
        wire += t.wire_bytes
        dense += t.dense_bytes
        n += t.n_records
    return CommTelemetry(wire_bytes=wire, dense_bytes=dense, n_records=n)


def wire_seconds(wire_bytes: float) -> float:
    """Seconds measured wire bytes occupy one fast link."""
    return price_wire_bytes(wire_bytes)
