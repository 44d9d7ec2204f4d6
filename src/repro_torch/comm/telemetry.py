"""Comm-side telemetry: bytes-on-wire counters.

Counterpart of ``repro.comm.telemetry``'s ``emit``: every reduce under
``CommPolicy.collect_stats`` appends one row to the comm stream of
``repro_torch.obs.metrics`` under :data:`TAG`, and
``metrics.comm_summary()`` reads it back. The reference's ``summary`` /
``totals`` readers, its per-policy tags and ``wire_seconds`` (the price of
the bytes on a TPU link) are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.obs import metrics

TAG = "comm/"


def emit(wire_bytes: torch.Tensor, dense_bytes: torch.Tensor) -> None:
    """Record one exchange's byte counts (0-d f32 device tensors)."""
    metrics.emit_comm(TAG, wire_bytes, dense_bytes)
