"""Dither, residual-memory, comm and fallback telemetry over the bus.

Counterpart of ``repro.obs.metrics``: the named read/write calls over the
built-in streams of the process default bus (``repro_torch.obs.bus``):

* :func:`emit` / :func:`rows` / ...        -> stream ``"dither"``: each
  backward appends one row ``[sparsity, bits, delta]`` per dithered layer;
* :func:`emit_memory` / ...                -> stream ``"memory"``: each
  forward that saves a residual for a backward appends one row
  ``[measured, capacity, dense]`` bytes per dithered layer (the
  wire-equivalent occupancy, the device-resident capacity of the encoding,
  the dense store it replaces);
* :func:`emit_comm` / ...                  -> stream ``"comm"``: each
  compressed gradient exchange appends ``[wire, dense]`` bytes (through
  ``repro_torch.comm.telemetry``);
* :func:`emit_kernel_fallbacks`            -> stream ``"fallback"``.

Rows stay device tensors until a reader asks, so emitting costs no host
sync. ``reset()`` starts a new run. The aggregations (:func:`overall_sparsity`
and the rest) visit tags in the order of their first row.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.nsd import QuantStats
from repro_torch.obs.bus import get_bus

STREAM_DITHER = "dither"
STREAM_COMM = "comm"
STREAM_MEMORY = "memory"
STREAM_FALLBACK = "fallback"


def reset() -> None:
    """Clear every stream on the default bus."""
    get_bus().reset()


def _tags(stream: str) -> List[str]:
    """A stream's tags in the order of their first row: the order the
    port's aggregations have used since its first slice (the reference
    sorts; an f32 mean over concatenated rows depends on their order)."""
    return [t for s, t in get_bus().cursors() if s == stream]


# ---------------------------------------------------------------------------
# dither sparsity / bit-width / delta (stream "dither")
# ---------------------------------------------------------------------------

def emit(tag: str, stats: QuantStats) -> None:
    """Record one layer's stats (called from inside a backward pass)."""
    row = torch.stack([stats.sparsity, stats.max_bitwidth,
                       stats.delta.to(torch.float32)])
    get_bus().emit(STREAM_DITHER, tag, row)


def tags() -> List[str]:
    return _tags(STREAM_DITHER)


def rows(tag: str) -> np.ndarray:
    """(n, 3) f32 array of [sparsity, bits, delta] records for a tag."""
    return get_bus().rows(STREAM_DITHER, tag)


def rows_since(tag: str, start: int) -> np.ndarray:
    """Records from index ``start`` on, without restacking the history (the
    sparsity controller's telemetry window reads these)."""
    return get_bus().rows_since(STREAM_DITHER, tag, start)


def row_count(tag: str) -> int:
    return get_bus().row_count(STREAM_DITHER, tag)


def _all_rows() -> np.ndarray:
    all_rows = [r for r in (rows(t) for t in tags()) if len(r)]
    if not all_rows:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(all_rows, axis=0)


def overall_sparsity() -> float:
    """Mean sparsity over every recorded layer x step, as in Table 1."""
    cat = _all_rows()
    return float(cat[:, 0].mean()) if len(cat) else float("nan")


def overall_max_bits() -> float:
    """Worst-case bit-width over every recorded layer x step."""
    cat = _all_rows()
    return float(cat[:, 1].max()) if len(cat) else float("nan")


# ---------------------------------------------------------------------------
# residual-memory counters: bytes the backward keeps alive per layer
# ---------------------------------------------------------------------------

def emit_memory(tag: str, measured_bytes, capacity_bytes: int,
                dense_bytes: int) -> None:
    """Record one layer's (measured, capacity, dense) residual byte counts
    (called from inside a forward pass). ``measured_bytes`` may be a device
    tensor (the nsd wire figure): it stays there until a reader asks, and
    the two static counts stay host numbers, so emitting never copies to or
    waits for the device."""
    get_bus().emit(STREAM_MEMORY, tag, (measured_bytes, float(capacity_bytes),
                                        float(dense_bytes)))


def memory_tags() -> List[str]:
    return _tags(STREAM_MEMORY)


def memory_rows(tag: str) -> np.ndarray:
    """(n, 3) f32 array of [measured, capacity, dense] byte records."""
    return get_bus().rows(STREAM_MEMORY, tag)


def memory_summary() -> Dict[str, Dict[str, float]]:
    """Per-tag residual byte totals and the two compression factors:
    ``capacity_compression`` (dense / device-resident capacity) and
    ``occupancy_compression`` (dense / wire-equivalent measured bytes)."""
    out = {}
    for tag in memory_tags():
        r = memory_rows(tag)
        if len(r) == 0:
            continue
        measured, cap, dense = (float(r[:, i].sum()) for i in range(3))
        out[tag] = {
            "measured_bytes": measured,
            "capacity_bytes": cap,
            "dense_bytes": dense,
            "occupancy_compression": (dense / measured if measured
                                      else float("nan")),
            "capacity_compression": dense / cap if cap else float("nan"),
            "n_records": int(len(r)),
        }
    return out


def overall_residual_compression() -> float:
    """dense / measured bytes over every recorded layer x step."""
    stored = dense = 0.0
    for tag in memory_tags():
        r = memory_rows(tag)
        if len(r):
            stored += float(r[:, 0].sum())
            dense += float(r[:, 2].sum())
    if stored <= 0:
        return float("nan")
    return dense / stored


# ---------------------------------------------------------------------------
# comm counters: bytes on the wire of a compressed gradient exchange
# ---------------------------------------------------------------------------

def emit_comm(tag: str, wire_bytes: torch.Tensor,
              dense_bytes: torch.Tensor) -> None:
    """Record one exchange's (wire, dense) byte counts, 0-d f32 tensors that
    stay on their device until a reader asks."""
    get_bus().emit(STREAM_COMM, tag, torch.stack([wire_bytes, dense_bytes]))


def comm_tags() -> List[str]:
    return _tags(STREAM_COMM)


def comm_rows(tag: str) -> np.ndarray:
    """(n, 2) f32 array of [wire_bytes, dense_bytes] records for a tag."""
    return get_bus().rows(STREAM_COMM, tag)


def comm_summary() -> Dict[str, Dict[str, float]]:
    """Per-tag total wire and dense bytes and the compression ratio."""
    out = {}
    for tag in comm_tags():
        r = comm_rows(tag)
        if len(r) == 0:
            continue
        wire, dense = float(r[:, 0].sum()), float(r[:, 1].sum())
        out[tag] = {
            "wire_bytes": wire,
            "dense_bytes": dense,
            "ratio": wire / dense if dense else float("nan"),
            "n_records": int(len(r)),
        }
    return out


# ---------------------------------------------------------------------------
# kernel fallback counters (stream "fallback")
# ---------------------------------------------------------------------------

def emit_kernel_fallbacks(*, bus=None) -> Dict[str, int]:
    """Snapshot ``repro_torch.kernels.ops.KERNEL_FALLBACKS`` onto the bus:
    one row a reason (tag ``kernels/`` + reason, value the cumulative count),
    so a run directory records which structural forms left the kernel path.
    Returns the snapshot. Host-side; ``RunObs.finish`` calls it."""
    from repro_torch.kernels.ops import KERNEL_FALLBACKS

    snap = dict(KERNEL_FALLBACKS)
    bus = bus if bus is not None else get_bus()
    for reason, count in sorted(snap.items()):
        bus.record(STREAM_FALLBACK, "kernels/" + reason, [float(count)])
    return snap
