"""Dither, residual-memory and comm telemetry.

Counterpart of the ``"dither"``, ``"memory"`` and ``"comm"`` streams of
``repro.obs.metrics``, with the calls the training harness reads:

* each backward appends one row ``[sparsity, bits, delta]`` per dithered
  layer (:func:`emit`);
* each forward that saves a residual for a backward appends one row
  ``[measured, capacity, dense]`` bytes per dithered layer
  (:func:`emit_memory`): the wire-equivalent occupancy, the device-resident
  capacity of the encoding, and the dense store it replaces;
* each compressed gradient exchange appends one row ``[wire, dense]``
  bytes (:func:`emit_comm`, through ``repro_torch.comm.telemetry``).

Rows stay device tensors until a reader asks, so emitting costs no host
sync. The store is module state shared by the process, like the reference's
default bus: ``reset()`` starts a new run.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.nsd import QuantStats

_ROWS: Dict[str, List[torch.Tensor]] = {}
_MEMORY: Dict[str, List[torch.Tensor]] = {}
_COMM: Dict[str, List[torch.Tensor]] = {}


def reset() -> None:
    _ROWS.clear()
    _MEMORY.clear()
    _COMM.clear()


def emit(tag: str, stats: QuantStats) -> None:
    """Record one layer's stats (called from inside a backward pass)."""
    row = torch.stack([stats.sparsity, stats.max_bitwidth,
                       stats.delta.to(torch.float32)])
    _ROWS.setdefault(tag, []).append(row)


def tags() -> List[str]:
    return list(_ROWS)


def rows(tag: str) -> np.ndarray:
    """(n, 3) f32 array of [sparsity, bits, delta] records for a tag."""
    if not _ROWS.get(tag):
        return np.zeros((0, 3), np.float32)
    return torch.stack(_ROWS[tag]).cpu().numpy()


def _all_rows() -> np.ndarray:
    if not any(_ROWS.values()):
        return np.zeros((0, 3), np.float32)
    return np.concatenate([rows(t) for t in tags()], axis=0)


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
    _MEMORY.setdefault(tag, []).append(
        (measured_bytes, float(capacity_bytes), float(dense_bytes)))


def memory_tags() -> List[str]:
    return list(_MEMORY)


def memory_rows(tag: str) -> np.ndarray:
    """(n, 3) f32 array of [measured, capacity, dense] byte records."""
    return np.array([[float(m), c, d] for m, c, d in _MEMORY.get(tag, ())],
                    np.float32).reshape(-1, 3)


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
    _COMM.setdefault(tag, []).append(torch.stack([wire_bytes, dense_bytes]))


def comm_tags() -> List[str]:
    return list(_COMM)


def comm_rows(tag: str) -> np.ndarray:
    """(n, 2) f32 array of [wire_bytes, dense_bytes] records for a tag."""
    if not _COMM.get(tag):
        return np.zeros((0, 2), np.float32)
    return torch.stack(_COMM[tag]).cpu().numpy()


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
