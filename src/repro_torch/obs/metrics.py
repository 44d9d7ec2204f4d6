"""Dither telemetry: per-layer sparsity, bit-width and step size.

Counterpart of the ``"dither"`` stream of ``repro.obs.metrics``, with the
calls the training harness reads. Each backward appends one row
``[sparsity, bits, delta]`` per dithered layer; rows stay device tensors
until a reader asks, so emitting costs no host sync. The store is module
state shared by the process, like the reference's default bus:
``reset()`` starts a new run.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.nsd import QuantStats

_ROWS: Dict[str, List[torch.Tensor]] = {}


def reset() -> None:
    _ROWS.clear()


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
