"""The metrics bus: one typed store for every telemetry row.

Counterpart of ``repro.obs.bus``. Producers append rows to a declared
stream (``repro_torch.obs.streams``) under a tag: the backward passes'
dither rows, the forwards' residual bytes, the comm wire's byte counts, the
span tracer's phase timings, the trainer's per-step metrics.

Rows from the device stay there. :meth:`MetricsBus.emit` (and
:meth:`MetricsBus.record`) keep a row given as a device tensor, or as a
sequence of device scalars and host numbers, as it is: appending costs no
host sync and no host-to-device copy. Readers first *drain*: every row still
on a device is copied to the host in one transfer per device and dtype and
replaced by its f32 numpy row. That copy waits for the work that produced
the rows, as the reference's ``jax.effects_barrier()`` waits for its
in-flight callbacks; after it, the store holds host rows only, f32 like the
reference's.

Stacked views are cached per (stream, tag) *generation* (the row count at
stack time): reading an unchanged tag again returns the cached stack.
:meth:`MetricsBus.rows_since` stacks only the suffix a cursor has not seen,
so per-step consumers (the controller's telemetry window, monitors, the run
log) cost O(new rows) a tick. Monitor events are dicts in a parallel log on
the same bus. One lock guards the store, so concurrent recorders keep each
tag's order.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.streams import MetricStream, StreamRegistry


def _device_row(row) -> bool:
    """Whether a row holds device values (a tensor, or a sequence with a
    tensor in it)."""
    if isinstance(row, torch.Tensor):
        return True
    return (isinstance(row, (list, tuple))
            and any(isinstance(v, torch.Tensor) for v in row))


class MetricsBus:
    """Thread-safe process-local store of typed telemetry rows."""

    def __init__(self):
        self.registry = StreamRegistry()
        self._lock = threading.Lock()
        # (stream, tag) -> rows: (ncols,) f32 numpy rows, or rows still on a
        # device (a (ncols,) tensor, or a tuple of 0-d tensors and floats)
        self._rows: Dict[Tuple[str, str], List[Any]] = {}
        # rows still on a device: (stream, tag, index) in arrival order
        self._pending: List[Tuple[str, str, int]] = []
        # (stream, tag) -> (generation == len at stack time, stacked view)
        self._stacked: Dict[Tuple[str, str], Tuple[int, np.ndarray]] = {}
        # structured (non-numeric) event records, in arrival order
        self._events: List[Dict[str, Any]] = []
        # stacks made, for the regression pin of the generation cache
        self.stack_calls = 0

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        with self._lock:
            self._rows.clear()
            self._pending.clear()
            self._stacked.clear()
            self._events.clear()

    def drain(self) -> None:
        """Copy every row still on a device to the host (readers call this
        first). One transfer per device and dtype; a no-op when nothing is
        pending."""
        with self._lock:
            if not self._pending:
                return
            # each device value goes into its (device, dtype) group; a row
            # keeps, per entry, a host float or its group and offset
            groups: Dict[Tuple[torch.device, torch.dtype], list] = {}
            sizes: Dict[Tuple[torch.device, torch.dtype], int] = {}
            layouts = []
            for stream, tag, i in self._pending:
                row = self._rows[(stream, tag)][i]
                parts = [row] if isinstance(row, torch.Tensor) else row
                layout = []
                for v in parts:
                    if not isinstance(v, torch.Tensor):
                        layout.append((None, float(v)))
                        continue
                    key = (v.device, v.dtype)
                    offset = sizes.get(key, 0)
                    groups.setdefault(key, []).append(v.detach().reshape(-1))
                    sizes[key] = offset + v.numel()
                    layout.extend((key, offset + j) for j in range(v.numel()))
                layouts.append(layout)
            # through f64: exact for f32 and for integer counts < 2^53, then
            # rounded once to f32, as float(x) then f32 would be
            host = {key: torch.cat(vals).cpu().to(torch.float64).numpy()
                    for key, vals in groups.items()}
            for (stream, tag, i), layout in zip(self._pending, layouts):
                self._rows[(stream, tag)][i] = np.array(
                    [v if key is None else host[key][v] for key, v in layout],
                    np.float32)
            self._pending.clear()

    # ------------------------------------------------------------- writers
    def record(self, stream: str, tag: str, row) -> None:
        """Append one row: a host row (anything ``np.asarray`` takes), a
        device tensor of the stream's arity, or a sequence of that many 0-d
        tensors and numbers. Device values stay where they are until a
        reader drains them."""
        spec = self.registry.get(stream)
        if _device_row(row):
            if isinstance(row, torch.Tensor):
                shape = tuple(row.shape)
            else:
                row = tuple(row)
                if any(isinstance(v, torch.Tensor) and v.numel() != 1
                       for v in row):
                    raise ValueError(f"stream {stream!r}: a row entry is "
                                     f"not a scalar")
                shape = (len(row),)
        else:
            row = np.asarray(row, np.float32).reshape(-1)
            shape = row.shape
        if shape != (spec.ncols,):
            raise ValueError(
                f"stream {stream!r} expects {spec.ncols} columns "
                f"{spec.columns}, got row of shape {shape}")
        with self._lock:
            rows = self._rows.setdefault((stream, tag), [])
            if not isinstance(row, np.ndarray):
                self._pending.append((stream, tag, len(rows)))
            rows.append(row)

    def emit(self, stream: str, tag: str, values) -> None:
        """Record one row from inside a forward or backward pass: ``values``
        (a device tensor or a sequence of device scalars and numbers) is
        kept as it is, so emitting never waits for the device."""
        self.record(stream, tag, values)

    def log_event(self, event: Dict[str, Any]) -> None:
        """Append one structured (dict) event: monitor trips etc."""
        with self._lock:
            self._events.append(dict(event))

    # ------------------------------------------------------------- readers
    def _empty(self, stream: str) -> np.ndarray:
        return np.zeros((0, self.registry.get(stream).ncols), np.float32)

    def rows(self, stream: str, tag: str) -> np.ndarray:
        """(n, ncols) f32 array of every row recorded for (stream, tag).
        The stack is cached per generation: reading an unchanged tag again
        costs O(1)."""
        self.drain()
        key = (stream, tag)
        with self._lock:
            rows = self._rows.get(key)
            if not rows:
                return self._empty(stream)
            gen = len(rows)
            cached = self._stacked.get(key)
            if cached is not None and cached[0] == gen:
                return cached[1]
            stacked = np.stack(rows)
            self.stack_calls += 1
            self._stacked[key] = (gen, stacked)
            return stacked

    def rows_since(self, stream: str, tag: str, start: int) -> np.ndarray:
        """Rows from index ``start`` on, stacking only the new suffix."""
        self.drain()
        with self._lock:
            new = self._rows.get((stream, tag), [])[start:]
            if not new:
                return self._empty(stream)
            self.stack_calls += 1
            return np.stack(new)

    def row_count(self, stream: str, tag: str) -> int:
        with self._lock:
            return len(self._rows.get((stream, tag), []))

    def tags(self, stream: str) -> List[str]:
        with self._lock:
            return sorted(t for (s, t), r in self._rows.items()
                          if s == stream and r)

    def streams_present(self) -> List[str]:
        """Stream names that hold at least one row."""
        with self._lock:
            return sorted({s for (s, _t), r in self._rows.items() if r})

    def events(self, start: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events[start:]]

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    def cursors(self) -> Dict[Tuple[str, str], int]:
        """Row counts by (stream, tag), in the order of each key's first
        row, for incremental exporters."""
        with self._lock:
            return {k: len(v) for k, v in self._rows.items() if v}


# ---------------------------------------------------------------------------
# the process default bus (what obs.metrics and the tracer write to)
# ---------------------------------------------------------------------------

_DEFAULT: Optional[MetricsBus] = None
_DEFAULT_LOCK = threading.Lock()


def get_bus() -> MetricsBus:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsBus()
    return _DEFAULT


def set_bus(bus: Optional[MetricsBus]) -> MetricsBus:
    """Swap the process default (tests); returns the new default."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = bus
    return get_bus()


def register_stream(stream: MetricStream) -> MetricStream:
    return get_bus().registry.register(stream)
