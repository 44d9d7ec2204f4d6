"""Health monitors: rolling-window detectors over the metrics bus.

Counterpart of ``repro.obs.monitor``, with its detectors, thresholds,
severities and messages. Each monitor consumes the *new* rows of one stream
a tick (cursor-based, so a tick is O(new rows)), folds them into a bounded
rolling window, and emits structured :class:`MonitorEvent` records when the
window violates its threshold. Events land in the bus's event log (drained
into ``monitor.jsonl`` by the run log) and are logged as warnings; a
:class:`MonitorSuite` with ``escalate=True`` raises :class:`MonitorAlert` on
critical events, so an unattended run stops instead of training on NaNs.

Built-in detectors:

* :class:`LossMonitor`        non-finite loss on the ``train`` stream
                              (critical);
* :class:`SparsityMonitor`    rolling per-layer dither sparsity below
                              ``setpoint - band`` (the controller's target
                              band made observable);
* :class:`CommRatioMonitor`   wire/dense byte ratio above a ceiling;
* :class:`MemoryRatioMonitor` residual compression (dense / measured) below
                              a floor;
* :class:`BoundMonitor`       the compressed reduce's pointwise error bound
                              above a ceiling;
* :class:`ServeMonitor`       a serving engine stalled (work pending, no
                              token fed; critical) or backlogged (rolling
                              queue depth above a ceiling).

A monitor reads the bus and logs; it never changes the run's policy.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.bus import MetricsBus, get_bus
from repro_torch.utils import get_logger

log = get_logger("repro_torch.obs.monitor")

SEV_WARNING = "warning"
SEV_CRITICAL = "critical"


class MonitorAlert(RuntimeError):
    """Raised by an escalating MonitorSuite on a critical event."""

    def __init__(self, events: Sequence["MonitorEvent"]):
        self.events = list(events)
        super().__init__("; ".join(e.message for e in self.events))


@dataclasses.dataclass(frozen=True)
class MonitorEvent:
    """One structured detector trip."""

    kind: str  # detector id, e.g. "loss_nonfinite"
    severity: str  # "warning" | "critical"
    step: int
    message: str
    value: float  # the offending measurement
    threshold: float  # the limit it violated
    tag: str = ""  # stream tag (layer name etc.), when per-tag

    def to_dict(self) -> Dict:
        def safe(v):  # strict-JSON scalar: non-finite -> null
            return float(v) if np.isfinite(v) else None

        return {"kind": self.kind, "severity": self.severity,
                "step": int(self.step), "message": self.message,
                "value": safe(self.value),
                "threshold": safe(self.threshold), "tag": self.tag}


class Monitor:
    """Base: cursor-tracked consumer of one stream."""

    stream = ""
    kind = ""

    def __init__(self, *, window: int = 20, bus: Optional[MetricsBus] = None):
        self.window = int(window)
        self._bus = bus
        self._cursors: Dict[str, int] = {}
        self._windows: Dict[str, Deque[np.ndarray]] = {}

    @property
    def bus(self) -> MetricsBus:
        return self._bus if self._bus is not None else get_bus()

    def _consume(self) -> List[Tuple[str, np.ndarray]]:
        """(tag, new_rows) for every tag with fresh rows; updates cursors
        and rolling windows."""
        out = []
        bus = self.bus
        for tag in bus.tags(self.stream):
            seen = self._cursors.get(tag, 0)
            new = bus.rows_since(self.stream, tag, seen)
            if not len(new):
                continue
            self._cursors[tag] = seen + len(new)
            win = self._windows.setdefault(
                tag, collections.deque(maxlen=self.window))
            for r in new:
                win.append(r)
            out.append((tag, new))
        return out

    def window_rows(self, tag: str) -> np.ndarray:
        win = self._windows.get(tag)
        if not win:
            return np.zeros((0,), np.float32)
        return np.stack(list(win))

    def tick(self, step: int) -> List[MonitorEvent]:
        raise NotImplementedError


class LossMonitor(Monitor):
    """Critical on any non-finite loss row (stream ``train``)."""

    stream = "train"
    kind = "loss_nonfinite"

    def tick(self, step: int) -> List[MonitorEvent]:
        events = []
        for tag, new in self._consume():
            bad = new[~np.isfinite(new[:, 1])]
            if len(bad):
                events.append(MonitorEvent(
                    kind=self.kind, severity=SEV_CRITICAL,
                    step=int(bad[0, 0]) if np.isfinite(bad[0, 0]) else step,
                    message=f"non-finite loss at step "
                            f"{int(bad[0, 0]) if np.isfinite(bad[0, 0]) else step}",
                    value=float(bad[0, 1]), threshold=float("inf"), tag=tag))
        return events


class SparsityMonitor(Monitor):
    """Rolling per-layer dither sparsity below ``setpoint - band``.

    ``setpoint`` is the controller target (or the policy author's
    expectation, ~0.92 for the paper's s=2 regime); ``band`` is the slack
    before a warning fires. ``min_rows`` rows must be in a layer's window
    before it is judged, so warmup noise cannot trip it.
    """

    stream = "dither"
    kind = "sparsity_collapse"

    def __init__(self, setpoint: float = 0.92, band: float = 0.15, *,
                 min_rows: int = 5, window: int = 50,
                 bus: Optional[MetricsBus] = None):
        super().__init__(window=window, bus=bus)
        self.setpoint = float(setpoint)
        self.band = float(band)
        self.min_rows = int(min_rows)

    def tick(self, step: int) -> List[MonitorEvent]:
        events = []
        floor = self.setpoint - self.band
        for tag, _new in self._consume():
            win = self.window_rows(tag)
            if len(win) < self.min_rows:
                continue
            mean_sp = float(win[:, 0].mean())
            if mean_sp < floor:
                events.append(MonitorEvent(
                    kind=self.kind, severity=SEV_WARNING, step=step,
                    message=f"{tag}: rolling sparsity {mean_sp:.3f} below "
                            f"setpoint {self.setpoint:.2f} - band "
                            f"{self.band:.2f}",
                    value=mean_sp, threshold=floor, tag=tag))
        return events


class CommRatioMonitor(Monitor):
    """Wire/dense byte ratio above ``max_ratio`` over the rolling window —
    the compressed gradient exchange stopped compressing."""

    stream = "comm"
    kind = "comm_ratio_drift"

    def __init__(self, max_ratio: float = 0.5, *, min_rows: int = 3,
                 window: int = 50, bus: Optional[MetricsBus] = None):
        super().__init__(window=window, bus=bus)
        self.max_ratio = float(max_ratio)
        self.min_rows = int(min_rows)

    def tick(self, step: int) -> List[MonitorEvent]:
        events = []
        for tag, _new in self._consume():
            win = self.window_rows(tag)
            if len(win) < self.min_rows:
                continue
            wire, dense = float(win[:, 0].sum()), float(win[:, 1].sum())
            if dense <= 0:
                continue
            ratio = wire / dense
            if ratio > self.max_ratio:
                events.append(MonitorEvent(
                    kind=self.kind, severity=SEV_WARNING, step=step,
                    message=f"{tag}: wire/dense ratio {ratio:.3f} above "
                            f"{self.max_ratio:.3f}",
                    value=ratio, threshold=self.max_ratio, tag=tag))
        return events


class MemoryRatioMonitor(Monitor):
    """Residual compression (dense / measured bytes) below ``min_x``."""

    stream = "memory"
    kind = "residual_compression_drift"

    def __init__(self, min_x: float = 1.5, *, min_rows: int = 3,
                 window: int = 50, bus: Optional[MetricsBus] = None):
        super().__init__(window=window, bus=bus)
        self.min_x = float(min_x)
        self.min_rows = int(min_rows)

    def tick(self, step: int) -> List[MonitorEvent]:
        events = []
        for tag, _new in self._consume():
            win = self.window_rows(tag)
            if len(win) < self.min_rows:
                continue
            measured, dense = float(win[:, 0].sum()), float(win[:, 2].sum())
            if measured <= 0:
                continue
            x = dense / measured
            if x < self.min_x:
                events.append(MonitorEvent(
                    kind=self.kind, severity=SEV_WARNING, step=step,
                    message=f"{tag}: residual compression {x:.2f}x below "
                            f"{self.min_x:.2f}x floor",
                    value=x, threshold=self.min_x, tag=tag))
        return events


class BoundMonitor(Monitor):
    """Compressed-reduce pointwise error bound above ``max_bound`` —
    the eq.-6 error budget blowing up (stream ``bound``)."""

    stream = "bound"
    kind = "error_bound_blowup"

    def __init__(self, max_bound: float = 1.0, *,
                 window: int = 20, bus: Optional[MetricsBus] = None):
        super().__init__(window=window, bus=bus)
        self.max_bound = float(max_bound)

    def tick(self, step: int) -> List[MonitorEvent]:
        events = []
        for tag, new in self._consume():
            worst = float(np.max(new[:, 1]))
            if worst > self.max_bound or not np.isfinite(worst):
                events.append(MonitorEvent(
                    kind=self.kind, severity=SEV_WARNING, step=step,
                    message=f"{tag}: reduce error bound {worst:.3g} above "
                            f"{self.max_bound:.3g}",
                    value=worst, threshold=self.max_bound, tag=tag))
        return events


class ServeMonitor(Monitor):
    """Serving-engine health on the ``serve`` stream (tag = worker name).

    Two detectors in one consumer: a *stall* (critical) — rows show work in
    the system (active slots or queued requests) but no tokens fed for
    ``min_rows`` consecutive ticks, i.e. the engine is wedged — and a
    *backlog* (warning) — rolling mean queue depth above ``max_backlog``,
    i.e. admission is not keeping up with arrivals.
    """

    stream = "serve"
    kind = "serve_stall"

    def __init__(self, max_backlog: float = 32.0, *, min_rows: int = 8,
                 window: int = 50, bus: Optional[MetricsBus] = None):
        super().__init__(window=window, bus=bus)
        self.max_backlog = float(max_backlog)
        self.min_rows = int(min_rows)

    def tick(self, step: int) -> List[MonitorEvent]:
        events = []
        for tag, _new in self._consume():
            win = self.window_rows(tag)
            if len(win) < self.min_rows:
                continue
            tail = win[-self.min_rows:]
            busy = (tail[:, 1] + tail[:, 2]) > 0  # active_slots + queue
            fed = tail[:, 3]
            if busy.all() and float(fed.sum()) == 0.0:
                events.append(MonitorEvent(
                    kind=self.kind, severity=SEV_CRITICAL, step=step,
                    message=f"{tag}: {self.min_rows} ticks with work "
                            f"pending but zero tokens fed (engine stalled)",
                    value=0.0, threshold=1.0, tag=tag))
            backlog = float(win[:, 2].mean())
            if backlog > self.max_backlog:
                events.append(MonitorEvent(
                    kind="serve_backlog", severity=SEV_WARNING, step=step,
                    message=f"{tag}: rolling queue depth {backlog:.1f} "
                            f"above {self.max_backlog:.0f}",
                    value=backlog, threshold=self.max_backlog, tag=tag))
        return events


def default_monitors(*, sparsity_setpoint: Optional[float] = None,
                     bus: Optional[MetricsBus] = None) -> List[Monitor]:
    """The standard detector set for a training run. When the run carries a
    closed-loop sparsity controller, pass its target as the setpoint so the
    collapse band tracks the controller's own."""
    mons: List[Monitor] = [LossMonitor(bus=bus),
                           CommRatioMonitor(bus=bus),
                           MemoryRatioMonitor(bus=bus),
                           BoundMonitor(bus=bus)]
    if sparsity_setpoint is not None:
        mons.append(SparsityMonitor(setpoint=sparsity_setpoint, bus=bus))
    return mons


class MonitorSuite:
    """Runs a detector set each tick; records + logs + optionally raises.

    A condition that stays tripped is rate-limited: each (kind, tag) pair
    re-emits at most once per ``reemit_every`` steps, so a persistently
    uncompressed layer warns once per window instead of once per step.
    """

    def __init__(self, monitors: Sequence[Monitor], *,
                 escalate: bool = False,
                 raise_on: Sequence[str] = (SEV_CRITICAL,),
                 reemit_every: int = 50,
                 bus: Optional[MetricsBus] = None):
        self.monitors = list(monitors)
        self.escalate = bool(escalate)
        self.raise_on = tuple(raise_on)
        self.reemit_every = int(reemit_every)
        self._bus = bus
        self._last_emit: Dict[Tuple[str, str], int] = {}
        self.tripped: List[MonitorEvent] = []

    @property
    def bus(self) -> MetricsBus:
        return self._bus if self._bus is not None else get_bus()

    def tick(self, step: int) -> List[MonitorEvent]:
        raw: List[MonitorEvent] = []
        for mon in self.monitors:
            raw.extend(mon.tick(step))
        events: List[MonitorEvent] = []
        for ev in raw:
            key = (ev.kind, ev.tag)
            last = self._last_emit.get(key)
            if last is not None and step - last < self.reemit_every:
                continue
            self._last_emit[key] = step
            events.append(ev)
        for ev in events:
            self.bus.log_event(ev.to_dict())
            log.warning("[monitor] %s (%s): %s", ev.kind, ev.severity,
                        ev.message)
        self.tripped.extend(events)
        if self.escalate:
            fatal = [e for e in events if e.severity in self.raise_on]
            if fatal:
                raise MonitorAlert(fatal)
        return events
