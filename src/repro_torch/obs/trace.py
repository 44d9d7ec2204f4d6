"""Step-phase tracing: host-side spans that land on the metrics bus.

Counterpart of ``repro.obs.trace``. ``with span("dispatch"): ...`` measures
the wall clock of one phase of one step and records a row ``[step,
duration_s]`` on the ``"phase"`` stream, tagged by the span's path (nested
spans join with ``/``: ``"dispatch/compile"``); the row is recorded even
when the body raises. Each span also opens
``torch.profiler.record_function(path)``, so the same phase shows up in a
``torch.profiler`` trace under the same name: one taxonomy for host timing
and device profiles.

The spans of the built-in loops:

* ``data``        batch construction / next(loader)
* ``dispatch``    the step: its launches and any host sync inside them
* ``controller``  the sparsity controller's host tick (its telemetry read
                  copies the step's rows to the host)
* ``monitor``     the health monitors (``repro_torch.obs.monitor``)

Spans are host wall clock. On the card the launches are asynchronous, so
``dispatch`` times the launches and whatever synchronises inside them, not
the device work, which ends wherever the next sync waits for it. Inside a
step, :func:`annotate` names a range for the profiler alone
(``record_function``): the trainer's ``step/grad`` and ``step/update``, the
SSGD step's ``ssgd/*``.

The module-level :func:`span` uses the process-default tracer, whose step
the training loop advances with :func:`set_step`. Recording is cheap (a
perf_counter pair and a list append) and always on.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional

import numpy as np
from torch.profiler import record_function

from repro_torch.obs.bus import MetricsBus, get_bus
from repro_torch.obs.streams import PHASE

_TLS = threading.local()


def annotate(name: str):
    """A profiler range for code inside a step, under the same taxonomy as
    the host spans (``torch.profiler.record_function``)."""
    return record_function(name)


class Tracer:
    """Span recorder bound to a bus; one per process is typical."""

    def __init__(self, bus: Optional[MetricsBus] = None):
        self._bus = bus
        self._step = 0

    @property
    def bus(self) -> MetricsBus:
        return self._bus if self._bus is not None else get_bus()

    def set_step(self, step: int) -> None:
        """Set the step stamped on later span rows."""
        self._step = int(step)

    @property
    def step(self) -> int:
        return self._step

    def _stack(self) -> list:
        stack = getattr(_TLS, "span_stack", None)
        if stack is None:
            stack = _TLS.span_stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Measure one phase; nested spans record under a joined path."""
        stack = self._stack()
        stack.append(name)
        path = "/".join(stack)
        t0 = time.perf_counter()
        try:
            with record_function(path):
                yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            self.bus.record(PHASE.name, path,
                            np.array([self._step, dt], np.float32))


_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT


def span(name: str):
    """``with span("data"): ...`` on the process-default tracer."""
    return _DEFAULT.span(name)


def set_step(step: int) -> None:
    _DEFAULT.set_step(step)
