"""repro_torch.obs: the metrics bus, tracing, run logs, monitors, report.

Counterpart of ``repro.obs``:

* :mod:`repro_torch.obs.streams` and :mod:`repro_torch.obs.bus`: the typed
  metrics bus (declared stream schemas, device rows kept on the device
  until a reader drains them, cached stacked reads);
  :mod:`repro_torch.obs.metrics` is the named read/write API over its
  built-in streams.
* :mod:`repro_torch.obs.trace`: host-side step-phase spans (``with
  span("dispatch")``), each also a ``torch.profiler`` range, and
  ``annotate`` for profiler ranges inside a step.
* :mod:`repro_torch.obs.runlog`: append-only JSONL export of every stream
  into a run directory with a provenance manifest; :class:`RunObs` bundles
  exporter, tracer and monitors for ``Trainer(obs=...)`` / ``--run-dir``.
* :mod:`repro_torch.obs.monitor`: rolling-window health detectors (loss
  NaN/inf, sparsity collapse, comm-ratio and residual-compression drift,
  error-bound blowup) with escalate-to-raise.
* :mod:`repro_torch.obs.report`: ``python -m repro_torch.obs.report
  <run-dir>`` renders Table-1-style per-layer summaries and a step-time
  breakdown from the JSONL alone.
"""
from repro_torch.obs.bus import MetricsBus, get_bus, register_stream, set_bus
from repro_torch.obs.monitor import (BoundMonitor, CommRatioMonitor,
                                     LossMonitor, MemoryRatioMonitor, Monitor,
                                     MonitorAlert, MonitorEvent, MonitorSuite,
                                     SparsityMonitor, default_monitors)
from repro_torch.obs.runlog import RunLog, RunObs, read_run, run_obs
from repro_torch.obs.streams import BUILTIN_STREAMS, MetricStream
from repro_torch.obs.trace import Tracer, annotate, get_tracer, set_step, span

__all__ = [
    "BUILTIN_STREAMS",
    "BoundMonitor",
    "CommRatioMonitor",
    "LossMonitor",
    "MemoryRatioMonitor",
    "MetricStream",
    "MetricsBus",
    "Monitor",
    "MonitorAlert",
    "MonitorEvent",
    "MonitorSuite",
    "RunLog",
    "RunObs",
    "SparsityMonitor",
    "Tracer",
    "annotate",
    "default_monitors",
    "get_bus",
    "get_tracer",
    "read_run",
    "register_stream",
    "run_obs",
    "set_bus",
    "set_step",
    "span",
]
