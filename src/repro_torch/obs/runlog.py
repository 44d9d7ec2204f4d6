"""Run log: drain the metrics bus into durable JSONL streams and a manifest.

Counterpart of ``repro.obs.runlog``. A *run directory* is the unit of
observability this subsystem produces::

    <run_dir>/
      manifest.json     provenance + declared stream schemas
      dither.jsonl      one object per telemetry row, columns named
      comm.jsonl        ...
      memory.jsonl
      phase.jsonl       step-phase spans (repro_torch.obs.trace)
      train.jsonl       per-step headline metrics
      fallback.jsonl    kernel-path fallback counts at run end
      monitor.jsonl     structured monitor events (repro_torch.obs.monitor)

Everything in it is strict JSON (``allow_nan=False``), non-finite floats
written as ``null``; the offline report (``python -m repro_torch.obs.report
<run_dir>``) renders it from these files alone. The two packages read each
other's run directories.

The manifest takes its provenance from ``repro_torch.bench.schema`` (git
sha, torch version where the reference writes its jax version, platform
"gpu" or "cpu"), so a run directory and a ``BENCH_*.json`` from one commit
join, and adds the run's identity (``run_id``, creation time) and the
caller's context (argv-derived settings, the program strings).

:class:`RunLog` is the incremental exporter (cursor-based appends: a
``flush()`` writes only the rows that arrived since the previous one);
:class:`RunObs` bundles it with the span tracer and a monitor suite into the
one object ``Trainer(obs=...)`` and the launcher's ``--run-dir`` take.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.bus import MetricsBus, get_bus
from repro_torch.obs.monitor import MonitorSuite, default_monitors
from repro_torch.obs.trace import Tracer, get_tracer
from repro_torch.utils import get_logger
from repro_torch.utils.logging import set_log_context

log = get_logger("repro_torch.obs.runlog")

MANIFEST_NAME = "manifest.json"
MANIFEST_SCHEMA_VERSION = 1
FLUSH_EVERY = 25  # RunObs.on_step appends the new rows every N steps


def _json_safe(v: float) -> Optional[float]:
    """Strict-JSON scalar: non-finite floats become null."""
    f = float(v)
    return f if math.isfinite(f) else None


def new_run_id() -> str:
    return time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:6]


class RunLog:
    """Append-only JSONL exporter over one bus."""

    def __init__(self, run_dir: str, *, bus: Optional[MetricsBus] = None,
                 context: Optional[Dict[str, Any]] = None):
        self.run_dir = run_dir
        self._bus = bus
        self.run_id = new_run_id()
        self.context = dict(context or {})
        self._cursors: Dict[Tuple[str, str], int] = {}
        self._event_cursor = 0
        os.makedirs(run_dir, exist_ok=True)
        self.write_manifest()

    @property
    def bus(self) -> MetricsBus:
        return self._bus if self._bus is not None else get_bus()

    # --------------------------------------------------------------- files
    def manifest_path(self) -> str:
        return os.path.join(self.run_dir, MANIFEST_NAME)

    def stream_path(self, stream: str) -> str:
        return os.path.join(self.run_dir, f"{stream}.jsonl")

    def write_manifest(self) -> str:
        import torch

        from repro_torch.bench.schema import git_sha

        manifest = {
            "schema_version": MANIFEST_SCHEMA_VERSION,
            "run_id": self.run_id,
            "created_unix": time.time(),
            "git_sha": git_sha(),
            "torch_version": torch.__version__,
            "platform": "gpu" if torch.cuda.is_available() else "cpu",
            "context": self.context,
            "streams": {name: list(cols) for name, cols
                        in self.bus.registry.schema().items()},
        }
        path = self.manifest_path()
        with open(path, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True, allow_nan=False)
            f.write("\n")
        return path

    # --------------------------------------------------------------- drain
    def flush(self) -> int:
        """Append every row/event that arrived since the last flush.

        Returns the number of JSONL lines written. Cursor-based: O(new
        records), so calling it every N steps is cheap on long runs.
        """
        bus = self.bus
        written = 0
        for (stream, tag), total in sorted(bus.cursors().items()):
            seen = self._cursors.get((stream, tag), 0)
            if total <= seen:
                continue
            new = bus.rows_since(stream, tag, seen)
            cols = bus.registry.get(stream).columns
            with open(self.stream_path(stream), "a") as f:
                for row in new:
                    obj = {"tag": tag}
                    obj.update({c: _json_safe(v) for c, v in zip(cols, row)})
                    json.dump(obj, f, allow_nan=False)
                    f.write("\n")
                    written += 1
            self._cursors[(stream, tag)] = total
        events = bus.events(self._event_cursor)
        if events:
            with open(self.stream_path("monitor"), "a") as f:
                for ev in events:
                    ev = {k: _json_safe(v) if isinstance(v, float) else v
                          for k, v in ev.items()}
                    json.dump(ev, f, allow_nan=False)
                    f.write("\n")
                    written += 1
            self._event_cursor += len(events)
        return written

    def close(self) -> None:
        self.flush()


def read_run(run_dir: str) -> Tuple[Dict[str, Any],
                                    Dict[str, List[Dict[str, Any]]]]:
    """Load a run directory back: (manifest, {stream: [row dicts]}).

    Parsing is strict: a bare ``NaN``/``Infinity`` literal in any line is
    an exporter bug and raises instead of silently round-tripping.
    """
    def _reject(const: str):
        raise ValueError(f"non-strict JSON constant {const!r} in run dir")

    with open(os.path.join(run_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f, parse_constant=_reject)
    streams: Dict[str, List[Dict[str, Any]]] = {}
    for fname in sorted(os.listdir(run_dir)):
        if not fname.endswith(".jsonl"):
            continue
        name = fname[: -len(".jsonl")]
        rows = []
        with open(os.path.join(run_dir, fname)) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line, parse_constant=_reject))
        streams[name] = rows
    return manifest, streams


# ---------------------------------------------------------------------------
# RunObs: the bundle the Trainer / launchers accept
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunObs:
    """One run's observability: exporter + tracer + monitors.

    Build with :func:`run_obs`; drive with :meth:`on_step` once per
    optimizer step and :meth:`finish` at the end. ``span`` is the tracing
    entry point loops should use so phase rows carry the current step.
    """

    runlog: RunLog
    tracer: Tracer
    monitors: MonitorSuite

    def span(self, name: str):
        return self.tracer.span(name)

    def set_step(self, step: int) -> None:
        self.tracer.set_step(step)
        set_log_context(step=int(step))

    def on_step(self, step: int, metrics: Optional[Dict[str, float]] = None
                ) -> None:
        """Record the step's loss, its comm bytes (a trainer's wire) and
        error bound (an SSGD reduce's), run the monitors, flush every
        ``FLUSH_EVERY`` steps."""
        bus = self.runlog.bus
        metrics = metrics or {}
        if "loss" in metrics:
            bus.record("train", "train", [float(step),
                                          float(metrics["loss"])])
        if "comm_wire_bytes" in metrics:
            bus.record("comm", "step",
                       [float(metrics["comm_wire_bytes"]),
                        float(metrics.get("comm_dense_bytes", 0.0))])
        if "comm_error_bound" in metrics:
            bus.record("bound", "reduce",
                       [float(step), float(metrics["comm_error_bound"])])
        with self.tracer.span("monitor"):
            self.monitors.tick(step)
        if step % FLUSH_EVERY == 0:
            self.runlog.flush()

    def finish(self) -> None:
        self.monitors.tick(self.tracer.step)
        # snapshot cumulative kernel-path fallback counters into the run
        # artifact: a structural form silently falling off the kernel path
        # should show up in the run dir, not just in-process
        from repro_torch.obs import metrics as obs_metrics

        obs_metrics.emit_kernel_fallbacks(bus=self.runlog.bus)
        self.runlog.close()
        set_log_context(run_id=None, step=None)
        log.info("run log closed: %s (run_id %s)", self.runlog.run_dir,
                 self.runlog.run_id)


def run_obs(run_dir: str, *, context: Optional[Dict[str, Any]] = None,
            monitors=None, escalate: bool = False,
            sparsity_setpoint: Optional[float] = None,
            bus: Optional[MetricsBus] = None) -> RunObs:
    """Standard RunObs: run log in ``run_dir``, the process tracer, and the
    detector set ``monitors`` (default: the training set, whose collapse
    detector ``sparsity_setpoint`` arms; pass the controller target when
    the run has one)."""
    runlog = RunLog(run_dir, bus=bus, context=context)
    set_log_context(run_id=runlog.run_id)
    suite = MonitorSuite(
        monitors if monitors is not None
        else default_monitors(sparsity_setpoint=sparsity_setpoint, bus=bus),
        escalate=escalate, bus=bus)
    return RunObs(runlog=runlog, tracer=get_tracer(), monitors=suite)
