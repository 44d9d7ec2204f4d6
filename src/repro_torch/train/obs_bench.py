"""The observability subsystem's gates: bus overhead, monitors, report.

Counterpart of ``benchmarks/obs_bench.py``, with its recipe, results and
gates:

* **bus overhead**: LeNet-300-100 training with telemetry on against off,
  the best of three interleaved runs each after one warm-up run each; the
  gate is on the on/off *ratio*, never on wall clock. The port's rows stay
  on the device until read, so the telemetry-on step adds the rows'
  device ops and no host sync.
* **monitor trips**: the detectors fire exactly on synthetic pathologies
  (a NaN loss, a sparsity collapse), the suite rate-limits a persisting
  condition, escalation raises; zero-band gates.
* **report render**: a real dithered run with nsd residuals drains into a
  run directory, and the offline report renders every expected section
  from the JSONL alone; the line count is exact.

    python -m repro_torch.train.obs_bench [--full] [--device cpu] \\
        [--check benchmarks/baselines/BENCH_obs_bench.json]

runs on CUDA unless told otherwise, prints one JSON line a result and, with
``--check``, gates them against the reference's committed results and exits
non-zero on a regression. The report's run directory is a temporary
directory, removed afterwards.
"""
from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch.bench import BenchResult, Gate, SuiteRun, compare_runs
from repro_torch.bench.compare import CompareReport
from repro_torch.configs import paper_models as pm
from repro_torch.core.policy import DitherPolicy
from repro_torch.obs import metrics
from repro_torch.obs.bus import MetricsBus, get_bus, set_bus
from repro_torch.obs.monitor import (LossMonitor, MonitorAlert, MonitorSuite,
                                     SparsityMonitor)
from repro_torch.obs.report import render
from repro_torch.obs.runlog import RunLog, read_run
from repro_torch.obs.trace import Tracer
from repro_torch.train.classifier import train_classifier


def bus_overhead(quick: bool = True, *,
                 device: Optional[torch.device] = None) -> BenchResult:
    """Telemetry on against off: warm both, then the best of three
    interleaved runs each (the reference's protocol)."""
    steps = 30 if quick else 100
    model = pm.lenet300100()
    pol_off = DitherPolicy(variant="paper", s=2.0)
    pol_on = DitherPolicy(variant="paper", s=2.0, collect_stats=True)

    def train(policy):
        return train_classifier(model, policy, steps=steps, device=device)

    gc.collect()
    train(pol_off)
    train(pol_on)
    off_us, on_us = [], []
    for _ in range(3):
        off_us.append(train(pol_off)["ms_per_step"] * 1e3)
        on_us.append(train(pol_on)["ms_per_step"] * 1e3)
    off, on = min(off_us), min(on_us)
    rows = sum(metrics.row_count(t) for t in metrics.tags())
    return BenchResult(
        name="obs/bus_overhead",
        value=on,
        derived={
            "overhead_ratio": on / max(off, 1e-9),
            "us_per_step_off": off,
            "rows_per_step": rows / max(steps - 1, 1),
        },
        # the ratio only, and generous: LeNet-300-100's steps are short, so
        # the emission path is a worst-case share of the step
        gates={"overhead_ratio": Gate(rel=0.75, abs=1.0, direction="high")},
        context={"steps": steps, "model": "lenet300100"},
    )


def monitor_trip() -> BenchResult:
    """Exact trip counts on synthetic rows, on a bus of its own."""
    t0 = time.perf_counter()
    bus = MetricsBus()

    # a NaN loss: one critical trip
    loss_mon = LossMonitor(bus=bus)
    bus.record("train", "train", [1.0, 2.5])
    bus.record("train", "train", [2.0, float("nan")])
    loss_trips = len(loss_mon.tick(2))

    # collapsed sparsity: one warning; persisting: rate-limited
    sp_mon = SparsityMonitor(setpoint=0.9, band=0.1, min_rows=1, bus=bus)
    suite = MonitorSuite([sp_mon], reemit_every=100, bus=bus)
    bus.record("dither", "fc0", [0.1, 4.0, 0.1])
    sparsity_trips = len(suite.tick(1))
    reemits = 0
    for s in range(2, 6):
        bus.record("dither", "fc0", [0.1, 4.0, 0.1])
        reemits += len(suite.tick(s))

    # escalation raises on critical
    esc = MonitorSuite([LossMonitor(bus=bus)], escalate=True, bus=bus)
    bus.record("train", "esc", [3.0, float("inf")])
    try:
        esc.tick(3)
        raised = 0.0
    except MonitorAlert:
        raised = 1.0

    dt_us = (time.perf_counter() - t0) * 1e6
    zero = Gate(rel=0.0, abs=0.0, direction="both")
    return BenchResult(
        name="obs/monitor_trip",
        value=dt_us,
        derived={"loss_trips": float(loss_trips),
                 "sparsity_trips": float(sparsity_trips),
                 "rate_limited_reemits": float(reemits),
                 "escalate_raised": raised},
        gates={"loss_trips": zero, "sparsity_trips": zero,
               "rate_limited_reemits": zero, "escalate_raised": zero},
    )


def report_render(quick: bool = True, *, steps: Optional[int] = None,
                  device: Optional[torch.device] = None) -> BenchResult:
    """A dithered LeNet-300-100 run with nsd residuals on a fresh bus,
    drained into a temporary run directory and rendered from its JSONL;
    ``steps`` overrides the recipe's 25 (quick) or 80."""
    steps = steps or (25 if quick else 80)
    run_dir = tempfile.mkdtemp(prefix="obs_run")
    old_bus = get_bus()
    bus = set_bus(MetricsBus())
    try:
        tracer = Tracer(bus)
        with tracer.span("train"):
            res = train_classifier(
                pm.lenet300100(),
                DitherPolicy(variant="paper", s=2.0, collect_stats=True),
                steps=steps, memory="default=nsd", device=device)
        bus.record("train", "train", [float(steps), res["final_loss"]])

        runlog = RunLog(run_dir, bus=bus, context={
            "tool": "obs_bench", "model": "lenet300100", "steps": steps})
        lines = runlog.flush()
        t0 = time.perf_counter()
        text = render(run_dir)
        render_us = (time.perf_counter() - t0) * 1e6
        _, streams = read_run(run_dir)
    finally:
        set_bus(old_bus)
        shutil.rmtree(run_dir, ignore_errors=True)

    present = set(streams)
    return BenchResult(
        name="obs/report_render",
        value=render_us,
        derived={
            "jsonl_lines": float(lines),
            "report_chars": float(len(text)),
            # zero-band presence flags: every section a dithered run with a
            # memory policy produces
            "has_dither": float("dither" in present),
            "has_memory": float("memory" in present),
            "has_phase": float("phase" in present),
            "has_train": float("train" in present),
            "overall_sparsity_pct": float(np.mean(
                [r["sparsity"] for r in streams.get("dither", [])
                 if r.get("sparsity") is not None]) * 100),
        },
        gates={
            "has_dither": Gate(direction="both"),
            "has_memory": Gate(direction="both"),
            "has_phase": Gate(direction="both"),
            "has_train": Gate(direction="both"),
            "jsonl_lines": Gate(rel=0.0, abs=0.0, direction="both"),
            "overall_sparsity_pct": Gate(rel=0.0, abs=3.0,
                                         direction="both"),
        },
        context={"steps": steps},
    )


def bench(quick: bool = True, *, device: Optional[torch.device] = None
          ) -> List[BenchResult]:
    """The reference's ``bench()``: the three gated BenchResults."""
    return [bus_overhead(quick, device=device), monitor_trip(),
            report_render(quick, device=device)]


def check(current: List[BenchResult], baseline: SuiteRun,
          quick: bool = True) -> CompareReport:
    """Gate ``current`` against ``baseline`` with the current run's
    bands."""
    return compare_runs(SuiteRun(suite=baseline.suite, quick=quick,
                                 results=current), baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="100 / 80 training steps (default: 30 / 25)")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is none)")
    ap.add_argument("--check", default=None, metavar="BASELINE_JSON",
                    help="gate the results against this SuiteRun file")
    args = ap.parse_args(argv)
    current = bench(quick=not args.full, device=args.device)
    for r in current:
        print(json.dumps({"name": r.name, "value": r.value, "unit": r.unit,
                          "derived": r.derived}), flush=True)
    if args.check is None:
        return 0
    report = check(current, SuiteRun.from_dict(
        json.loads(Path(args.check).read_text())), quick=not args.full)
    print(report.render(), flush=True)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
