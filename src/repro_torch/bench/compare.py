"""Regression comparator: a current ``SuiteRun`` vs a committed baseline.

Counterpart of ``repro.bench.compare``, the same verdicts on the same
records (``tests/test_torch_table1.py``). Policy:

* no baseline file        -> every bench reports ``no-baseline``; PASS.
  (The gate cannot block the very commit that introduces a suite; the
  baseline lands with it.)
* bench only in baseline  -> ``missing``; FAIL. A silently dropped bench
  is how perf regressions hide.
* bench only in current   -> ``new``; PASS (it has nothing to regress
  against — committing the refreshed baseline makes it binding).
* gated metric drifts outside its band -> ``regression``; FAIL.
* gated metric within band, or ungated metric (timing, context) -> PASS;
  ungated drift is still listed so the trajectory stays visible.

The *current* run's gates are authoritative: tolerances live in suite
code, and retightening a band in a PR must take effect in that same PR
even though the committed baseline still carries the old one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.bench.schema import BenchResult, SuiteRun

# statuses that fail the gate
FAILING = ("regression", "missing")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One (bench, metric) comparison outcome."""

    bench: str
    metric: str
    status: str  # ok | drift | regression | missing | new | no-baseline
    #              | mode-mismatch (quick run vs full baseline or v.v.)
    baseline: float = float("nan")
    current: float = float("nan")
    band: float = float("nan")

    @property
    def failing(self) -> bool:
        return self.status in FAILING

    def render(self) -> str:
        if self.status in ("new", "missing", "no-baseline",
                           "mode-mismatch"):
            return f"  [{self.status:>14s}] {self.bench}"
        line = (f"  [{self.status:>10s}] {self.bench} :: {self.metric} "
                f"baseline={self.baseline:.6g} current={self.current:.6g}")
        if self.status != "drift":  # ungated metrics have no band
            line += f" band=±{self.band:.3g}"
        return line


@dataclasses.dataclass(frozen=True)
class CompareReport:
    suite: str
    findings: List[Finding]

    @property
    def regressions(self) -> List[Finding]:
        return [f for f in self.findings if f.failing]

    @property
    def ok(self) -> bool:
        return not self.regressions

    def render(self, verbose: bool = False) -> str:
        lines = [f"{self.suite}: "
                 f"{'OK' if self.ok else 'REGRESSION'} "
                 f"({len(self.findings)} checks, "
                 f"{len(self.regressions)} failing)"]
        for f in self.findings:
            if verbose or f.failing or f.status in ("new", "no-baseline",
                                                    "mode-mismatch",
                                                    "drift"):
                lines.append(f.render())
        return "\n".join(lines)


def compare_result(current: BenchResult,
                   baseline: BenchResult) -> List[Finding]:
    """Compare every gated metric of one bench against its baseline."""
    findings = []
    for metric, gate in current.gates.items():
        cur = current.derived.get(metric)
        base = baseline.derived.get(metric)
        if cur is None:
            # a gate naming a metric the suite never emitted is a suite bug
            findings.append(Finding(current.name, metric, "regression",
                                    band=gate.band(0.0)))
            continue
        if base is None:
            findings.append(Finding(current.name, metric, "new",
                                    current=cur))
            continue
        ok = gate.check(base, cur)
        findings.append(Finding(
            current.name, metric, "ok" if ok else "regression",
            baseline=base, current=cur, band=gate.band(base)))
    # ungated drift report (timing + uncovered derived): informational
    for metric in ("value",):
        findings.append(Finding(current.name, metric, "drift",
                                baseline=baseline.value,
                                current=current.value))
    return findings


def compare_runs(current: SuiteRun,
                 baseline: Optional[SuiteRun]) -> CompareReport:
    if baseline is None:
        return CompareReport(current.suite, [
            Finding(r.name, "*", "no-baseline") for r in current.results])
    if baseline.quick != current.quick:
        # quick and full runs use different shapes/step counts, so their
        # numbers are not comparable — gating would fail spuriously.
        # Report the mismatch (visible, non-failing) instead.
        return CompareReport(current.suite, [
            Finding(r.name, "*", "mode-mismatch")
            for r in current.results])
    cur_by: Dict[str, BenchResult] = current.by_name()
    base_by: Dict[str, BenchResult] = baseline.by_name()
    findings: List[Finding] = []
    for name in base_by:
        if name not in cur_by:
            findings.append(Finding(name, "*", "missing"))
    for name, cur in cur_by.items():
        if name not in base_by:
            findings.append(Finding(name, "*", "new", current=cur.value))
            continue
        findings.extend(compare_result(cur, base_by[name]))
    return CompareReport(current.suite, findings)
