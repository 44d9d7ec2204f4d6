"""Machine-readable benchmark results: the ``BenchResult`` wire schema.

Counterpart of ``repro.bench.schema``, with torch's version in place of
jax's. A suite (``repro_torch.train.table1``) emits a list of
``BenchResult``s, wrapped in a ``SuiteRun`` with the provenance needed to
interpret a number later: git sha, torch version, platform, quick/full
flag. Its JSON is the reference's (``torch_version`` for
``jax_version``), so the reference's committed baselines read as data. The
JSON round trip is exact (``tests/test_torch_table1.py``).

Two metric classes live side by side in one result:

* ``value`` — the wall-clock headline (``unit`` says what it measures).
  Timing on shared CI runners is noise, so it is recorded for the
  trajectory but never gated.
* ``derived`` — named scalar stats (accuracy, sparsity, wire ratio,
  packs per segment ...). A suite declares which of these are
  regression-gated, and with what tolerance band, via ``gates``. The
  comparator (``repro_torch.bench.compare``) only ever fails on gated
  metrics.

Tolerance bands follow the ``tests/stat_utils.py`` philosophy: derive the
band from what the metric *is* (deterministic telemetry -> near-zero band,
short stochastic training -> a band covering seed/platform jitter) instead
of sprinkling ad-hoc fudge factors at comparison time.
"""
from __future__ import annotations

import dataclasses
import subprocess
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

# Multiplicative headroom applied on top of every band for f32/accumulation
# noise (the reference's tests/stat_utils.BOUND_SLACK), not a statistical
# fudge factor.
BOUND_SLACK = 1.001


@dataclasses.dataclass(frozen=True)
class Gate:
    """Tolerance band for one gated metric.

    band = max(rel * |baseline|, abs); ``direction`` says which drift is a
    regression: "low" (metric must not drop below baseline - band, e.g.
    accuracy/sparsity), "high" (must not rise above baseline + band, e.g.
    wire ratio, error bound), "both" (either way, e.g. exact invariants
    with abs == 0).
    """

    rel: float = 0.0
    abs: float = 0.0
    direction: str = "both"

    def band(self, baseline: float) -> float:
        return max(self.rel * abs(baseline), self.abs)

    def check(self, baseline: float, current: float) -> bool:
        """True when ``current`` is within the band around ``baseline``."""
        b = self.band(baseline) * BOUND_SLACK + abs(baseline) * (
            BOUND_SLACK - 1.0)
        lo_ok = current >= baseline - b
        hi_ok = current <= baseline + b
        if self.direction == "low":
            return lo_ok
        if self.direction == "high":
            return hi_ok
        return lo_ok and hi_ok

    def to_dict(self) -> Dict[str, Any]:
        return {"rel": self.rel, "abs": self.abs,
                "direction": self.direction}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Gate":
        return cls(rel=float(d.get("rel", 0.0)), abs=float(d.get("abs", 0.0)),
                   direction=str(d.get("direction", "both")))


@dataclasses.dataclass(frozen=True)
class BenchResult:
    """One benchmark row: headline timing + gated derived stats."""

    name: str  # stable id, e.g. "table1/lenet5" — the comparator's join key
    value: float  # headline metric (timing; recorded, never gated)
    unit: str = "us"
    derived: Dict[str, float] = dataclasses.field(default_factory=dict)
    gates: Dict[str, Gate] = dataclasses.field(default_factory=dict)
    context: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def derived_str(self) -> str:
        """Legacy ``name,us,derived`` CSV cell (benchmarks.run output)."""
        parts = [f"{k}={v:.4g}" for k, v in self.derived.items()]
        parts += [f"{k}={v}" for k, v in self.context.items()]
        return " ".join(parts)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "value": self.value,
            "unit": self.unit,
            "derived": dict(self.derived),
            "gates": {k: g.to_dict() for k, g in self.gates.items()},
            "context": dict(self.context),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchResult":
        return cls(
            name=str(d["name"]),
            value=float(d["value"]),
            unit=str(d.get("unit", "us")),
            derived={k: float(v) for k, v in d.get("derived", {}).items()},
            gates={k: Gate.from_dict(g)
                   for k, g in d.get("gates", {}).items()},
            context=dict(d.get("context", {})),
        )


@dataclasses.dataclass(frozen=True)
class SuiteRun:
    """All results of one suite execution plus provenance."""

    suite: str
    results: List[BenchResult]
    git_sha: str = "unknown"
    torch_version: str = "unknown"
    platform: str = "unknown"
    quick: bool = True
    schema_version: int = SCHEMA_VERSION

    def by_name(self) -> Dict[str, BenchResult]:
        return {r.name: r for r in self.results}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "suite": self.suite,
            "git_sha": self.git_sha,
            "torch_version": self.torch_version,
            "platform": self.platform,
            "quick": self.quick,
            "results": [r.to_dict() for r in self.results],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SuiteRun":
        return cls(
            suite=str(d["suite"]),
            results=[BenchResult.from_dict(r) for r in d.get("results", [])],
            git_sha=str(d.get("git_sha", "unknown")),
            torch_version=str(d.get("torch_version", "unknown")),
            platform=str(d.get("platform", "unknown")),
            quick=bool(d.get("quick", True)),
            schema_version=int(d.get("schema_version", SCHEMA_VERSION)),
        )


def git_sha(cwd: Optional[str] = None) -> str:
    """Best-effort HEAD sha for provenance; never raises."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10,
                             cwd=cwd)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def make_suite_run(suite: str, results: List[BenchResult], *,
                   quick: bool = True, device=None) -> SuiteRun:
    """Stamp a result list with this process's provenance: ``platform`` is
    "gpu" for a CUDA ``device``, else its type."""
    import torch

    dev = torch.device(device) if device is not None else torch.device("cpu")
    return SuiteRun(
        suite=suite, results=list(results), git_sha=git_sha(),
        torch_version=torch.__version__,
        platform="gpu" if dev.type == "cuda" else dev.type, quick=quick)
