"""Machine-readable benchmark results and the regression comparator
(counterpart of ``repro.bench``)."""
from repro_torch.bench.compare import CompareReport, Finding, compare_runs
from repro_torch.bench.schema import (BOUND_SLACK, SCHEMA_VERSION, BenchResult,
                                      Gate, SuiteRun, git_sha, make_suite_run)

__all__ = [
    "BOUND_SLACK",
    "SCHEMA_VERSION",
    "BenchResult",
    "CompareReport",
    "Finding",
    "Gate",
    "SuiteRun",
    "compare_runs",
    "git_sha",
    "make_suite_run",
]
