"""The paper's Table 1: accuracy and pre-activation-gradient sparsity of
plain, dithered and 8-bit + dithered backprop across the paper's six models
(on synthetic stand-ins for MNIST and CIFAR-10: the environment is
offline).

Counterpart of ``benchmarks/table1_sparsity.py``, with its recipe (s = 2,
batch 64, 50 steps, the paper's SGD), columns, method names and row names.
Each row trains its model three times from the same seed: plain backprop
(the baseline's accuracy), ``variant="paper"`` (dithered) and
``variant="int8"`` (8-bit + dithered), and measures the baseline's
sparsity on the raw gradients through the tap probe (3 batches).

    python -m repro_torch.train.table1 [--full] [--steps N] [--device cpu]

runs on CUDA unless told otherwise and prints one JSON line a row; the
quick set is the three MNIST models, ``--full`` adds AlexNet, VGG11 and
ResNet18. ``--check BASELINE.json`` then gates the rows named in that file
(the reference's ``benchmarks/baselines/BENCH_table1_sparsity.json``, read
as data) with the current run's bands and exits non-zero on a regression.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch.bench import BenchResult, Gate, SuiteRun, compare_runs
from repro_torch.bench.compare import CompareReport
from repro_torch.configs import paper_models as pm
from repro_torch.core.policy import DitherPolicy
from repro_torch.models.cnn import CNNConfig
from repro_torch.train.classifier import (measure_baseline_sparsity,
                                          train_classifier)

QUICK_MODELS = ("mlp-mnist", "lenet300100", "lenet5")
FULL_MODELS = QUICK_MODELS + ("alexnet-c10", "vgg11-c10", "resnet18-c10")


def _model(name: str) -> CNNConfig:
    return {
        "mlp-mnist": lambda: pm.mlp_mnist(hidden=(500, 500)),
        "lenet300100": pm.lenet300100,
        "lenet5": pm.lenet5,
        "alexnet-c10": pm.alexnet_cifar,
        "vgg11-c10": pm.vgg11_cifar,
        "resnet18-c10": pm.resnet18_cifar,
    }[name]()


def run(quick: bool = True, steps: int = 50, *,
        device: Optional[torch.device] = None) -> List[Dict]:
    """Table 1's rows: the quick set (MNIST models) or all six, each
    trained for ``steps`` steps per method."""
    rows = []
    names = QUICK_MODELS if quick else FULL_MODELS
    for name in names:
        model = _model(name)
        base_sp = measure_baseline_sparsity(model, steps=3, device=device)
        res_base = train_classifier(model, None, steps=steps, device=device)
        methods = {
            "dithered": DitherPolicy(variant="paper", s=2.0,
                                     collect_stats=True),
            "int8+dith": DitherPolicy(variant="int8", s=2.0,
                                      collect_stats=True),
        }
        row = {
            "model": name,
            "baseline_acc": res_base["acc"],
            "baseline_sparsity": base_sp,
            "us_per_step_baseline": res_base["ms_per_step"] * 1e3,
        }
        for mname, pol in methods.items():
            r = train_classifier(model, pol, steps=steps, device=device)
            row[f"{mname}_acc"] = r["acc"]
            row[f"{mname}_sparsity"] = r.get("sparsity", float("nan"))
            row[f"{mname}_bits"] = r.get("max_bits", float("nan"))
            row[f"us_per_step_{mname}"] = r["ms_per_step"] * 1e3
        rows.append(row)
    return rows


def results(rows: List[Dict]) -> List[BenchResult]:
    """One BenchResult a row, gated as the reference's: accuracies must not
    drop (the paper's parity claim) and induced sparsity must not collapse
    (its efficiency claim). The bands cover seed and platform jitter of a
    ~50-step synthetic run; timing is recorded, never gated."""
    out = []
    for row in rows:
        out.append(BenchResult(
            name=f"table1/{row['model']}",
            value=row["us_per_step_dithered"],
            unit="us/step",
            derived={
                "baseline_acc": row["baseline_acc"],
                "dithered_acc": row["dithered_acc"],
                "int8_dith_acc": row["int8+dith_acc"],
                "baseline_sparsity": row["baseline_sparsity"],
                "dithered_sparsity": row["dithered_sparsity"],
                "int8_dith_sparsity": row["int8+dith_sparsity"],
                "dithered_bits": row["dithered_bits"],
                "us_per_step_baseline": row["us_per_step_baseline"],
            },
            gates={
                "dithered_acc": Gate(abs=10.0, direction="low"),
                "int8_dith_acc": Gate(abs=10.0, direction="low"),
                "dithered_sparsity": Gate(abs=8.0, direction="low"),
                "int8_dith_sparsity": Gate(abs=8.0, direction="low"),
                "dithered_bits": Gate(abs=1.0, direction="high"),
            },
        ))
    return out


def bench(quick: bool = True, *, device: Optional[torch.device] = None
          ) -> List[BenchResult]:
    """The reference's ``bench()``: one gated BenchResult a Table-1 row."""
    return results(run(quick=quick, device=device))


def check(current: List[BenchResult], baseline: SuiteRun) -> CompareReport:
    """Gate the rows named in ``baseline`` against it. A row is trained the
    same way in the quick and the full set, so the rows of a full run that
    a quick baseline names are held to it as a quick run's would be."""
    names = {r.name for r in baseline.results}
    return compare_runs(
        SuiteRun(suite=baseline.suite, quick=baseline.quick,
                 results=[r for r in current if r.name in names]),
        baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="all six models (default: the three MNIST ones)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is none)")
    ap.add_argument("--check", default=None, metavar="BASELINE_JSON",
                    help="gate the rows this SuiteRun file names")
    args = ap.parse_args(argv)
    rows = run(quick=not args.full, steps=args.steps, device=args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.check is None:
        return 0
    report = check(results(rows), SuiteRun.from_dict(
        json.loads(Path(args.check).read_text())))
    print(report.render(), flush=True)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
