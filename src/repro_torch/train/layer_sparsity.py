"""Per-layer sparsity over training under policy programs (fig. 4 style).

Counterpart of ``benchmarks/layer_sparsity.py``, with its recipe, results
and gates. LeNet-300-100 trains through a ``PolicyProgram``
(``repro_torch.train.classifier.train_classifier``) four times:

* **parity**: a program whose only rule is the universal ``LayerRule()``
  reproduces the global ``DitherPolicy``'s telemetry (sparsity, bit-width
  and Delta of every layer x step row) bit for bit: the band is zero;
* **per-layer table**: an ``s`` ramp 1.0 -> 4.0 with a rule pinning ``fc0``
  at s = 4.0 from step 0; each layer's sparsity over three step windows,
  and the early contrast between the pinned and the ramped layers (about
  10 points) stays open;
* **controller**: the closed-loop sparsity controller (target 0.93, gain
  4.0) lands each layer's final-window sparsity within 5 points of it.

Each run starts the telemetry afresh (``train_classifier`` resets it), so
the port's tags are the bare layer names where the reference prefixes a
stats tag a run.

    python -m repro_torch.train.layer_sparsity [--full] [--device cpu] \\
        [--check benchmarks/baselines/BENCH_layer_sparsity.json]

runs on CUDA unless told otherwise, prints one JSON line a result and, with
``--check``, gates them against the reference's committed results and
exits non-zero on a regression.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bench import BenchResult, Gate, SuiteRun, compare_runs
from repro_torch.bench.compare import CompareReport
from repro_torch.configs import paper_models as pm
from repro_torch.core.policy import DitherPolicy
from repro_torch.core.schedule import (LayerRule, Linear, PolicyProgram,
                                       SparsityController)
from repro_torch.obs import metrics
from repro_torch.train.classifier import train_classifier

LAYERS = ("fc0", "fc1", "fc2")
N_WINDOWS = 3
TARGET = 0.93


def _window_sparsity(rows: np.ndarray, n_windows: int = N_WINDOWS
                     ) -> List[float]:
    """Mean sparsity (%) of a layer's telemetry rows split into step
    windows."""
    if len(rows) == 0:
        return [float("nan")] * n_windows
    return [float(w.mean()) * 100
            for w in np.array_split(rows[:, 0], n_windows)]


def _snapshot() -> Dict[str, np.ndarray]:
    """Every telemetry row of the last run, by layer name."""
    return {tag: metrics.rows(tag).copy() for tag in metrics.tags()}


def run(quick: bool = True, *, steps: Optional[int] = None,
        device: Optional[torch.device] = None) -> Dict[str, Dict]:
    """The four runs; ``steps`` overrides the recipe's 40 (quick) or 120."""
    steps = steps or (40 if quick else 120)
    model = pm.lenet300100()

    def train(policy) -> Dict[str, float]:
        return train_classifier(model, policy, steps=steps, device=device)

    # parity: the global policy against a single-universal-rule program
    policy = DitherPolicy(variant="paper", s=2.0, collect_stats=True)
    res_global = train(policy)
    rows_global = _snapshot()
    res_prog = train(PolicyProgram(base=policy, rules=(LayerRule(),)))
    rows_prog = _snapshot()
    diffs = []
    for layer in LAYERS:
        a, b = rows_global.get(layer), rows_prog.get(layer)
        if a is None or b is None or a.shape != b.shape:
            diffs.append(float("inf"))
        else:
            diffs.append(float(np.max(np.abs(a - b))) if a.size else 0.0)
    parity = {
        "max_abs_diff": max(diffs),
        "global_sparsity": res_global.get("sparsity", float("nan")),
        "program_sparsity": res_prog.get("sparsity", float("nan")),
        "us_per_step": res_prog["ms_per_step"] * 1e3,
    }

    # the per-layer table: an s ramp 1 -> 4 with fc0 pinned at s = 4
    res_sched = train(PolicyProgram(base=policy, s=Linear(0, steps, 1.0, 4.0),
                                    rules=(LayerRule(pattern="fc0", s=4.0),)))
    rows_sched = _snapshot()
    table: Dict[str, Dict] = {}
    for layer in LAYERS:
        wins = _window_sparsity(rows_sched.get(layer, np.zeros((0, 3))))
        table[layer] = {"windows": wins, "ramp_delta": wins[-1] - wins[0],
                        "us_per_step": res_sched["ms_per_step"] * 1e3}
    # the pinned layer starts at s = 4 while the ramp is near s = 1: the
    # early contrast is what shows per-layer resolution
    contrast = table["fc0"]["windows"][0] - table["fc1"]["windows"][0]

    # the closed-loop controller
    train(PolicyProgram(base=policy,
                        controller=SparsityController(target=TARGET, gain=4.0)))
    rows_ctl = _snapshot()
    gaps = [abs(_window_sparsity(rows_ctl.get(layer, np.zeros((0, 3))))[-1]
                - TARGET * 100) for layer in LAYERS]
    controller = {"target_pct": TARGET * 100, "max_final_gap_pct": max(gaps)}
    return {"parity": parity, "table": table, "contrast": contrast,
            "controller": controller}


def results(out: Dict[str, Dict]) -> List[BenchResult]:
    """The reference's BenchResults and gates from :func:`run`'s output."""
    res = [BenchResult(
        name="layer_sparsity/parity",
        value=out["parity"]["us_per_step"],
        unit="us/step",
        derived={
            "max_abs_diff": out["parity"]["max_abs_diff"],
            "global_sparsity": out["parity"]["global_sparsity"],
            "program_sparsity": out["parity"]["program_sparsity"],
        },
        gates={
            # the universal-rule program equals the global policy bit for
            # bit: the band is exactly zero
            "max_abs_diff": Gate(abs=0.0, direction="both"),
            "program_sparsity": Gate(abs=8.0, direction="low"),
        },
    )]
    for layer, row in out["table"].items():
        derived = {f"w{i}_sparsity": w for i, w in enumerate(row["windows"])}
        derived["ramp_delta"] = row["ramp_delta"]
        if layer == "fc0":
            # pinned at s = 4 from step 0: drift either way means per-layer
            # resolution broke
            gates = {f"w{i}_sparsity": Gate(abs=6.0, direction="both")
                     for i in range(N_WINDOWS)}
        else:
            # ramped layers: sparsity keeps rising across windows
            gates = {f"w{i}_sparsity": Gate(abs=8.0, direction="low")
                     for i in range(N_WINDOWS)}
            gates["ramp_delta"] = Gate(abs=8.0, direction="low")
        res.append(BenchResult(name=f"layer_sparsity/{layer}",
                               value=row["us_per_step"], unit="us/step",
                               derived=derived, gates=gates))
    res.append(BenchResult(
        name="layer_sparsity/rule_contrast",
        value=0.0,
        unit="us",
        derived={"fc0_w0_minus_fc1_w0": out["contrast"]},
        # the pinned-vs-ramped early gap (~10 points) stays open
        gates={"fc0_w0_minus_fc1_w0": Gate(abs=4.0, direction="low")},
    ))
    res.append(BenchResult(
        name="layer_sparsity/controller",
        value=0.0,
        unit="us",
        derived={
            "target_pct": out["controller"]["target_pct"],
            "max_final_gap_pct": out["controller"]["max_final_gap_pct"],
        },
        gates={"max_final_gap_pct": Gate(abs=5.0, direction="high")},
    ))
    return res


def bench(quick: bool = True, *, steps: Optional[int] = None,
          device: Optional[torch.device] = None) -> List[BenchResult]:
    """The reference's ``bench()``: the six gated BenchResults."""
    return results(run(quick=quick, steps=steps, device=device))


def check(current: List[BenchResult], baseline: SuiteRun,
          quick: bool = True) -> CompareReport:
    """Gate ``current`` against ``baseline`` with the current run's
    bands."""
    return compare_runs(SuiteRun(suite=baseline.suite, quick=quick,
                                 results=current), baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="120 training steps a run (default: 40)")
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
