"""The quant engine's acceptance gates: every registered codec raced
through the one front door, and training with registry codecs on the
cotangent and the optimizer moments.

Counterpart of ``benchmarks/quant_bench.py``, with its specs, arms and
gates:

* **registry_race**: for every codec in ``codec_names()`` (a registered
  codec left out of ``RACE_SPECS`` fails the race), encode -> decode within
  the codec's own ``error_bound`` (the worst ratio banded at 1.05); the
  ``nsd`` decode bit-exact against ``nsd_fakequant`` with the same noise
  and fp32/remat the identity (zero-width bands); compression ratios
  (dense over ``stored_nbytes``) banded so a layout cannot fatten.
* **compute_on_packed**: the nsd codec's products from the packed
  cotangent against decode-then-matmul.
* **encode_timing**: each codec's encode + decode, recorded, never gated.
* **grad_codec_int4**: LeNet-300-100 with ``int4@g32`` on the cotangent
  (``DitherPolicy.grad_codec``) against the paper NSD arm.
* **moments**: AdamW with ``mu_codec="m8"`` / ``nu_codec="u8"`` against
  f32-moment AdamW, and SGD momentum in ``m8`` against the paper arm.

    python -m repro_torch.train.quant_bench [--full] [--device cpu] \\
        [--check benchmarks/baselines/BENCH_quant_bench.json]

runs on CUDA unless told otherwise, prints one JSON line a result and, with
``--check``, gates them against the reference's committed results (read
as data) and exits non-zero on a regression.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bench import BenchResult, Gate, SuiteRun, compare_runs
from repro_torch.bench.compare import CompareReport
from repro_torch.configs import paper_models as pm
from repro_torch.core.policy import DitherPolicy, fold_in
from repro_torch.device import resolve_device
from repro_torch.quant import (codec_names, decode, dense_nbytes, encode,
                               error_bound, get_codec, nsd_fakequant,
                               parse_spec, stored_nbytes)
from repro_torch.train.classifier import train_classifier

# every registered codec raced as spec strings (the parameterised forms
# exercise the grammar, not just the bare names)
RACE_SPECS = ("fp32", "remat", "bf16", "int8", "nsd", "nsd@0.5",
              "int8_absmax", "int4@g32", "int4@g64", "m8", "u8")


def _normal(shape, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device)


def _test_tensor(spec: str, seed: int, device) -> torch.Tensor:
    x = _normal((64, 256), seed, device) * 3.0
    if parse_spec(spec).codec == "u8":
        return torch.square(x)  # second moments are non-negative
    return x


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def registry_race(seed: int = 0, *, device: Optional[torch.device] = None
                  ) -> Dict[str, float]:
    """Round-trip every codec: the worst bound violation, the nsd and
    identity differences, the compression ratios. Each spec i draws its
    tensor and its noise stream key from ``fold_in(seed, i)``; every codec
    gets the key (those that take no noise ignore it)."""
    dev = resolve_device(device)
    raced = set()
    out: Dict[str, float] = {"worst_err_over_bound": 0.0}
    for i, spec in enumerate(RACE_SPECS):
        codec = parse_spec(spec).codec
        raced.add(codec)
        key = fold_in(seed, i)
        x = _test_tensor(spec, key, dev)
        enc = encode(spec, x, key)
        dec = decode(spec, enc)
        label = spec.replace("@", "_")
        out[f"{label}_compression_x"] = (
            dense_nbytes(x.shape, x.dtype) / stored_nbytes(spec, x.shape,
                                                           x.dtype))
        if codec in ("fp32", "remat"):
            out[f"{label}_max_abs_diff"] = float((dec - x).abs().max())
            continue
        if codec == "nsd":
            ref = nsd_fakequant(x, key, parse_spec(spec).param)
            out[f"{label}_max_abs_diff"] = float((dec - ref).abs().max())
        bound = error_bound(spec, enc)
        over = float(((dec - x).abs() / (bound + 1e-12)).max())
        out[f"{label}_err_over_bound"] = over
        out["worst_err_over_bound"] = max(out["worst_err_over_bound"], over)
    missing = set(codec_names()) - raced
    if missing:  # a newly registered codec must join the race
        raise AssertionError(f"codecs registered but not raced: {missing}")
    return out


def packed_compute_metrics(seed: int = 0, *,
                           device: Optional[torch.device] = None
                           ) -> Dict[str, float]:
    """The nsd codec's packed-domain products of y = x @ w against the
    decoded cotangent's dense products: the largest difference over the
    largest entry, for dx and dW."""
    dev = resolve_device(device)
    g = _normal((32, 256), seed, dev)
    x = _normal((32, 128), seed + 1, dev)
    w = _normal((128, 256), seed + 2, dev)
    key = fold_in(seed, 0)
    enc = encode("nsd", g, key)
    dx, dw = get_codec("nsd").compute_on_packed(parse_spec("nsd"), enc, x, w)
    g_hat = decode("nsd", enc)
    dx_ref, dw_ref = g_hat @ w.t(), x.t() @ g_hat

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-12))

    return {"dx_rel_err": rel(dx, dx_ref), "dw_rel_err": rel(dw, dw_ref)}


def timing_metrics(seed: int = 0, reps: int = 20, *,
                   device: Optional[torch.device] = None) -> Dict[str, float]:
    """Each spec's encode + decode in us on the host clock around work that
    ends in a device synchronise, one untimed round trip first."""
    dev = resolve_device(device)
    key = fold_in(seed, 0)
    out: Dict[str, float] = {}
    for spec in RACE_SPECS:
        x = _test_tensor(spec, key, dev)
        decode(spec, encode(spec, x, key))  # first use: kernel build
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            decode(spec, encode(spec, x, key))
        _sync(dev)
        out[f"{spec.replace('@', '_')}_roundtrip_us"] = (
            (time.perf_counter() - t0) / reps * 1e6)
    return out


def run(quick: bool = True, *, device: Optional[torch.device] = None
        ) -> Dict[str, Dict]:
    """The five LeNet-300-100 arms (40 steps quick, 120 full), the race,
    the packed products and the timings."""
    steps = 40 if quick else 120
    model = pm.lenet300100()
    paper = DitherPolicy(variant="paper", s=2.0)

    def train(policy, **kw):
        r = train_classifier(model, policy, steps=steps, device=device, **kw)
        return dict(r, us_per_step=r["ms_per_step"] * 1e3)

    adamw = {"name": "adamw", "lr": 3e-3}
    arms = {
        "paper": train(paper),
        "grad_int4": train(paper.replace(grad_codec="int4@g32")),
        "sgd_m8": train(paper, opt_overrides={"mu_codec": "m8"}),
        "adamw_fp32": train(paper, opt_overrides=adamw),
        "adamw_m8u8": train(paper, opt_overrides=dict(
            adamw, mu_codec="m8", nu_codec="u8")),
    }
    return {"arms": arms, "race": registry_race(device=device),
            "packed": packed_compute_metrics(device=device),
            "timing": timing_metrics(device=device)}


def results(out: Dict[str, Dict]) -> List[BenchResult]:
    """The reference's five BenchResults with its gates."""
    arms, race = out["arms"], out["race"]
    return [
        BenchResult(
            name="quant_bench/registry_race",
            value=race["worst_err_over_bound"], unit="x",
            derived=dict(race),
            gates={
                # nsd through the registry == the fake-quant, bit for bit;
                # identity codecs exact: zero-width bands
                "nsd_max_abs_diff": Gate(abs=0.0, direction="both"),
                "nsd_0.5_max_abs_diff": Gate(abs=0.0, direction="both"),
                "fp32_max_abs_diff": Gate(abs=0.0, direction="both"),
                "remat_max_abs_diff": Gate(abs=0.0, direction="both"),
                # every codec honours its own bound (<= 1, fp headroom)
                "worst_err_over_bound": Gate(abs=0.05, direction="high"),
                # layout accounting: a format that fattens shows here
                "int8_compression_x": Gate(rel=0.02, direction="low"),
                "int4_g32_compression_x": Gate(rel=0.02, direction="low"),
                "bf16_compression_x": Gate(abs=0.0, direction="both"),
                "m8_compression_x": Gate(rel=0.02, direction="low"),
                "u8_compression_x": Gate(rel=0.02, direction="low"),
            },
        ),
        BenchResult(
            name="quant_bench/compute_on_packed",
            value=out["packed"]["dw_rel_err"], unit="x",
            derived=dict(out["packed"]),
            gates={"dx_rel_err": Gate(abs=1e-5, direction="high"),
                   "dw_rel_err": Gate(abs=1e-5, direction="high")},
        ),
        BenchResult(
            name="quant_bench/encode_timing",
            value=out["timing"]["nsd_roundtrip_us"], unit="us",
            derived=dict(out["timing"]),
            gates={},  # wall clock: trajectory only
        ),
        BenchResult(
            name="quant_bench/grad_codec_int4",
            value=arms["grad_int4"]["us_per_step"], unit="us/step",
            derived={
                "acc": arms["grad_int4"]["acc"],
                "dacc": arms["grad_int4"]["acc"] - arms["paper"]["acc"],
                "paper_acc": arms["paper"]["acc"],
                "final_loss": arms["grad_int4"]["final_loss"],
            },
            gates={"acc": Gate(abs=10.0, direction="low"),
                   "dacc": Gate(abs=8.0, direction="low")},
        ),
        BenchResult(
            name="quant_bench/moments",
            value=arms["adamw_m8u8"]["us_per_step"], unit="us/step",
            derived={
                "adamw_m8u8_acc": arms["adamw_m8u8"]["acc"],
                "adamw_fp32_acc": arms["adamw_fp32"]["acc"],
                "adamw_dacc": (arms["adamw_m8u8"]["acc"]
                               - arms["adamw_fp32"]["acc"]),
                "sgd_m8_acc": arms["sgd_m8"]["acc"],
                "sgd_m8_dacc": arms["sgd_m8"]["acc"] - arms["paper"]["acc"],
            },
            gates={"adamw_m8u8_acc": Gate(abs=10.0, direction="low"),
                   "adamw_dacc": Gate(abs=8.0, direction="low"),
                   "sgd_m8_dacc": Gate(abs=8.0, direction="low")},
        ),
    ]


def bench(quick: bool = True, *, device: Optional[torch.device] = None
          ) -> List[BenchResult]:
    """The reference's ``bench()``: the five gated BenchResults."""
    return results(run(quick=quick, device=device))


def check(current: List[BenchResult], baseline: SuiteRun,
          quick: bool = True) -> CompareReport:
    """Gate ``current`` against ``baseline`` with the current run's
    bands."""
    return compare_runs(SuiteRun(suite=baseline.suite, quick=quick,
                                 results=current), baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="120 training steps an arm (default: 40)")
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
