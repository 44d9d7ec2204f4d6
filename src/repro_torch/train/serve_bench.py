"""The serving tier's gates: throughput, latency, KV bytes, decode parity.

Counterpart of ``benchmarks/serve_bench.py``, with its trace, arms and
gates. A synthetic heavy-traffic trace (staggered arrivals, prompts of 3 to
24 tokens, 4 to 16 new tokens, seed 0) drives the chunked-prefill engine
on the gemma-2b smoke configuration (its seed-0 parameters), one arm per
KV layout:

* ``dense``: per-slot fp32 buffers from ``Model.init_cache``;
* ``fp32``: paged pool, fp32 passthrough pages;
* ``int8`` / ``nsd``: quantized pages;
* ``preempt``: fp32 pages on a pool of 14 pages of 8 positions, sized to
  force preemption and recompute.

Gates, unloosened: every request completes; ``dense``, ``fp32`` and
``preempt`` tokens equal the port's own ``greedy_generate`` (batch 1,
``Model.prefill``) token for token (paging and chunked prefill are layout
changes, not numerics changes); ``int8`` and ``nsd`` disagree on at most
0.15 and 0.60 of the tokens and their KV capacity is at least 3x the dense
fp32 counterfactual's (the dual byte accounting of the ``serve`` stream);
``preempt`` preempts at least once. Tokens a second and p99 tick latency
carry the reference's wide bands.

    python -m repro_torch.train.serve_bench [--full] [--device cpu] \\
        [--check benchmarks/baselines/BENCH_serve_bench.json]

runs on CUDA unless told otherwise, prints one JSON line a result and, with
``--check``, gates them against the reference's committed results (read as
data) and exits non-zero on a regression.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench import BenchResult, Gate, SuiteRun, compare_runs
from repro_torch.bench.compare import CompareReport
from repro_torch.configs import get_smoke_model
from repro_torch.device import resolve_device
from repro_torch.obs.bus import MetricsBus, set_bus
from repro_torch.serve import Engine, Request, ServeConfig, greedy_generate

DISAGREE_BOUND = {"int8": 0.15, "nsd": 0.60}
MAX_TICKS = 4000
ARMS = {
    "dense": ServeConfig(max_batch=8, max_len=64, chunk=8),
    "fp32": ServeConfig(max_batch=8, max_len=64, chunk=8,
                        kv_mode="fp32", kv_page=16),
    "int8": ServeConfig(max_batch=8, max_len=64, chunk=8,
                        kv_mode="int8", kv_page=16),
    "nsd": ServeConfig(max_batch=8, max_len=64, chunk=8,
                       kv_mode="nsd", kv_page=16),
    # pool sized for ~2.5 of 8 slots at worst case -> forced eviction
    "preempt": ServeConfig(max_batch=8, max_len=64, chunk=8,
                           kv_mode="fp32", kv_page=8, kv_pool_pages=14),
}


def _trace(vocab: int, n_requests: int, seed: int = 0
           ) -> List[Tuple[np.ndarray, int, int]]:
    """(prompt, max_new, arrival_tick) synthetic trace: bursty arrivals,
    prompt lengths 3..24, generation lengths 4..16."""
    rng = np.random.default_rng(seed)
    out = []
    tick = 0
    for _ in range(n_requests):
        plen = int(rng.integers(3, 25))
        nnew = int(rng.integers(4, 17))
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        out.append((prompt, nnew, tick))
        if rng.random() < 0.4:  # burst boundary
            tick += int(rng.integers(1, 4))
    return out


def _drive(model, params, cfg: ServeConfig, trace, max_ticks: int):
    """Feed the trace by arrival tick; returns (results, tick_times_s,
    engine). The trace never trips the queue bound."""
    eng = Engine(model, params, cfg, name=f"bench-{cfg.kv_mode}"
                 f"{'-paged' if cfg.kv_page else ''}")
    results: Dict[int, List[int]] = {}
    times: List[float] = []
    pending = sorted(range(len(trace)), key=lambda i: trace[i][2])
    cursor = 0
    for tick in range(max_ticks):
        while cursor < len(pending) and trace[pending[cursor]][2] <= tick:
            uid = pending[cursor]
            prompt, nnew, _ = trace[uid]
            assert eng.submit(Request(uid, prompt, max_new_tokens=nnew))
            cursor += 1
        t0 = time.perf_counter()
        eng.step()
        times.append(time.perf_counter() - t0)
        results.update(eng._finished)
        eng._finished = {}
        if (cursor == len(pending) and eng.sched.queue_depth == 0
                and all(s is None for s in eng._slots)):
            break
    return results, times, eng


def _kv_bytes_per_token(bus: MetricsBus, tag: str) -> Tuple[float, float]:
    """(kv_bytes per generated token, capacity compression x) from the
    serve stream rows: byte-ticks over token-ticks of the busy ticks."""
    rows = bus.rows_since("serve", tag, 0)
    busy = rows[rows[:, 1] > 0]  # active_slots > 0
    gen = float(busy[:, 4].sum())
    byte_ticks = float(busy[:, 5].sum())
    dense_ticks = float(busy[:, 6].sum())
    return byte_ticks / max(gen, 1.0), dense_ticks / max(byte_ticks, 1.0)


def setup(quick: bool = True, *, device: Optional[torch.device] = None):
    """(model, params, trace, greedy_generate's tokens a request): what
    every arm shares."""
    model = get_smoke_model("gemma-2b")
    params = model.init(0, resolve_device(device))
    trace = _trace(model.cfg.vocab, 24 if quick else 96)
    refs = {uid: greedy_generate(model, params, p, n, max_len=64)
            for uid, (p, n, _) in enumerate(trace)}
    return model, params, trace, refs


def run_arm(arm: str, model, params, trace, refs,
            quick: bool = True) -> BenchResult:
    """One arm of :data:`ARMS` on the trace, gated."""
    cfg = ARMS[arm]
    total_ref_tokens = sum(len(v) for v in refs.values())
    bus = MetricsBus()
    set_bus(bus)
    try:
        t0 = time.perf_counter()
        results, times, eng = _drive(model, params, cfg, trace, MAX_TICKS)
        wall = time.perf_counter() - t0
    finally:
        set_bus(None)

    done_tokens = sum(len(v) for v in results.values())
    completed = len(results) / len(trace)
    mism = sum(1 for uid, toks in results.items()
               for a, b in zip(toks, refs[uid]) if a != b)
    disagree = mism / max(total_ref_tokens, 1)
    tok_s = done_tokens / max(wall, 1e-9)
    # latency is gated on the steady state (the reference skips its
    # first ticks' compilation)
    steady = times[10:] if len(times) > 20 else times
    p99_ms = float(np.percentile(np.asarray(steady), 99) * 1e3)
    per_tok, comp = _kv_bytes_per_token(bus, eng.name)

    derived = {
        "completed_frac": completed,
        "token_disagree_frac": disagree,
        "tokens_per_sec": tok_s,
        "p99_tick_ms": p99_ms,
        "kv_bytes_per_token": per_tok,
    }
    gates = {
        # every request must finish within the tick budget
        "completed_frac": Gate(abs=0.0, direction="both"),
        # throughput/latency recorded with wide noise-safe bands
        "tokens_per_sec": Gate(rel=0.90, direction="low"),
        "p99_tick_ms": Gate(rel=9.0, direction="high"),
        # byte accounting is deterministic: tight relative band
        "kv_bytes_per_token": Gate(rel=0.02, abs=1.0,
                                   direction="high"),
    }
    if arm in ("dense", "fp32", "preempt"):
        # layout changes only: token for token against the reference
        gates["token_disagree_frac"] = Gate(abs=0.0, direction="both")
    else:
        # quantized pages flip near-tie argmaxes; the absolute damage
        # bound is per codec, and drift beyond the committed baseline
        # is gated apart
        derived["disagree_bounded"] = (
            1.0 if disagree <= DISAGREE_BOUND[arm] else 0.0)
        gates["disagree_bounded"] = Gate(abs=0.0, direction="both")
        gates["token_disagree_frac"] = Gate(abs=0.10, direction="high")
    if cfg.kv_page and arm in ("int8", "nsd"):
        derived["kv_capacity_x"] = comp
        derived["meets_3x_floor"] = 1.0 if comp >= 3.0 else 0.0
        gates["meets_3x_floor"] = Gate(abs=0.0, direction="both")
        gates["kv_capacity_x"] = Gate(rel=0.02, direction="low")
    if arm == "preempt":
        derived["preemptions"] = float(eng.preemptions)
        derived["preempted_any"] = 1.0 if eng.preemptions > 0 else 0.0
        gates["preempted_any"] = Gate(abs=0.0, direction="both")

    return BenchResult(
        name=f"serve/{arm}",
        value=wall * 1e6,
        derived=derived,
        gates=gates,
        context={"requests": len(trace), "model": "gemma-2b-smoke",
                 "kv_mode": cfg.kv_mode, "kv_page": cfg.kv_page,
                 "pool_pages": cfg.kv_pool_pages,
                 "chunk": cfg.chunk, "quick": quick},
    )


def bench(quick: bool = True, *, device: Optional[torch.device] = None
          ) -> List[BenchResult]:
    """The reference's ``bench()``: one gated BenchResult an arm."""
    shared = setup(quick, device=device)
    return [run_arm(arm, *shared, quick=quick) for arm in ARMS]




def check(current: List[BenchResult], baseline: SuiteRun,
          quick: bool = True) -> CompareReport:
    """Gate ``current`` against ``baseline`` with the current run's
    bands."""
    return compare_runs(SuiteRun(suite=baseline.suite, quick=quick,
                                 results=current), baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="96 requests (default: 24)")
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
