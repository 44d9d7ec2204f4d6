"""The paper's figs. 5/6 and its distributed comm claim: as the number of
nodes N grows (and s with it, s = 2 sqrt(N)), per-node sparsity rises and
the worst-case bit-width falls while accuracy stays flat, and with the NSD
wire on the node -> server hop the bytes on the wire shrink as sparsity
grows.

Counterpart of ``benchmarks/distributed_nodes.py``: its ``run`` (MLP-MNIST
(256, 256), SGD lr 0.05 / momentum 0.9 / weight decay 5e-4,
``variant="paper"``, batch 32, 30 steps, the comm ``nsd`` mode at
``s_for_n()``) and the ring row of its ``compare_topologies`` (8 nodes,
128 x 128 gradients ``normal * 0.01`` from the seed, drawn here with
numpy). The rows leave out the reference's TPU-link pricing
(``wire_s_v5e``, ``comm_speedup``, the ``*_us`` link times), which no gate
reads.

    python -m repro_torch.train.distributed_nodes [--device cpu] [--steps N] \\
        [--check benchmarks/baselines/BENCH_distributed_nodes.json]

runs on CUDA unless told otherwise and prints one JSON line a row;
``--check`` gates the ``fig5-6/N=*`` and ``topology/ring/N=8`` rows against
the reference's committed baseline (read as data) with the current run's
bands, names every baseline row it does not run as not ported, and exits
non-zero on a regression.
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
from repro_torch.comm import CommPolicy, RingConfig, ring_allreduce_nsd
from repro_torch.comm import telemetry as comm_telemetry
from repro_torch.configs import paper_models as pm
from repro_torch.core.policy import DitherPolicy
from repro_torch.data.synthetic import ClassifConfig, classification_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import SSGDConfig, make_ssgd_step, shard_batch
from repro_torch.models.cnn import CNN, accuracy
from repro_torch.obs import metrics
from repro_torch.optim.optimizers import OptConfig, init_opt_state

BATCH = 32  # the sweep's global batch, split over the nodes
RING_NODES, RING_SHAPE, RING_S = 8, (128, 128), 2.0  # the ring row

# baseline rows of the reference's suite that the port does not run, with
# the ROADMAP.md item that ports them
NOT_PORTED = {
    "topology/hier/": "ROADMAP.md section 1 item 7 (comm hierarchy)",
    "topology/butterfly/": "ROADMAP.md section 1 item 7 (comm butterfly)",
    "butterfly/vs-tree/": "ROADMAP.md section 1 item 7 (comm butterfly)",
    "overlap/": "ROADMAP.md section 1 item 7 (comm overlap)",
}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(node_counts=(1, 2, 4), steps: int = 30, seed: int = 0, *,
        device: Optional[torch.device] = None) -> List[Dict]:
    """One row per node count: accuracy (%), dither sparsity (%), max bits,
    host time per step, and the wire's bytes and ratio."""
    dev = resolve_device(device)
    rows = []
    for n in node_counts:
        metrics.reset()
        net = CNN(pm.mlp_mnist(hidden=(256, 256)), seed=seed, device=dev)
        opt_cfg = OptConfig(lr=0.05, momentum=0.9, weight_decay=5e-4)
        dcfg = SSGDConfig(n_nodes=n, s_schedule="sqrt", s_base=2.0)
        pol = DitherPolicy(variant="paper", collect_stats=True)
        # the comm-side NSD rides the same sqrt(N) schedule as the dither
        comm_policy = CommPolicy(default="nsd", s=dcfg.s_for_n(),
                                 collect_stats=True)
        step_fn, used = make_ssgd_step(net, opt_cfg, dcfg, pol,
                                       comm_policy=comm_policy, device=dev)
        state = init_opt_state(dict(net.named_parameters()))
        data_cfg = ClassifConfig(n_classes=10, img_size=28, channels=1,
                                 noise=0.5, seed=seed)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(steps):
            b = classification_batch(data_cfg, i, BATCH, device=dev)
            step_fn(state, shard_batch(b, n), seed)
        _sync(dev)
        us = (time.perf_counter() - t0) / steps * 1e6
        test = classification_batch(data_cfg, 10**6, 512, device=dev)
        cs = metrics.comm_summary()[comm_telemetry.TAG]
        rows.append({"n_nodes": n, "s": used.s,
                     "acc": float(accuracy(net, test)) * 100,
                     "sparsity": metrics.overall_sparsity() * 100,
                     "max_bits": metrics.overall_max_bits(),
                     "us_per_step": us,
                     "wire_mb": cs["wire_bytes"] / 1e6,
                     "wire_ratio": cs["ratio"]})
    return rows


def compare_topologies(seed: int = 0, *,
                       device: Optional[torch.device] = None) -> Dict:
    """The flat ring of 8 nodes at s = 2 on 128 x 128 gradients
    ``normal * 0.01`` (numpy, from ``seed``): measured wire bytes, the
    pointwise error bound and the measured error against the dense mean,
    packs per segment."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    grads = torch.from_numpy((rng.standard_normal((RING_NODES,) + RING_SHAPE)
                              * 0.01).astype(np.float32)).to(dev)
    mean, tele = ring_allreduce_nsd(grads, seed, RingConfig(s=RING_S))
    row = dict(topology="ring", n_nodes=RING_NODES,
               wire_bytes=float(tele.wire_bytes),
               dense_bytes=float(tele.dense_bytes),
               wire_ratio=float(tele.ratio),
               error_bound=float(tele.error_bound),
               max_err=float((mean - grads.mean(0)).abs().max()),
               packs_per_segment=int(tele.packs_per_segment))
    return {"n_nodes": RING_NODES, "shape": list(RING_SHAPE), "s": RING_S,
            "seed": seed, "rows": [row]}


def results(rows: List[Dict], topo: Dict, topo_us: float) -> List[BenchResult]:
    """The reference's bench rows and gates: accuracy and sparsity must not
    drop, bits and the wire ratio must not rise (training and compression
    claims); the ring's packs per segment are exact, its error bound and
    wire bytes move only if the algorithm changes. Timing is recorded,
    never gated."""
    out = []
    for r in rows:
        derived = {"s": r["s"], "acc": r["acc"], "sparsity": r["sparsity"],
                   "max_bits": r["max_bits"], "wire_mb": r["wire_mb"],
                   "wire_ratio": r["wire_ratio"]}
        gates = {"acc": Gate(abs=10.0, direction="low"),
                 "sparsity": Gate(abs=8.0, direction="low"),
                 "max_bits": Gate(abs=1.0, direction="high"),
                 "wire_ratio": Gate(rel=0.15, direction="high")}
        out.append(BenchResult(
            name=f"fig5-6/N={r['n_nodes']}", value=r["us_per_step"],
            unit="us/step", derived=derived, gates=gates))
    for r in topo["rows"]:
        out.append(BenchResult(
            name=f"topology/{r['topology']}/N={r['n_nodes']}", value=topo_us,
            unit="us",
            derived={"packs_per_segment": float(r["packs_per_segment"]),
                     "error_bound": r["error_bound"],
                     "max_err": r["max_err"],
                     "wire_kb": r["wire_bytes"] / 1e3},
            gates={"packs_per_segment": Gate(abs=0.0, direction="both"),
                   "error_bound": Gate(rel=0.05, direction="high"),
                   "wire_kb": Gate(rel=0.05, direction="high")},
            context={"shape": "x".join(str(d) for d in topo["shape"])}))
    return out


def bench(*, steps: int = 30, device: Optional[torch.device] = None
          ) -> Tuple[List[BenchResult], List[Dict], Dict]:
    """The reference's quick suite: the scaling sweep (N = 1, 2, 4) and the
    ring row at 128 x 128, as gated BenchResults, with the raw rows."""
    dev = resolve_device(device)
    rows = run(node_counts=(1, 2, 4), steps=steps, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    topo = compare_topologies(device=dev)
    _sync(dev)
    us = (time.perf_counter() - t0) * 1e6
    return results(rows, topo, us), rows, topo


def not_ported(baseline: SuiteRun) -> List[Tuple[str, str]]:
    """(row, ROADMAP item) of each baseline row the port does not run."""
    out = []
    for r in baseline.results:
        for prefix, item in NOT_PORTED.items():
            if r.name.startswith(prefix):
                out.append((r.name, item))
    return out


def check(current: List[BenchResult], baseline: SuiteRun) -> CompareReport:
    """Gate the baseline's rows that the port runs; the rows it does not
    run are left to :func:`not_ported`, every other baseline row must be
    in ``current`` (a missing one fails)."""
    skip = {name for name, _ in not_ported(baseline)}
    return compare_runs(
        SuiteRun(suite=baseline.suite, quick=baseline.quick,
                 results=current),
        SuiteRun(suite=baseline.suite, quick=baseline.quick,
                 results=[r for r in baseline.results if r.name not in skip]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is none)")
    ap.add_argument("--check", default=None, metavar="BASELINE_JSON",
                    help="gate the rows this SuiteRun file names")
    args = ap.parse_args(argv)
    res, rows, topo = bench(steps=args.steps, device=args.device)
    for row in rows + topo["rows"]:
        print(json.dumps(row), flush=True)
    if args.check is None:
        return 0
    baseline = SuiteRun.from_dict(json.loads(Path(args.check).read_text()))
    for name, item in not_ported(baseline):
        print(f"not ported: {name}: {item}", flush=True)
    report = check(res, baseline)
    print(report.render(), flush=True)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
