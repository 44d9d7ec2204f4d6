"""The paper's figs. 5/6 and its distributed comm claim: as the number of
nodes N grows (and s with it, s = 2 sqrt(N)), per-node sparsity rises and
the worst-case bit-width falls while accuracy stays flat, and with the NSD
wire on the node -> server hop the bytes on the wire shrink as sparsity
grows.

Counterpart of ``benchmarks/distributed_nodes.py``: its ``run`` (MLP-MNIST
(256, 256), SGD lr 0.05 / momentum 0.9 / weight decay 5e-4,
``variant="paper"``, batch 32, 30 steps, the comm ``nsd`` mode at
``s_for_n()``), its ``compare_topologies`` (the ring, the hierarchy and the
butterfly over 8 nodes in 2 pods, 128 x 128 gradients ``normal * 0.01``
from the seed, drawn here with numpy), its ``compare_butterfly`` (the
butterfly against the tree at 8 nodes in 4 pods on 64 x 64 gradients: the
one-pod butterfly equal to the one-pod tree, the same pack depth, a busiest
DCN line no heavier than the tree root's) and its ``compare_overlap`` (the
bucketed hier reduce of 4 nodes in 2 pods against the blocking one on
MLP-(128, 128)'s node gradients: bit for bit, and the overlap efficiency
that ``comm.pricing.price_overlap`` gives from host timings of each bucket's
reduce, a device sync around each, beside the one it gives from bytes on
a link calibrated to the same timings; each timing the median of five,
where the reference times one call). The link prices (``comm_speedup``,
the topology rows' ``ici_us``, ``dcn_us`` and ``total_us``) are
``repro_torch.comm.pricing``'s on the H100 platform's NVLink and
InfiniBand rates, so they differ from the reference's committed values;
no gate reads them. The reference's ``wire_s_v5e`` (the bytes priced on a
TPU link) is left out.

    python -m repro_torch.train.distributed_nodes [--device cpu] [--steps N] \\
        [--check benchmarks/baselines/BENCH_distributed_nodes.json]

runs on CUDA unless told otherwise and prints one JSON line a row;
``--check`` gates every row against the reference's committed baseline
(read as data) with the current run's bands and exits non-zero on a
regression.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench import BenchResult, Gate, SuiteRun, compare_runs
from repro_torch.bench.compare import CompareReport
from repro_torch.comm import (ButterflyConfig, CommPolicy, HierConfig,
                              RingConfig, butterfly_allreduce_nsd,
                              hier_allreduce_nsd, reducer,
                              ring_allreduce_nsd)
from repro_torch.configs import paper_models as pm
from repro_torch.core.policy import DitherPolicy, fold_in
from repro_torch.data.synthetic import ClassifConfig, classification_batch
from repro_torch.device import resolve_device
from repro_torch.distributed import SSGDConfig, make_ssgd_step, shard_batch
from repro_torch.comm.pricing import (compression_speedup, price_overlap,
                                      price_reduce)
from repro_torch.models.cnn import CNN, accuracy, loss_fn
from repro_torch.obs import metrics
from repro_torch.optim.optimizers import OptConfig, init_opt_state

BATCH = 32  # the sweep's global batch, split over the nodes
# the topology rows: ring, hier and butterfly over 8 nodes in 2 pods
TOPO_NODES, TOPO_PODS, TOPO_SHAPE, TOPO_S = 8, 2, (128, 128), 2.0
# the butterfly-vs-tree row: 8 nodes in 4 pods
BFLY_NODES, BFLY_PODS, BFLY_SHAPE = 8, 4, (64, 64)
# the overlap row: hier over 4 nodes in 2 pods, 256 KiB buckets
OVL_NODES, OVL_PODS, OVL_HIDDEN, OVL_BUCKET = 4, 2, (128, 128), 256 * 1024
OVL_REPEATS = 5  # timings a median is taken over (the host clock is noisy)


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
        opt_cfg = OptConfig(name="sgd", lr=0.05, momentum=0.9,
                            weight_decay=5e-4, grad_clip=None)
        dcfg = SSGDConfig(n_nodes=n, s_schedule="sqrt", s_base=2.0)
        pol = DitherPolicy(variant="paper", collect_stats=True)
        # the comm-side NSD rides the same sqrt(N) schedule as the dither
        comm_policy = CommPolicy(default="nsd", s=dcfg.s_for_n(),
                                 collect_stats=True)
        step_fn, used = make_ssgd_step(net, opt_cfg, dcfg, pol,
                                       comm_policy=comm_policy, device=dev)
        state = init_opt_state(dict(net.named_parameters()), opt_cfg)
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
        cs = metrics.comm_summary()[comm_policy.stats_tag]
        rows.append({"n_nodes": n, "s": used.s,
                     "acc": float(accuracy(net, test)) * 100,
                     "sparsity": metrics.overall_sparsity() * 100,
                     "max_bits": metrics.overall_max_bits(),
                     "us_per_step": us,
                     "wire_mb": cs["wire_bytes"] / 1e6,
                     "wire_ratio": cs["ratio"],
                     "comm_speedup": compression_speedup(
                         cs["wire_bytes"], cs["dense_bytes"])})
    return rows


def _node_grads(n: int, shape, seed: int, dev: torch.device) -> torch.Tensor:
    """n node gradients ``normal * 0.01`` of ``shape`` (numpy, ``seed``)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((n,) + tuple(shape))
                             * 0.01).astype(np.float32)).to(dev)


def compare_topologies(seed: int = 0, *,
                       device: Optional[torch.device] = None) -> Dict:
    """The flat ring, the hierarchy and the butterfly over 8 nodes in 2
    pods at s = 2 on the same gradients: measured wire bytes (the
    two-level reduces split by link class), the pointwise error bound and
    the measured error against the dense mean, packs per segment, and the
    cost model's fast- and slow-axis seconds (``ici_s``, ``dcn_s``,
    ``total_s``)."""
    dev = resolve_device(device)
    grads = _node_grads(TOPO_NODES, TOPO_SHAPE, seed, dev)
    dense_mean = grads.mean(0)

    def row(name, mean, tele, **extra):
        return dict(topology=name, n_nodes=TOPO_NODES,
                    wire_bytes=float(tele.wire_bytes),
                    dense_bytes=float(tele.dense_bytes),
                    wire_ratio=float(tele.ratio),
                    error_bound=float(tele.error_bound),
                    max_err=float((mean - dense_mean).abs().max()),
                    packs_per_segment=int(tele.packs_per_segment),
                    pods=TOPO_PODS,
                    **price_reduce(tele, nodes=TOPO_NODES, pods=TOPO_PODS),
                    **extra)

    def split(tele):
        return dict(per_pod=TOPO_NODES // TOPO_PODS,
                    wire_ici_bytes=float(tele.wire_ici_bytes),
                    wire_dcn_bytes=float(tele.wire_dcn_bytes),
                    peak_dcn_bytes=float(tele.peak_dcn_bytes))

    mean_r, tele_r = ring_allreduce_nsd(grads, seed, RingConfig(s=TOPO_S))
    mean_h, tele_h = hier_allreduce_nsd(
        grads, seed, HierConfig(pods=TOPO_PODS, s=TOPO_S))
    mean_b, tele_b = butterfly_allreduce_nsd(
        grads, seed, ButterflyConfig(pods=TOPO_PODS, s=TOPO_S))
    rows = [row("ring", mean_r, tele_r),
            row("hier", mean_h, tele_h, **split(tele_h)),
            row("butterfly", mean_b, tele_b, **split(tele_b))]
    return {"n_nodes": TOPO_NODES, "pods": TOPO_PODS,
            "shape": list(TOPO_SHAPE), "s": TOPO_S, "seed": seed,
            "rows": rows}


def compare_butterfly(seed: int = 0, *,
                      device: Optional[torch.device] = None) -> Dict:
    """The butterfly against the tree over 8 nodes in 4 pods: the one-pod
    butterfly's difference from the one-pod tree (0: the same packs), the
    difference of their pack depths (0), how far the butterfly's busiest
    DCN line exceeds the tree root's (0) and their ratio, and the
    butterfly's error bound and measured error."""
    dev = resolve_device(device)
    grads = _node_grads(BFLY_NODES, BFLY_SHAPE, seed, dev)
    m_h1, _ = hier_allreduce_nsd(grads, seed, HierConfig(pods=1, s=TOPO_S))
    m_b1, _ = butterfly_allreduce_nsd(grads, seed,
                                      ButterflyConfig(pods=1, s=TOPO_S))
    _, t_h = hier_allreduce_nsd(grads, seed,
                                HierConfig(pods=BFLY_PODS, s=TOPO_S))
    m_b, t_b = butterfly_allreduce_nsd(
        grads, seed, ButterflyConfig(pods=BFLY_PODS, s=TOPO_S))
    peak_b, peak_h = float(t_b.peak_dcn_bytes), float(t_h.peak_dcn_bytes)
    return {"n_nodes": BFLY_NODES, "pods": BFLY_PODS,
            "shape": list(BFLY_SHAPE), "s": TOPO_S,
            "maxdiff_g1": float((m_b1 - m_h1).abs().max()),
            "packs_diff": float(t_b.packs_per_segment - t_h.packs_per_segment),
            "peak_excess": max(0.0, peak_b - peak_h),
            "peak_ratio": peak_b / max(peak_h, 1.0),
            "error_bound": float(t_b.error_bound),
            "max_err": float((m_b - grads.mean(0)).abs().max())}


def compare_overlap(seed: int = 0, *,
                    device: Optional[torch.device] = None) -> Dict:
    """The bucketed hier reduce against the blocking one over 4 nodes in 2
    pods, on the node gradients of MLP-(128, 128) at batch 0: their largest
    difference and wire-byte difference (both 0: a leaf's pack keys do not
    depend on its bucket), the bucket count, and the overlap efficiency
    ``price_overlap`` gives from each bucket's measured reduce seconds and
    from seconds modelled on a link whose rate is calibrated to the same
    measurements (so the gap compares schedules, not rates)."""
    dev = resolve_device(device)
    net = CNN(pm.mlp_mnist(hidden=OVL_HIDDEN), seed=seed, device=dev)
    data_cfg = ClassifConfig(n_classes=10, img_size=28, channels=1,
                             noise=0.5, seed=seed)
    sb = shard_batch(classification_batch(data_cfg, 0, BATCH, device=dev),
                     OVL_NODES)
    names, params = zip(*net.named_parameters())

    def node_grads():
        per = [torch.autograd.grad(loss_fn(net, {k: v[w] for k, v in
                                                 sb.items()}), params)
               for w in range(OVL_NODES)]
        return {n: torch.stack([g[i] for g in per])
                for i, n in enumerate(names)}

    def timed(fn):
        """``fn()`` after a warm-up call, and the median of ``OVL_REPEATS``
        timed calls on the host clock, each between device syncs."""
        out = fn()
        secs = []
        for _ in range(OVL_REPEATS):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            secs.append(time.perf_counter() - t0)
        return out, statistics.median(secs)

    threads = torch.get_num_threads()
    if dev.type == "cpu":
        # one thread: idle threads of a shared host's pool stretch a few
        # small ops' time far more than a whole bucket's
        torch.set_num_threads(1)
    try:
        grads, bwd_s = timed(node_grads)
        pol = CommPolicy(default="nsd", s=TOPO_S, topology="hier",
                         pods=OVL_PODS)
        blocking = reducer(pol, n_nodes=OVL_NODES)
        bucketed = reducer(pol.replace(bucket_bytes=OVL_BUCKET),
                           n_nodes=OVL_NODES)
        key = fold_in(seed, 1)
        mean_b, tele_b, _ = blocking.reduce(grads, key, 0)
        mean_o, tele_o, _ = bucketed.reduce(grads, key, 0)
        plan = bucketed.plan_for(grads)
        bucket_s, bucket_wire = [], []
        for bucket in plan.buckets:
            sub = {n: grads[n] for n in bucket}
            (_, tele, _), sec = timed(lambda: blocking.reduce(sub, key, 0))
            bucket_s.append(sec)
            bucket_wire.append(float(tele.wire_bytes))
    finally:
        torch.set_num_threads(threads)
    maxdiff = max(float((mean_b[n] - mean_o[n]).abs().max()) for n in names)
    bw = sum(bucket_wire) / max(sum(bucket_s), 1e-12)
    measured = price_overlap(plan.bucket_bytes, bucket_s, bwd_s=bwd_s)
    modeled = price_overlap(plan.bucket_bytes, [w / bw for w in bucket_wire],
                            bwd_s=bwd_s)
    eff_meas = measured["overlap_efficiency"]
    eff_model = modeled["overlap_efficiency"]
    return {"n_nodes": OVL_NODES, "pods": OVL_PODS,
            "bucket_bytes": OVL_BUCKET, "n_buckets": plan.n_buckets,
            "maxdiff": maxdiff,
            "wire_diff": abs(float(tele_b.wire_bytes)
                             - float(tele_o.wire_bytes)),
            "bwd_s": bwd_s, "bucket_s": bucket_s,
            "eff_measured": eff_meas, "eff_modeled": eff_model,
            "eff_gap": abs(eff_model - eff_meas)}


def results(rows: List[Dict], topo: Dict, topo_us: float, bfly: Dict,
            bfly_us: float, ovl: Dict, ovl_us: float) -> List[BenchResult]:
    """The reference's bench rows and gates: accuracy and sparsity must not
    drop, bits and the wire ratio must not rise (training and compression
    claims); each topology's packs per segment are exact, its error bound
    and wire bytes move only if the algorithm changes; the butterfly's
    three invariants against the tree are exact; the overlap row's are
    :func:`overlap_result`'s. Timing is recorded, never gated."""
    out = []
    for r in rows:
        derived = {"s": r["s"], "acc": r["acc"], "sparsity": r["sparsity"],
                   "max_bits": r["max_bits"], "wire_mb": r["wire_mb"],
                   "wire_ratio": r["wire_ratio"],
                   "comm_speedup": r["comm_speedup"]}
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
                     "wire_kb": r["wire_bytes"] / 1e3,
                     "ici_us": r["ici_s"] * 1e6,
                     "dcn_us": r["dcn_s"] * 1e6,
                     "total_us": r["total_s"] * 1e6},
            gates={"packs_per_segment": Gate(abs=0.0, direction="both"),
                   "error_bound": Gate(rel=0.05, direction="high"),
                   "wire_kb": Gate(rel=0.05, direction="high")},
            context={"pods": topo["pods"],
                     "shape": "x".join(str(d) for d in topo["shape"])}))
    out.append(BenchResult(
        name=f"butterfly/vs-tree/N={bfly['n_nodes']}", value=bfly_us,
        unit="us",
        derived={k: bfly[k] for k in ("maxdiff_g1", "packs_diff",
                                      "peak_excess", "peak_ratio",
                                      "error_bound")},
        gates={"maxdiff_g1": Gate(abs=0.0, direction="both"),
               "packs_diff": Gate(abs=0.0, direction="both"),
               "peak_excess": Gate(abs=0.0, direction="high"),
               "error_bound": Gate(rel=0.05, direction="high")},
        context={"pods": bfly["pods"],
                 "shape": "x".join(str(d) for d in bfly["shape"])}))
    out.append(overlap_result(ovl, ovl_us))
    return out


def overlap_result(ovl: Dict, us: float) -> BenchResult:
    """The overlap row: the bucketed reduce equals the blocking one
    exactly, in as many buckets, and the modelled efficiency stays within
    0.35 of the measured one (host timings move the measured number; the
    gate bounds the gap, not the number)."""
    return BenchResult(
        name=f"overlap/hier-bucketed/N={ovl['n_nodes']}", value=us,
        unit="us",
        derived={"maxdiff": ovl["maxdiff"], "wire_diff": ovl["wire_diff"],
                 "n_buckets": float(ovl["n_buckets"]),
                 "eff_measured": ovl["eff_measured"],
                 "eff_modeled": ovl["eff_modeled"],
                 "eff_gap": ovl["eff_gap"]},
        gates={"maxdiff": Gate(abs=0.0, direction="both"),
               "wire_diff": Gate(abs=0.0, direction="both"),
               "n_buckets": Gate(abs=0.0, direction="both"),
               "eff_gap": Gate(abs=0.35, direction="high")},
        context={"bucket_bytes": ovl["bucket_bytes"]})


def bench(*, steps: int = 30, device: Optional[torch.device] = None
          ) -> Tuple[List[BenchResult], List[Dict], Dict]:
    """The reference's quick suite: the scaling sweep (N = 1, 2, 4), the
    three topology rows at 128 x 128, the butterfly-vs-tree row at 64 x 64
    and the overlap row, as gated BenchResults, with the raw rows (the
    topology rows under ``topo["rows"]``, the butterfly's and the overlap's
    under ``topo["butterfly"]`` and ``topo["overlap"]``)."""
    dev = resolve_device(device)
    rows = run(node_counts=(1, 2, 4), steps=steps, device=dev)

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(device=dev)
        _sync(dev)
        return out, (time.perf_counter() - t0) * 1e6

    topo, topo_us = timed(compare_topologies)
    bfly, bfly_us = timed(compare_butterfly)
    ovl, ovl_us = timed(compare_overlap)
    return (results(rows, topo, topo_us, bfly, bfly_us, ovl, ovl_us), rows,
            dict(topo, butterfly=bfly, overlap=ovl))


def check(current: List[BenchResult], baseline: SuiteRun) -> CompareReport:
    """Gate the current rows against every baseline row (a missing one
    fails)."""
    return compare_runs(SuiteRun(suite=baseline.suite, quick=baseline.quick,
                                 results=current), baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is none)")
    ap.add_argument("--check", default=None, metavar="BASELINE_JSON",
                    help="gate the rows this SuiteRun file names")
    args = ap.parse_args(argv)
    res, rows, topo = bench(steps=args.steps, device=args.device)
    for row in rows + topo["rows"] + [topo["butterfly"], topo["overlap"]]:
        print(json.dumps(row), flush=True)
    if args.check is None:
        return 0
    baseline = SuiteRun.from_dict(json.loads(Path(args.check).read_text()))
    report = check(res, baseline)
    print(report.render(), flush=True)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
