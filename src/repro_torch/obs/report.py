"""Offline run report: Table-1-style summaries from a run directory alone.

    python -m repro_torch.obs.report <run-dir>

Counterpart of ``repro.obs.report``. Reads the JSONL streams and manifest
that :mod:`repro_torch.obs.runlog` writes (no live process, no tensors) and
renders:

* the run header (run id, git sha, torch version, platform, caller context)
* a per-layer dither table: mean sparsity %, worst-case / mean bits,
  record count per layer tag (the paper's Table 1 aggregation)
* comm totals: wire vs dense bytes and the achieved ratio per tag
* residual-memory totals: occupancy and capacity compression per layer
* a step-phase breakdown: total / mean / share of wall clock per span path
  (the ``data`` / ``dispatch`` / ``controller`` / ``monitor`` taxonomy of
  :mod:`repro_torch.obs.trace`)
* monitor events, most recent last

Every line after the header is the reference's format, so the two packages'
reports of one run directory agree line for line.
"""
from __future__ import annotations

import argparse
import collections
from typing import Any, Dict, List

from repro_torch.obs.runlog import read_run


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TB"


def _by_tag(rows: List[Dict[str, Any]]) -> Dict[str, List[Dict[str, Any]]]:
    out: Dict[str, List[Dict[str, Any]]] = collections.defaultdict(list)
    for r in rows:
        out[r.get("tag", "")].append(r)
    return out


def _vals(rows: List[Dict[str, Any]], col: str) -> List[float]:
    return [r[col] for r in rows if r.get(col) is not None]


def dither_table(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-layer-tag [mean sparsity %, max bits, mean bits, n] rows."""
    table = []
    for tag, rs in sorted(_by_tag(rows).items()):
        sp, bits = _vals(rs, "sparsity"), _vals(rs, "bits")
        if not sp:
            continue
        table.append({
            "tag": tag,
            "mean_sparsity_pct": 100.0 * sum(sp) / len(sp),
            "max_bits": max(bits) if bits else float("nan"),
            "mean_bits": sum(bits) / len(bits) if bits else float("nan"),
            "n": len(rs),
        })
    return table


def phase_table(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-span-path total / mean duration and share of the traced total."""
    grand = 0.0
    agg: Dict[str, List[float]] = collections.defaultdict(list)
    for r in rows:
        d = r.get("duration_s")
        if d is None:
            continue
        agg[r.get("tag", "")].append(d)
        # only top-level spans count toward the grand total: nested span
        # time is already inside the parent's measurement
        if "/" not in r.get("tag", ""):
            grand += d
    table = []
    for tag, ds in sorted(agg.items()):
        total = sum(ds)
        table.append({
            "span": tag, "total_s": total, "mean_ms": 1e3 * total / len(ds),
            "n": len(ds),
            "share_pct": 100.0 * total / grand if grand > 0 else 0.0,
        })
    table.sort(key=lambda r: -r["total_s"])
    return table


def render(run_dir: str) -> str:
    manifest, streams = read_run(run_dir)
    out: List[str] = []
    ctx = manifest.get("context", {})
    out.append(f"run {manifest.get('run_id')}  "
               f"[git {manifest.get('git_sha')}, "
               f"torch {manifest.get('torch_version')}, "
               f"{manifest.get('platform')}]")
    for k in sorted(ctx):
        out.append(f"  {k}: {ctx[k]}")

    dt = dither_table(streams.get("dither", []))
    if dt:
        out.append("")
        out.append("per-layer dither telemetry (Table-1 aggregation)")
        out.append(f"  {'layer':<28} {'sparsity%':>9} {'max bits':>8} "
                   f"{'mean bits':>9} {'n':>6}")
        for r in dt:
            out.append(f"  {r['tag']:<28} {r['mean_sparsity_pct']:>9.2f} "
                       f"{r['max_bits']:>8.1f} {r['mean_bits']:>9.2f} "
                       f"{r['n']:>6d}")
        all_sp = _vals(streams["dither"], "sparsity")
        if all_sp:
            out.append(f"  overall sparsity: "
                       f"{100.0 * sum(all_sp) / len(all_sp):.2f}% over "
                       f"{len(all_sp)} layer x step records")

    comm = streams.get("comm", [])
    if comm:
        out.append("")
        out.append("comm: compressed gradient exchange")
        for tag, rs in sorted(_by_tag(comm).items()):
            wire = sum(_vals(rs, "wire_bytes"))
            dense = sum(_vals(rs, "dense_bytes"))
            ratio = wire / dense if dense else float("nan")
            out.append(f"  {tag:<28} wire {_fmt_bytes(wire):>10} / dense "
                       f"{_fmt_bytes(dense):>10}  ratio {ratio:.4f}")

    mem = streams.get("memory", [])
    if mem:
        out.append("")
        out.append("memory: residual store per layer")
        out.append(f"  {'layer':<28} {'measured':>10} {'capacity':>10} "
                   f"{'dense':>10} {'occ x':>6} {'cap x':>6}")
        for tag, rs in sorted(_by_tag(mem).items()):
            m = sum(_vals(rs, "measured_bytes"))
            c = sum(_vals(rs, "capacity_bytes"))
            d = sum(_vals(rs, "dense_bytes"))
            occ = d / m if m else float("nan")
            cap = d / c if c else float("nan")
            out.append(f"  {tag:<28} {_fmt_bytes(m):>10} {_fmt_bytes(c):>10} "
                       f"{_fmt_bytes(d):>10} {occ:>6.2f} {cap:>6.2f}")

    pt = phase_table(streams.get("phase", []))
    if pt:
        out.append("")
        out.append("step-phase breakdown (host spans)")
        out.append(f"  {'span':<24} {'total s':>9} {'mean ms':>9} "
                   f"{'n':>6} {'share%':>7}")
        for r in pt:
            out.append(f"  {r['span']:<24} {r['total_s']:>9.3f} "
                       f"{r['mean_ms']:>9.2f} {r['n']:>6d} "
                       f"{r['share_pct']:>7.1f}")

    train = streams.get("train", [])
    losses = [(r["step"], r["loss"]) for r in train
              if r.get("loss") is not None]
    if losses:
        out.append("")
        first, last = losses[0], losses[-1]
        out.append(f"train: {len(losses)} steps, loss "
                   f"{first[1]:.4f} (step {int(first[0])}) -> "
                   f"{last[1]:.4f} (step {int(last[0])})")

    events = streams.get("monitor", [])
    out.append("")
    if events:
        out.append(f"monitor events ({len(events)}):")
        for ev in events:
            out.append(f"  step {ev.get('step', '?'):>5} "
                       f"[{ev.get('severity')}] {ev.get('kind')}: "
                       f"{ev.get('message')}")
    else:
        out.append("monitor events: none")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render Table-1-style summaries + step-time breakdown "
                    "from a run directory's JSONL streams")
    ap.add_argument("run_dir", help="directory written via --run-dir / "
                    "repro_torch.obs.runlog.RunLog")
    args = ap.parse_args(argv)
    print(render(args.run_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
