"""gemma-2b's launcher step times (chip_smoke.py phase 7a's command) from
several checkouts, one fresh process a run, in a given order on one card.

Two trees of the port are compared on one machine by alternating them
(``--order ABBA...``), so that a shift between machines or runs is not read
as a shift between trees. Each run builds the tree's kernels first (into
its own ``build/``), then trains 6 steps under phase 7a's program and times
every step on the host clock between two ``torch.cuda.synchronize()``, as
phase 7a does; no obs, no stats.

    python tests/lm_step_times.py --tree A=_archive/parent --tree B=. \\
        --order ABBAAB --out lm_step_times.jsonl

One JSON line a run (tree, run, ms a step, launches a step), then a summary
of the kernel steps (2-5) per tree and the card's name and power limit.
Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# chip_smoke.py phase 7a
LM_ARGV = ["--arch", "gemma-2b", "--preset", "full", "--batch", "8",
           "--seq", "128", "--steps", "6", "--program",
           "dither: phase@0=off;phase@2=kernel;s=lin(2,6,4.0,2.0);rule lm_head:off"]
FIRST_KERNEL_STEP = 2


def child() -> None:
    """One launcher run of the tree on ``sys.path``; prints one JSON line."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import train as lm_train
    from repro_torch.train import trainer as trainer_mod

    build.library()
    seen = []
    real_step = trainer_mod.Trainer.train_step

    def timed_step(self, batch, step):
        torch.cuda.synchronize()
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        out = real_step(self, batch, step)
        torch.cuda.synchronize()
        seen.append(((time.perf_counter() - t0) * 1e3,
                     {k: v - before[k] for k, v in build.LAUNCHES.items()
                      if v != before[k]}))
        return out

    trainer_mod.Trainer.train_step = timed_step
    lm_train.main(LM_ARGV)
    print(json.dumps({"ms": [m for m, _ in seen],
                      "launches": [n for _, n in seen]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR, a checkout of the repo (its src/ is used)")
    ap.add_argument("--order", default="ABBA",
                    help="the labels in the order to run them")
    ap.add_argument("--out", default=None, help="append the JSON lines here")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child()
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    if not trees or any(label not in trees for label in args.order):
        ap.error(f"--order {args.order!r} names a tree not in {sorted(trees)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    kernel_ms = {label: [] for label in trees}
    lines = []
    for i, label in enumerate(args.order):
        root = os.path.abspath(trees[label])
        env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child"], cwd=root, env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec = {"tree": label, "dir": trees[label], "run": i, "card": card,
               **rec}
        lines.append(rec)
        kernel_ms[label] += rec["ms"][FIRST_KERNEL_STEP:]
        print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    for label, ms in kernel_ms.items():
        print(f"tree {label} ({trees[label]}): kernel steps {len(ms)}, "
              f"median {statistics.median(ms):.3f} ms, {min(ms):.3f}-"
              f"{max(ms):.3f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
