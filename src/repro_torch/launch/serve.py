"""Serving launcher: a supervisor over one slot engine a worker.

    python -m repro_torch.launch.serve --arch gemma-2b --device cpu
    python -m repro_torch.launch.serve --preset full \\
        --serve "worker gemma-2b: batch=8;max_len=128;chunk=8;kv=nsd;page=16" \\
        --requests 16 --new-tokens 16 --run-dir /tmp/serve-run

Counterpart of ``repro.launch.serve``. A ``--serve`` spec, in the same
section-prefixed shape as the trainer's ``--program``, configures one
worker a ``worker <arch>:`` section. Its clauses are ``key=value`` pairs
mapped onto :class:`~repro_torch.serve.engine.ServeConfig` (``batch``,
``max_len``, ``chunk``, ``kv`` mode, ``page`` size, ``pool`` pages,
``queue`` bound, ``budget`` active-token bound). Synthetic traffic (4-token
prompts from seed 0) is spread round-robin across workers; ``--run-dir``
exports the ``serve`` stream's rows and the monitor events through the run
log. ``--arch`` (with ``--max-len``) builds a one-worker spec. The
parameters are the model's seed-0 draw (``Model.init(0, device)``).

Archs: the dense (gemma-2b, gemma3-4b, qwen2.5-32b, minitron-8b), MoE
(moonshot-v1-16b-a3b, dbrx-132b), VLM (internvl2-2b, served on text as the
reference's engine serves it), SSM (mamba2-370m) and hybrid (hymba-1.5b)
families; a windowed config (gemma3-4b, hymba-1.5b) and the SSM's
per-layer states take dense buffers (``page=0``, the default), a local
layer's ring of ``min(window, max_len)`` slots (hymba: behind its pinned
meta slots). Runs on CUDA unless ``--device cpu``. The audio family
(whisper-small) is parsed and then refused by its worker's engine with the
reference's ``ValueError``: each request needs its own encoder features,
and ``repro_torch.serve.greedy_generate(..., frames=...)`` serves it.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ARCH_IDS, get_model, get_smoke_model
from repro_torch.device import resolve_device
from repro_torch.obs.monitor import MonitorSuite, ServeMonitor
from repro_torch.obs.runlog import run_obs
from repro_torch.serve import ServeConfig, Supervisor
from repro_torch.utils import get_logger

log = get_logger("repro_torch.serve-cli")

_KEYS = ("batch", "max_len", "chunk", "kv", "page", "pool", "queue",
         "budget")


def parse_serve_spec(spec: str) -> List[Tuple[str, Dict[str, str]]]:
    """Split a ``--serve`` spec into (arch, {key: value}) worker sections.

    Grammar mirrors ``--program``: a section starts at the token pair
    ``worker <arch>:``; its clauses are ``;``-separated ``key=value``
    pairs and extend to the next ``worker`` marker.
    """
    toks = spec.split()
    if not toks or toks[0] != "worker":
        raise ValueError(
            f"--serve spec must start with 'worker <arch>:', got {spec!r}")
    out: List[Tuple[str, List[str]]] = []
    i = 0
    while i < len(toks):
        if toks[i] != "worker":
            out[-1][1].append(toks[i])
            i += 1
            continue
        if i + 1 >= len(toks) or not toks[i + 1].endswith(":"):
            raise ValueError("'worker' must be followed by '<arch>:'")
        out.append((toks[i + 1][:-1], []))
        i += 2
    sections = []
    for arch, clause_toks in out:
        if arch not in ARCH_IDS:
            raise ValueError(f"unknown arch {arch!r}; one of {ARCH_IDS}")
        kv: Dict[str, str] = {}
        for clause in " ".join(clause_toks).split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if "=" not in clause:
                raise ValueError(f"clause {clause!r} is not key=value")
            k, v = clause.split("=", 1)
            if k not in _KEYS:
                raise ValueError(f"unknown serve key {k!r}; one of {_KEYS}")
            kv[k] = v
        sections.append((arch, kv))
    return sections


def serve_config(kv: Dict[str, str]) -> ServeConfig:
    return ServeConfig(
        max_batch=int(kv.get("batch", 4)),
        max_len=int(kv.get("max_len", 128)),
        chunk=int(kv.get("chunk", 8)),
        kv_mode=kv.get("kv", "fp32"),
        kv_page=int(kv.get("page", 0)),
        kv_pool_pages=int(kv.get("pool", 0)),
        max_queue=int(kv.get("queue", 0)),
        max_active_tokens=int(kv.get("budget", 0)),
    )


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", default=None,
                    help="worker spec: 'worker <arch>: k=v;k=v worker ...'")
    ap.add_argument("--arch", choices=ARCH_IDS, default=None,
                    help="single-worker shorthand")
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-ticks", type=int, default=0,
                    help="0: auto from request sizes")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is none)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Supervisor:
    """Serve ``--requests`` synthetic requests; returns the supervisor
    (its workers' results and health)."""
    args = parse_args(argv)
    if (args.serve is None) == (args.arch is None):
        raise SystemExit("exactly one of --serve / --arch is required")
    if args.serve:
        sections = parse_serve_spec(args.serve)
    else:
        sections = [(args.arch, {"max_len": str(args.max_len)})]
    device = resolve_device(args.device)

    obs = None
    if args.run_dir:
        obs = run_obs(args.run_dir,
                      context={"launcher": "serve",
                               "workers": [a for a, _ in sections]},
                      monitors=[ServeMonitor()])

    sup = Supervisor()
    sup.monitors = MonitorSuite([ServeMonitor()]) if obs is None \
        else obs.monitors
    get = get_smoke_model if args.preset == "smoke" else get_model
    for arch, kv in sections:
        model = get(arch)
        sup.add_worker(arch, model, model.init(0, device), serve_config(kv))

    rng = np.random.default_rng(0)
    names = list(sup.workers)
    expected = []
    for i in range(args.requests):
        w = sup.workers[names[i % len(names)]]
        uid = sup.submit(rng.integers(0, w.model.cfg.vocab, size=4),
                         max_new_tokens=args.new_tokens, model=w.name)
        if uid is None:
            log.warning("request %d rejected (queue bound)", i)
        else:
            expected.append(uid)

    ticks = args.max_ticks or (
        args.requests * (args.new_tokens + 2) + 8)
    done = sup.run(max_ticks=ticks)
    for uid, toks in sorted(done.items()):
        log.info("request %d -> %s", uid, toks)
    for h in sup.health():
        log.info("%s: ticks=%d finished=%d preempt=%d rejected=%d",
                 h.name, h.ticks, h.finished, h.preemptions, h.rejected)
    if obs is not None:
        obs.finish()
    print(f"served {len(done)}/{len(expected)} requests "
          f"across {len(sup.workers)} worker(s)")
    return sup


if __name__ == "__main__":
    main()
