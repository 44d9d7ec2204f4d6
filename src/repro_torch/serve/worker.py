"""Serving workers: one engine per hosted model, a supervisor above them.

Counterpart of ``repro.serve.worker``, unchanged in behaviour.

A :class:`Worker` wraps one :class:`~repro_torch.serve.engine.Engine` for one
model-zoo config and gives it a stable name — the name is the tag its
per-tick rows carry on the ``serve`` obs stream, so health detectors and
run logs distinguish workers for free. A :class:`Supervisor` hosts several
workers (several zoo configs side by side), round-robins ticks across
them, routes requests by model name, and runs a
:class:`~repro_torch.obs.monitor.MonitorSuite` with a
:class:`~repro_torch.obs.monitor.ServeMonitor` over the shared stream — a
stalled worker trips a critical event; ``escalate=True`` turns that into
a raised :class:`~repro_torch.obs.monitor.MonitorAlert`.

Everything is in-process and single-host: the point is the scheduling and
health surface, not RPC.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.models.api import Model
from repro_torch.obs.monitor import MonitorSuite, ServeMonitor
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.utils import get_logger

log = get_logger("repro_torch.serve.worker")


@dataclasses.dataclass
class WorkerHealth:
    """Snapshot of one worker's state for health checks."""

    name: str
    model: str
    ticks: int
    active_slots: int
    queue_depth: int
    finished: int
    preemptions: int
    rejected: int

    @property
    def idle(self) -> bool:
        return self.active_slots == 0 and self.queue_depth == 0


class Worker:
    """One named engine hosting one model config."""

    def __init__(self, name: str, model: Model, params, cfg: ServeConfig):
        self.name = name
        self.model = model
        self.engine = Engine(model, params, cfg, name=name)
        self.results: Dict[int, List[int]] = {}
        self._finished = 0

    def submit(self, req: Request) -> bool:
        return self.engine.submit(req)

    def tick(self) -> None:
        self.engine.step()
        done = self.engine._finished
        if done:
            self._finished += len(done)
            self.results.update(done)
            self.engine._finished = {}

    @property
    def idle(self) -> bool:
        eng = self.engine
        return (all(s is None for s in eng._slots)
                and eng.sched.queue_depth == 0)

    def health(self) -> WorkerHealth:
        eng = self.engine
        return WorkerHealth(
            name=self.name, model=self.model.name, ticks=eng._tick,
            active_slots=sum(s is not None for s in eng._slots),
            queue_depth=eng.sched.queue_depth, finished=self._finished,
            preemptions=eng.preemptions, rejected=eng.sched.rejected)


class Supervisor:
    """Hosts several workers; routes by model name, ticks round-robin."""

    def __init__(self, *, escalate: bool = False, max_backlog: float = 32.0,
                 stall_ticks: int = 8):
        self.workers: Dict[str, Worker] = {}
        self.monitors = MonitorSuite(
            [ServeMonitor(max_backlog=max_backlog, min_rows=stall_ticks)],
            escalate=escalate)
        self._uid = 0
        self._route: Dict[int, str] = {}  # uid -> worker name

    def add_worker(self, name: str, model: Model, params,
                   cfg: ServeConfig) -> Worker:
        if name in self.workers:
            raise ValueError(f"duplicate worker name {name!r}")
        w = Worker(name, model, params, cfg)
        self.workers[name] = w
        log.info("worker %s hosting %s (batch=%d, kv=%s%s)", name,
                 model.name, cfg.max_batch, cfg.kv_mode,
                 f"/page{cfg.kv_page}" if cfg.kv_page else "/dense")
        return w

    def _worker_for(self, model_name: Optional[str]) -> Worker:
        if model_name is None:
            if len(self.workers) != 1:
                raise ValueError("model name required with several workers")
            return next(iter(self.workers.values()))
        for w in self.workers.values():
            if w.model.name == model_name or w.name == model_name:
                return w
        raise KeyError(f"no worker hosts {model_name!r}; have "
                       f"{[w.model.name for w in self.workers.values()]}")

    def submit(self, prompt, max_new_tokens: int = 16,
               model: Optional[str] = None) -> Optional[int]:
        """Route a prompt; returns the request uid, or None when the
        worker's queue bound rejected it."""
        w = self._worker_for(model)
        uid = self._uid
        self._uid += 1
        ok = w.submit(Request(uid, np.asarray(prompt, np.int32),
                              max_new_tokens=max_new_tokens))
        if not ok:
            return None
        self._route[uid] = w.name
        return uid

    def tick(self) -> None:
        """One supervisor tick: every worker steps, then health runs."""
        for w in self.workers.values():
            w.tick()
        step = max(w.engine._tick for w in self.workers.values())
        self.monitors.tick(step)

    def run(self, max_ticks: int = 256) -> Dict[int, List[int]]:
        """Tick until every worker drains or ``max_ticks``; returns all
        finished {uid: tokens} accumulated so far."""
        for _ in range(max_ticks):
            self.tick()
            if all(w.idle for w in self.workers.values()):
                break
        out: Dict[int, List[int]] = {}
        for w in self.workers.values():
            out.update(w.results)
        return out

    def result(self, uid: int) -> Optional[List[int]]:
        name = self._route.get(uid)
        if name is None:
            return None
        return self.workers[name].results.get(uid)

    def health(self) -> List[WorkerHealth]:
        return [w.health() for w in self.workers.values()]
