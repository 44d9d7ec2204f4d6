"""repro_torch.serve: the serving tier for the dense and MoE families.

Counterpart of ``repro.serve``: the chunked-prefill engine
(``engine.py``), the paged KV cache with codec-encoded pages
(``kvcache.py``), the host-side scheduler (``scheduler.py``) and the
workers and their supervisor (``worker.py``); the launcher is
``repro_torch.launch.serve``.
"""
from repro_torch.serve.engine import Engine, Request, ServeConfig, greedy_generate
from repro_torch.serve.kvcache import KV_MODES, PagedKV, init_paged, pages_for
from repro_torch.serve.scheduler import PagePool, Scheduler, SchedulerConfig
from repro_torch.serve.worker import Supervisor, Worker, WorkerHealth

__all__ = [
    "Engine", "Request", "ServeConfig", "greedy_generate",
    "KV_MODES", "PagedKV", "init_paged", "pages_for",
    "PagePool", "Scheduler", "SchedulerConfig",
    "Supervisor", "Worker", "WorkerHealth",
]
