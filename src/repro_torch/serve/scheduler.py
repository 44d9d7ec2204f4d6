"""Admission control + page-pool-aware scheduling (host side).

Counterpart of ``repro.serve.scheduler``, the same rules: host Python over
numpy, nothing on the device.

The engine owns the device step; this module owns the host bookkeeping
around it: a bounded request queue, an active-token budget, and — in paged
mode — the shared physical page pool with per-slot allocation, release,
and the free-list arithmetic behind preemption decisions.

Policy (deliberately simple, deterministic, and test-pinned):

* FIFO admission, gated by queue bound and ``max_active_tokens`` (the sum
  of prompt + max_new_tokens across active slots).
* A request whose worst-case footprint can never fit the pool is rejected
  at submit time — admitting it would deadlock the preemption loop.
* On pool exhaustion the engine preempts the *youngest* active slot
  (least work lost; its request requeues at the FRONT with the tokens it
  already generated folded into the replay prompt, so greedy decoding
  reproduces the same output after re-admission).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional

import numpy as np

from repro_torch.serve.kvcache import pages_for


class PagePool:
    """Free-list allocator over ``n_pages`` physical pages."""

    def __init__(self, n_pages: int, page: int):
        if n_pages < 1 or page < 1:
            raise ValueError("n_pages and page must be >= 1")
        self.n_pages = int(n_pages)
        self.page = int(page)
        # LIFO free list: recently released pages are re-used first, which
        # keeps the working set of physical ids small and deterministic
        self._free: List[int] = list(range(n_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages, all-or-nothing; None when the pool is short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        return out

    def free(self, ids) -> None:
        for pid in ids:
            pid = int(pid)
            if not 0 <= pid < self.n_pages or pid in self._free:
                raise ValueError(f"double/invalid free of page {pid}")
            self._free.append(pid)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_queue: int = 0  # pending requests bound; 0 = unbounded
    max_active_tokens: int = 0  # sum(prompt+max_new) over active; 0 = unbounded


class Scheduler:
    """Queue + (optional) page-table bookkeeping for ``max_batch`` slots."""

    def __init__(self, cfg: SchedulerConfig, max_batch: int,
                 max_pages_per_slot: int = 0,
                 pool: Optional[PagePool] = None):
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.pool = pool
        self.max_pages = int(max_pages_per_slot)
        self._queue: Deque = collections.deque()
        self._pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.rejected = 0  # queue-bound rejections (telemetry)

    # ------------------------------------------------------------- queue
    def submit(self, req, *, tokens_worst_case: int) -> bool:
        """Enqueue; False when the queue bound rejects it. Raises when the
        request can NEVER fit the pool (admitting it would deadlock)."""
        if self.pool is not None:
            need = pages_for(tokens_worst_case, self.pool.page)
            cap = min(self.pool.n_pages, self.max_pages or need)
            if need > cap:
                raise ValueError(
                    f"request needs {need} pages (prompt+max_new="
                    f"{tokens_worst_case}) but the pool caps at {cap}")
        if self.cfg.max_queue and len(self._queue) >= self.cfg.max_queue:
            self.rejected += 1
            return False
        self._queue.append(req)
        return True

    def requeue_front(self, req) -> None:
        """Preempted work goes to the head: it already holds progress."""
        self._queue.appendleft(req)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def next_request(self, active_tokens: int, tokens_of) -> Optional[object]:
        """Pop the head request if the token budget admits it."""
        if not self._queue:
            return None
        head = self._queue[0]
        if (self.cfg.max_active_tokens
                and active_tokens + tokens_of(head)
                > self.cfg.max_active_tokens):
            return None
        return self._queue.popleft()

    # ------------------------------------------------------------- pages
    def slot_pages(self, slot: int) -> List[int]:
        return self._pages[slot]

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow slot's mapping to cover ``n_tokens`` positions; False when
        the pool cannot supply the missing pages (caller preempts)."""
        if self.pool is None:
            return True
        need = pages_for(n_tokens, self.pool.page)
        have = len(self._pages[slot])
        if need <= have:
            return True
        got = self.pool.alloc(need - have)
        if got is None:
            return False
        self._pages[slot].extend(got)
        return True

    def release(self, slot: int) -> None:
        if self.pool is not None and self._pages[slot]:
            self.pool.free(self._pages[slot])
        self._pages[slot] = []

    def table(self) -> np.ndarray:
        """(max_batch, max_pages) physical-id table, -1 for unmapped."""
        t = np.full((self.max_batch, max(self.max_pages, 1)), -1, np.int32)
        for s, ids in enumerate(self._pages):
            t[s, :len(ids)] = ids
        return t
