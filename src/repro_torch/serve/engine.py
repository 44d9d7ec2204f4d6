"""Throughput-oriented serving engine: chunked prefill + paged KV cache.

Counterpart of ``repro.serve.engine``. A fixed pool of B slots advances in
ticks. Each tick feeds up to ``chunk`` tokens a slot through ``chunk``
decode micro-steps (the reference's ``lax.scan``, here a loop of
``decode_step`` calls): slots still consuming their prompt feed a prompt
chunk (chunked prefill), slots in steady state feed the token they
generated last tick, empty slots ride along fully masked. Every slot
carries its own position counter (a request admitted at tick 40 writes
cache position 0, not 40), and an inactive micro-step is position
``t = -1``: its write is dropped and attention masks the slot entirely.

KV storage is either the dense per-slot buffers of ``Model.init_cache``
(``kv_page=0``) or the paged, codec-quantized pool of
``repro_torch.serve.kvcache``; admission, page allocation and
preemption-and-recompute on pool exhaustion live in
``repro_torch.serve.scheduler``. A preempted request requeues at the front
with its generated tokens folded into the replay prompt, so greedy decoding
completes with the output it would have produced uninterrupted.

A tick uploads its token block and positions once and reads back its
sampled tokens once (the argmax's one host sync); the positions stay on
the host too, where the paged cache decides which pages seal. Per-tick
telemetry (occupancy, fed and generated tokens, KV capacity bytes against
the dense fp32 counterfactual) lands on the ``serve`` stream of the bus,
from host numbers only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.obs.bus import get_bus
from repro_torch.obs.trace import span
from repro_torch.serve import kvcache
from repro_torch.serve.scheduler import PagePool, Scheduler, SchedulerConfig
from repro_torch.utils import get_logger

log = get_logger("repro_torch.serve")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    eos_id: int = -1  # -1: never stop early
    chunk: int = 8  # prompt tokens fused into one tick (chunked prefill)
    kv_mode: str = "fp32"  # fp32 | bf16 | int8 | nsd (paged mode only)
    kv_page: int = 0  # tokens per KV page; 0 = dense per-slot buffers
    kv_pool_pages: int = 0  # physical pages; 0 = auto (no oversubscription)
    max_queue: int = 0  # pending-request bound; 0 = unbounded
    max_active_tokens: int = 0  # admission token budget; 0 = unbounded


def _is_paged(x) -> bool:
    return hasattr(x, "update_and_view")


def _select_cache(t: torch.Tensor, new, old):
    """Per-slot cache select: keep ``old`` rows where the slot was inactive
    this micro-step (t < 0). Paged caches pass through: their writes are
    already masked by the t < 0 convention (and their pools are
    page-major)."""
    out, active = [], None
    for n, o in zip(new, old):
        if _is_paged(n):
            out.append(n)
            continue
        if active is None:
            active = t >= 0
        out.append(tuple(torch.where(
            active.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(n, o)))
    return out


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` with no stream sync."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


class Engine:
    def __init__(self, model: Model, params: Any, cfg: ServeConfig,
                 name: str = "engine"):
        if cfg.chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.name = name
        self.device = next(params.parameters()).device
        B = cfg.max_batch

        pool = None
        self._max_pages = 0
        if cfg.kv_page > 0:
            self._max_pages = kvcache.pages_for(cfg.max_len, cfg.kv_page)
            n_pages = cfg.kv_pool_pages or B * self._max_pages
            pool = PagePool(n_pages, cfg.kv_page)
            self.cache = self._paged_cache(n_pages)
        else:
            self.cache = model.init_cache(B, cfg.max_len, device=self.device)
        self.sched = Scheduler(
            SchedulerConfig(max_queue=cfg.max_queue,
                            max_active_tokens=cfg.max_active_tokens),
            B, self._max_pages, pool)

        self._slots: List[Optional[Request]] = [None] * B
        self._prompt: List[Optional[np.ndarray]] = [None] * B  # replay prompt
        self._fed = np.zeros(B, np.int64)  # prompt tokens consumed
        self._remaining = np.zeros(B, np.int64)
        self._next_tok = np.zeros(B, np.int64)  # steady-state feed token
        self._seq = np.zeros(B, np.int64)  # admission order (for preemption)
        self._admit_counter = 0
        self._tick = 0
        self.preemptions = 0
        self._finished: Dict[int, List[int]] = {}

    # ------------------------------------------------------------ caches
    def _paged_cache(self, n_pages: int):
        cfg, mcfg = self.cfg, self.model.cfg
        n_kv, hd = mcfg.n_kv_heads, mcfg.hd
        self._table = kvcache.PageTable(cfg.max_batch, self._max_pages,
                                        self.device)
        out = [kvcache.init_paged(cfg.kv_mode, cfg.max_batch, cfg.max_len,
                                  n_pages, cfg.kv_page, n_kv, hd, mcfg.dtype,
                                  kvcache.layer_key(i), device=self.device,
                                  table=self._table)
               for i in range(mcfg.n_layers)]
        # dual byte accounting for telemetry: encoded capacity per sealed
        # page against its dense fp32 counterfactual, summed over layers
        self._page_bytes = mcfg.n_layers * kvcache.page_stored_nbytes(
            cfg.kv_mode, cfg.kv_page, n_kv, hd)
        self._page_dense = mcfg.n_layers * kvcache.page_dense_nbytes(
            cfg.kv_page, n_kv, hd)
        return out

    def _reset_slot(self, i: int) -> None:
        """Zero slot ``i``'s dense buffers (the reference's copy of the
        fresh template row): the last request's rows are masked, but a
        masked row still meets a zero probability in the value product, and
        0 x inf is NaN. Paged caches skip: replayed positions overwrite, and
        their pages decode from finite encodings."""
        for kv in self.cache:
            if not _is_paged(kv):
                for a in kv:
                    a[i] = 0

    def _push_table(self) -> None:
        if self.cfg.kv_page <= 0:
            return
        self._table.set(self.sched.table())

    def _kv_bytes(self) -> tuple:
        """(capacity bytes, dense fp32 counterfactual) of live KV state."""
        if self.cfg.kv_page > 0:
            used = self.sched.pool.used_pages
            return used * self._page_bytes, used * self._page_dense
        n = sum(a.numel() * a.element_size() for kv in self.cache for a in kv)
        return n, n

    # ------------------------------------------------------------ request API
    def submit(self, req: Request) -> bool:
        """Enqueue a request; False when the queue bound rejects it."""
        req.out_tokens = []
        worst = len(req.prompt) + req.max_new_tokens
        return self.sched.submit(req, tokens_worst_case=worst)

    def _tokens_of(self, req: Request) -> int:
        return len(req.prompt) + req.max_new_tokens

    def _active_tokens(self) -> int:
        return sum(self._tokens_of(r) for r in self._slots if r is not None)

    def _admit(self) -> None:
        for i in range(self.cfg.max_batch):
            if self._slots[i] is not None:
                continue
            req = self.sched.next_request(self._active_tokens(),
                                          self._tokens_of)
            if req is None:
                return
            if req.max_new_tokens - len(req.out_tokens) <= 0:
                # nothing to generate: complete without occupying a slot
                self._finish_tokens(req)
                continue
            self._slots[i] = req
            # replay = original prompt + whatever a preempted run already
            # generated; greedy decode reproduces the rest deterministically
            self._prompt[i] = np.concatenate(
                [np.asarray(req.prompt, np.int64),
                 np.asarray(req.out_tokens, np.int64)])
            self._fed[i] = 0
            self._remaining[i] = req.max_new_tokens - len(req.out_tokens)
            self._seq[i] = self._admit_counter
            self._admit_counter += 1
            self._reset_slot(i)

    def _finish_tokens(self, req: Request) -> None:
        self._finished[req.uid] = req.out_tokens
        log.info("request %d finished (%d tokens)", req.uid,
                 len(req.out_tokens))

    def _finish_slot(self, i: int) -> None:
        self._finish_tokens(self._slots[i])
        self._slots[i] = None
        self._prompt[i] = None
        self.sched.release(i)

    def _preempt(self, i: int) -> None:
        req = self._slots[i]
        self.preemptions += 1
        log.info("preempting request %d (slot %d, %d generated)", req.uid, i,
                 len(req.out_tokens))
        self._slots[i] = None
        self._prompt[i] = None
        self.sched.release(i)
        self.sched.requeue_front(req)

    # ------------------------------------------------------------ stepping
    def _run_chunk(self, tok_block: np.ndarray, n_feed: np.ndarray,
                   pos0: np.ndarray) -> np.ndarray:
        """``C = tok_block.shape[1]`` decode micro-steps; returns each
        slot's argmax token after its last fed position (host)."""
        C = tok_block.shape[1]
        i = np.arange(C)[:, None]
        t_all = np.where(i < n_feed, pos0 + i, -1)  # (C, B) positions
        toks = _to_device(tok_block, self.device)
        t_dev = _to_device(t_all, self.device)
        nxt = []
        for j in range(C):
            t = t_dev[j]
            logits, cache = self.model.decode_step(
                self.params, self.cache, toks[:, j:j + 1], t,
                t_host=t_all[j])
            self.cache = _select_cache(t, cache, self.cache)
            nxt.append(torch.argmax(logits[:, 0], dim=-1))
        idx = _to_device(np.clip(n_feed - 1, 0, C - 1), self.device)
        rows = torch.arange(len(n_feed), device=self.device)
        return torch.stack(nxt)[idx, rows].cpu().numpy()

    def _plan(self):
        """Per-slot feed plan for this tick; allocates pages, preempting
        the youngest slot when the pool runs dry."""
        B, C = self.cfg.max_batch, self.cfg.chunk
        plan = {}  # slot -> (tokens, n_feed, pos0)
        order = sorted((s for s in range(B) if self._slots[s] is not None),
                       key=lambda s: self._seq[s])
        for s in order:
            if self._slots[s] is None:  # preempted by an earlier iteration
                continue
            prompt, fed = self._prompt[s], int(self._fed[s])
            if fed < len(prompt):
                n = min(C, len(prompt) - fed)
                toks = prompt[fed:fed + n]
            else:
                n = 1
                toks = np.asarray([self._next_tok[s]], np.int64)
            while not self.sched.ensure(s, fed + n):
                victims = [v for v in range(B) if self._slots[v] is not None]
                victim = max(victims, key=lambda v: self._seq[v])
                self._preempt(victim)
                plan.pop(victim, None)
                if victim == s:
                    break
            if self._slots[s] is None:
                continue
            plan[s] = (toks, n, fed)
        return plan

    def step(self) -> None:
        """One engine tick: admit, plan pages, run the fused chunk."""
        with span("serve/admit"):
            self._admit()
            plan = self._plan()
            self._push_table()
        B = self.cfg.max_batch
        C = self.cfg.chunk if any(n > 1 for _, n, _ in plan.values()) else 1
        tok_block = np.zeros((B, C), np.int64)
        n_feed = np.zeros(B, np.int64)
        pos0 = np.zeros(B, np.int64)
        for s, (toks, n, p0) in plan.items():
            tok_block[s, :n] = toks
            n_feed[s] = n
            pos0[s] = p0

        active = sum(s is not None for s in self._slots)
        gen = 0
        if plan:
            with span("serve/decode"):
                nxt = self._run_chunk(tok_block, n_feed, pos0)
            for s in list(plan):
                if self._slots[s] is None:
                    continue
                _, n, _ = plan[s]
                self._fed[s] += n
                if self._fed[s] < len(self._prompt[s]):
                    continue  # still prefilling; no sample point yet
                tok = int(nxt[s])
                req = self._slots[s]
                req.out_tokens.append(tok)
                gen += 1
                self._remaining[s] -= 1
                self._next_tok[s] = tok
                if self._remaining[s] <= 0 or tok == self.cfg.eos_id:
                    self._finish_slot(s)

        kv_bytes, kv_dense = self._kv_bytes()
        get_bus().record("serve", self.name, np.array(
            [self._tick, active, self.sched.queue_depth,
             int(n_feed.sum()), gen, float(kv_bytes), float(kv_dense)],
            np.float32))
        self._tick += 1

    def run(self, max_ticks: int = 64) -> Dict[int, List[int]]:
        """Tick until idle or ``max_ticks``; returns {uid: tokens} finished
        during this call (requests still queued or active stay pending)."""
        self._finished = {}
        for _ in range(max_ticks):
            self.step()
            if (all(s is None for s in self._slots)
                    and self.sched.queue_depth == 0):
                break
        return self._finished


def greedy_generate(model: Model, params, prompt, n_new: int,
                    max_len: int = 256) -> List[int]:
    """Single-sequence reference path: ``Model.prefill`` + greedy decode.
    The engine's fp32-page output is gated token for token against this in
    ``repro_torch.train.serve_bench``."""
    if n_new <= 0:
        return []
    device = next(params.parameters()).device
    prompt = torch.as_tensor(np.asarray(prompt, np.int64), device=device)
    if prompt.dim() == 1:
        prompt = prompt[None]
    logits, cache, t = model.prefill(params, prompt, max_len)
    tok = torch.argmax(logits[:, -1:, :], dim=-1)
    out = [tok]
    for _ in range(n_new - 1):
        t = t + 1
        logits, cache = model.decode_step(params, cache, tok, t)
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
        out.append(tok)
    return [int(x) for x in torch.cat(out, 1)[0].cpu()]
