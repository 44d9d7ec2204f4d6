"""A prefetching input pipeline: a (step -> host batch) function becomes an
iterator of (step, device batch).

Counterpart of ``repro.data.pipeline``. A background thread keeps
``prefetch`` batches ready, so step N + 1's batch is built and copied while
step N computes. Without a mesh one process drives the one card, and its
slice of the global batch is the whole batch. With a
:class:`repro_torch.launch.mesh.NodeMesh` one process is one data-parallel
node, and rank r keeps rows ``[r * per, (r + 1) * per)`` of each leaf, per
= global batch / ranks (the reference's host slice, process r of the
process count); only those rows are copied to its device. ``batch_axes``,
the reference's mesh axes that the batch splits over, may be left out; if
given, it must name every axis of the node mesh, since a rank is one node.

On CUDA each host batch is pinned and copied with ``non_blocking=True`` on
a side stream, and an event marks the copy's end. :meth:`__next__` makes
the consumer's current stream wait on that event (no host sync) and calls
``record_stream`` on each tensor, so the caching allocator does not hand a
batch's memory to the side stream again while the consumer may still read
it. On the CPU the batch is handed over as the function made it.

The first batch is ``start_step``'s: a resumed run starts its loader at the
step it resumed from. An exception in ``batch_fn`` is raised by the ``next``
that would have returned its batch, and by every ``next`` after it.
:meth:`close` stops the thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.device import resolve_device

Batch = Dict[str, torch.Tensor]


class ShardedLoader:
    """Wraps a (step -> host batch) function into a prefetched iterator of
    ``(step, batch)`` on ``device`` (CUDA unless named)."""

    def __init__(self, batch_fn: Callable[[int], Batch], mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = None,
                 prefetch: int = 2, start_step: int = 0,
                 device: Optional[torch.device] = None):
        self.batch_fn = batch_fn
        # the reference shards the global array over ``batch_axes`` of its
        # device mesh; a process holds one node, so the batch splits over
        # every axis of the node mesh, and naming others is an error
        if batch_axes is not None and (
                mesh is None or set(batch_axes) != set(mesh.shape)):
            have = "no mesh" if mesh is None else f"mesh axes {tuple(mesh.shape)}"
            raise ValueError(
                f"batch_axes {tuple(batch_axes)} with {have}: a rank holds "
                "one node, so its rows split over every axis of its mesh")
        self.mesh = mesh
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._error: Optional[Exception] = None
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _host_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch."""
        n = self.mesh.size
        if global_batch % n:
            raise ValueError(f"batch {global_batch} does not split over "
                             f"{n} ranks")
        per = global_batch // n
        return slice(self.mesh.index * per, (self.mesh.index + 1) * per)

    def _to_device(self, batch: Batch
                   ) -> Tuple[Batch, Optional[torch.cuda.Event]]:
        if self.mesh is not None:
            rows = self._host_slice(next(iter(batch.values())).shape[0])
            batch = {k: v[rows] for k, v in batch.items()}
        if not self._cuda:
            return {k: v.to(self.device) for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _put(self, item) -> bool:
        """Queue ``item`` unless the loader closes first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, *self._to_device(self.batch_fn(step)))
            except Exception as e:  # handed to the consumer's next()
                self._put(e)
                return
            if not self._put(item):
                return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Tuple[int, Batch]:
        if self._error is not None:  # the worker has stopped
            raise self._error
        item = self._q.get()
        if isinstance(item, Exception):
            self._error = item
            raise item
        step, batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for v in batch.values():
                v.record_stream(consumer)
        return step, batch

    def close(self, timeout: float = 10.0) -> None:
        """Stop the thread and drop the batches it made."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)
