"""Wire containers between processes: the hops of the compressed reduces
over a :class:`repro_torch.launch.mesh.NodeMesh`.

The reference's shard_map programs move a ``PackedNSD`` pytree between
devices with ``jax.lax.ppermute``. Here each rank is a process, and a pack
crosses as two point-to-point messages of one ``dist.batch_isend_irecv``
round each:

  fixed part   the bitmap (chunk/8 bytes a chunk), the deltas (4 bytes a
               chunk) and the header (4 bytes: ``nnz``), in that order in
               the buffer, so the bitmap that the wire expand kernel reads
               starts aligned;
  levels       the live prefix of ``levels``: ``nnz`` bytes (no message
               when ``nnz`` is 0).

So the bytes that cross are ``PackedNSD.wire_bytes()``. The receiver knows
the container's chunk count from the segment's shape, reads ``nnz`` off
the header once the first round is in and posts the second. The sender
needs one host read of ``nnz`` (and ``deltas[0]``) a hop: the levels
message's length.

With gloo and CUDA tensors every message is staged through a pinned host
buffer (one stream sync a round on the sending side); NCCL takes the device
buffers as they are; gloo on the CPU takes the tensors themselves. A
failed send or receive raises out of the reduce: nothing here retries or
falls back.

Every pack that leaves or reaches this rank is logged with its host (wire
bytes, Delta) under its pack id (the ``(salt, *indices)`` of its noise),
within the exchange's current :attr:`Exchange.scope` (a reducer sets it to
the leaf's name, so one exchange serves every leaf of a reduce):
:meth:`Exchange.records` gathers those of every rank, once a reduce, from
which each share replays the simulation's accounting
(``reduce_base.Ledger``). :data:`TRAFFIC` counts what this process
received.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.quant import wire
from repro_torch.quant.registry import dtype_name

Pid = Tuple[int, ...]

__all__ = ["Exchange", "TRAFFIC", "Traffic", "fixed_nbytes"]


@dataclasses.dataclass
class Traffic:
    """Bytes this process received since the last :meth:`reset`: packs (by
    id, with their wire bytes) and dense tensors (gathered leaves)."""

    packs: List[Tuple[Pid, int]] = dataclasses.field(default_factory=list)
    dense_bytes: int = 0

    @property
    def pack_bytes(self) -> int:
        return sum(b for _, b in self.packs)

    def reset(self) -> None:
        self.packs.clear()
        self.dense_bytes = 0


TRAFFIC = Traffic()


def fixed_nbytes(n_chunks: int) -> int:
    """Bytes of a container's fixed part: header, deltas and bitmap."""
    return wire.HEADER_BYTES + n_chunks * (4 + wire.DEFAULT_CHUNK // 8)


def _n_chunks(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return -(-n // wire.DEFAULT_CHUNK)


def _fixed_part(p: wire.PackedNSD) -> torch.Tensor:
    return torch.cat([p.bitmap.reshape(-1), p.deltas.view(torch.uint8),
                      p.nnz.reshape(1).to(torch.int32).view(torch.uint8)])


def _head_slices(buf: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """The 8 bytes of a fixed part that the host reads: Delta, nnz."""
    d0 = n_chunks * (wire.DEFAULT_CHUNK // 8)
    return torch.cat([buf[d0:d0 + 4], buf[-4:]])


def _parse_head(raw: torch.Tensor) -> Tuple[int, float]:
    """(nnz, Delta) from the 8 host bytes of :func:`_head_slices`."""
    delta, nnz = struct.unpack("<fi", raw.numpy().tobytes())
    return nnz, delta


class Exchange:
    """The hops of one reduce on one rank, on ``device``: of one leaf, or
    of every leaf of a reducer's reduce, each under its own ``scope``."""

    def __init__(self, mesh, device: torch.device):
        import torch.distributed as dist

        self.dist, self.mesh, self.device = dist, mesh, torch.device(device)
        self.stage = mesh.backend == "gloo" and self.device.type == "cuda"
        if mesh.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL mesh moves CUDA tensors; pass "
                             "device='cuda' or build the mesh on gloo")
        self.scope = ""
        self.seen: Dict[str, Dict[Pid, Tuple[int, float]]] = {}

    # -- the two rounds --------------------------------------------------
    def _host(self, t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.numel(), dtype=torch.uint8, pin_memory=True)
        h.copy_(t.view(torch.uint8), non_blocking=True)
        return h

    def _round(self, sends: Sequence[Tuple[int, torch.Tensor]],
               recvs: Sequence[Tuple[int, torch.Tensor]], parity: int) -> None:
        """Post every send and receive as one batch and wait for all. Tags
        number the messages between a pair in posting order."""
        dist, ops, seq = self.dist, [], {}
        for kind, items in ((dist.isend, sends), (dist.irecv, recvs)):
            for peer, buf in items:
                k = seq.get((kind, peer), 0)
                seq[(kind, peer)] = k + 1
                ops.append(dist.P2POp(kind, buf, peer, self.mesh.group,
                                      tag=2 * k + parity))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def swap(self, sends: Sequence[Tuple[int, Pid, wire.PackedNSD]],
             recvs: Sequence[Tuple[int, Pid, Tuple[int, ...]]],
             dtype=torch.float32) -> List[wire.PackedNSD]:
        """Send each ``(peer rank, pack id, pack)`` and receive each
        ``(peer rank, pack id, shape)``; returns the received packs, in
        ``recvs`` order. Peers list their messages to each other in the
        same order."""
        dev = self.device
        # round 1: the fixed parts
        out_fixed = [_fixed_part(p) for _, _, p in sends]
        in_chunks = [_n_chunks(shape) for _, _, shape in recvs]
        in_dev = [torch.empty(fixed_nbytes(c), dtype=torch.uint8, device=dev)
                  for c in in_chunks]
        if self.stage:
            out_msg = [self._host(b) for b in out_fixed]
            in_msg = [torch.empty(b.numel(), dtype=torch.uint8, pin_memory=True)
                      for b in in_dev]
            torch.cuda.current_stream(dev).synchronize()
        else:
            out_msg, in_msg = out_fixed, in_dev
        self._round([(peer, b) for (peer, _, _), b in zip(sends, out_msg)],
                    [(peer, b) for (peer, _, _), b in zip(recvs, in_msg)], 0)
        heads_out = self._headers(out_msg, [p.n_chunks for _, _, p in sends])
        heads_in = self._headers(in_msg, in_chunks)
        seen = self.seen.setdefault(self.scope, {})
        for (_, pid, p), (nnz, delta) in zip(sends, heads_out):
            seen[pid] = (fixed_nbytes(p.n_chunks) + nnz, delta)
        if self.stage:
            for d, h in zip(in_dev, in_msg):
                d.copy_(h, non_blocking=True)

        # round 2: the live prefixes of levels
        levels = [torch.zeros(c * wire.DEFAULT_CHUNK, dtype=torch.int8,
                              device=dev) for c in in_chunks]
        out_lv = [(peer, p.levels[:nnz]) for (peer, _, p), (nnz, _)
                  in zip(sends, heads_out) if nnz]
        in_lv = [(peer, lv[:nnz]) for (peer, _, _), lv, (nnz, _)
                 in zip(recvs, levels, heads_in) if nnz]
        if self.stage:
            out_lv = [(peer, self._host(b)) for peer, b in out_lv]
            in_host = [(peer, torch.empty(b.numel(), dtype=torch.uint8,
                                          pin_memory=True)) for peer, b in in_lv]
            torch.cuda.current_stream(dev).synchronize()
            self._round(out_lv, in_host, 1)
            for (_, d), (_, h) in zip(in_lv, in_host):
                d.view(torch.uint8).copy_(h, non_blocking=True)
        else:
            self._round(out_lv, in_lv, 1)

        got = []
        for (_, pid, shape), buf, lv, c, (nnz, delta) in zip(
                recvs, in_dev, levels, in_chunks, heads_in):
            nb = c * (wire.DEFAULT_CHUNK // 8)
            got.append(wire.PackedNSD(
                levels=lv, bitmap=buf[:nb].view(c, wire.DEFAULT_CHUNK // 8),
                deltas=buf[nb:nb + 4 * c].view(torch.float32),
                nnz=buf[nb + 4 * c:].view(torch.int32).reshape(()),
                shape=tuple(int(d) for d in shape), dtype=dtype_name(dtype)))
            nbytes = fixed_nbytes(c) + nnz
            seen[pid] = (nbytes, delta)
            TRAFFIC.packs.append((pid, nbytes))
        return got

    def _headers(self, bufs: Sequence[torch.Tensor],
                 n_chunks: Sequence[int]) -> List[Tuple[int, float]]:
        """(nnz, Delta) of each fixed part, with one host read for all of
        them when they are on the card."""
        if not bufs:
            return []
        host = torch.cat([_head_slices(b, c)
                          for b, c in zip(bufs, n_chunks)]).cpu()
        return [_parse_head(host[8 * i:8 * i + 8]) for i in range(len(bufs))]

    # -- dense tensors and the accounting records ---------------------------
    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in mesh order."""
        dist, n = self.dist, self.mesh.size
        src = t.detach().reshape(-1).contiguous()
        if self.stage:
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=self.mesh.group)
        TRAFFIC.dense_bytes += (n - 1) * src.numel() * src.element_size()
        return [o.to(t.device).reshape(t.shape) for o in out]

    def records(self) -> Dict[str, Dict[Pid, Tuple[int, float]]]:
        """scope -> pack id -> (wire bytes, Delta) of every pack that any
        rank of the mesh sent or received in this exchange: one gather of
        every rank's log, after the last hop."""
        every: List[Optional[Dict]] = [None] * self.mesh.size
        self.dist.all_gather_object(every, self.seen, group=self.mesh.group)
        table: Dict[str, Dict[Pid, Tuple[int, float]]] = {}
        for part in every:
            for scope, recs in part.items():
                table.setdefault(scope, {}).update(recs)
        return table
