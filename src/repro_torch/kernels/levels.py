"""Levels compact and expand: the wrappers of ``csrc/levels.cu`` and their
plain versions.

Counterpart of ``repro.kernels.levels`` (``levels_compact_blocked`` /
``levels_expand_blocked`` and their oracles in ``levels/ref.py``). The wire
format stores the non-zero int8 levels of each 256-element chunk compacted
to the front in order; the chunk-local functions do that per chunk, with
the chunks as rows:

    compact(k)        k (C, 256) int8 -> (each row's non-zeros moved to the
                      front in order, zero-filled (C, 256) int8,
                      per-row count (C,) int32)
    expand(lv, mask)  lv (C, 256) row-local compacted levels, mask (C, 256)
                      occupancy -> (C, 256) int8: row c's levels scattered
                      back to its mask's positions, 0 elsewhere

The wire functions are the whole encode and decode of the levels, what the
reference computes with its kernel and the XLA ops around it
(``repro.quant.wire._compact_pallas`` / ``_expand_pallas``):

    compact_wire(k)              k (C, 256) int8 -> (levels (C*256,) int8:
                                 every non-zero in flat order, then zeros;
                                 bitmap (C, 32) uint8, LSB first; nnz, 0-d
                                 int32)
    expand_wire(levels, bitmap)  the inverse -> (C, 256) int8

Each is one kernel launch on the card (the chunk offsets come from a
decoupled look-back inside the kernel); their plain versions are the
chunk-local functions composed with a cumsum over the per-chunk counts and
one scatter or gather.

The reference keeps its chunks as columns, (256, C), for the TPU's sublane
rolls; the port takes them as rows, the order the flat tensor has in memory.
All integer work: the kernels are bit-exact against the plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.quant import wire

CHUNK = 256  # the one supported chunk length (the wire's DEFAULT_CHUNK)
WIRE_CHUNKS_PER_BLOCK = 32  # kWireChunks in csrc/levels.cu


def _check(name: str, *tensors: torch.Tensor) -> int:
    shape = tensors[0].shape
    for t in tensors:
        if t.dim() != 2 or t.shape[1] != CHUNK or t.shape != shape:
            raise ValueError(f"{name}: operands must be one (C, {CHUNK}) "
                             f"shape, got {[tuple(x.shape) for x in tensors]}")
    return shape[0]


def _prefix(occ: torch.Tensor) -> torch.Tensor:
    """P[c, j] = number of occupied positions < j in row c (int64)."""
    return torch.cumsum(occ.to(torch.int64), 1) - occ.to(torch.int64)


def levels_compact_plain(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compact kernel's function in plain torch ops, on any device."""
    C = _check("levels_compact", k)
    occ = k != 0
    tgt = torch.where(occ, _prefix(occ), CHUNK)  # zeros -> a dropped column
    out = torch.zeros((C, CHUNK + 1), dtype=torch.int8, device=k.device)
    out.scatter_(1, tgt, k.to(torch.int8))
    return out[:, :CHUNK].contiguous(), occ.sum(1, dtype=torch.int32)


def levels_expand_plain(lv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The expand kernel's function in plain torch ops, on any device."""
    _check("levels_expand", lv, mask)
    occ = mask != 0
    got = torch.gather(lv.to(torch.int8), 1, _prefix(occ).clamp(max=CHUNK - 1))
    return torch.where(occ, got, torch.zeros_like(got))


def _chunk_starts(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix of the per-chunk counts (int32)."""
    return torch.cumsum(counts, 0, dtype=torch.int32) - counts


def levels_compact_wire_plain(k: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The wire compact kernel's function in plain torch ops, on any
    device: the chunk-local compact, the chunks' starts, one scatter into
    the flat levels, and the bitmap."""
    C = _check("levels_compact_wire", k)
    n = C * CHUNK
    local, counts = levels_compact_plain(k)
    i = torch.arange(CHUNK, dtype=torch.int32, device=k.device)
    live = i[None, :] < counts[:, None]
    tgt = torch.where(live, _chunk_starts(counts)[:, None] + i[None, :], n)
    levels = torch.zeros(n + 1, dtype=torch.int8, device=k.device)
    # every dropped slot receives a 0 (compact zero-fills past the count)
    levels.scatter_(0, tgt.reshape(-1).to(torch.int64), local.reshape(-1))
    return levels[:n], wire.pack_bitmap(k), counts.sum(dtype=torch.int32)


def _check_wire(levels: torch.Tensor, bitmap: torch.Tensor) -> int:
    if (bitmap.dim() != 2 or bitmap.shape[1] != CHUNK // 8
            or levels.shape != (bitmap.shape[0] * CHUNK,)):
        raise ValueError(f"levels_expand_wire: want levels (C*{CHUNK},) and "
                         f"bitmap (C, {CHUNK // 8}), got {tuple(levels.shape)} "
                         f"and {tuple(bitmap.shape)}")
    return bitmap.shape[0]


def levels_expand_wire_plain(levels: torch.Tensor, bitmap: torch.Tensor
                             ) -> torch.Tensor:
    """The wire expand kernel's function in plain torch ops, on any device:
    the bitmap's mask, one gather of each chunk's levels over the chunks'
    starts, and the chunk-local expand."""
    _check_wire(levels, bitmap)
    n = levels.shape[0]
    mask = wire.unpack_bitmap(bitmap).to(torch.int8)
    counts = mask.sum(1, dtype=torch.int32)
    i = torch.arange(CHUNK, dtype=torch.int32, device=levels.device)
    idx = (_chunk_starts(counts)[:, None] + i[None, :]).clamp(max=n - 1)
    got = levels[idx.to(torch.int64)]
    local = torch.where(i[None, :] < counts[:, None], got, torch.zeros_like(got))
    return levels_expand_plain(local, mask)


def _kernel_operands(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: operands must be int8, got {t.dtype}")
    build.check_cuda_operands(name, *tensors)


def _workspace(name: str, C: int, device) -> torch.Tensor:
    """The wire kernels' look-back status words and ticket (cleared by the
    launch itself)."""
    if C * CHUNK >= 2**31:
        raise ValueError(f"{name}: {C} chunks: offsets must fit int32")
    blocks = -(-C // WIRE_CHUNKS_PER_BLOCK)
    return torch.empty(blocks + 1, dtype=torch.int64, device=device)


def levels_compact(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k: (C, 256) int8. Returns (compacted (C, 256) int8, counts (C,)
    int32). CPU tensors take the plain version; CUDA tensors launch the
    kernel, or raise."""
    C = _check("levels_compact", k)
    if k.device.type == "cpu":
        return levels_compact_plain(k)
    _kernel_operands("levels_compact", k)
    out = torch.empty_like(k)
    counts = torch.empty(C, dtype=torch.int32, device=k.device)
    if C:
        build.launch("levels_compact", "levels_compact_launch", build.ptr(k),
                     build.ptr(out), build.ptr(counts), C)
    return out, counts


def levels_expand(lv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """lv: (C, 256) int8 row-local compacted levels; mask: (C, 256) int8
    occupancy (non-zero = occupied). Returns (C, 256) int8. CPU tensors take
    the plain version; CUDA tensors launch the kernel, or raise."""
    C = _check("levels_expand", lv, mask)
    if lv.device.type == "cpu":
        return levels_expand_plain(lv, mask)
    _kernel_operands("levels_expand", lv, mask)
    out = torch.empty_like(lv)
    if C:
        build.launch("levels_expand", "levels_expand_launch", build.ptr(lv),
                     build.ptr(mask), build.ptr(out), C)
    return out


def levels_compact_wire(k: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k: (C, 256) int8. Returns (levels (C*256,) int8, bitmap (C, 32)
    uint8, nnz 0-d int32): the wire container's levels and bitmap. CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    launch, counted under ``levels_compact``), or raise."""
    C = _check("levels_compact_wire", k)
    if k.device.type == "cpu":
        return levels_compact_wire_plain(k)
    _kernel_operands("levels_compact_wire", k)
    ws = _workspace("levels_compact_wire", C, k.device)
    levels = torch.empty(C * CHUNK, dtype=torch.int8, device=k.device)
    bitmap = torch.empty((C, CHUNK // 8), dtype=torch.uint8, device=k.device)
    nnz = torch.empty((), dtype=torch.int32, device=k.device)
    if not C:
        return levels, bitmap, nnz.zero_()
    build.launch("levels_compact", "levels_compact_wire_launch", build.ptr(k),
                 build.ptr(levels), build.ptr(bitmap), build.ptr(nnz),
                 build.ptr(ws), ws.numel(), C)
    return levels, bitmap, nnz


def levels_expand_wire(levels: torch.Tensor, bitmap: torch.Tensor
                       ) -> torch.Tensor:
    """levels: (C*256,) int8, a chunk stream's non-zeros compacted in flat
    order; bitmap: (C, 32) uint8. Returns k (C, 256) int8. CPU tensors take
    the plain version; CUDA tensors launch the kernel (one launch, counted
    under ``levels_expand``), or raise."""
    C = _check_wire(levels, bitmap)
    if levels.device.type == "cpu":
        return levels_expand_wire_plain(levels, bitmap)
    _kernel_operands("levels_expand_wire", levels)
    if bitmap.dtype != torch.uint8:
        raise TypeError(f"levels_expand_wire: bitmap must be uint8, got "
                        f"{bitmap.dtype}")
    build.check_cuda_operands("levels_expand_wire", levels, bitmap, align=1)
    ws = _workspace("levels_expand_wire", C, levels.device)
    out = torch.empty((C, CHUNK), dtype=torch.int8, device=levels.device)
    if C:
        build.launch("levels_expand", "levels_expand_wire_launch",
                     build.ptr(levels), build.ptr(bitmap), build.ptr(out),
                     build.ptr(ws), ws.numel(), C)
    return out
