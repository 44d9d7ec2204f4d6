"""Chunk-local levels compact and expand: the wrappers of
``csrc/levels.cu`` and their plain versions.

Counterpart of ``repro.kernels.levels`` (``levels_compact_blocked`` /
``levels_expand_blocked`` and their oracles in ``levels/ref.py``). The wire
format stores the non-zero int8 levels of each 256-element chunk compacted
to the front in order; these functions do that per chunk, with the chunks
as rows:

    compact(k)        k (C, 256) int8 -> (each row's non-zeros moved to the
                      front in order, zero-filled (C, 256) int8,
                      per-row count (C,) int32)
    expand(lv, mask)  lv (C, 256) row-local compacted levels, mask (C, 256)
                      occupancy -> (C, 256) int8: row c's levels scattered
                      back to its mask's positions, 0 elsewhere

The reference keeps its chunks as columns, (256, C), for the TPU's sublane
rolls; the port takes them as rows, the order the flat tensor has in memory.
All integer work: the kernels are bit-exact against the plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

CHUNK = 256  # the one supported chunk length (the wire's DEFAULT_CHUNK)


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


def _kernel_operands(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: operands must be int8, got {t.dtype}")
    build.check_cuda_operands(name, *tensors)


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
