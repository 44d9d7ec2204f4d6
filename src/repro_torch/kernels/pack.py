"""Occupancy-bitmap pack: the wrapper of ``csrc/pack.cu`` and its plain
version.

Counterpart of ``repro.kernels.pack`` (``bitmap_pack_blocked``) fused with
the tile reduction of ``repro.quant.wire`` that derives the backward
matmul's tile mask from the packed bitmap: from int8 k (M, N) one pass
gives the LSB-first bitmap (M, N/8), the per-tile nnz and the tile mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.quant import wire


def _check(k, bm, bn):
    if k.dim() != 2:
        raise ValueError(f"bitmap_pack: k must be 2-D, got {tuple(k.shape)}")
    M, N = k.shape
    if M % bm or N % bn or bn % 8:
        raise ValueError(f"bitmap_pack: shape {(M, N)} is not a multiple of "
                         f"the tile {(bm, bn)} (bn a multiple of 8)")
    return M, N


def bitmap_pack_blocked_plain(k: torch.Tensor, *, bm: int = 128,
                              bn: int = 128):
    """The kernel's function in plain torch ops, on any device."""
    _check(k, bm, bn)
    bitmap = wire.pack_bitmap(k)
    return (bitmap, wire.tile_nnz_from_bitmap(bitmap, bm, bn),
            wire.tile_mask_from_bitmap(bitmap, bm, bn))


def bitmap_pack_blocked(k: torch.Tensor, *, bm: int = 128, bn: int = 128):
    """k: (M, N) int8 with M % bm == 0, N % bn == 0.

    Returns (bitmap uint8 (M, N // 8), nnz int32 (M // bm, N // bn),
    mask int32 (M // bm, N // bn)). CPU tensors take the plain version; CUDA
    tensors launch the kernel (which needs bn % 32 == 0), or raise.
    """
    M, N = _check(k, bm, bn)
    if k.device.type == "cpu":
        return bitmap_pack_blocked_plain(k, bm=bm, bn=bn)
    if k.device.type != "cuda":
        raise ValueError(f"bitmap_pack: no kernel for device {k.device}")
    if k.dtype != torch.int8:
        raise TypeError(f"bitmap_pack: k must be int8, got {k.dtype}")
    if bn % 32:
        raise ValueError(f"bitmap_pack: tile width {bn} is not a multiple "
                         f"of 32 (one ballot word)")
    build.check_cuda_operands("bitmap_pack", k)
    dev = k.device
    bitmap = torch.empty((M, N // 8), dtype=torch.uint8, device=dev)
    nnz = torch.empty((M // bm, N // bn), dtype=torch.int32, device=dev)
    mask = torch.empty_like(nnz)
    build.launch("bitmap_pack", "bitmap_pack_launch", build.ptr(k),
                 build.ptr(bitmap), build.ptr(nnz), build.ptr(mask), M, N,
                 bm, bn)
    return bitmap, nnz, mask
