"""Occupancy-bitmap pack and unpack: the wrappers of ``csrc/pack.cu`` and
their plain versions.

Counterpart of ``repro.kernels.pack``:

* ``bitmap_pack_blocked``, fused with the tile reduction of
  ``repro.quant.wire`` that derives the backward matmul's tile mask from
  the packed bitmap: from int8 k (M, N) one pass gives the LSB-first bitmap
  (M, N/8), the per-tile nnz and the tile mask. The training step does not
  call it (the NSD kernel writes all three with k); it serves indices
  already at hand (``kernels.ops.quantized_from_indices``);
* ``bitmap_unpack`` (the reference's ``bitmap_unpack_blocked``): bitmap
  (M, N/8) -> int8 0/1 mask (M, N). Elementwise, so any M works (the
  reference's tile multiples come from its blocked grid). The NSD wire
  decode does not call it: the wire expand kernel reads the bitmap itself,
  as the reference's decode reads its jnp ``unpack_bitmap`` and not its
  unpack kernel.
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


def _check_unpack(bitmap):
    if bitmap.dim() != 2:
        raise ValueError(f"bitmap_unpack: bitmap must be 2-D, got "
                         f"{tuple(bitmap.shape)}")


def bitmap_unpack_plain(bitmap: torch.Tensor) -> torch.Tensor:
    """The unpack kernel's function in plain torch ops, on any device."""
    _check_unpack(bitmap)
    return wire.unpack_bitmap(bitmap).to(torch.int8)


def bitmap_unpack(bitmap: torch.Tensor) -> torch.Tensor:
    """bitmap: (M, N // 8) uint8 -> int8 0/1 occupancy mask (M, N).

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise.
    """
    _check_unpack(bitmap)
    if bitmap.device.type == "cpu":
        return bitmap_unpack_plain(bitmap)
    if bitmap.device.type != "cuda":
        raise ValueError(f"bitmap_unpack: no kernel for device {bitmap.device}")
    if bitmap.dtype != torch.uint8:
        raise TypeError(f"bitmap_unpack: bitmap must be uint8, got "
                        f"{bitmap.dtype}")
    if bitmap.numel() >= 2**31:
        raise ValueError("bitmap_unpack: more than 2^31 - 1 bitmap bytes")
    build.check_cuda_operands("bitmap_unpack", bitmap, align=1)
    M, NB = bitmap.shape
    mask = torch.empty((M, NB * 8), dtype=torch.int8, device=bitmap.device)
    build.check_cuda_operands("bitmap_unpack", mask, align=8)
    if bitmap.numel():
        build.launch("bitmap_unpack", "bitmap_unpack_launch", build.ptr(bitmap),
                     build.ptr(mask), bitmap.numel())
    return mask
