"""Occupancy-bitmap helpers of the NSD wire format (plain torch).

Counterpart of the bitmap half of ``repro.quant.wire``: one occupancy bit
per element, LSB first (bit j of byte b is element 8b + j of the row), and
the per-tile counts and mask derived from the packed bytes. These are the
plain versions the CUDA pack kernel (``repro_torch.kernels.pack``) is held
against; the chunked ``PackedNSD`` wire container is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def pack_bitmap(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8m) bool/int occupancy -> (..., m) uint8, LSB first."""
    b = (bits != 0).to(torch.int32)
    b8 = b.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (b8 * w).sum(-1).to(torch.uint8)


def unpack_bitmap(bitmap: torch.Tensor) -> torch.Tensor:
    """(..., m) uint8 -> (..., 8m) bool, the inverse of :func:`pack_bitmap`."""
    shifts = torch.arange(8, dtype=torch.int32, device=bitmap.device)
    bits = (bitmap.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(bitmap.shape[:-1] + (bitmap.shape[-1] * 8,)) != 0


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-byte population count (SWAR, int32 math) of a uint8 tensor."""
    v = x.to(torch.int32)
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def _pad2d(x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    pm, pn = (-x.shape[0]) % m, (-x.shape[1]) % n
    return F.pad(x, (0, pn, 0, pm)) if pm or pn else x


def _tile_sums(per_byte: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    if bk % 8:
        raise ValueError(f"tile width {bk} is not a multiple of 8")
    bkb = bk // 8
    x = _pad2d(per_byte, bm, bkb)
    M, KB = x.shape
    return x.reshape(M // bm, bm, KB // bkb, bkb).sum((1, 3), dtype=torch.int32)


def tile_nnz_from_bitmap(bitmap: torch.Tensor, bm: int = 128, bk: int = 128
                         ) -> torch.Tensor:
    """Per-tile non-zero counts (int32) from a packed (M, K/8) bitmap, by a
    popcount reduction; ragged edges are zero-padded."""
    return _tile_sums(popcount_u8(bitmap), bm, bk)


def tile_mask_from_bitmap(bitmap: torch.Tensor, bm: int = 128, bk: int = 128
                          ) -> torch.Tensor:
    """(M/bm, K/bk) int32 tile-occupancy mask from a packed (M, K/8) bitmap:
    1 where any byte of the tile is non-zero; padded tiles read 0."""
    tiles = _tile_sums((bitmap != 0).to(torch.int32), bm, bk)
    return (tiles > 0).to(torch.int32)
