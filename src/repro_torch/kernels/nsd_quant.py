"""Fused NSD quantizer: the wrappers of ``csrc/nsd_quant.cu`` and their plain
versions.

Counterpart of ``repro.kernels.nsd_quant`` (the Pallas kernel and its jnp
oracle), fused with the occupancy pack of ``repro.kernels.pack`` and the
tile reduction of ``repro.quant.wire``. One launch of :func:`nsd_quantize`
reads x as it stands, unpadded, and writes, over the 128-padded shape,

    k      = clip(floor((x + nu) / max(delta, tiny) + 1/2), -127, 127)  int8
             (all zeros when delta <= 0; zeros in the padding)
    bitmap   LSB-first occupancy of k                     (Tp, Np/8) uint8
    nnz      non-zero count of each 128 x 128 tile        int32
    mask     nnz > 0                                      int32

with nu = u * delta (f32), the unit draw u either fed as nu (``noise=``,
the tests' route) or drawn inside the kernel from a 64-bit stream key
(``key=``, the training route).

The draw (Philox4x32-10, the generator of Random123 and cuRAND). The kernel
sees x as a 2-D view (rows, cols) over its flat order (``cols`` defaults to
the last dimension). Element (r, c) takes word c % 4 of

    philox4x32_10(counter = (c // 4, r, 0, 0), key = (seed & 0xffffffff,
                                                       seed >> 32))

as u = (word >> 8) * 2^-24 - 1/2, exact in f32 and in [-1/2, 1/2).
:func:`philox_uniform` writes that draw alone (one launch of the same
file's draw-only kernel), so a unit draw taken outside the NSD launch is
the one the launch takes inside.

``delta`` (a global std reduction) is formed outside, so the kernel is a
pure function of its inputs. :func:`nsd_quantize_blocked` keeps the
reference's padded, fed-noise signature (k and nnz) on the same kernel, for
tiles that are multiples of 128 on either device; only the tests call it.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, pack

_TINY = torch.finfo(torch.float32).tiny
TILE = 128  # the kernel's tile: k is padded to it, nnz and mask count it
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


class NsdQuant(NamedTuple):
    """The fused NSD launch's outputs over the 128-padded (Tp, Np)."""

    k: torch.Tensor  # (Tp, Np) int8
    bitmap: Optional[torch.Tensor]  # (Tp, Np / 8) uint8, None if not asked
    nnz: torch.Tensor  # (Tp / 128, Np / 128) int32
    mask: torch.Tensor  # (Tp / 128, Np / 128) int32, nnz > 0


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------

def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for a constant a and an int64 tensor b
    of 32-bit values. b goes through 16-bit limbs, so no int64 product
    exceeds 2^48."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    mid = p1 + (p0 >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox4x32_10_plain(counter, key: Tuple[int, int]):
    """Philox4x32-10 in torch int64 arithmetic: four int64 tensors of 32-bit
    counter words (broadcastable) and two 32-bit key words -> the four
    output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _M32
                      for c in counter)
    k0, k1 = key[0] & _M32, key[1] & _M32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _view(shape, cols: Optional[int]) -> Tuple[Tuple[int, ...], int, int, int]:
    """(shape, numel, rows, cols) of the 2-D view over a tensor's flat
    order: ``cols`` columns (default: the last dimension), the last row
    possibly partial."""
    shape = tuple(int(d) for d in shape)
    numel = math.prod(shape)
    cols = cols or (shape[-1] if shape else 1)
    if cols <= 0:
        raise ValueError(f"nsd_quant: no 2-D view with {cols} columns")
    return shape, numel, -(-numel // cols), cols


def philox_uniform_plain(key: int, shape, *, cols: Optional[int] = None,
                         device=None) -> torch.Tensor:
    """u ~ U(-1/2, 1/2) f32 of ``shape`` from stream key ``key``, element
    (r, c) of the (rows, cols) view taking word c % 4 of counter
    (c // 4, r, 0, 0); plain torch ops."""
    shape, numel, rows, cols = _view(shape, cols)
    groups = -(-cols // 4)
    c0 = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    c1 = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10_plain((c0, c1, zero, zero),
                                (key & _M32, (key >> 32) & _M32))
    w = torch.stack(torch.broadcast_tensors(*words), -1).reshape(rows, groups * 4)
    u = (w[:, :cols] >> 8).to(torch.float32) * 2.0 ** -24 - 0.5
    return u.reshape(-1)[:numel].reshape(shape)


def philox_uniform(key: int, shape, *, device,
                   cols: Optional[int] = None) -> torch.Tensor:
    """The draw of :func:`philox_uniform_plain` on ``device`` (required: no
    tensor names the route). On the CPU the plain version; on a CUDA device
    one launch of the draw-only kernel."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_uniform_plain(key, shape, cols=cols, device=device)
    if device.type != "cuda":
        raise ValueError(f"philox_uniform: no kernel for device {device}")
    shape, numel, rows, cols = _view(shape, cols)
    u = torch.empty(rows * cols, dtype=torch.float32, device=device)
    if numel:
        build.launch("philox_uniform", "philox_uniform_launch",
                     ctypes.c_uint64(key & (2**64 - 1)), build.ptr(u), rows,
                     cols)
    return u[:numel].reshape(shape)


# ---------------------------------------------------------------------------
# the fused quantizer
# ---------------------------------------------------------------------------

def _padded(n: int) -> int:
    return -(-n // TILE) * TILE


def _check_route(x, noise, key):
    if (noise is None) == (key is None):
        raise ValueError("nsd_quant: pass exactly one of noise= and key=")
    if noise is not None and noise.shape != x.shape:
        raise ValueError(f"nsd_quant: noise {tuple(noise.shape)} is not the "
                         f"shape of x {tuple(x.shape)}")


def _nsd_levels(x, nu, delta):
    d = delta.to(torch.float32).reshape(())
    safe = torch.clamp(d, min=_TINY)
    k = torch.floor((x.to(torch.float32) + nu.to(torch.float32)) / safe + 0.5)
    k = torch.clamp(k, -127.0, 127.0)
    return torch.where(d > 0.0, k, torch.zeros_like(k)).to(torch.int8)


def nsd_quantize_plain(x: torch.Tensor, delta: torch.Tensor, *,
                       noise: Optional[torch.Tensor] = None,
                       key: Optional[int] = None, cols: Optional[int] = None,
                       bitmap: bool = True) -> NsdQuant:
    """The fused kernel's function in plain torch ops, on any device."""
    _check_route(x, noise, key)
    _, n, rows, cols = _view(x.shape, cols)
    if key is not None:
        nu = philox_uniform_plain(key, (rows, cols), device=x.device) * \
            delta.to(torch.float32).reshape(())
    else:
        nu = F.pad(noise.reshape(-1), (0, rows * cols - n)).reshape(rows, cols)
    xv = F.pad(x.reshape(-1), (0, rows * cols - n)).reshape(rows, cols)
    k = _nsd_levels(xv, nu, delta)
    live = torch.arange(rows * cols, device=x.device).reshape(rows, cols) < n
    k = torch.where(live, k, torch.zeros_like(k))
    k = F.pad(k, (0, _padded(cols) - cols, 0, _padded(rows) - rows))
    bm, nnz, mask = pack.bitmap_pack_blocked_plain(k, bm=TILE, bn=TILE)
    return NsdQuant(k=k, bitmap=bm if bitmap else None, nnz=nnz, mask=mask)


def nsd_quantize(x: torch.Tensor, delta: torch.Tensor, *,
                 noise: Optional[torch.Tensor] = None,
                 key: Optional[int] = None, cols: Optional[int] = None,
                 bitmap: bool = True) -> NsdQuant:
    """NSD-quantize x (any shape, viewed as (rows, cols) over its flat order;
    ``cols`` defaults to x's last dimension) with delta (a scalar f32) and
    either the dither ``noise`` nu (x's shape) or the stream ``key`` (an int
    below 2^64). ``bitmap=False`` skips the bitmap (None in the result).

    CPU tensors take the plain version; CUDA tensors launch the kernel once,
    or raise.
    """
    _check_route(x, noise, key)
    if x.device.type == "cpu":
        return nsd_quantize_plain(x, delta, noise=noise, key=key, cols=cols,
                                  bitmap=bitmap)
    if x.device.type != "cuda":
        raise ValueError(f"nsd_quant: no kernel for device {x.device}")
    if delta.numel() != 1:
        raise ValueError("nsd_quant: delta must be a scalar")
    operands = (x,) if noise is None else (x, noise)
    if any(t.dtype != torch.float32 for t in operands + (delta,)):
        raise TypeError("nsd_quant: x, noise and delta must be float32")
    _, n, rows, cols = _view(x.shape, cols)
    if n >= 2**31:
        raise ValueError("nsd_quant: more than 2^31 - 1 elements")
    build.check_cuda_operands("nsd_quant", *operands)
    build.check_cuda_operands("nsd_quant", x, delta, align=4)
    Tp, Np = _padded(rows), _padded(cols)
    dev = x.device
    k = torch.empty((Tp, Np), dtype=torch.int8, device=dev)
    bm = (torch.empty((Tp, Np // 8), dtype=torch.uint8, device=dev)
          if bitmap else None)
    nnz = torch.empty((Tp // TILE, Np // TILE), dtype=torch.int32, device=dev)
    mask = torch.empty_like(nnz)
    if rows:
        build.launch("nsd_quant", "nsd_quant_launch", build.ptr(x),
                     build.ptr(noise), ctypes.c_uint64((key or 0) & (2**64 - 1)),
                     build.ptr(delta), build.ptr(k), build.ptr(bm),
                     build.ptr(nnz), build.ptr(mask), rows, cols, n)
    return NsdQuant(k=k, bitmap=bm, nnz=nnz, mask=mask)


# ---------------------------------------------------------------------------
# the reference's padded signature
# ---------------------------------------------------------------------------

def _check(x, noise, delta, bm, bn):
    if x.dim() != 2 or x.shape != noise.shape:
        raise ValueError(f"nsd_quant: x {tuple(x.shape)} and noise "
                         f"{tuple(noise.shape)} must be one 2-D shape")
    M, N = x.shape
    if bm % TILE or bn % TILE or bm <= 0 or bn <= 0:
        raise ValueError(f"nsd_quant: the tile {(bm, bn)} is not a multiple "
                         f"of the kernel's {TILE} x {TILE}")
    if M % bm or N % bn:
        raise ValueError(f"nsd_quant: shape {(M, N)} is not a multiple of "
                         f"the tile {(bm, bn)}")
    if delta.numel() != 1:
        raise ValueError("nsd_quant: delta must be a scalar")
    return M, N


def nsd_quantize_blocked_plain(x: torch.Tensor, noise: torch.Tensor,
                               delta: torch.Tensor, *, bm: int = 128,
                               bn: int = 128):
    """The reference's blocked quantizer in plain torch ops, on any device."""
    M, N = _check(x, noise, delta, bm, bn)
    k = _nsd_levels(x, noise, delta)
    nnz = (k != 0).to(torch.int32).reshape(M // bm, bm, N // bn, bn).sum(
        (1, 3), dtype=torch.int32)
    return k, nnz


def nsd_quantize_blocked(x: torch.Tensor, noise: torch.Tensor,
                         delta: torch.Tensor, *, bm: int = 128, bn: int = 128):
    """x, noise: (M, N) f32 with M % bm == 0, N % bn == 0; delta: scalar f32;
    bm and bn multiples of 128 on either device.

    Returns (k int8 (M, N), nnz int32 (M // bm, N // bn)). CPU tensors take
    the plain version; CUDA tensors launch the fused kernel (without its
    bitmap) and sum its 128 x 128 tile counts into (bm, bn) tiles, or raise.
    """
    M, N = _check(x, noise, delta, bm, bn)
    if x.device.type == "cpu":
        return nsd_quantize_blocked_plain(x, noise, delta, bm=bm, bn=bn)
    if x.device.type != "cuda":
        raise ValueError(f"nsd_quant: no kernel for device {x.device}")
    q = nsd_quantize(x, delta, noise=noise, bitmap=False)
    if (bm, bn) == (TILE, TILE):
        return q.k, q.nnz
    nnz = q.nnz.reshape(M // bm, bm // TILE, N // bn, bn // TILE).sum(
        (1, 3), dtype=torch.int32)
    return q.k, nnz
