"""The dithered backward of one layer, chained through the three kernels.

Counterpart of ``repro.kernels.ops``. For y = x @ w with cotangent g:

    fused NSD kernel  ->  int8 k + per-tile nnz          (one pass over g)
    pack kernel       ->  uint8 occupancy bitmap + the tile mask, derived
                          from the bitmap's ballot words
    bsp kernel x2     ->  dx = (k . w_q^T) * delta * s_w      (mask)
                          dW = (k^T . x_q)^T * delta * s_x    (mask, A read
                                                               transposed)

Operands are zero-padded to 128-multiples; padded elements quantize to
k == 0, so padding tiles read 0 in the mask and are skipped. Each wrapper
takes its plain version for CPU tensors and launches its kernel for CUDA
tensors. ``LAUNCHES`` counts the kernel launches per wrapper;
``KERNEL_FALLBACKS`` counts structural fallbacks (a grouped convolution),
which are never silent.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import nsd
from repro_torch.core.int8 import absmax_int8
from repro_torch.kernels import bsp_matmul, nsd_quant, pack
from repro_torch.kernels.build import LAUNCHES, reset_launches  # noqa: F401

BLOCK = 128  # the tile of the nnz map, the bitmap's tile mask and the matmul

KERNEL_FALLBACKS: dict = {}


def note_fallback(reason: str, name: str) -> None:
    KERNEL_FALLBACKS[reason] = KERNEL_FALLBACKS.get(reason, 0) + 1


def _pad_to(x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    pm, pn = (-x.shape[0]) % m, (-x.shape[1]) % n
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    return x.contiguous()


class QuantizedGrad(NamedTuple):
    """A pre-activation gradient after the fused NSD pass, tile-mask ready.

    ``k`` is zero-padded to ``BLOCK`` multiples; ``nnz`` is the NSD kernel's
    per-tile count; ``bitmap`` the packed occupancy; ``mask`` the tile mask
    the matmuls consume, derived from ``bitmap``; ``shape`` the unpadded
    (T, N).
    """

    k: torch.Tensor  # (Tp, Np) int8
    delta: torch.Tensor  # 0-d f32
    nnz: torch.Tensor  # (Tp/BLOCK, Np/BLOCK) int32, from the NSD kernel
    bitmap: torch.Tensor  # (Tp, Np/8) uint8
    mask: torch.Tensor  # (Tp/BLOCK, Np/BLOCK) int32, from the bitmap
    shape: Tuple[int, int]


def quantize_and_mask(g: torch.Tensor, u: torch.Tensor, s: float
                      ) -> QuantizedGrad:
    """NSD-quantize g (T, N) with unit noise u (T, N), then pack its bitmap
    and tile mask: one NSD kernel and one pack kernel."""
    T, N = g.shape
    delta = nsd.compute_delta(g, s)
    noise = nsd.dither_noise(u, delta)
    k, nnz = nsd_quant.nsd_quantize_blocked(
        _pad_to(g.to(torch.float32), BLOCK, BLOCK), _pad_to(noise, BLOCK, BLOCK),
        delta, bm=BLOCK, bn=BLOCK)
    bitmap, _, mask = pack.bitmap_pack_blocked(k, bm=BLOCK, bn=BLOCK)
    return QuantizedGrad(k=k, delta=delta, nnz=nnz, bitmap=bitmap, mask=mask,
                         shape=(T, N))


def quantized_from_indices(k: torch.Tensor, delta: torch.Tensor
                           ) -> QuantizedGrad:
    """A :class:`QuantizedGrad` from NSD indices already at hand: pads,
    packs, and takes nnz and the mask from the bitmap alone."""
    T, N = k.shape
    kp = _pad_to(k.to(torch.int8), BLOCK, BLOCK)
    bitmap, nnz, mask = pack.bitmap_pack_blocked(kp, bm=BLOCK, bn=BLOCK)
    return QuantizedGrad(k=kp, delta=delta, nnz=nnz, bitmap=bitmap, mask=mask,
                         shape=(T, N))


def bsp_backward_from_quantized(q: QuantizedGrad, x: torch.Tensor,
                                w: torch.Tensor, *, need_dx: bool = True
                                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Both backward products of y = x @ w from a quantized cotangent.

    x: (T, K); w: (K, N). Returns (dx (T, K) or None when ``need_dx`` is
    False, dw (K, N)), with x and w absmax-quantized to int8.
    """
    T, N = q.shape
    K = x.shape[-1]
    xq = absmax_int8(x.reshape(-1, K))
    dx = None
    if need_dx:
        wq = absmax_int8(w)
        # dx = k . w_q^T: w_q (K, N) is op(B)^T as stored
        dx = bsp_matmul.bsp_matmul_int8(
            q.k, _pad_to(wq.q, BLOCK, BLOCK), q.delta * wq.scale, q.mask,
            trans_b=True)[:T, :K].to(x.dtype)
    # dW^T = k^T . x_q: k read transposed in place, its mask as stored
    dw_t = bsp_matmul.bsp_matmul_int8(
        q.k, _pad_to(xq.q, BLOCK, BLOCK), q.delta * xq.scale, q.mask,
        trans_a=True)
    return dx, dw_t[:N, :K].t().to(w.dtype)


def dithered_backward_matmuls(g: torch.Tensor, x: torch.Tensor,
                              w: torch.Tensor, u: torch.Tensor, s: float):
    """The kernel-path backward of y = x @ w for cotangent g (T, N), inputs
    x (T, K), w (K, N) and unit noise u (T, N): (dx, dW)."""
    return bsp_backward_from_quantized(quantize_and_mask(g, u, s), x, w)
