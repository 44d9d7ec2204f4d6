"""The dithered backward of one layer, chained through the kernels.

Counterpart of ``repro.kernels.ops``. For y = x @ w with cotangent g:

    fused NSD kernel  ->  int8 k, the uint8 occupancy bitmap, per-tile nnz
                          and the tile mask, in one pass over g as it
                          stands (the dither drawn inside from the layer's
                          Philox stream key, or fed)
    bsp kernel x2     ->  dx = (k . w_q^T) * delta * s_w      (mask)
                          dW = (k^T . x_q)^T * delta * s_x    (mask, A read
                                                               transposed)

with x and w absmax-quantized to int8 (``int8_operands=True``, the default
and the training path), or, with ``int8_operands=False``, both products on
the dequant kernel against the f32 operands (the reference's
``bsp_matmul`` branch; no trainer selects it):

    dequant kernel x2 ->  dx = (k . w^T) * delta          (mask)
                          dW = (k^T . x)^T * delta        (mask, A read
                                                           transposed)

k is written over the 128-padded shape, zeros in the padding, so padding
tiles read 0 in the mask and are skipped; the matmuls' other operands are
zero-padded to 128-multiples. The reference's pack kernel runs only for
indices already at hand (:func:`quantized_from_indices`). Each wrapper
takes its plain version for CPU tensors and launches its kernel for CUDA
tensors. ``LAUNCHES`` counts the kernel launches per wrapper;
``KERNEL_FALLBACKS`` counts structural fallbacks (a grouped convolution),
which are never silent.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

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

    ``k`` is zero-padded to ``BLOCK`` multiples; ``nnz`` the per-tile count;
    ``bitmap`` the packed occupancy; ``mask`` the tile mask the matmuls
    consume (nnz > 0, as the reference derives it from the bitmap);
    ``shape`` the unpadded (T, N).
    """

    k: torch.Tensor  # (Tp, Np) int8
    delta: torch.Tensor  # 0-d f32
    nnz: torch.Tensor  # (Tp/BLOCK, Np/BLOCK) int32
    bitmap: torch.Tensor  # (Tp, Np/8) uint8
    mask: torch.Tensor  # (Tp/BLOCK, Np/BLOCK) int32
    shape: Tuple[int, int]


def quantize_and_mask(g: torch.Tensor, noise: Union[int, torch.Tensor],
                      s: float) -> QuantizedGrad:
    """NSD-quantize g (T, N) and lay out its bitmap and tile mask: Delta,
    then one NSD launch. ``noise`` is the layer's Philox stream key (an int,
    ``DitherCtx.cotangent_key``: the kernel draws u itself) or a fed unit
    draw u (T, N)."""
    T, N = g.shape
    g = g.to(torch.float32).contiguous()
    delta = nsd.compute_delta(g, s)
    route = ({"noise": nsd.dither_noise(noise, delta)}
             if isinstance(noise, torch.Tensor) else {"key": noise})
    q = nsd_quant.nsd_quantize(g, delta, **route)
    return QuantizedGrad(k=q.k, delta=delta, nnz=q.nnz, bitmap=q.bitmap,
                         mask=q.mask, shape=(T, N))


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
                                w: torch.Tensor, *, need_dx: bool = True,
                                int8_operands: bool = True
                                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Both backward products of y = x @ w from a quantized cotangent.

    x: (T, K); w: (K, N). Returns (dx (T, K) or None when ``need_dx`` is
    False, dw (K, N)), with x and w absmax-quantized to int8, or kept in
    f32 when ``int8_operands`` is False.
    """
    T, N = q.shape
    K = x.shape[-1]
    if not int8_operands:
        dx = None
        if need_dx:
            # dx = k . w^T: the f32 operand laid out (N, K), contraction rows
            dx = bsp_matmul.bsp_matmul(
                q.k, q.delta, _pad_to(w.t().to(torch.float32), BLOCK, BLOCK),
                q.mask)[:T, :K].to(x.dtype)
        # dW^T = k^T . x: k read transposed in place
        dw_t = bsp_matmul.bsp_matmul(
            q.k, q.delta, _pad_to(x.reshape(-1, K).to(torch.float32), BLOCK,
                                  BLOCK), q.mask, trans_a=True)
        return dx, dw_t[:N, :K].t().to(w.dtype)
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
                              w: torch.Tensor, noise: Union[int, torch.Tensor],
                              s: float, *, int8_operands: bool = True):
    """The kernel-path backward of y = x @ w for cotangent g (T, N), inputs
    x (T, K), w (K, N) and a stream key or unit draw u (T, N)
    (:func:`quantize_and_mask`): (dx, dW)."""
    return bsp_backward_from_quantized(quantize_and_mask(g, noise, s), x, w,
                                       int8_operands=int8_operands)
