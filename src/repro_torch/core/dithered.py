"""Dithered backprop as PyTorch ops (the paper's eqs. 7-9).

Counterpart of ``repro.core.dithered`` for ``dense`` and ``conv2d``. The
forward is exact. The backward takes the pre-activation cotangent g (delta_z
in the paper), quantizes it once with NSD, and uses the quantized tensor for
both products:

    dx = g~ . W^T        (activation gradient, eq. 8)
    dW = x^T . g~        (weight gradient, eq. 9)

The bias is added outside the autograd Function, so its gradient is exact.

Variants (``DitherPolicy.variant``):
  off     plain backprop (no Function in the graph at all)
  paper   NSD in f32, both products in f32
  kernel  fused NSD + bitmap pack + tile-skipping int8 products on the
          CUDA kernels (``repro_torch.kernels.ops``); a convolution goes
          through im2col (``F.unfold``), and dx folds back with ``F.fold``.

The noise of a layer is ``ctx.unit_noise(name, (T, N))`` for its 2-D
cotangent. For a convolution the T rows run in the reference's NHWC order
(b, h, w), so a fed reference draw lines up element for element.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import nsd
from repro_torch.core.policy import VARIANT_KERNEL, DitherCtx, DitherPolicy
from repro_torch.kernels import ops
from repro_torch.obs import metrics


def quantize_cotangent(g2d: torch.Tensor, u: torch.Tensor,
                       pol: DitherPolicy, name: str) -> torch.Tensor:
    """The paper variant's NSD fake-quant of a 2-D cotangent: k * Delta."""
    delta = nsd.compute_delta(g2d, pol.s)
    k = nsd.nsd_indices(g2d, u, delta)
    if pol.collect_stats:
        metrics.emit(name, nsd.quant_stats(k, delta))
    return (k.to(torch.float32) * delta).to(g2d.dtype)


def _kernel_products(g2d, x2d, w, u, pol: DitherPolicy, name: str,
                     need_dx: bool):
    """Kernel-variant products; telemetry comes from the same k the
    matmul kernels consume (sliced back to the live region)."""
    q = ops.quantize_and_mask(g2d, u, pol.s)
    if pol.collect_stats:
        T, N = g2d.shape
        metrics.emit(name, nsd.quant_stats(q.k[:T, :N], q.delta))
    return ops.bsp_backward_from_quantized(q, x2d, w, need_dx=need_dx)


class _DitheredDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dctx: DitherCtx, name: str):
        ctx.save_for_backward(x, w)
        ctx.dctx, ctx.name = dctx, name
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pol, name = ctx.dctx.resolve(ctx.name), ctx.name
        need_dx = ctx.needs_input_grad[0]
        x2d = x.reshape(-1, x.shape[-1])
        g2d = g.reshape(-1, g.shape[-1])
        u = ctx.dctx.unit_noise(name, g2d.shape)
        if pol.variant == VARIANT_KERNEL:
            dx2d, dw = _kernel_products(g2d, x2d, w, u, pol, name, need_dx)
        else:
            gq = quantize_cotangent(g2d, u, pol, name)
            dx2d = gq @ w.t() if need_dx else None
            dw = x2d.t() @ gq
        dx = dx2d.reshape(x.shape) if need_dx else None
        return dx, dw, None, None


class _DitheredConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups,
                dctx: DitherCtx, name: str):
        ctx.save_for_backward(x, w)
        ctx.geom = (stride, padding, dilation, groups)
        ctx.dctx, ctx.name = dctx, name
        return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.geom
        pol, name = ctx.dctx.resolve(ctx.name), ctx.name
        need_dx = ctx.needs_input_grad[0]
        B, Co, Ho, Wo = g.shape
        g2d = g.permute(0, 2, 3, 1).reshape(-1, Co)  # rows (b, h, w): NHWC
        u = ctx.dctx.unit_noise(name, g2d.shape)
        dx = None
        if pol.variant == VARIANT_KERNEL and groups == 1:
            kh, kw = w.shape[2:]
            # im2col: features in (Ci, kh, kw) order, rows (b, h, w)
            cols = F.unfold(x, (kh, kw), dilation, padding, stride)
            kk, L = cols.shape[1:]
            cols2d = cols.transpose(1, 2).reshape(B * L, kk)
            w_mat = w.reshape(Co, kk).t()
            dcols2d, dw_mat = _kernel_products(g2d, cols2d, w_mat, u, pol,
                                               name, need_dx)
            if need_dx:
                dx = F.fold(dcols2d.reshape(B, L, kk).transpose(1, 2),
                            x.shape[2:], (kh, kw), dilation, padding, stride)
            dw = dw_mat.t().reshape(w.shape)
        else:
            if pol.variant == VARIANT_KERNEL:
                ops.note_fallback("conv:groups", name)
            gq = quantize_cotangent(g2d, u, pol, name)
            gq = gq.reshape(B, Ho, Wo, Co).permute(0, 3, 1, 2)
            if need_dx:
                dx = torch.nn.grad.conv2d_input(x.shape, w, gq, stride,
                                                padding, dilation, groups)
            dw = torch.nn.grad.conv2d_weight(x, w.shape, gq, stride, padding,
                                             dilation, groups)
        return dx, dw, None, None, None, None, None, None


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          *, ctx: Optional[DitherCtx] = None, name: str = "dense"
          ) -> torch.Tensor:
    """y = x @ w (+ b), x (..., K), w (K, N); dithered backward when the
    context's policy covers ``name``, plain autograd otherwise."""
    if ctx is not None and ctx.resolve(name) is not None:
        y = _DitheredDense.apply(x, w, ctx, name)
    else:
        y = torch.matmul(x, w)
    return y if b is None else y + b


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride=1, padding=0, dilation=1, groups: int = 1,
           ctx: Optional[DitherCtx] = None, name: str = "conv"
           ) -> torch.Tensor:
    """NCHW x OIHW convolution (+ b); dithered backward when the context's
    policy covers ``name``. A grouped convolution in the kernel variant is
    a counted fallback (``ops.KERNEL_FALLBACKS``) to the paper path."""
    if ctx is not None and ctx.resolve(name) is not None:
        y = _DitheredConv2d.apply(x, w, stride, padding, dilation, groups,
                                  ctx, name)
    else:
        y = F.conv2d(x, w, None, stride, padding, dilation, groups)
    return y if b is None else y + b.reshape(1, -1, 1, 1)
