"""8-bit forward-pass training after Banner et al. 2018 (paper section 3.5),
and the per-tensor symmetric absmax int8 it rests on.

Counterpart of ``repro.core.int8`` (and of the ``int8_absmax`` codec of
``repro.quant.codecs``). Activations and weights are absmax-quantized per
tensor; the product runs int8 x int8 with an exact int32 sum and is
rescaled on exit; gradients flow straight through. Dithered backprop's
``int8`` variant (``repro_torch.core.dithered``) uses the same operands.

Stochastic rounding takes its uniform draw u ~ U(-1/2, 1/2) as a tensor
(the reference draws it from a key), so a test can feed the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import div
from repro_torch.kernels import bsp_matmul

_TINY = torch.finfo(torch.float32).tiny


class QuantTensor(NamedTuple):
    q: torch.Tensor  # int8
    scale: torch.Tensor  # 0-d f32: value ~= q * scale


def absmax_scale(x: torch.Tensor) -> torch.Tensor:
    amax = x.to(torch.float32).abs().max()
    return div(torch.clamp(amax, min=_TINY), 127.0)


def _quantize_int8(x: torch.Tensor, u: Optional[torch.Tensor] = None
                   ) -> QuantTensor:
    """q = clip(round(x / scale (+ u)), -127, 127): a true division and
    round half to even, as ``jnp.round`` does; stochastic rounding when a
    unit draw ``u`` (x's shape) is given."""
    scale = absmax_scale(x)
    v = x.to(torch.float32) / scale
    if u is not None:
        v = v + u.to(torch.float32)
    q = torch.clamp(torch.round(v), -127, 127).to(torch.int8)
    return QuantTensor(q=q, scale=scale)


def absmax_int8(x: torch.Tensor) -> QuantTensor:
    """Absmax int8 with round to nearest (the operands of the int8
    products)."""
    return _quantize_int8(x)


def int8_matmul(xq: QuantTensor, wq: QuantTensor,
                out_dtype=torch.float32) -> torch.Tensor:
    """xq (..., K) x wq (K, N): the int32 sum times both scales.

    The product is the int8 kernel's (``bsp_matmul.bsp_matmul_int8`` with
    every tile live, operands zero-padded to its 128 tiles): its plain
    version on the CPU, the kernel on the card.
    """
    lead, K = xq.q.shape[:-1], xq.q.shape[-1]
    N = wq.q.shape[1]
    a = xq.q.reshape(-1, K)
    M = a.shape[0]
    t = bsp_matmul.TILE
    pm, pk, pn = (-M) % t, (-K) % t, (-N) % t
    a = F.pad(a, (0, pk, 0, pm)).contiguous()
    b = F.pad(wq.q, (0, pn, 0, pk)).contiguous()
    mask = torch.ones(((M + pm) // t, (K + pk) // t), dtype=torch.int32,
                      device=a.device)
    scale = (xq.scale * wq.scale).to(torch.float32)
    out = bsp_matmul.bsp_matmul_int8(a, b, scale, mask)[:M, :N]
    return out.reshape(*lead, N).to(out_dtype)


class _Int8DenseSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return int8_matmul(_quantize_int8(x), _quantize_int8(w),
                           out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2d = x.reshape(-1, x.shape[-1])
        g2d = g.reshape(-1, g.shape[-1])
        dx = (g2d @ w.t().to(g2d.dtype)).reshape(x.shape)
        dw = (x2d.t() @ g2d).to(w.dtype)
        return dx.to(x.dtype), dw


def int8_dense_ste(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Forward in int8, backward straight through (exact f32 gradients)."""
    return _Int8DenseSTE.apply(x, w)


def range_batchnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    axis=0, eps: float = 1e-5) -> torch.Tensor:
    """Range BatchNorm (Banner et al.): normalise by the batch range over
    ``axis`` (an int or a tuple), scaled by 1 / sqrt(2 ln n), a consistent
    estimate of sigma for Gaussian data."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    xf = x.to(torch.float32)
    mean = xf.mean(axes, keepdim=True)
    centered = xf - mean
    rng = centered.amax(axes, keepdim=True) - centered.amin(axes, keepdim=True)
    n = math.prod(x.shape[a] for a in axes)
    denom = rng / math.sqrt(2.0 * math.log(max(n, 2))) + eps
    return (gamma * centered / denom + beta).to(x.dtype)
