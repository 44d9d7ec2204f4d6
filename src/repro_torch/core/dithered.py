"""Dithered backprop as PyTorch ops (the paper's eqs. 7-9).

Counterpart of ``repro.core.dithered`` for ``dense``, ``conv2d`` and
``dithered_einsum``. The forward is exact. The backward takes the
pre-activation cotangent g (delta_z in the paper), quantizes it once, and
uses the quantized tensor for both products:

    dx = g~ . W^T        (activation gradient, eq. 8)
    dW = x^T . g~        (weight gradient, eq. 9)

The bias is added outside the autograd Function, so its gradient is exact.

Variants (``DitherPolicy.variant``):
  off     plain backprop (no Function in the graph at all)
  paper   NSD in f32, both products in f32
  int8    NSD + absmax-int8 operands: a dense layer's k from the NSD kernel
          and both products on the int8 kernel (``kernels.ops``), equal to
          the reference's int8 products in int32; a convolution takes the
          paper path, as in the reference
  row     structured row dither (``core.rowdither``), f32 products
  meprop  per-row top-k (``core.meprop``), f32 products
  kernel  fused NSD (with the bitmap and tile mask) + tile-skipping int8
          products on the CUDA kernels (``repro_torch.kernels.ops``); a
          convolution goes through im2col (``F.unfold``), and dx folds back
          with ``F.fold``; an einsum by its form (:func:`_einsum_form`).

A two-operand einsum (:func:`dithered_einsum`, the MoE expert FFNs) takes
the generic path in every variant but ``kernel``: its cotangent is
quantized whole (Delta over every element, the draw of its (T, N) view, T
the product of the leading axes) and pushed through the einsum's exact
vector-Jacobian product. Under ``kernel``, ``...k,kn->...n``
(``dense2d``) is a dense layer on the flattened operands, and
``B...k,Bkn->B...n`` (``batched``) quantizes the whole (B x ..., N)
cotangent with one NSD launch (one Delta, one draw), then, for each slice
b, packs the slice's k (the pack kernel, through
``ops.quantized_from_indices``) and runs both int8 products on it and
slice b of x and w. Any other form is a counted fallback
(``ops.KERNEL_FALLBACKS``) to the generic path, as in the reference.

The noise of a layer is drawn for its 2-D cotangent (T, N): the kernel
variant (and int8's dense layers) hands the NSD launch the layer's stream
key (``ctx.cotangent_dither``), the paper variant draws the same numbers as
a tensor (``ctx.unit_noise(name, (T, N))``), the row variant one number a
row (``ctx.unit_noise(name, (T, 1))``). For a convolution the T rows run
in the reference's NHWC order (b, h, w), so a fed reference draw lines up
element for element.

A cotangent codec (``DitherPolicy.grad_codec``, the quant program's
``grad=``) replaces the variant's built-in quantizer, as in the reference:
the cotangent takes the registered codec's fake-quant round trip
(``quant.quantize``; a codec that takes noise gets the layer's
``ctx.cotangent_dither``), and both products run as the paper variant's, in
the op's dtype. The kernel and int8 routes are skipped: that is the
reference's design, not a fallback, so no fallback is noted.

Convolutions take the reference's padding: ``"SAME"`` (for stride 2 the
extra row and column go to the bottom and right), ``"VALID"``, an int or
explicit ((top, bottom), (left, right)). Uneven padding is applied with
``F.pad`` inside the autograd Function, before the forward convolution and
before ``F.unfold`` in the backward (dx is sliced back), so the residual
saved and encoded is the unpadded x, as in the reference.

Residual memory (``repro_torch.memory``): the activation x that the
weight-gradient product consumes is saved under the layer's residual mode
(``DitherPolicy.residual``): the forward stores ``quant.encode(x)``, the
backward decodes it. A convolution's x is encoded in the reference's NHWC
order, so an ``nsd`` container and its noise draw (the stream of
``ctx.resid_dither(name, (B, H, W, C))``) line up with the reference's, and
is permuted back to NCHW after the decode. dx = g~ . W^T never reads x, so
with any codec every cotangent, and so every BatchNorm and bias gradient,
equals the fp32-residual run's; only dW moves. Mode ``remat`` saves nothing
of the op: ``torch.utils.checkpoint`` reruns its forward in the backward,
with telemetry stripped inside (the layer records a memory row, no dither
row, as in the reference).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import quant
from repro_torch.core import meprop, nsd, rowdither
from repro_torch.core.policy import (VARIANT_INT8, VARIANT_KERNEL,
                                     VARIANT_MEPROP, VARIANT_ROW, DitherCtx,
                                     DitherPolicy)
from repro_torch.kernels import ops
from repro_torch.obs import metrics

_DENSE_MODES = (quant.MODE_FP32, quant.MODE_REMAT)
# the variants whose dense layers run k and both products on the kernels
_KERNEL_DENSE = (VARIANT_KERNEL, VARIANT_INT8)


def _emit_zero_share(out: torch.Tensor, bits: float, name: str) -> None:
    """The telemetry row of a quantizer without NSD indices: the zero share
    of its output and its ``bits``."""
    zero = 1.0 - nsd.mask_mean(out != 0)
    metrics.emit(name, nsd.QuantStats(
        zero, torch.full_like(zero, float(bits)), torch.zeros_like(zero)))


def _cotangent_noise(dctx: DitherCtx, pol: DitherPolicy, name: str, shape):
    """The noise the generic path's quantizer consumes for a (..., N)
    cotangent of T rows (the product of the leading axes): for a cotangent
    codec that takes noise, the layer's stream key (or fed draw,
    ``DitherCtx.cotangent_dither``), for one that takes none, None; else by
    variant, the unit draw u of the cotangent's shape for NSD (the draw of
    its (T, N) view), one number a row (T, 1) for row dither, none for
    meProp."""
    if pol.grad_codec is not None:
        return (dctx.cotangent_dither(name, shape)
                if quant.takes_noise(pol.grad_codec) else None)
    if pol.variant == VARIANT_MEPROP:
        return None
    if pol.variant == VARIANT_ROW:
        return dctx.unit_noise(name, (math.prod(shape[:-1]), 1))
    return dctx.unit_noise(name, shape)


def quantize_cotangent(g2d: torch.Tensor, u, pol: DitherPolicy, name: str
                       ) -> torch.Tensor:
    """The generic path's quantizer of a cotangent (see
    :func:`_cotangent_noise` for ``u``): the cotangent codec's round trip
    when ``pol.grad_codec`` is set, else by variant NSD's fake-quant
    k * Delta (paper, int8 and kernel variants), the row dither (u + 1/2,
    exact in f32, is the row's uniform in [0, 1)), or meProp's top-k. A
    dense layer's and a convolution's cotangent is 2-D; an einsum's keeps
    its shape, as in the reference, whose Delta reduces over that shape."""
    if pol.grad_codec is not None:
        out = quant.quantize(pol.grad_codec, g2d, u).to(g2d.dtype)
        if pol.collect_stats:
            _emit_zero_share(out, quant.parse_spec(pol.grad_codec).bits, name)
        return out
    if pol.variant == VARIANT_ROW:
        out = rowdither.row_dither(g2d, u + 0.5, pol.row_alpha)
    elif pol.variant == VARIANT_MEPROP:
        out = meprop.meprop_sparsify(g2d, pol.meprop_k_frac)
    else:
        delta = nsd.compute_delta(g2d, pol.s)
        k = nsd.nsd_indices(g2d, u, delta)
        if pol.collect_stats:
            metrics.emit(name, nsd.quant_stats(k, delta))
        return (k.to(torch.float32) * delta).to(g2d.dtype)
    if pol.collect_stats:
        _emit_zero_share(out, 32, name)
    return out


def _kernel_products(g2d, x2d, w, noise, pol: DitherPolicy, name: str,
                     need_dx: bool):
    """Kernel-variant products from the layer's stream key or fed unit draw
    (``noise``); telemetry comes from the same k the matmul kernels consume
    (sliced back to the live region)."""
    q = ops.quantize_and_mask(g2d, noise, pol.s)
    if pol.collect_stats:
        T, N = g2d.shape
        metrics.emit(name,
                     nsd.quant_stats(q.k[:T, :N], q.delta))
    return ops.bsp_backward_from_quantized(q, x2d, w, need_dx=need_dx)


# ---------------------------------------------------------------------------
# residual store: encode in the forward, decode in the backward
# ---------------------------------------------------------------------------

def _save_residual(ctx, x: torch.Tensor, w: torch.Tensor, pol: DitherPolicy,
                   dctx: DitherCtx, name: str, conv: bool) -> None:
    """Encode x under the layer's mode and save it with w. An encoded
    container (a dataclass, or int8_absmax's NamedTuple) is saved as its
    tensors (``save_for_backward``), its static fields (shape, dtype) as
    attributes."""
    mode = pol.residual
    if mode in _DENSE_MODES:
        enc = x
    else:
        xr = x.permute(0, 2, 3, 1).contiguous() if conv else x  # NHWC
        noise = (dctx.resid_dither(name, xr.shape) if quant.takes_noise(mode)
                 else None)
        enc = quant.encode(mode, xr, noise)
    if pol.collect_stats and not dctx.recompute:
        metrics.emit_memory(name,
                            quant.measured_bytes(mode, enc),
                            quant.capacity_bytes(mode, enc),
                            quant.dense_nbytes(x.shape, x.dtype))
    if isinstance(enc, torch.Tensor):
        ctx.resid = None
        ctx.save_for_backward(enc, w)
        return
    fields = (list(enc._fields) if isinstance(enc, tuple)
              else [f.name for f in dataclasses.fields(enc)])
    tensors = [n for n in fields if isinstance(getattr(enc, n), torch.Tensor)]
    ctx.resid = (type(enc), tensors,
                 {n: getattr(enc, n) for n in fields if n not in tensors})
    ctx.save_for_backward(w, *(getattr(enc, n) for n in tensors))


def _load_residual(ctx, conv: bool):
    """(x, w) from the saved tensors, x decoded back to the op's layout."""
    if ctx.resid is None:
        return ctx.saved_tensors
    cls, names, static = ctx.resid
    w, *tensors = ctx.saved_tensors
    x = quant.decode(ctx.pol.residual, cls(**dict(zip(names, tensors)), **static))
    return (x.permute(0, 3, 1, 2).contiguous() if conv else x), w


def _differentiable(*tensors: torch.Tensor) -> bool:
    """Whether a backward can run: only then is a residual saved."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _apply_op(fn, x, w, pol: DitherPolicy, dctx: DitherCtx, name: str
              ) -> torch.Tensor:
    """``fn(x, w, pol)`` under the layer's residual mode. ``remat`` runs it
    under ``torch.utils.checkpoint`` with telemetry stripped (the backward
    reruns the forward), and records the op inputs it keeps alive: measured
    == capacity == dense."""
    if pol.residual != quant.MODE_REMAT:
        return fn(x, w, pol)
    y = checkpoint(fn, x, w, pol.replace(collect_stats=False),
                   use_reentrant=False, preserve_rng_state=False)
    if pol.collect_stats and not dctx.recompute:
        nbytes = quant.dense_nbytes(x.shape, x.dtype)
        metrics.emit_memory(name, nbytes, nbytes, nbytes)
    return y


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------

class _DitheredDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, pol: DitherPolicy, dctx: DitherCtx, name: str):
        _save_residual(ctx, x, w, pol, dctx, name, conv=False)
        ctx.pol, ctx.dctx, ctx.name = pol, dctx, name
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = _load_residual(ctx, conv=False)
        pol, name = ctx.pol, ctx.name
        need_dx = ctx.needs_input_grad[0]
        x2d = x.reshape(-1, x.shape[-1])
        g2d = g.reshape(-1, g.shape[-1])
        if pol.variant in _KERNEL_DENSE and pol.grad_codec is None:
            dx2d, dw = _kernel_products(
                g2d, x2d, w, ctx.dctx.cotangent_dither(name, g2d.shape), pol,
                name, need_dx)
        else:
            gq = quantize_cotangent(
                g2d, _cotangent_noise(ctx.dctx, pol, name, g2d.shape), pol,
                name)
            dx2d = gq @ w.t() if need_dx else None
            dw = x2d.t() @ gq
        dx = dx2d.reshape(x.shape) if need_dx else None
        return dx, dw, None, None, None


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(int(a) for a in v)


def _same_pads(size: int, k: int, stride: int, dilation: int
               ) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: out = ceil(size / stride), total =
    max((out - 1) stride + the dilated kernel - size, 0), the odd one at
    the end."""
    eff = (k - 1) * dilation + 1
    total = max((-(-size // stride) - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def conv_pads(padding, hw, khw, stride, dilation
              ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) of ``padding``: "SAME", "VALID", an
    int or explicit ((top, bottom), (left, right))."""
    stride, dilation = _pair(stride), _pair(dilation)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "SAME":
            return tuple(_same_pads(hw[i], khw[i], stride[i], dilation[i])
                         for i in range(2))
        if mode == "VALID":
            return (0, 0), (0, 0)
        raise ValueError(f"conv2d: unknown padding {padding!r}")
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    if len(padding) != 2 or any(isinstance(p, int) or len(p) != 2
                                for p in padding):
        raise ValueError(f"conv2d: padding {padding!r} is not "
                         f"((top, bottom), (left, right))")
    return tuple((int(a), int(b)) for a, b in padding)


def _padded_input(x: torch.Tensor, pads):
    """(x to convolve, torch's symmetric padding): x itself and (top, left)
    when the padding is even on both axes, else x padded with ``F.pad``
    and no padding."""
    (t, b), (lt, r) = pads
    if t == b and lt == r:
        return x, (t, lt)
    return F.pad(x, (lt, r, t, b)), (0, 0)


def _unpad(dx: torch.Tensor, x_shape, pads) -> torch.Tensor:
    """The gradient of the padded input sliced back to x's."""
    (t, b), (lt, r) = pads
    if t == b and lt == r:
        return dx
    H, W = x_shape[2:]
    return dx[:, :, t:t + H, lt:lt + W]


class _DitheredConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, geom, pol: DitherPolicy, dctx: DitherCtx,
                name: str):
        _save_residual(ctx, x, w, pol, dctx, name, conv=True)
        ctx.geom = geom
        ctx.pol, ctx.dctx, ctx.name = pol, dctx, name
        stride, pads, dilation, groups = geom
        xp, padding = _padded_input(x, pads)
        return F.conv2d(xp, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = _load_residual(ctx, conv=True)
        stride, pads, dilation, groups = ctx.geom
        xp, padding = _padded_input(x, pads)
        pol, name = ctx.pol, ctx.name
        need_dx = ctx.needs_input_grad[0]
        B, Co, Ho, Wo = g.shape
        g2d = g.permute(0, 2, 3, 1).reshape(-1, Co)  # rows (b, h, w): NHWC
        dx = None
        if (pol.variant == VARIANT_KERNEL and pol.grad_codec is None
                and groups == 1):
            kh, kw = w.shape[2:]
            # im2col: features in (Ci, kh, kw) order, rows (b, h, w)
            cols = F.unfold(xp, (kh, kw), dilation, padding, stride)
            kk, L = cols.shape[1:]
            cols2d = cols.transpose(1, 2).reshape(B * L, kk)
            w_mat = w.reshape(Co, kk).t()
            dcols2d, dw_mat = _kernel_products(
                g2d, cols2d, w_mat, ctx.dctx.cotangent_dither(name, g2d.shape),
                pol, name, need_dx)
            if need_dx:
                dx = F.fold(dcols2d.reshape(B, L, kk).transpose(1, 2),
                            xp.shape[2:], (kh, kw), dilation, padding, stride)
            dw = dw_mat.t().reshape(w.shape)
        else:
            if pol.variant == VARIANT_KERNEL and pol.grad_codec is None:
                ops.note_fallback("conv:groups", name)
            gq = quantize_cotangent(g2d, _cotangent_noise(ctx.dctx, pol, name,
                                                         g2d.shape), pol, name)
            gq = gq.reshape(B, Ho, Wo, Co).permute(0, 3, 1, 2)
            if need_dx:
                dx = torch.nn.grad.conv2d_input(xp.shape, w, gq, stride,
                                                padding, dilation, groups)
            dw = torch.nn.grad.conv2d_weight(xp, w.shape, gq, stride, padding,
                                             dilation, groups)
        if dx is not None:
            dx = _unpad(dx, x.shape, pads)
        return dx, dw, None, None, None, None


def _einsum_form(spec: str) -> Optional[str]:
    """The kernel backward's form of a two-operand einsum: ``"dense2d"``
    for ``...k,kn->...n`` (one 2-D weight: flatten and run the dense
    layer's kernels), ``"batched"`` for ``B...k,Bkn->B...n`` (a leading
    axis shared by both operands, a 2-D product a slice: the expert FFNs),
    None for any other (the reference's classifier, letter for letter)."""
    if "->" not in spec or "." in spec:
        return None
    ins, out = spec.split("->")
    if "," not in ins:
        return None
    a, b = ins.split(",")
    if len(set(a)) != len(a) or len(set(b)) != len(b):
        return None
    if len(b) == 2 and len(a) >= 2 and a[-1] == b[0] \
            and out == a[:-1] + b[1] and b[1] not in a:
        return "dense2d"
    if len(b) == 3 and len(a) >= 3 and a[0] == b[0] \
            and a[-1] == b[1] and out == a[0] + a[1:-1] + b[2] \
            and b[2] not in a:
        return "batched"
    return None


def _batched_kernel_products(g, x, w, noise, pol: DitherPolicy, name: str,
                             need_dx: bool):
    """The ``batched`` form's kernel backward: one NSD launch over the
    whole (n_b x C, N) cotangent, so that Delta and the draw are the
    paper path's; then slice b's k (C, N) is packed (its bitmap, tile nnz
    and mask) and both int8 products run on it, x's slice (C, K) and w's
    (K, N)."""
    n_b, fdim = x.shape[0], g.shape[-1]
    g2d = g.reshape(-1, fdim)
    q = ops.quantize_and_mask(g2d, noise, pol.s)
    T = g2d.shape[0]
    if pol.collect_stats:
        metrics.emit(name, nsd.quant_stats(q.k[:T, :fdim], q.delta))
    k3 = q.k[:T, :fdim].reshape(n_b, -1, fdim)
    x3 = x.reshape(n_b, -1, x.shape[-1])
    dxs, dws = [], []
    for e in range(n_b):
        dx_e, dw_e = ops.bsp_backward_from_quantized(
            ops.quantized_from_indices(k3[e], q.delta), x3[e], w[e],
            need_dx=need_dx)
        dxs.append(dx_e)
        dws.append(dw_e)
    dx = torch.stack(dxs).reshape(x.shape) if need_dx else None
    return dx, torch.stack(dws)


class _DitheredEinsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, spec: str, pol: DitherPolicy, dctx: DitherCtx,
                name: str):
        _save_residual(ctx, x, w, pol, dctx, name, conv=False)
        ctx.spec, ctx.pol, ctx.dctx, ctx.name = spec, pol, dctx, name
        return torch.einsum(spec, x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = _load_residual(ctx, conv=False)
        spec, pol, name = ctx.spec, ctx.pol, ctx.name
        need_dx = ctx.needs_input_grad[0]
        g2d = g.reshape(-1, g.shape[-1])
        form = (_einsum_form(spec) if pol.variant == VARIANT_KERNEL
                and pol.grad_codec is None else None)
        if form is not None:
            noise = ctx.dctx.cotangent_dither(name, g2d.shape)
            if form == "dense2d":
                dx2d, dw = _kernel_products(g2d, x.reshape(-1, x.shape[-1]),
                                            w, noise, pol, name, need_dx)
                dx = dx2d.reshape(x.shape) if need_dx else None
            else:
                dx, dw = _batched_kernel_products(g, x, w, noise, pol, name,
                                                  need_dx)
            return dx, dw, None, None, None, None
        if pol.variant == VARIANT_KERNEL and pol.grad_codec is None:
            ops.note_fallback("einsum:unsupported-form:" + spec, name)
        gq = quantize_cotangent(
            g, _cotangent_noise(ctx.dctx, pol, name, g.shape), pol, name)
        with torch.enable_grad():
            xx = x.detach().requires_grad_(need_dx)
            ww = w.detach().requires_grad_()
            y = torch.einsum(spec, xx, ww)
            grads = torch.autograd.grad(y, (xx, ww) if need_dx else (ww,), gq)
        dx, dw = grads if need_dx else (None, grads[0])
        return dx, dw, None, None, None, None


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          *, ctx: Optional[DitherCtx] = None, name: str = "dense"
          ) -> torch.Tensor:
    """y = x @ w (+ b), x (..., K), w (K, N); dithered backward when the
    context's policy covers ``name``, plain autograd otherwise."""
    pol = ctx.resolve(name) if ctx is not None else None
    if pol is not None and _differentiable(x, w):
        y = _apply_op(lambda xx, ww, p: _DitheredDense.apply(xx, ww, p, ctx,
                                                             name),
                      x, w, pol, ctx, name)
    else:
        y = torch.matmul(x, w)
    return y if b is None else y + b


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride=1, padding=0, dilation=1, groups: int = 1,
           ctx: Optional[DitherCtx] = None, name: str = "conv"
           ) -> torch.Tensor:
    """NCHW x OIHW convolution (+ b); dithered backward when the context's
    policy covers ``name``. ``padding``: "SAME", "VALID", an int or
    ((top, bottom), (left, right)) (:func:`conv_pads`). A grouped
    convolution in the kernel variant is a counted fallback
    (``ops.KERNEL_FALLBACKS``) to the paper path."""
    pol = ctx.resolve(name) if ctx is not None else None
    pads = conv_pads(padding, x.shape[2:], w.shape[2:], stride, dilation)
    if pol is not None and _differentiable(x, w):
        geom = (stride, pads, dilation, groups)
        y = _apply_op(lambda xx, ww, p: _DitheredConv2d.apply(xx, ww, geom, p,
                                                              ctx, name),
                      x, w, pol, ctx, name)
    else:
        xp, tpad = _padded_input(x, pads)
        y = F.conv2d(xp, w, None, stride, tpad, dilation, groups)
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def dithered_einsum(spec: str, x: torch.Tensor, w: torch.Tensor, *,
                    ctx: Optional[DitherCtx] = None, name: str = "einsum"
                    ) -> torch.Tensor:
    """``torch.einsum(spec, x, w)`` with a dithered backward when the
    context's policy covers ``name`` (see the module's docstring for the
    kernel variant's forms)."""
    pol = ctx.resolve(name) if ctx is not None else None
    if pol is not None and _differentiable(x, w):
        return _apply_op(lambda xx, ww, p: _DitheredEinsum.apply(
            xx, ww, spec, p, ctx, name), x, w, pol, ctx, name)
    return torch.einsum(spec, x, w)
