"""Fused NSD quantizer: the wrapper of ``csrc/nsd_quant.cu`` and its plain
version.

Counterpart of ``repro.kernels.nsd_quant`` (the Pallas kernel and its jnp
oracle). Per (bm, bn) tile of the padded pre-activation gradient:

    k   = clip(floor((x + nu) / max(delta, tiny) + 1/2), -127, 127)  int8
          (all zeros when delta <= 0)
    nnz = number of non-zero k in the tile                           int32

``delta`` (a global std reduction) and ``nu`` (the dither noise) are formed
outside, so the kernel is a pure function of its inputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_TINY = torch.finfo(torch.float32).tiny


def _check(x, noise, delta, bm, bn):
    if x.dim() != 2 or x.shape != noise.shape:
        raise ValueError(f"nsd_quant: x {tuple(x.shape)} and noise "
                         f"{tuple(noise.shape)} must be one 2-D shape")
    M, N = x.shape
    if M % bm or N % bn:
        raise ValueError(f"nsd_quant: shape {(M, N)} is not a multiple of "
                         f"the tile {(bm, bn)}")
    if delta.numel() != 1:
        raise ValueError("nsd_quant: delta must be a scalar")
    return M, N


def nsd_quantize_blocked_plain(x: torch.Tensor, noise: torch.Tensor,
                               delta: torch.Tensor, *, bm: int = 128,
                               bn: int = 128):
    """The kernel's function in plain torch ops, on any device."""
    M, N = _check(x, noise, delta, bm, bn)
    d = delta.to(torch.float32).reshape(())
    safe = torch.clamp(d, min=_TINY)
    k = torch.floor((x.to(torch.float32) + noise.to(torch.float32)) / safe + 0.5)
    k = torch.clamp(k, -127.0, 127.0)
    k = torch.where(d > 0.0, k, torch.zeros_like(k)).to(torch.int8)
    nnz = (k != 0).to(torch.int32).reshape(M // bm, bm, N // bn, bn).sum(
        (1, 3), dtype=torch.int32)
    return k, nnz


def nsd_quantize_blocked(x: torch.Tensor, noise: torch.Tensor,
                         delta: torch.Tensor, *, bm: int = 128, bn: int = 128):
    """x, noise: (M, N) f32 with M % bm == 0, N % bn == 0; delta: scalar f32.

    Returns (k int8 (M, N), nnz int32 (M // bm, N // bn)). CPU tensors take
    the plain version; CUDA tensors launch the kernel, or raise.
    """
    M, N = _check(x, noise, delta, bm, bn)
    if x.device.type == "cpu":
        return nsd_quantize_blocked_plain(x, noise, delta, bm=bm, bn=bn)
    if x.device.type != "cuda":
        raise ValueError(f"nsd_quant: no kernel for device {x.device}")
    if not (x.dtype == noise.dtype == delta.dtype == torch.float32):
        raise TypeError("nsd_quant: x, noise and delta must be float32")
    if bn % 4:
        raise ValueError(f"nsd_quant: tile width {bn} is not a multiple of 4")
    build.check_cuda_operands("nsd_quant", x, noise)
    build.check_cuda_operands("nsd_quant", x, delta, align=4)
    k = torch.empty((M, N), dtype=torch.int8, device=x.device)
    nnz = torch.empty((M // bm, N // bn), dtype=torch.int32, device=x.device)
    build.launch("nsd_quant", "nsd_quant_launch", build.ptr(x),
                 build.ptr(noise), build.ptr(delta), build.ptr(k),
                 build.ptr(nnz), M, N, bm, bn)
    return k, nnz
