"""Tile-skipping int8 matrix product: the wrapper of
``csrc/bsp_matmul_int8.cu`` and its plain version.

Counterpart of ``repro.kernels.bsp_matmul.bsp_matmul_int8``:

    C = (op(A) . op(B) over the K-tiles where mask != 0) * scale

with A, B int8, exact int32 accumulation and f32 out, on 128 x 128 tiles.
``trans_a`` / ``trans_b`` say that an operand is stored transposed, so the
weight-gradient product k^T . x_q reads k in place; ``mask`` is always the
tile mask of A as stored.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

TILE = 128


def _check(a, b, mask, trans_a, trans_b):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("bsp_matmul_int8: operands must be 2-D")
    M, K = a.shape[::-1] if trans_a else a.shape
    K2, N = b.shape[::-1] if trans_b else b.shape
    if K != K2:
        raise ValueError(f"bsp_matmul_int8: contraction {K} != {K2}")
    if M % TILE or N % TILE or K % TILE:
        raise ValueError(f"bsp_matmul_int8: {(M, K, N)} not multiples of "
                         f"{TILE}")
    want = (K // TILE, M // TILE) if trans_a else (M // TILE, K // TILE)
    if tuple(mask.shape) != want:
        raise ValueError(f"bsp_matmul_int8: mask {tuple(mask.shape)} != "
                         f"{want}")
    return M, N, K


def bsp_matmul_int8_plain(a: torch.Tensor, b: torch.Tensor,
                          scale: torch.Tensor, mask: torch.Tensor, *,
                          trans_a: bool = False, trans_b: bool = False
                          ) -> torch.Tensor:
    """The kernel's function in plain torch ops, on any device.

    The sum is exact: products of int8 are below 2^14 and the sums stay far
    below 2^53, so float64 accumulates them without rounding in any order.
    """
    _check(a, b, mask, trans_a, trans_b)
    a_op = a.t() if trans_a else a
    m_op = mask.t() if trans_a else mask
    b_op = b.t() if trans_b else b
    keep = (m_op != 0).repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
    a_kept = torch.where(keep, a_op.to(torch.float64), 0.0)
    acc = (a_kept @ b_op.to(torch.float64)).to(torch.int64).to(torch.int32)
    return acc.to(torch.float32) * scale.to(torch.float32).reshape(())


def bsp_matmul_int8(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                    mask: torch.Tensor, *, trans_a: bool = False,
                    trans_b: bool = False) -> torch.Tensor:
    """op(A) (M, K) int8 x op(B) (K, N) int8 over occupied K-tiles, times
    ``scale``; M, N, K multiples of 128. Returns (M, N) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise.
    """
    M, N, K = _check(a, b, mask, trans_a, trans_b)
    if a.device.type == "cpu":
        return bsp_matmul_int8_plain(a, b, scale, mask, trans_a=trans_a,
                                     trans_b=trans_b)
    if a.device.type != "cuda":
        raise ValueError(f"bsp_matmul_int8: no kernel for device {a.device}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("bsp_matmul_int8: operands must be int8")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise TypeError("bsp_matmul_int8: scale must be one float32")
    if mask.dtype != torch.int32:
        raise TypeError("bsp_matmul_int8: mask must be int32")
    build.check_cuda_operands("bsp_matmul_int8", a, b)
    build.check_cuda_operands("bsp_matmul_int8", a, scale, mask, align=4)
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    build.check_cuda_operands("bsp_matmul_int8", c)
    build.launch("bsp_matmul_int8", "bsp_matmul_int8_launch", build.ptr(a),
                 build.ptr(b), build.ptr(scale), build.ptr(mask), build.ptr(c),
                 M, N, K, int(trans_a), int(trans_b))
    return c
