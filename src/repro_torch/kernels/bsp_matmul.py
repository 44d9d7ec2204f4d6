"""Tile-skipping matrix products: the wrappers of
``csrc/bsp_matmul_int8.cu`` and ``csrc/bsp_matmul_dequant.cu`` and their
plain versions.

Counterparts of ``repro.kernels.bsp_matmul``:

    bsp_matmul_int8:  C = (op(A) . op(B) over the K-tiles where mask != 0)
                          * scale, A and B int8, exact int32 accumulation
    bsp_matmul:       C = (f32(op(k)) . B over the K-tiles where mask != 0)
                          * delta, k int8 NSD indices, B f32, f32
                          accumulation (the ``int8_operands=False`` path)

with f32 out, on 128 x 128 tiles. ``trans_a`` / ``trans_b`` say that an
operand is stored transposed, so the weight-gradient product k^T . x reads
k in place; ``mask`` is always the tile mask of A as stored.

Both kernels split the contraction when the output tiles alone would not
fill the card (:func:`split_k`): each of S blocks per output tile sums its
own K-range into a workspace the wrapper allocates, and a second kernel in
the same C launch adds the S partials. One Python-level launch per product.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

TILE = 128
MIN_SPLIT_TILES = 4  # K-tiles per split, at least (where there are that many)


def split_k(m_tiles: int, n_tiles: int, k_tiles: int, sms: int) -> int:
    """How many K-ranges the kernels cut a product into: a function of the
    shapes alone, so the mask is never read on the host.

    1 when the m_tiles x n_tiles output tiles already fill the ``sms``
    streaming multiprocessors; else enough splits for about two waves of
    blocks, with at least ``MIN_SPLIT_TILES`` K-tiles in each.
    """
    tiles = m_tiles * n_tiles
    if tiles >= sms:
        return 1
    return max(1, min(-(-2 * sms // tiles), k_tiles // MIN_SPLIT_TILES))


def split_bounds(k_tiles: int, splits: int) -> list:
    """The K-tile range [begin, end) of each split, as the kernels cut it."""
    return [(s * k_tiles // splits, (s + 1) * k_tiles // splits)
            for s in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_for(M: int, N: int, K: int, device: torch.device) -> int:
    """:func:`split_k` for an (M, K) x (K, N) product on a CUDA device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return split_k(M // TILE, N // TILE, K // TILE, _sm_count(index))


def _check(a, b, mask, trans_a, trans_b, name="bsp_matmul_int8"):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{name}: operands must be 2-D")
    M, K = a.shape[::-1] if trans_a else a.shape
    K2, N = b.shape[::-1] if trans_b else b.shape
    if K != K2:
        raise ValueError(f"{name}: contraction {K} != {K2}")
    if M % TILE or N % TILE or K % TILE:
        raise ValueError(f"{name}: {(M, K, N)} not multiples of {TILE}")
    want = (K // TILE, M // TILE) if trans_a else (M // TILE, K // TILE)
    if tuple(mask.shape) != want:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} != {want}")
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
    splits = splits_for(M, N, K, a.device)
    # the split partials' scratch; the reduce adds them in the same launch
    ws = (torch.empty((splits, M, N), dtype=torch.int32, device=a.device)
          if splits > 1 else None)
    build.launch("bsp_matmul_int8", "bsp_matmul_int8_launch", build.ptr(a),
                 build.ptr(b), build.ptr(scale), build.ptr(mask), build.ptr(c),
                 build.ptr(ws), M, N, K, int(trans_a), int(trans_b), splits)
    return c


def bsp_matmul_plain(k: torch.Tensor, delta: torch.Tensor, b: torch.Tensor,
                     mask: torch.Tensor, *, trans_a: bool = False
                     ) -> torch.Tensor:
    """The dequant kernel's function in plain torch ops, on any device.

    Mirrors the reference's blocked f32 oracle
    (``bsp_matmul/ref.py::bsp_matmul_blocked_ref``): one f32 product per
    K-tile, the occupied tiles' products summed in tile order, then one
    multiply by delta. (Run TF32 off on the card.)
    """
    M, N, K = _check(k, b, mask, trans_a, False, "bsp_matmul")
    a_op = (k.t() if trans_a else k).to(torch.float32)
    m_op = (mask.t() if trans_a else mask) != 0
    bf = b.to(torch.float32)
    acc = torch.zeros((M, N), dtype=torch.float32, device=k.device)
    live = m_op.any(0).tolist()  # one host read, not one per tile
    for kt in range(K // TILE):
        if not live[kt]:
            continue
        rows = m_op[:, kt].repeat_interleave(TILE)
        sl = slice(kt * TILE, (kt + 1) * TILE)
        acc = acc + torch.where(rows[:, None], a_op[:, sl] @ bf[sl], 0.0)
    return acc * delta.to(torch.float32).reshape(())


def bsp_matmul(k: torch.Tensor, delta: torch.Tensor, b: torch.Tensor,
               mask: torch.Tensor, *, trans_a: bool = False) -> torch.Tensor:
    """op(k) (M, K) int8 x B (K, N) f32 over occupied K-tiles, times
    ``delta``; M, N, K multiples of 128. Returns (M, N) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise.
    """
    M, N, K = _check(k, b, mask, trans_a, False, "bsp_matmul")
    if k.device.type == "cpu":
        return bsp_matmul_plain(k, delta, b, mask, trans_a=trans_a)
    if k.device.type != "cuda":
        raise ValueError(f"bsp_matmul: no kernel for device {k.device}")
    if k.dtype != torch.int8:
        raise TypeError(f"bsp_matmul: k must be int8, got {k.dtype}")
    if b.dtype != torch.float32:
        raise TypeError(f"bsp_matmul: b must be float32, got {b.dtype}")
    if delta.dtype != torch.float32 or delta.numel() != 1:
        raise TypeError("bsp_matmul: delta must be one float32")
    if mask.dtype != torch.int32:
        raise TypeError("bsp_matmul: mask must be int32")
    build.check_cuda_operands("bsp_matmul", k, b)
    build.check_cuda_operands("bsp_matmul", k, delta, mask, align=4)
    c = torch.empty((M, N), dtype=torch.float32, device=k.device)
    build.check_cuda_operands("bsp_matmul", c)
    splits = splits_for(M, N, K, k.device)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=k.device)
          if splits > 1 else None)
    build.launch("bsp_matmul_dequant", "bsp_matmul_dequant_launch",
                 build.ptr(k), build.ptr(delta), build.ptr(b), build.ptr(mask),
                 build.ptr(c), build.ptr(ws), M, N, K, int(trans_a), splits)
    return c
