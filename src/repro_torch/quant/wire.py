"""The NSD wire format: occupancy bitmaps and the chunked ``PackedNSD``.

Counterpart of ``repro.quant.wire``. An NSD-quantized tensor travels and
rests as

    header        4 bytes   (element count)
    deltas        4 bytes per chunk   (f32 step size, the per-tensor Delta)
    bitmap        chunk/8 bytes per chunk  (1 bit per element: non-zero?)
    levels        1 byte per NON-ZERO element (int8 k, compacted in order)

so wire bytes = 4 + n_chunks * (4 + chunk/8) + nnz. The bitmap is LSB first
(bit j of byte b is element 8b + j of the chunk). ``levels`` keeps capacity
for the all-non-zero case, with the live prefix length in ``nnz``.

Two routes compute the same bytes:

* ``backend="plain"``: the reference's jnp path, a cumsum over the whole
  flat tensor (:func:`_compact` / :func:`_expand`);
* ``backend="kernel"`` (the default): the port's kernels. The encode runs
  the NSD kernel on x as it stands, viewed as (n_chunks, 256) (the dither
  drawn inside from a stream key, or fed), then the wire compact kernel,
  which writes levels, bitmap and nnz in one launch (the chunks' offsets
  come from a prefix scan inside the kernel); the decode is one launch of
  the wire expand kernel. The reference keeps the assembly between the
  chunks in XLA ops outside its ``pallas_call``, which XLA fuses; eager
  torch would launch each op, so the port's kernels take it in. Each kernel
  wrapper takes its plain version for CPU tensors: the chunk-local
  composition (a cumsum over the per-chunk counts, one scatter, one
  gather), independent of the global route.

Both routes are bit-exact against each other and against the reference's
bytes for the same (x, noise, Delta). The noise is a unit draw u (fed) or
a Philox stream key, whose u is :func:`unit_draw`.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import nsd
from repro_torch.quant.registry import as_dtype, dtype_name

DEFAULT_CHUNK = 256  # elements per chunk, the only chunk either route uses
HEADER_BYTES = 4
BACKENDS = ("kernel", "plain")
_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class PackedNSD:
    """An NSD-quantized tensor in wire layout; the tensors stay on their
    device, ``nnz`` and :meth:`wire_bytes` are 0-d int32 tensors (no host
    sync)."""

    levels: torch.Tensor  # int8 (n_chunks * chunk,): non-zero k compacted
    #                       to the front in flat row-major order, zero padded
    bitmap: torch.Tensor  # uint8 (n_chunks, chunk // 8): LSB-first occupancy
    deltas: torch.Tensor  # f32 (n_chunks,): step size per chunk
    nnz: torch.Tensor  # int32 0-d: live prefix length of ``levels``
    shape: Tuple[int, ...] = ()
    dtype: str = "float32"
    chunk: ClassVar[int] = DEFAULT_CHUNK

    @property
    def n_chunks(self) -> int:
        return self.bitmap.shape[0]

    def wire_bytes(self) -> torch.Tensor:
        """Bytes this tensor occupies on the wire (0-d int32)."""
        fixed = HEADER_BYTES + self.n_chunks * (4 + self.chunk // 8)
        return self.nnz + fixed

    def dense_bytes(self) -> int:
        """Bytes of the dense f32 tensor this replaces."""
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * 4


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


# ---------------------------------------------------------------------------
# levels compaction: the plain global route (the kernel route is
# repro_torch.kernels.levels' wire functions)
# ---------------------------------------------------------------------------

def _compact(k_flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move the non-zeros of an int8 vector to the front, in order."""
    n = k_flat.shape[0]
    nz = k_flat != 0
    pos = torch.cumsum(nz.to(torch.int32), 0) - 1
    tgt = torch.where(nz, pos, n).to(torch.int64)  # zeros -> a dropped slot
    levels = torch.zeros(n + 1, dtype=torch.int8, device=k_flat.device)
    levels.scatter_(0, tgt, k_flat.to(torch.int8))
    return levels[:n], nz.sum(dtype=torch.int32)


def _expand(levels: torch.Tensor, mask_flat: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_compact` given the occupancy mask."""
    pos = torch.cumsum(mask_flat.to(torch.int32), 0) - 1
    got = levels[pos.clamp(min=0).to(torch.int64)]
    return torch.where(mask_flat, got, torch.zeros_like(got))


def _check_backend(backend: str) -> bool:
    """True for the kernel route."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    return backend == "kernel"


def _chunk_view(flat: torch.Tensor) -> torch.Tensor:
    """(n,) -> zero-padded (n_chunks, DEFAULT_CHUNK)."""
    pad = (-flat.shape[0]) % DEFAULT_CHUNK
    return (F.pad(flat, (0, pad)) if pad else flat).reshape(-1, DEFAULT_CHUNK)


def unit_draw(key: int, shape, *, device) -> torch.Tensor:
    """The unit draw u (``shape``, f32) that the encode's NSD launch takes
    from stream ``key``: ``repro_torch.kernels.nsd_quant``'s Philox draw
    over the (n_chunks, DEFAULT_CHUNK) view of the flat order."""
    from repro_torch.kernels import nsd_quant

    return nsd_quant.philox_uniform(key, shape, cols=DEFAULT_CHUNK,
                                    device=device)


def pack_indices(k: torch.Tensor, delta: torch.Tensor, shape, dtype, *,
                 backend: str = "kernel") -> PackedNSD:
    """Pack precomputed NSD indices (int8/int32 k) and a scalar Delta."""
    kernel = _check_backend(backend)
    k2d = _chunk_view(k.to(torch.int8).reshape(-1))
    if kernel:
        from repro_torch.kernels import levels as levels_k

        levels, bitmap, nnz = levels_k.levels_compact_wire(k2d)
    else:
        bitmap = pack_bitmap(k2d)
        levels, nnz = _compact(k2d.reshape(-1))
    deltas = delta.to(torch.float32).reshape(1).repeat(k2d.shape[0])
    return PackedNSD(levels=levels, bitmap=bitmap, deltas=deltas, nnz=nnz,
                     shape=tuple(int(d) for d in shape),
                     dtype=dtype_name(dtype))


def pack_nsd(x: torch.Tensor, noise: Union[int, torch.Tensor], s: float, *,
             backend: str = "kernel",
             delta: Optional[torch.Tensor] = None) -> PackedNSD:
    """NSD-quantize ``x`` and lay it out in wire format: Delta = s * std(x)
    (population std, f32) unless ``delta`` is given,
    k = clip(floor((x + u * Delta) / Delta + 1/2), +-127) over the flat
    (row-major) order of ``x``, with ``noise`` either the unit draw u (x's
    shape) or a stream key whose draw is :func:`unit_draw`.

    The kernel route runs one NSD launch on x as it stands (zeros in the
    padding of the last chunk) and lays its k out with one launch of the
    wire compact kernel.
    """
    from repro_torch.kernels import nsd_quant

    fed = isinstance(noise, torch.Tensor)
    if fed and noise.shape != x.shape:
        raise ValueError(f"pack_nsd: noise {tuple(noise.shape)} is not the "
                         f"shape of x {tuple(x.shape)}")
    kernel = _check_backend(backend)
    if delta is None:
        delta = nsd.compute_delta(x, s)
    delta = delta.to(torch.float32).reshape(())
    if not kernel:
        u = noise if fed else nsd_quant.philox_uniform_plain(
            noise, x.shape, cols=DEFAULT_CHUNK, device=x.device)
        return pack_indices(nsd.nsd_indices(x, u, delta), delta, x.shape,
                            x.dtype, backend=backend)
    route = {"noise": nsd.dither_noise(noise, delta)} if fed else {"key": noise}
    q = nsd_quant.nsd_quantize(x.to(torch.float32).contiguous(), delta,
                               cols=DEFAULT_CHUNK, bitmap=False, **route)
    k2d = q.k[:-(-x.numel() // DEFAULT_CHUNK)]
    return pack_indices(k2d, delta, x.shape, x.dtype, backend=backend)


def unpack_indices(p: PackedNSD, *, backend: str = "kernel") -> torch.Tensor:
    """The int8 k of a packed tensor, (n_chunks * chunk,) flat, padding
    included."""
    if _check_backend(backend):
        from repro_torch.kernels import levels as levels_k

        return levels_k.levels_expand_wire(p.levels, p.bitmap).reshape(-1)
    return _expand(p.levels, unpack_bitmap(p.bitmap).reshape(-1))


def unpack_nsd(p: PackedNSD, *, backend: str = "kernel") -> torch.Tensor:
    """Reconstruct the dequantized tensor from wire layout alone."""
    k = unpack_indices(p, backend=backend)
    vals = (k.to(torch.float32).reshape(p.n_chunks, p.chunk)
            * p.deltas[:, None]).reshape(-1)
    n = 1
    for d in p.shape:
        n *= int(d)
    return vals[:n].reshape(p.shape).to(as_dtype(p.dtype))
