"""Built-in codecs of the quant engine, and the facade over them.

Counterpart of ``repro.quant.codecs``:

    fp32         identity passthrough (the parity arm)
    remat        a storage mode, not a format: identity here; the dithered
                 ops rerun the forward in the backward instead of storing
    bf16         2-byte truncation
    int8         affine per-row: q = round((x - min_row) / scale_row) - 128,
                 scale_row = range_row / 255, rows over the LAST axis
    nsd[@S]      the paper's operator in the wire layout
                 (``repro_torch.quant.wire``), s = S (default 1.0)
    int8_absmax  per-tensor symmetric absmax int8 (``core/int8``'s
                 operands); stochastic rounding when given noise
    int4[@gG]    4-bit grouped scale: two values a byte, one f32 scale per
                 G elements of the flat order (default 32), round to nearest
    m8           optimizer momentum: per-row symmetric absmax int8
    u8           optimizer second moment: per-row absmax uint8 of sqrt(v)
                 (v >= 0), decoded as the square

and ``nsd_int8``, NSD to a dense (int8 k, f32 Delta) pair (the comm
wire's ``int8`` mode), and ``nsd_fakequant``, the NSD round trip k * Delta.
Rows are prod(shape[:-1]); a 0-d tensor is one row of one. The arithmetic
is the reference's: f32 throughout, true divisions and round half to even.

A conv residual is encoded in the reference's NHWC order (the caller
permutes), so an ``nsd`` container is byte-identical to the reference's and
the ``int8`` rows are its channel rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import int8 as int8lib
from repro_torch.core import nsd
from repro_torch.device import div
from repro_torch.quant import wire
from repro_torch.quant.registry import (Codec, _nelems, as_dtype,
                                        dense_nbytes, dtype_name, get_codec,
                                        parse_spec, register)
from repro_torch.quant.spec import QuantSpec

# "nsd" residuals want fidelity (they feed the weight-gradient product), so
# the default dither scale is gentler than the gradient side's s = 2.
DEFAULT_NSD_S = 1.0

# Salt of the residual-encode noise stream, so the activation dither draws
# independently of the backward's cotangent dither
# (``repro_torch.core.policy.DitherCtx.resid_noise``).
RESID_SALT = 0x4E5D

DEFAULT_INT4_GROUP = 32

_TINY = torch.finfo(torch.float32).tiny

Noise = Optional[Union[int, torch.Tensor]]


def absmax_int8(x: torch.Tensor, noise: Noise = None) -> int8lib.QuantTensor:
    """Per-tensor absmax int8 (``core/int8``'s operands); stochastic
    rounding when ``noise`` is given: a unit draw u ~ U(-1/2, 1/2) of x's
    shape, or a stream key whose draw is ``nsd_quant.philox_uniform`` over
    x's (rows, shape[-1]) view (one launch of the draw kernel on the card).
    """
    if isinstance(noise, int):
        from repro_torch.kernels import nsd_quant

        noise = nsd_quant.philox_uniform(noise, x.shape, device=x.device)
    return int8lib._quantize_int8(x, noise)


def nsd_fakequant(x: torch.Tensor, noise: Union[int, torch.Tensor],
                  s: float) -> torch.Tensor:
    """The NSD round trip Delta * k in x's dtype, Delta = s * std(x): the
    values the ``nsd`` codec's decode must give for the same ``noise`` (the
    unit draw of x's shape, or a stream key whose draw is the wire's,
    ``wire.unit_draw``), computed elementwise in f32 ops."""
    if isinstance(noise, int):
        noise = wire.unit_draw(noise, x.shape, device=x.device)
    delta = nsd.compute_delta(x, s)
    k = nsd.nsd_indices(x, noise, delta)
    return (k.to(torch.float32) * delta).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Bf16Residual:
    data: torch.Tensor  # bf16, original shape
    dtype: str = "float32"

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)


@dataclasses.dataclass(frozen=True)
class Int8Residual:
    """Affine per-row int8: value ~= (q + 128) * scale + lo, row-wise."""

    q: torch.Tensor  # int8 (rows, cols), rows = prod(shape[:-1])
    scale: torch.Tensor  # f32 (rows, 1): range / 255 (guarded > 0)
    lo: torch.Tensor  # f32 (rows, 1): per-row minimum
    shape: Tuple[int, ...] = ()
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class Int4Grouped:
    """4-bit grouped scale: ``packed[g, b]`` holds elements 2b (low nibble)
    and 2b + 1 (high nibble) of group g, each the unsigned code q + 8 of
    q = round(x / scale_g) in [-7, 7]."""

    packed: torch.Tensor  # uint8 (n_groups, group // 2)
    scale: torch.Tensor  # f32 (n_groups, 1): absmax / 7 (guarded > 0)
    shape: Tuple[int, ...] = ()
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RowQuant8:
    """Per-row symmetric absmax int8: value ~= q * scale, row-wise."""

    q: torch.Tensor  # int8 (rows, cols)
    scale: torch.Tensor  # f32 (rows, 1): absmax / 127 (guarded > 0)
    shape: Tuple[int, ...] = ()
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SqrtRowQuant8:
    """Sqrt-domain per-row uint8 of a non-negative tensor:
    v ~= (q * scale)^2."""

    q: torch.Tensor  # uint8 (rows, cols): round(sqrt(v) / scale)
    scale: torch.Tensor  # f32 (rows, 1): max_row sqrt(v) / 255 (guarded > 0)
    shape: Tuple[int, ...] = ()
    dtype: str = "float32"


def _rows_cols(shape) -> Tuple[int, int]:
    cols = int(shape[-1]) if shape else 1
    return _nelems(shape) // cols, cols


def _no_param(name: str, param: str) -> None:
    if param:
        raise ValueError(f"codec {name!r} takes no @-parameter, got "
                         f"{param!r}")


def _rows2d(x: torch.Tensor) -> torch.Tensor:
    """x in f32 as (rows, last axis); a 0-d tensor as (1, 1)."""
    return x.to(torch.float32).reshape(-1, x.shape[-1] if x.dim() else 1)


def _per_elem(scale: torch.Tensor, stored, shape) -> torch.Tensor:
    """A per-row (or per-group) bound broadcast over the ``stored`` code
    shape and cut back to the tensor's ``shape``."""
    return scale.expand(stored).reshape(-1)[:_nelems(shape)].reshape(shape)


class Fp32Codec(Codec):
    name = "fp32"
    needs_noise = False
    takes_noise = False

    def make_spec(self, param: str) -> QuantSpec:
        _no_param(self.name, param)
        return QuantSpec(codec=self.name, bits=32, layout="dense")

    def encode(self, spec, x, noise=None):
        return x

    def decode(self, spec, enc):
        return enc

    def stored_nbytes(self, spec, shape, dtype) -> int:
        return dense_nbytes(shape, dtype)


class RematMode(Fp32Codec):
    """Not a format: the dithered ops rerun the forward instead of storing.
    Registered so ``"remat"`` validates through the one front door; identity
    and dense accounting here (remat keeps the op's inputs alive)."""

    name = "remat"


def nsd_int8(x: torch.Tensor, noise: Union[int, torch.Tensor], s: float
             ) -> nsd.QuantizedGrad:
    """NSD to (int8 k of x's shape, f32 Delta = s * std(x)): the dense
    counterpart of the wire's ``pack_nsd``, the same k for the same
    ``noise`` (a stream key or the unit draw u); one NSD launch on a CUDA
    tensor."""
    delta = nsd.compute_delta(x, s).reshape(())
    k2d = wire.quantize_chunks(x, noise, delta)
    return nsd.QuantizedGrad(k=k2d.reshape(-1)[:x.numel()].reshape(x.shape),
                             delta=delta)


class Bf16Codec(Codec):
    name = "bf16"
    needs_noise = False
    takes_noise = False

    def make_spec(self, param: str) -> QuantSpec:
        _no_param(self.name, param)
        return QuantSpec(codec=self.name, bits=16, layout="dense")

    def encode(self, spec, x, noise=None):
        return Bf16Residual(data=x.to(torch.bfloat16), dtype=dtype_name(x.dtype))

    def decode(self, spec, enc):
        return enc.data.to(as_dtype(enc.dtype))

    def stored_nbytes(self, spec, shape, dtype) -> int:
        return _nelems(shape) * 2

    def error_bound(self, spec, enc):
        # bf16 keeps 8 significand bits: |x - bf16(x)| <= 2^-8 |x|, so in
        # terms of the decoded value the safe bound is 2^-7 |decoded|
        return self.decode(spec, enc).abs() * 2.0 ** -7


class Int8RowAffineCodec(Codec):
    name = "int8"
    needs_noise = False
    takes_noise = False

    def make_spec(self, param: str) -> QuantSpec:
        _no_param(self.name, param)
        return QuantSpec(codec=self.name, bits=8, granularity="row",
                         layout="row-affine")

    def encode(self, spec, x, noise=None):
        cols = x.shape[-1] if x.dim() else 1
        x2 = x.to(torch.float32).reshape(-1, cols)
        lo = x2.amin(1, keepdim=True)
        hi = x2.amax(1, keepdim=True)
        scale = div(torch.clamp(hi - lo, min=_TINY), 255.0)
        # true division and round half to even, as jnp.round does
        q = torch.round((x2 - lo) / scale) - 128.0
        q = torch.clamp(q, -128, 127).to(torch.int8)
        return Int8Residual(q=q, scale=scale, lo=lo, shape=tuple(x.shape),
                            dtype=dtype_name(x.dtype))

    def decode(self, spec, enc):
        x2 = (enc.q.to(torch.float32) + 128.0) * enc.scale + enc.lo
        return x2.reshape(enc.shape).to(as_dtype(enc.dtype))

    def stored_nbytes(self, spec, shape, dtype) -> int:
        rows, _ = _rows_cols(shape)
        return _nelems(shape) + rows * 8  # q int8 + per-row (scale, lo) f32

    def error_bound(self, spec, enc):
        return _per_elem(enc.scale * 0.5, enc.q.shape, enc.shape)


class NsdCodec(Codec):
    """The paper's operator in the wire layout; see
    ``repro_torch.quant.wire``. Encode and decode run the kernel route."""

    name = "nsd"
    needs_noise = True
    takes_noise = True

    def make_spec(self, param: str) -> QuantSpec:
        s = float(param) if param else DEFAULT_NSD_S
        if not s > 0:
            raise ValueError(f"nsd spec: s must be > 0, got {s}")
        return QuantSpec(codec=self.name, bits=8, granularity="chunk",
                         dither="uniform", layout="bitmap+levels", param=s,
                         chunk=wire.DEFAULT_CHUNK)

    def encode(self, spec, x, noise):
        if noise is None:
            raise ValueError("nsd encode needs a stream key or a unit noise "
                             "draw (dithered codec)")
        return wire.pack_nsd(x, noise, spec.param)

    def decode(self, spec, enc):
        return wire.unpack_nsd(enc)

    def stored_nbytes(self, spec, shape, dtype) -> int:
        chunk = wire.DEFAULT_CHUNK
        padded = ((_nelems(shape) + chunk - 1) // chunk) * chunk
        # levels capacity + bitmap + per-chunk deltas + nnz scalar
        return padded + padded // 8 + 4 * (padded // chunk) + 4

    def measured_bytes(self, spec, enc) -> torch.Tensor:
        return enc.wire_bytes()

    def error_bound(self, spec, enc):
        # |x + nu - Delta k| <= Delta / 2 and |nu| <= Delta / 2, so the error
        # is under Delta for every element that the clip of k leaves alone
        n = _nelems(enc.shape)
        per_elem = enc.deltas[:, None].expand(enc.n_chunks, enc.chunk)
        return per_elem.reshape(-1)[:n].reshape(enc.shape)

    def compute_on_packed(self, spec, enc, x, w):
        """Both backward products of y = x @ w from the packed 2-D
        cotangent ``enc`` (T, N): decode, then dx = g~ w^T and dW = x^T g~
        in f32 (the reference's ``jnp`` route; x (..., K), w (K, N))."""
        g2d = self.decode(spec, enc).to(torch.float32)
        x2d = x.reshape(-1, x.shape[-1]).to(torch.float32)
        dx = (g2d @ w.to(torch.float32).t()).reshape(x.shape)
        dw = x2d.t() @ g2d
        return dx.to(x.dtype), dw.to(w.dtype)


class Int8AbsmaxCodec(Codec):
    """Per-tensor symmetric absmax int8 (``core/int8`` lineage)."""

    name = "int8_absmax"
    needs_noise = False  # noise optional: stochastic rounding
    takes_noise = True

    def make_spec(self, param: str) -> QuantSpec:
        _no_param(self.name, param)
        return QuantSpec(codec=self.name, bits=8, dither="stochastic-round",
                         layout="dense")

    def encode(self, spec, x, noise=None):
        return absmax_int8(x, noise)

    def decode(self, spec, enc):
        return enc.q.to(torch.float32) * enc.scale

    def stored_nbytes(self, spec, shape, dtype) -> int:
        return _nelems(shape) + 4

    def capacity_bytes(self, spec, enc) -> int:
        return enc.q.numel() + 4

    def error_bound(self, spec, enc):
        # scale / 2 when rounding to nearest; stochastic rounding adds u in
        # [-1/2, 1/2) first, so one scale bounds both
        return enc.scale.expand(enc.q.shape)


class Int4GroupedCodec(Codec):
    """4-bit grouped scale over the flat order, zero-padded to whole
    groups."""

    name = "int4"
    needs_noise = False
    takes_noise = False

    def make_spec(self, param: str) -> QuantSpec:
        raw = param.lstrip("g") if param else ""
        group = int(raw) if raw else DEFAULT_INT4_GROUP
        if group < 2 or group % 2:
            raise ValueError(
                f"int4 spec: group must be even and >= 2, got {group}")
        return QuantSpec(codec=self.name, bits=4, granularity="group",
                         group=group, layout="grouped", param=float(group))

    def encode(self, spec, x, noise=None):
        g = spec.group
        flat = x.to(torch.float32).reshape(-1)
        g2 = F.pad(flat, (0, (-flat.shape[0]) % g)).reshape(-1, g)
        scale = div(torch.clamp(g2.abs().amax(1, keepdim=True), min=_TINY),
                    7.0)
        v = (torch.clamp(torch.round(g2 / scale), -7, 7) + 8).to(torch.uint8)
        return Int4Grouped(packed=v[:, 0::2] | (v[:, 1::2] << 4), scale=scale,
                           shape=tuple(x.shape), dtype=dtype_name(x.dtype))

    def decode(self, spec, enc):
        lo = (enc.packed & 0xF).to(torch.int32) - 8
        hi = (enc.packed >> 4).to(torch.int32) - 8
        q = torch.stack([lo, hi], -1).reshape(enc.packed.shape[0], -1)
        vals = (q.to(torch.float32) * enc.scale).reshape(-1)
        return (vals[:_nelems(enc.shape)].reshape(enc.shape)
                .to(as_dtype(enc.dtype)))

    def stored_nbytes(self, spec, shape, dtype) -> int:
        g = spec.group
        n_groups = -(-_nelems(shape) // g)
        return n_groups * (g // 2) + 4 * n_groups  # nibbles + f32 scales

    def error_bound(self, spec, enc):
        return _per_elem(enc.scale * 0.5, (enc.scale.shape[0], spec.group),
                         enc.shape)


class M8MomentCodec(Codec):
    """Optimizer momentum: per-row symmetric absmax int8, deterministic."""

    name = "m8"
    needs_noise = False
    takes_noise = False

    def make_spec(self, param: str) -> QuantSpec:
        _no_param(self.name, param)
        return QuantSpec(codec=self.name, bits=8, granularity="row",
                         layout="row-affine")

    def encode(self, spec, x, noise=None):
        x2 = _rows2d(x)
        scale = div(torch.clamp(x2.abs().amax(1, keepdim=True), min=_TINY),
                    127.0)
        q = torch.clamp(torch.round(x2 / scale), -127, 127).to(torch.int8)
        return RowQuant8(q=q, scale=scale, shape=tuple(x.shape),
                         dtype=dtype_name(x.dtype))

    def decode(self, spec, enc):
        x2 = enc.q.to(torch.float32) * enc.scale
        return x2.reshape(enc.shape).to(as_dtype(enc.dtype))

    def stored_nbytes(self, spec, shape, dtype) -> int:
        rows, _ = _rows_cols(shape)
        return _nelems(shape) + rows * 4

    def error_bound(self, spec, enc):
        return _per_elem(enc.scale * 0.5, enc.q.shape, enc.shape)


class U8SqrtMomentCodec(Codec):
    """Optimizer second moment: sqrt-domain per-row uint8 (v >= 0)."""

    name = "u8"
    needs_noise = False
    takes_noise = False

    def make_spec(self, param: str) -> QuantSpec:
        _no_param(self.name, param)
        return QuantSpec(codec=self.name, bits=8, granularity="row",
                         layout="row-affine")

    def encode(self, spec, x, noise=None):
        r = torch.sqrt(torch.clamp(_rows2d(x), min=0.0))
        scale = div(torch.clamp(r.amax(1, keepdim=True), min=_TINY), 255.0)
        q = torch.clamp(torch.round(r / scale), 0, 255).to(torch.uint8)
        return SqrtRowQuant8(q=q, scale=scale, shape=tuple(x.shape),
                             dtype=dtype_name(x.dtype))

    def decode(self, spec, enc):
        r = enc.q.to(torch.float32) * enc.scale
        return torch.square(r).reshape(enc.shape).to(as_dtype(enc.dtype))

    def stored_nbytes(self, spec, shape, dtype) -> int:
        rows, _ = _rows_cols(shape)
        return _nelems(shape) + rows * 4

    def error_bound(self, spec, enc):
        # |v - v^| = |r - r^| (r + r^) <= (s / 2)(2 r^ + s / 2), with the
        # r-domain error <= s / 2 and r <= r^ + s / 2
        s = enc.scale.expand(enc.q.shape)
        r_hat = enc.q.to(torch.float32) * enc.scale
        return ((s * 0.5) * (2.0 * r_hat + s * 0.5)).reshape(enc.shape)


register(Fp32Codec())
register(RematMode())
register(Bf16Codec())
register(Int8RowAffineCodec())
register(NsdCodec())
register(Int8AbsmaxCodec())
register(Int4GroupedCodec())
register(M8MomentCodec())
register(U8SqrtMomentCodec())


MODE_FP32 = "fp32"
MODE_BF16 = "bf16"
MODE_INT8 = "int8"
MODE_NSD = "nsd"
MODE_REMAT = "remat"
MODES = (MODE_FP32, MODE_BF16, MODE_INT8, MODE_NSD, MODE_REMAT)
_IDENTITY = (MODE_FP32, MODE_REMAT)


def parse_mode(mode: str) -> Tuple[str, float]:
    """``"nsd@0.5"`` -> ("nsd", 0.5); other specs get (codec, 0.0)."""
    try:
        spec = parse_spec(mode)
    except ValueError as e:
        if "unknown codec" in str(e):
            raise ValueError(
                f"unknown residual mode {mode!r}; a registered quant codec "
                f"spec (see repro_torch.quant.codec_names)") from None
        raise
    return spec.codec, spec.param if spec.codec == MODE_NSD else 0.0


def validate_mode(mode: str) -> str:
    parse_mode(mode)
    return mode


def needs_noise(mode: str) -> bool:
    """Whether :func:`encode` under ``mode`` needs a stream key or unit draw."""
    return get_codec(parse_spec(mode).codec).needs_noise


def takes_noise(mode: str) -> bool:
    """Whether :func:`encode` under ``mode`` uses noise when given it."""
    return get_codec(parse_spec(mode).codec).takes_noise


def encode(mode: str, x: torch.Tensor,
           noise: Optional[Union[int, torch.Tensor]] = None):
    """Encode under a spec string; fp32/remat return ``x`` itself. ``noise``
    is a stream key or a unit draw (see ``repro_torch.quant.registry``)."""
    spec = parse_spec(mode)
    if spec.codec in _IDENTITY:
        return x
    return get_codec(spec.codec).encode(spec, x, noise)


def decode(mode: str, enc) -> torch.Tensor:
    """Inverse of :func:`encode` (exact for fp32/remat, bounded otherwise)."""
    spec = parse_spec(mode)
    if spec.codec in _IDENTITY:
        return enc
    return get_codec(spec.codec).decode(spec, enc)


def quantize(mode: str, x: torch.Tensor,
             noise: Optional[Union[int, torch.Tensor]] = None) -> torch.Tensor:
    """decode(encode(x)): the fake-quant round trip."""
    return decode(mode, encode(mode, x, noise))


def stored_nbytes(mode: str, shape, dtype) -> int:
    """Shape-static bytes the encoding occupies on the device (capacity)."""
    spec = parse_spec(mode)
    return get_codec(spec.codec).stored_nbytes(spec, shape, dtype)


def capacity_bytes(mode: str, enc) -> int:
    """Static device-resident bytes of a concrete encoding."""
    spec = parse_spec(mode)
    if spec.codec in _IDENTITY:
        return dense_nbytes(enc.shape, enc.dtype)
    return get_codec(spec.codec).capacity_bytes(spec, enc)


def measured_bytes(mode: str, enc):
    """Occupancy-aware bytes: the wire figure (a 0-d int32 tensor on the
    encoding's device) for nsd, the static capacity (an int) otherwise."""
    spec = parse_spec(mode)
    if spec.codec in _IDENTITY:
        return dense_nbytes(enc.shape, enc.dtype)
    return get_codec(spec.codec).measured_bytes(spec, enc)


def error_bound(mode: str, enc) -> Optional[torch.Tensor]:
    """Per-element |decode - x| upper bound, or None when exact."""
    spec = parse_spec(mode)
    if spec.codec in _IDENTITY:
        return None
    return get_codec(spec.codec).error_bound(spec, enc)
