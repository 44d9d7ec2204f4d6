"""Built-in codecs of the residual store, and the facade over them.

Counterpart of ``repro.quant.codecs`` for the five residual modes
(``MODES``):

    fp32         identity passthrough (the parity arm)
    remat        a storage mode, not a format: identity here; the dithered
                 ops rerun the forward in the backward instead of storing
    bf16         2-byte truncation
    int8         affine per-row: q = round((x - min_row) / scale_row) - 128,
                 scale_row = range_row / 255, rows over the LAST axis
    nsd[@S]      the paper's operator in the wire layout
                 (``repro_torch.quant.wire``), s = S (default 1.0)

and ``nsd_int8``, NSD to a dense (int8 k, f32 Delta) pair (the comm
wire's ``int8`` mode). ``int8_absmax``, ``int4@gG``, ``m8`` and ``u8`` are
not ported yet.

A conv residual is encoded in the reference's NHWC order (the caller
permutes), so an ``nsd`` container is byte-identical to the reference's and
the ``int8`` rows are its channel rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import nsd
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

_TINY = torch.finfo(torch.float32).tiny


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


def _rows_cols(shape) -> Tuple[int, int]:
    cols = int(shape[-1]) if shape else 1
    return _nelems(shape) // cols, cols


def _no_param(name: str, param: str) -> None:
    if param:
        raise ValueError(f"codec {name!r} takes no @-parameter, got "
                         f"{param!r}")


class Fp32Codec(Codec):
    name = "fp32"
    needs_noise = False

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

    def make_spec(self, param: str) -> QuantSpec:
        _no_param(self.name, param)
        return QuantSpec(codec=self.name, bits=16, layout="dense")

    def encode(self, spec, x, noise=None):
        return Bf16Residual(data=x.to(torch.bfloat16), dtype=dtype_name(x.dtype))

    def decode(self, spec, enc):
        return enc.data.to(as_dtype(enc.dtype))

    def stored_nbytes(self, spec, shape, dtype) -> int:
        return _nelems(shape) * 2


class Int8RowAffineCodec(Codec):
    name = "int8"
    needs_noise = False

    def make_spec(self, param: str) -> QuantSpec:
        _no_param(self.name, param)
        return QuantSpec(codec=self.name, bits=8, granularity="row",
                         layout="row-affine")

    def encode(self, spec, x, noise=None):
        cols = x.shape[-1] if x.dim() else 1
        x2 = x.to(torch.float32).reshape(-1, cols)
        lo = x2.amin(1, keepdim=True)
        hi = x2.amax(1, keepdim=True)
        scale = torch.clamp(hi - lo, min=_TINY) / 255.0
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


class NsdCodec(Codec):
    """The paper's operator in the wire layout; see
    ``repro_torch.quant.wire``. Encode and decode run the kernel route."""

    name = "nsd"
    needs_noise = True

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


register(Fp32Codec())
register(RematMode())
register(Bf16Codec())
register(Int8RowAffineCodec())
register(NsdCodec())


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
