"""The codec registry: one entry point from spec strings to capabilities.

Counterpart of ``repro.quant.registry``. A :class:`Codec` owns every
capability of one quantization format:

    make_spec(param)                    "@param" grammar -> QuantSpec
    encode(spec, x, noise)              tensor -> encoded container
    decode(spec, enc)                   inverse (exact or bounded)
    stored_nbytes(spec, shape, dtype)   static device capacity of the encoding
    capacity_bytes(spec, enc)           static bytes of a concrete encoding
    measured_bytes(spec, enc)           occupancy-aware bytes (wire figure)
    error_bound(spec, enc)              per-element |decode - x| upper bound,
                                        or None when the round trip is exact
    compute_on_packed(...)              optional: consume the packed form
                                        directly (nsd: both backward products)

Where the reference passes an RNG key, the port passes ``noise``: a
Philox stream key (an int, ``DitherCtx.resid_key``; the nsd codec's kernel
route draws u ~ U(-1/2, 1/2) inside its NSD launch, its plain route draws
the same numbers in torch), or a unit draw tensor over the tensor's shape,
the seam through which tests feed the reference's own draw
(``DitherCtx.resid_noise``). ``needs_noise`` (the reference's
``needs_key``) says encode cannot run without it; codecs with
``needs_noise = False`` are deterministic and usable for optimizer
moments, which re-encode every step with no stream. ``takes_noise`` says
encode uses it when given: ``int8_absmax`` rounds stochastically then, as
the reference does when handed a key.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.quant.spec import QuantSpec

DType = Union[torch.dtype, str]


def _nelems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def as_dtype(dtype: DType) -> torch.dtype:
    """A torch dtype from a dtype or its name ("float32", "bfloat16")."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def dtype_name(dtype: DType) -> str:
    return str(as_dtype(dtype)).removeprefix("torch.")


def dense_nbytes(shape, dtype: DType) -> int:
    """Bytes the dense tensor occupies (what an encoding replaces)."""
    return _nelems(shape) * as_dtype(dtype).itemsize


class Codec:
    """Base class: one registered quantization format (see module doc)."""

    name: str = ""
    needs_noise: bool = True
    takes_noise: bool = True

    def make_spec(self, param: str) -> QuantSpec:
        raise NotImplementedError

    def encode(self, spec: QuantSpec, x: torch.Tensor,
               noise: Optional[Union[int, torch.Tensor]]):
        raise NotImplementedError

    def decode(self, spec: QuantSpec, enc) -> torch.Tensor:
        raise NotImplementedError

    def stored_nbytes(self, spec: QuantSpec, shape, dtype) -> int:
        raise NotImplementedError

    def capacity_bytes(self, spec: QuantSpec, enc) -> int:
        return self.stored_nbytes(spec, enc.shape, enc.dtype)

    def measured_bytes(self, spec: QuantSpec, enc):
        return self.capacity_bytes(spec, enc)

    def error_bound(self, spec: QuantSpec, enc) -> Optional[torch.Tensor]:
        """Per-element upper bound on |decode(enc) - x|; None = exact."""
        return None

    def compute_on_packed(self, spec: QuantSpec, enc, *operands):
        raise NotImplementedError(
            f"codec {self.name!r} has no compute_on_packed capability")


_REGISTRY: Dict[str, Codec] = {}


def register(codec: Codec) -> Codec:
    if not codec.name:
        raise ValueError("codec must set a name")
    if codec.name in _REGISTRY:
        raise ValueError(f"codec {codec.name!r} already registered")
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: {codec_names()}") from None


def codec_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@functools.lru_cache(maxsize=None)
def parse_spec(mode: str) -> QuantSpec:
    """Resolve a spec string (``"nsd@0.5"``, ``"int4@g32"``) to a
    QuantSpec: the codec before ``@`` must be registered, and its
    ``make_spec`` owns the parameter grammar."""
    kind, _, param = mode.partition("@")
    return get_codec(kind).make_spec(param)


def validate_spec(mode: str) -> str:
    parse_spec(mode)
    return mode
