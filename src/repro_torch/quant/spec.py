"""`QuantSpec`: the quantization IR every codec resolves to.

Counterpart of ``repro.quant.spec``. A spec string like ``"int8"`` or
``"nsd@0.5"`` parses (through ``repro_torch.quant.registry.parse_spec``)
into one frozen :class:`QuantSpec` describing what the encoded
representation is:

    codec        registry name ("fp32", "bf16", "int8", "nsd", ...)
    bits         payload bits per element (32, 16, 8, 4)
    granularity  scale granularity: "tensor" | "row" | "group" | "chunk"
    group        elements per scale group (granularity == "group")
    dither       "none" | "uniform" (NSD) | "stochastic-round"
    layout       "dense" | "row-affine" | "grouped" | "bitmap+levels"
    param        the codec's @-parameter (the NSD scale s)
    chunk        wire chunk size (layout == "bitmap+levels")

The spec is pure data; the behaviour lives on the registered codec.
"""
from __future__ import annotations

import dataclasses

GRANULARITIES = ("tensor", "row", "group", "chunk")
DITHERS = ("none", "uniform", "stochastic-round")
LAYOUTS = ("dense", "row-affine", "grouped", "bitmap+levels")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """One quantization format, fully resolved (see module docstring)."""

    codec: str
    bits: int = 32
    granularity: str = "tensor"
    group: int = 0
    dither: str = "none"
    layout: str = "dense"
    param: float = 0.0
    chunk: int = 0

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(
                f"granularity {self.granularity!r}: one of {GRANULARITIES}")
        if self.dither not in DITHERS:
            raise ValueError(f"dither {self.dither!r}: one of {DITHERS}")
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout {self.layout!r}: one of {LAYOUTS}")
        if self.granularity == "group" and self.group < 1:
            raise ValueError(
                f"group granularity needs group >= 1, got {self.group}")
