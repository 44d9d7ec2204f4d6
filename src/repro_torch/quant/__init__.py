"""repro_torch.quant: the quantization engine of the residual store.

Counterpart of ``repro.quant`` for the five residual modes:

    spec.py      QuantSpec IR
    registry.py  Codec base class, registration, the parse_spec front door
    codecs.py    fp32 / remat / bf16 / int8 / nsd and the facade below
    wire.py      the packed NSD wire layout (bitmap + compacted levels),
                 plain and kernel routes
"""
from repro_torch.quant import wire
from repro_torch.quant.codecs import (
    DEFAULT_NSD_S,
    MODE_BF16,
    MODE_FP32,
    MODE_INT8,
    MODE_NSD,
    MODE_REMAT,
    MODES,
    RESID_SALT,
    Bf16Residual,
    Int8Residual,
    capacity_bytes,
    decode,
    encode,
    measured_bytes,
    needs_noise,
    parse_mode,
    quantize,
    stored_nbytes,
    validate_mode,
)
from repro_torch.quant.registry import (
    Codec,
    codec_names,
    dense_nbytes,
    get_codec,
    parse_spec,
    register,
)
from repro_torch.quant.spec import QuantSpec

__all__ = [
    "DEFAULT_NSD_S", "MODE_BF16", "MODE_FP32", "MODE_INT8", "MODE_NSD",
    "MODE_REMAT", "MODES", "RESID_SALT", "Bf16Residual", "Int8Residual",
    "capacity_bytes", "decode", "encode", "measured_bytes", "needs_noise",
    "parse_mode", "quantize", "stored_nbytes", "validate_mode",
    "Codec", "codec_names", "dense_nbytes", "get_codec", "parse_spec",
    "register", "QuantSpec", "wire",
]
