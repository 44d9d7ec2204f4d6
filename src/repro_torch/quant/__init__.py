"""repro_torch.quant: the one quantization engine.

Counterpart of ``repro.quant``. Cotangents (``DitherPolicy.grad_codec``),
the residual store (``repro_torch.memory``), the comm wire and optimizer
moments (``OptConfig.mu_codec`` / ``nu_codec``) resolve spec strings
through :func:`parse_spec` and call the capabilities below:

    spec.py      QuantSpec IR
    registry.py  Codec base class, registration, the parse_spec front door
    codecs.py    fp32 / remat / bf16 / int8 / nsd / int8_absmax / int4 /
                 m8 / u8, the facade below and nsd_int8 (the comm wire's
                 dense int8 mode)
    program.py   the ``quant:`` section of ``--program``
    wire.py      the packed NSD wire layout (bitmap + compacted levels),
                 plain and kernel routes
"""
from repro_torch.quant import wire
from repro_torch.quant.codecs import (
    DEFAULT_INT4_GROUP,
    DEFAULT_NSD_S,
    MODE_BF16,
    MODE_FP32,
    MODE_INT8,
    MODE_NSD,
    MODE_REMAT,
    MODES,
    RESID_SALT,
    Bf16Residual,
    Int4Grouped,
    Int8Residual,
    RowQuant8,
    SqrtRowQuant8,
    absmax_int8,
    capacity_bytes,
    decode,
    encode,
    error_bound,
    measured_bytes,
    needs_noise,
    nsd_fakequant,
    nsd_int8,
    parse_mode,
    quantize,
    stored_nbytes,
    takes_noise,
    validate_mode,
)
from repro_torch.quant.program import (
    QuantProgram,
    format_quant_program,
    parse_quant_program,
)
from repro_torch.quant.registry import (
    Codec,
    codec_names,
    dense_nbytes,
    get_codec,
    parse_spec,
    register,
    validate_spec,
)
from repro_torch.quant.spec import QuantSpec

__all__ = [
    "DEFAULT_INT4_GROUP", "DEFAULT_NSD_S", "MODE_BF16", "MODE_FP32",
    "MODE_INT8", "MODE_NSD", "MODE_REMAT", "MODES", "RESID_SALT",
    "Bf16Residual", "Int4Grouped", "Int8Residual", "RowQuant8",
    "SqrtRowQuant8", "absmax_int8", "capacity_bytes", "decode", "encode",
    "error_bound", "measured_bytes", "needs_noise", "nsd_fakequant",
    "nsd_int8", "parse_mode", "quantize", "stored_nbytes", "takes_noise",
    "validate_mode",
    "Codec", "codec_names", "dense_nbytes", "get_codec", "parse_spec",
    "register", "validate_spec",
    "QuantProgram", "format_quant_program", "parse_quant_program",
    "QuantSpec", "wire",
]
