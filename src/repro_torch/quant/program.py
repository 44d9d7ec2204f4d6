"""The ``quant:`` section of the ``--program`` DSL.

Counterpart of ``repro.quant.program``. One place to pick codecs for every
quantization surface of a run::

    quant: grad=int4@g32;resid=int8;mu=m8;nu=u8

keys (each optional, ';'-separated, every value a registered codec spec):
  grad=SPEC    cotangent codec (``DitherPolicy.grad_codec``: replaces the
               variant's built-in NSD quantizer on dithered layers)
  wire=SPEC    default per-leaf comm mode (``CommPolicy.default``)
  resid=SPEC   default residual mode (shorthand for
               ``memory: default=SPEC``; an explicit memory section as well
               is an error, not a silent preference)
  mu=SPEC      stored first-moment codec (``OptConfig.mu_codec``;
               deterministic codecs only)
  nu=SPEC      stored second-moment codec (``OptConfig.nu_codec``)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.quant.registry import get_codec, parse_spec, validate_spec

_KEYS = ("grad", "wire", "resid", "mu", "nu")

_SPEC_DOC = """\
';'-separated key=SPEC clauses; keys: grad (cotangent codec), wire (comm
default mode), resid (residual default mode), mu / nu (stored optimizer
moment codecs, deterministic only). Every SPEC is a registered quant codec
spec, e.g. int4@g32, nsd@0.5, m8, u8.
"""


@dataclasses.dataclass(frozen=True)
class QuantProgram:
    """A parsed ``quant:`` section; None = surface not overridden."""

    grad: Optional[str] = None
    wire: Optional[str] = None
    resid: Optional[str] = None
    mu: Optional[str] = None
    nu: Optional[str] = None

    def __bool__(self) -> bool:
        return any(getattr(self, k) is not None for k in _KEYS)


def parse_quant_program(spec: str) -> QuantProgram:
    """Parse ``grad=...;wire=...;...`` into a validated QuantProgram."""
    out = {}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        key, sep, value = clause.partition("=")
        key = key.strip()
        value = value.strip()
        if not sep or not value or key not in _KEYS:
            raise ValueError(
                f"cannot parse quant clause {clause!r}; expected key=SPEC "
                f"with key in {_KEYS}\n{_SPEC_DOC}")
        if key in out:
            raise ValueError(f"duplicate quant key {key!r}")
        validate_spec(value)
        if key in ("mu", "nu") and get_codec(
                parse_spec(value).codec).needs_noise:
            raise ValueError(
                f"quant clause {clause!r}: moment codecs must be "
                f"deterministic (no RNG stream at re-encode)")
        out[key] = value
    return QuantProgram(**out)


def format_quant_program(qp: QuantProgram) -> str:
    """Render back to section text (parsing it round-trips)."""
    return ";".join(f"{k}={getattr(qp, k)}" for k in _KEYS
                    if getattr(qp, k) is not None)
