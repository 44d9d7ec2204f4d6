"""Per-layer residual-memory policy: which codec (or remat) each layer gets.

Counterpart of ``repro.memory.policy``. ``MemoryPolicy`` holds ordered
glob/substring rules, last match wins, selecting a residual mode (a
registered codec spec of ``repro_torch.quant``) per layer name. Resolution
happens in :meth:`repro_torch.core.policy.DitherCtx.resolve`, which stamps
the mode onto the layer's resolved policy (``DitherPolicy.residual``). A
layer whose dither resolution is None (policy off or excluded) runs plain
autograd with its own dense residuals.

CLI surface (``--memory-program`` on ``repro_torch.train.classifier``, the
``memory:`` section of the LM launcher's ``--program``)::

    default=nsd;rule fc0:int8;rule c*:remat;rule fc2:fp32
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from repro_torch.core.schedule import pattern_matches
from repro_torch.quant.codecs import MODE_FP32, validate_mode

# a literal, not a __doc__ slice: -OO strips docstrings
_SPEC_DOC = """\
clauses separated by ';':
  default=MODE          base mode for every dithered layer (default fp32)
  rule PATTERN:MODE     per-layer override; glob when the pattern contains
                        */?/[, substring otherwise; last match wins
MODE: any registered quant codec spec (repro_torch.quant.codec_names()),
      fp32 | bf16 | int8 | nsd | nsd@S | remat
"""


@dataclasses.dataclass(frozen=True)
class MemoryRule:
    """``pattern -> residual mode`` for the matching layers."""

    pattern: str = "*"
    mode: str = MODE_FP32

    def __post_init__(self):
        if not self.pattern:
            raise ValueError("MemoryRule: pattern must be a non-empty string")
        try:
            validate_mode(self.mode)
        except ValueError as e:
            raise ValueError(f"MemoryRule({self.pattern!r}): {e}") from None

    def matches(self, name: str) -> bool:
        return pattern_matches(self.pattern, name)


@dataclasses.dataclass(frozen=True)
class MemoryPolicy:
    """Ordered per-layer residual rules over a default mode."""

    default: str = MODE_FP32
    rules: Tuple[MemoryRule, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        try:
            validate_mode(self.default)
        except ValueError as e:
            raise ValueError(f"MemoryPolicy: {e}") from None

    def mode_for(self, name: str) -> str:
        mode = self.default
        for rule in self.rules:
            if rule.matches(name):
                mode = rule.mode
        return mode


def parse_memory_program(spec: str) -> MemoryPolicy:
    """Parse the ``--memory-program`` spec string (grammar in ``_SPEC_DOC``,
    printed in every parse error)."""
    default = MODE_FP32
    rules = []
    for clause in (c.strip() for c in spec.split(";")):
        if not clause:
            continue
        if clause.startswith("rule "):
            body = clause[len("rule "):]
            if ":" not in body:
                raise ValueError(
                    f"memory-program clause {clause!r}: rule syntax is "
                    f"'rule PATTERN:MODE'; grammar:\n{_SPEC_DOC}")
            pattern, mode = body.split(":", 1)
            rules.append(MemoryRule(pattern=pattern.strip(),
                                    mode=mode.strip()))
            continue
        if clause.startswith("default="):
            default = clause[len("default="):].strip()
            validate_mode(default)
            continue
        raise ValueError(
            f"memory-program: cannot parse clause {clause!r}; grammar:\n"
            + _SPEC_DOC)
    return MemoryPolicy(default=default, rules=tuple(rules))


def as_memory_policy(x: Union[None, str, MemoryPolicy]
                     ) -> Optional[MemoryPolicy]:
    """Lift a spec string (or pass through a MemoryPolicy / None)."""
    if x is None or isinstance(x, MemoryPolicy):
        return x
    if isinstance(x, str):
        return parse_memory_program(x) if x else None
    raise TypeError(
        f"expected MemoryPolicy, spec string or None, got {type(x)!r}")
