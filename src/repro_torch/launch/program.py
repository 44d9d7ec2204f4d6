"""One ``--program`` front door for the launcher DSLs.

Counterpart of ``repro.launch.program``. One spec string holds sections::

    --program "dither: phase@0=off;phase@30=paper;rule lm_head:off \\
               memory: default=nsd;rule L*.mlp.*:fp32"

A section starts at a whitespace-separated token that begins with
``dither:``, ``memory:``, ``comm:`` or ``quant:``; everything up to the next
such token belongs to it and goes verbatim to that subsystem's parser
(``repro_torch.core.schedule.parse_program`` for ``dither:``,
``repro_torch.memory.policy.parse_memory_program`` for ``memory:``,
``repro_torch.comm.reducer.parse_comm_program`` for ``comm:``,
``repro_torch.quant.parse_quant_program`` for ``quant:``). This module
only splits; a colon inside a clause (``rule lm_head:off``) never opens a
section. ``--policy-program`` and ``--memory-program`` stay as deprecated
aliases of the first two sections (:func:`merge_legacy_flags`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

SECTIONS = ("dither", "memory", "comm", "quant")

__all__ = ["SECTIONS", "LaunchSpec", "format_program", "merge_legacy_flags",
           "parse_program"]


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """The raw DSL sections of one ``--program`` spec."""

    dither: str = ""
    memory: str = ""
    comm: str = ""
    quant: str = ""

    def dither_program(self, base):
        """The dither section as a PolicyProgram over ``base`` (None if the
        section is empty)."""
        from repro_torch.core.schedule import parse_program as parse_dither
        return parse_dither(self.dither, base=base) if self.dither else None

    def memory_policy(self):
        """The memory section as a MemoryPolicy (None if empty)."""
        if not self.memory:
            return None
        from repro_torch.memory.policy import parse_memory_program
        return parse_memory_program(self.memory)

    def comm_policy(self, base=None):
        """The comm section as a CommPolicy over ``base`` (None if the
        section is empty)."""
        if not self.comm:
            return None
        from repro_torch.comm.reducer import parse_comm_program
        return parse_comm_program(self.comm, base)

    def quant_overrides(self):
        """The quant section as a validated QuantProgram (None if empty)."""
        if not self.quant:
            return None
        from repro_torch.quant import parse_quant_program
        return parse_quant_program(self.quant)


def parse_program(spec: str) -> LaunchSpec:
    """Split a ``--program`` spec into its sections. The spec must start
    with a section marker; a bare DSL string is an error that names the
    legacy flags."""
    sections = {name: [] for name in SECTIONS}
    current: Optional[str] = None
    for tok in spec.split():
        for name in SECTIONS:
            prefix = name + ":"
            if tok.startswith(prefix):
                if sections[name]:
                    raise ValueError(
                        f"duplicate {prefix!r} section in --program spec")
                current = name
                tok = tok[len(prefix):]
                break
        if current is None:
            raise ValueError(
                f"--program spec must start with a section prefix "
                f"({', '.join(s + ':' for s in SECTIONS)}); got {tok!r}. "
                "Migrating from --policy-program? That string goes under "
                "'dither:'; --memory-program under 'memory:'.")
        if tok:
            sections[current].append(tok)
    return LaunchSpec(**{name: " ".join(parts)
                         for name, parts in sections.items()})


def format_program(spec: LaunchSpec) -> str:
    """A LaunchSpec back to ``--program`` text (parsing it round-trips)."""
    parts = []
    for name in SECTIONS:
        body = getattr(spec, name)
        if body:
            parts.append(f"{name}: {body}")
    return " ".join(parts)


def merge_legacy_flags(program: str, policy_program: str = "",
                       memory_program: str = "") -> LaunchSpec:
    """``--program`` with the deprecated per-DSL flags merged in. Each legacy
    flag warns and fills its section; a flag whose section ``--program``
    also sets is an error."""
    spec = parse_program(program) if program else LaunchSpec()
    for flag, field, value in (("--policy-program", "dither",
                                policy_program),
                               ("--memory-program", "memory",
                                memory_program)):
        if not value:
            continue
        warnings.warn(
            f"{flag} is deprecated; use --program \"{field}: {value}\"",
            DeprecationWarning, stacklevel=2)
        if getattr(spec, field):
            raise ValueError(
                f"{flag} conflicts with the '{field}:' section of "
                "--program; specify one")
        spec = dataclasses.replace(spec, **{field: value})
    return spec
