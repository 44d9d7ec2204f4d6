"""Policy programs: per-layer, step-scheduled dithered backprop.

Counterpart of ``repro.core.schedule`` (its rules, phases, schedules and
the ``--policy-program`` grammar):

* :class:`LayerRule`: ``pattern -> per-layer overrides`` of the variant and
  the knobs (``s``, ``meprop_k_frac``, ``row_alpha``). A pattern is a glob
  when it holds glob characters, a substring otherwise; for each knob the
  last matching rule that sets it wins.
* schedules (:class:`Const`, :class:`Piecewise`, :class:`Linear`): a knob
  as a function of the step.
* :class:`PhaseSpec`: the variant (and knob defaults) from a step on.
* :class:`PolicyProgram`: the three over a base ``DitherPolicy``;
  :meth:`PolicyProgram.phase_policy_at` gives a step's base policy and
  :meth:`PolicyProgram.resolve_layer` one layer's policy at a step.

Knobs are host numbers here: a schedule is evaluated on the host at the
step, in f32 arithmetic as the reference evaluates it on the traced step,
and the layer's ``DitherPolicy`` carries the value. (The reference traces
its knobs so that a ramp never recompiles; PyTorch runs eagerly, so there is
nothing to recompile. A captured CUDA graph of the step would need them in
device memory, with the Philox key.)

Not ported yet: the closed-loop ``SparsityController`` with its
``ControllerDriver``, ``TelemetryWindow`` and ``discover_layer_names``
(the ``controller:`` clause raises ``NotImplementedError``).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.policy import (VARIANT_OFF, VARIANTS, DitherPolicy,
                                     validate_knob_values)

__all__ = ["Const", "Piecewise", "Linear", "eval_schedule",
           "pattern_matches", "LayerRule", "PhaseSpec", "PolicyProgram",
           "as_program", "parse_program"]

_F32 = np.float32
CONTROLLER_TODO = ("the sparsity controller (controller: clause) is not "
                   "ported yet: ROADMAP.md section 1, item 3")


# ---------------------------------------------------------------------------
# step schedules (host floats, f32 arithmetic)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Const:
    """A knob pinned to one value."""

    value: float

    def at(self, step: int) -> float:
        return float(_F32(self.value))


@dataclasses.dataclass(frozen=True)
class Piecewise:
    """Piecewise constant, ``points = ((step0, v0), (step1, v1), ...)``: the
    v of the last boundary <= step (a boundary step takes the new value);
    steps before the first boundary take the first value."""

    points: Tuple[Tuple[int, float], ...]

    def __post_init__(self):
        if not self.points:
            raise ValueError("Piecewise: needs at least one (step, value) point")
        object.__setattr__(self, "points",
                           tuple((int(b), float(v)) for b, v in self.points))
        bounds = [b for b, _ in self.points]
        if bounds != sorted(set(bounds)):
            raise ValueError(
                f"Piecewise: boundaries must be strictly increasing, got {bounds}")

    def at(self, step: int) -> float:
        idx = sum(int(step) >= b for b, _ in self.points) - 1
        return float(_F32(self.points[min(max(idx, 0),
                                          len(self.points) - 1)][1]))


@dataclasses.dataclass(frozen=True)
class Linear:
    """Linear ramp from ``start`` to ``end`` over [start_step, end_step],
    clamped outside it."""

    start_step: int
    end_step: int
    start: float
    end: float

    def __post_init__(self):
        if not self.end_step > self.start_step:
            raise ValueError(
                f"Linear: end_step must be > start_step, got "
                f"[{self.start_step}, {self.end_step}]")

    def at(self, step: int) -> float:
        t = (_F32(step) - _F32(self.start_step)) / _F32(
            self.end_step - self.start_step)
        t = min(max(t, _F32(0.0)), _F32(1.0))
        return float(_F32(self.start) + t * (_F32(self.end) - _F32(self.start)))


ScheduleLike = Union[float, int, Const, Piecewise, Linear]
_SCHEDULE_TYPES = (Const, Piecewise, Linear)


def eval_schedule(x: Optional[ScheduleLike], step: int):
    """A schedule's value at ``step``; a plain number stays as it is."""
    if isinstance(x, _SCHEDULE_TYPES):
        return x.at(step)
    return x


def _schedule_values(x: ScheduleLike) -> Tuple[float, ...]:
    """Every value a schedule can take (a Linear's lie between its ends)."""
    if isinstance(x, Const):
        return (x.value,)
    if isinstance(x, Piecewise):
        return tuple(v for _, v in x.points)
    if isinstance(x, Linear):
        return (x.start, x.end)
    return (float(x),)


def _validate_knob_schedules(s, meprop_k_frac, row_alpha, owner: str) -> None:
    """Range checks over every value a knob's schedule can take."""
    for field, value in (("s", s), ("meprop_k_frac", meprop_k_frac),
                         ("row_alpha", row_alpha)):
        if value is None:
            continue
        for v in _schedule_values(value):
            validate_knob_values(
                v if field == "s" else None,
                v if field == "meprop_k_frac" else None,
                v if field == "row_alpha" else None,
                owner=owner)


# ---------------------------------------------------------------------------
# per-layer rules and phases
# ---------------------------------------------------------------------------

_GLOB_CHARS = re.compile(r"[*?\[]")


def pattern_matches(pattern: str, name: str) -> bool:
    """Glob when the pattern contains glob metacharacters, else substring."""
    if _GLOB_CHARS.search(pattern):
        return fnmatch.fnmatchcase(name, pattern)
    return pattern in name


@dataclasses.dataclass(frozen=True)
class LayerRule:
    """``pattern -> overrides``. Unset (None) fields inherit; ``variant``
    may be "off" to exempt the matching layers."""

    pattern: str = "*"
    variant: Optional[str] = None
    s: Optional[ScheduleLike] = None
    meprop_k_frac: Optional[ScheduleLike] = None
    row_alpha: Optional[ScheduleLike] = None

    def __post_init__(self):
        if not self.pattern:
            raise ValueError("LayerRule: pattern must be a non-empty string")
        if self.variant is not None and self.variant not in VARIANTS:
            raise ValueError(
                f"LayerRule({self.pattern!r}): unknown variant "
                f"{self.variant!r}; one of {VARIANTS}")
        _validate_knob_schedules(self.s, self.meprop_k_frac, self.row_alpha,
                                 owner=f"LayerRule({self.pattern!r})")

    def matches(self, name: str) -> bool:
        return pattern_matches(self.pattern, name)


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """From ``start`` (inclusive) on, run ``variant`` until the next phase.
    Its knob defaults (plain floats) replace the base policy's while it
    is active and carry into later phases that leave them unset; schedules
    and rules override them."""

    start: int
    variant: str
    s: Optional[float] = None
    meprop_k_frac: Optional[float] = None
    row_alpha: Optional[float] = None

    def __post_init__(self):
        if self.start < 0:
            raise ValueError(f"PhaseSpec: start must be >= 0, got {self.start}")
        if self.variant not in VARIANTS:
            raise ValueError(
                f"PhaseSpec@{self.start}: unknown variant {self.variant!r}; "
                f"one of {VARIANTS}")
        validate_knob_values(self.s, self.meprop_k_frac, self.row_alpha,
                             owner=f"PhaseSpec@{self.start}")


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicyProgram:
    """Ordered per-layer rules and step schedules over a base policy.

    Layer ``name`` at step t: the variant is the base's, then the active
    phase's, then that of the last matching rule that sets one ("off"
    exempts the layer); each knob is the base's, then the phase default,
    then the program-level schedule, then the last matching rule's.
    """

    base: DitherPolicy = dataclasses.field(default_factory=DitherPolicy)
    rules: Tuple[LayerRule, ...] = ()
    phases: Tuple[PhaseSpec, ...] = ()
    s: Optional[ScheduleLike] = None
    meprop_k_frac: Optional[ScheduleLike] = None
    row_alpha: Optional[ScheduleLike] = None

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        object.__setattr__(self, "phases", tuple(self.phases))
        starts = [p.start for p in self.phases]
        if starts != sorted(set(starts)):
            raise ValueError(
                f"PolicyProgram: phase starts must be strictly increasing, "
                f"got {starts}")
        _validate_knob_schedules(self.s, self.meprop_k_frac, self.row_alpha,
                                 owner="PolicyProgram")

    def phase_policy_at(self, step: int) -> DitherPolicy:
        """The base policy of step ``step``: the phases' variant and knob
        defaults applied."""
        variant = self.base.variant
        s, kf, ra = self.base.s, self.base.meprop_k_frac, self.base.row_alpha
        for ph in self.phases:
            if int(step) >= ph.start:
                variant = ph.variant
                if ph.s is not None:
                    s = ph.s
                if ph.meprop_k_frac is not None:
                    kf = ph.meprop_k_frac
                if ph.row_alpha is not None:
                    ra = ph.row_alpha
        if (variant, s, kf, ra) == (self.base.variant, self.base.s,
                                    self.base.meprop_k_frac,
                                    self.base.row_alpha):
            return self.base
        return self.base.replace(variant=variant, s=s, meprop_k_frac=kf,
                                 row_alpha=ra)

    @property
    def rules_enable(self) -> bool:
        """Whether a rule pins an enabling variant: such layers dither even
        while the phase's variant is "off"."""
        return any(r.variant not in (None, VARIANT_OFF) for r in self.rules)

    def step_enabled(self, phase_policy: DitherPolicy) -> bool:
        """Whether a step under ``phase_policy`` needs a DitherCtx at all."""
        return phase_policy.enabled or self.rules_enable

    def resolve_layer(self, ctx, name: str) -> Optional[DitherPolicy]:
        """Layer ``name``'s policy at ``ctx.step`` under the phase policy
        ``ctx.policy``, or None for plain backprop."""
        base = ctx.policy
        if any(pat in name for pat in base.exclude):
            return None
        variant = base.variant
        s = self.s if self.s is not None else base.s
        kf = (self.meprop_k_frac if self.meprop_k_frac is not None
              else base.meprop_k_frac)
        ra = self.row_alpha if self.row_alpha is not None else base.row_alpha
        for rule in self.rules:
            if rule.matches(name):
                if rule.variant is not None:
                    variant = rule.variant
                if rule.s is not None:
                    s = rule.s
                if rule.meprop_k_frac is not None:
                    kf = rule.meprop_k_frac
                if rule.row_alpha is not None:
                    ra = rule.row_alpha
        if variant == VARIANT_OFF:
            return None
        return base.replace(variant=variant, s=eval_schedule(s, ctx.step),
                            meprop_k_frac=eval_schedule(kf, ctx.step),
                            row_alpha=eval_schedule(ra, ctx.step))

    def replace(self, **kw) -> "PolicyProgram":
        return dataclasses.replace(self, **kw)


def as_program(policy) -> Optional[PolicyProgram]:
    """Lift a DitherPolicy (or pass a PolicyProgram or None through)."""
    if policy is None or isinstance(policy, PolicyProgram):
        return policy
    if isinstance(policy, DitherPolicy):
        return PolicyProgram(base=policy)
    raise TypeError(
        f"expected DitherPolicy, PolicyProgram or None, got {type(policy)!r}")


# ---------------------------------------------------------------------------
# the spec-string parser (the --program "dither:" section)
# ---------------------------------------------------------------------------

_SPEC_DOC = """\
clauses separated by ';':
  phase@STEP=VARIANT[,KNOB=F...]
                              variant switch from STEP on (off|paper|int8|row|meprop|kernel);
                              optional per-phase knob DEFAULTS (s/k_frac/
                              row_alpha, plain floats) that rules and
                              schedules override
  s=EXPR | k_frac=EXPR | row_alpha=EXPR
                              program-wide knob (EXPR: FLOAT | lin(a,b,v0,v1)
                              | step(b0:v0,b1:v1,...))
  rule PATTERN:A[,A...]       per-layer overrides; A: off | variant=V | s=EXPR
                              | k_frac=EXPR | row_alpha=EXPR. Glob pattern when
                              it contains */?/[, substring otherwise; last
                              matching rule wins per knob.
  controller:target=F[,gain=F][,min=F][,max=F]
                              closed-loop per-layer s (not ported yet)
example:
  phase@0=off;phase@30=paper;s=lin(30,200,4.0,2.0);rule lm_head:off;rule L*.mlp.*:s=3.0
"""

_KNOB_ALIASES = {"s": "s", "k_frac": "meprop_k_frac",
                 "meprop_k_frac": "meprop_k_frac", "row_alpha": "row_alpha"}


def _split_top(text: str, sep: str) -> List[str]:
    """Split on ``sep`` outside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p for p in (p.strip() for p in parts) if p]


def _parse_expr(text: str, clause: str) -> ScheduleLike:
    text = text.strip()
    m = re.fullmatch(r"lin\(([^)]*)\)", text)
    if m:
        args = [a.strip() for a in m.group(1).split(",")]
        if len(args) != 4:
            raise ValueError(
                f"policy-program clause {clause!r}: lin() takes "
                f"(start_step, end_step, v0, v1), got {text!r}")
        return Linear(int(args[0]), int(args[1]), float(args[2]),
                      float(args[3]))
    m = re.fullmatch(r"step\(([^)]*)\)", text)
    if m:
        points = []
        for pt in m.group(1).split(","):
            if ":" not in pt:
                raise ValueError(
                    f"policy-program clause {clause!r}: step() points are "
                    f"STEP:VALUE, got {pt.strip()!r}")
            b, v = pt.split(":", 1)
            points.append((int(b.strip()), float(v.strip())))
        return Piecewise(tuple(points))
    try:
        return float(text)
    except ValueError:
        raise ValueError(
            f"policy-program clause {clause!r}: expected FLOAT, lin(...) or "
            f"step(...), got {text!r}") from None


def _parse_rule(body: str, clause: str) -> LayerRule:
    if ":" not in body:
        raise ValueError(
            f"policy-program clause {clause!r}: rule syntax is "
            f"'rule PATTERN:assign[,assign...]'")
    pattern, assigns = body.split(":", 1)
    kw: Dict[str, object] = {}
    for a in _split_top(assigns, ","):
        if a == "off":
            kw["variant"] = VARIANT_OFF
            continue
        if "=" not in a:
            raise ValueError(
                f"policy-program clause {clause!r}: bad assignment {a!r}")
        k, v = (t.strip() for t in a.split("=", 1))
        if k == "variant":
            kw["variant"] = v
        elif k in _KNOB_ALIASES:
            kw[_KNOB_ALIASES[k]] = _parse_expr(v, clause)
        else:
            raise ValueError(
                f"policy-program clause {clause!r}: unknown rule key {k!r}")
    return LayerRule(pattern=pattern.strip(), **kw)


def parse_program(spec: str, base: Optional[DitherPolicy] = None
                  ) -> PolicyProgram:
    """Parse a policy-program spec string (grammar: ``_SPEC_DOC``, printed
    in every parse error)."""
    base = base if base is not None else DitherPolicy()
    phases: List[PhaseSpec] = []
    rules: List[LayerRule] = []
    knobs: Dict[str, ScheduleLike] = {}
    for clause in _split_top(spec, ";"):
        m = re.fullmatch(r"phase@(\d+)\s*=\s*(.+)", clause)
        if m:
            parts = _split_top(m.group(2), ",")
            kw: Dict[str, float] = {}
            for a in parts[1:]:
                if "=" not in a:
                    raise ValueError(
                        f"policy-program clause {clause!r}: phase knob "
                        f"defaults are KNOB=FLOAT, got {a!r}")
                k, v = (t.strip() for t in a.split("=", 1))
                if k not in _KNOB_ALIASES:
                    raise ValueError(
                        f"policy-program clause {clause!r}: unknown phase "
                        f"knob {k!r} (one of {sorted(_KNOB_ALIASES)})")
                kw[_KNOB_ALIASES[k]] = float(v)
            phases.append(PhaseSpec(int(m.group(1)), parts[0].strip(), **kw))
            continue
        if clause.startswith("rule "):
            rules.append(_parse_rule(clause[len("rule "):], clause))
            continue
        if clause.startswith("controller:"):
            raise NotImplementedError(f"{clause!r}: {CONTROLLER_TODO}")
        if "=" in clause:
            k, v = (t.strip() for t in clause.split("=", 1))
            if k in _KNOB_ALIASES:
                knobs[_KNOB_ALIASES[k]] = _parse_expr(v, clause)
                continue
        raise ValueError(
            f"policy-program: cannot parse clause {clause!r}; grammar:\n"
            + _SPEC_DOC)
    return PolicyProgram(base=base, rules=tuple(rules), phases=tuple(phases),
                         **knobs)
