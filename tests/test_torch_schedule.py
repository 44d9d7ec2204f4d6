"""Port parity for the policy programs (``repro_torch.core.schedule``)
against ``repro.core.schedule``: the spec parser, phase policies, the
per-layer resolution of variant and knobs over a set of layer names and
steps, the schedules, and the error cases.

Knob values are compared as f32: the reference evaluates its schedules in
f32 on the traced step, the port in the same f32 arithmetic on the host.
They are held to one f32 ulp (XLA may fuse a ramp's multiply-add into one
FMA; the port rounds twice); every value met here agrees exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.policy import DitherCtx as JCtx, DitherPolicy as JPolicy  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro_torch.core import schedule as sched  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy, fold_in, name_salt  # noqa: E402

# the reference's tests/test_schedule.py specs, the launcher's own and the
# card's programs, a rule that turns layers on under an "off" base
SPECS = [
    "phase@0=off;phase@30=paper;s=lin(30,200,4.0,2.0);rule lm_head:off;"
    "rule L*.mlp.*:s=3.0",
    "phase@0=off;phase@30=paper;s=lin(30,200,4.0,2.0);"
    "k_frac=step(0:0.1,50:0.05);rule lm_head:off;"
    "rule L*.mlp.*:s=3.0,row_alpha=0.5",
    "phase@0=off;phase@10=paper,s=3.0,k_frac=0.2;phase@20=int8,row_alpha=0.5",
    "s=lin(0,10,4.0,2.0);rule fc:off",
    "rule fc1:variant=meprop,k_frac=0.3;rule fc*:s=step(0:1.5,5:3.0)",
    "phase@0=off;phase@2=kernel;s=lin(2,6,4.0,2.0);rule lm_head:off",
    "phase@0=off;phase@1=kernel;rule lm_head:off",
    "rule L.attn.*:variant=paper;rule L.attn.o:off",
    "phase@0=row;row_alpha=lin(0,4,0.5,2.0);rule L*.mlp.*:variant=meprop",
    "",
]
BASES = [dict(), dict(variant="off", s=3.0), dict(variant="kernel", s=1.5),
         dict(exclude=("fc2", "down"))]
NAMES = ["L.attn.q", "L.attn.k", "L.attn.o", "L.mlp.gate", "L.mlp.down",
         "lm_head", "fc1", "fc2", "conv"]
STEPS = [0, 1, 2, 3, 5, 9, 10, 19, 20, 29, 30, 31, 50, 100, 200, 250]


def _knobs(pol):
    return np.array([pol.s, pol.meprop_k_frac, pol.row_alpha], np.float32)


def _programs(spec, base):
    return (jsched.parse_program(spec, JPolicy(**base)),
            sched.parse_program(spec, DitherPolicy(**base)))


@pytest.mark.parametrize("base", BASES, ids=lambda b: ",".join(
    f"{k}={v}" for k, v in b.items()) or "default")
@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_phase_policy_and_resolution_match_reference(spec, base):
    jprog, prog = _programs(spec, base)
    assert prog.rules_enable == jprog.rules_enable
    key = jax.random.PRNGKey(0)
    for step in STEPS:
        jph, ph = jprog.phase_policy_at(step), prog.phase_policy_at(step)
        assert ph.variant == jph.variant, (step,)
        np.testing.assert_array_equal(_knobs(ph), _knobs(jph))
        assert prog.step_enabled(ph) == jprog.step_enabled(jph)
        jctx = JCtx.for_step(key, step, jph, program=jprog)
        ctx = DitherCtx(ph, step=step, program=prog, device="cpu")
        for name in NAMES:
            jr, r = jctx.resolve(name), ctx.resolve(name)
            assert (r is None) == (jr is None), (step, name)
            if r is None:
                continue
            assert r.variant == jr.spec.variant, (step, name)
            np.testing.assert_array_max_ulp(_knobs(r), np.asarray(jr.knobs),
                                            maxulp=1)


@pytest.mark.parametrize("x", [
    sched.Const(0.3), sched.Piecewise(((0, 4.0), (5, 2.5), (9, 1.1))),
    sched.Linear(2, 6, 4.0, 2.0), sched.Linear(30, 200, 4.0, 2.0),
    sched.Linear(0, 7, 0.1, 0.9)], ids=repr)
def test_schedules_match_reference(x):
    jx = {sched.Const: lambda: jsched.Const(x.value),
          sched.Piecewise: lambda: jsched.Piecewise(x.points),
          sched.Linear: lambda: jsched.Linear(x.start_step, x.end_step,
                                              x.start, x.end)}[type(x)]()
    for step in range(-2, 240):
        got = np.float32(x.at(step))
        assert got == x.at(step)  # an f32 value, exactly
        np.testing.assert_array_max_ulp(got, np.asarray(jx.at(step)), maxulp=1)


@pytest.mark.parametrize("pattern", ["L*.mlp.*", "lm_head", "attn", "fc[12]",
                                     "L.?ttn.q", "*", "mlp.up"])
def test_pattern_matches_reference(pattern):
    for name in NAMES + ["L.mlp.up", "fc12"]:
        assert sched.pattern_matches(pattern, name) == \
            jsched.pattern_matches(pattern, name)


ERRORS = ["bogus", "s=lin(1,2)", "rule fc:wat=1", "phase@0=bogus,s=2.0",
          "phase@0=paper,wat=1.0", "rule fc:row_alpha=lin(0,5,1.0,-1.0)",
          "s=-1.0", "phase@5=paper;phase@5=int8", "rule fc1:s=0",
          "k_frac=1.5", "phase@3=paper,s=-2.0", "rule fc1",
          "rule fc1:variant=wat", "s=step(0:1.0,bad)", "s=lin(5,5,1.0,2.0)",
          "s=step(5:1.0,2:2.0)", "phase@1=paper,s"]


@pytest.mark.parametrize("spec", ERRORS)
def test_errors_match_reference(spec):
    with pytest.raises(ValueError) as jerr:
        jsched.parse_program(spec)
    with pytest.raises(ValueError) as err:
        sched.parse_program(spec)
    assert str(err.value).splitlines()[0] == str(jerr.value).splitlines()[0]


def test_controller_clause_is_not_ported():
    assert jsched.parse_program("controller:target=0.9").controller is not None
    with pytest.raises(NotImplementedError, match="ROADMAP.md section 1, item 3"):
        sched.parse_program("phase@0=paper;controller:target=0.9")


def test_universal_rule_resolves_to_the_base():
    base = DitherPolicy(variant="kernel", s=1.5, collect_stats=True)
    prog = sched.as_program(base).replace(rules=(sched.LayerRule(),))
    ctx = DitherCtx(base, step=7, program=prog, device="cpu")
    assert ctx.resolve("L.mlp.gate") == base
    assert sched.as_program(prog) is prog and sched.as_program(None) is None
    with pytest.raises(TypeError):
        sched.as_program("paper")


def test_step_context_keys_fold_as_the_reference():
    """A context folds the step and the worker into its base key (the
    reference's for_step), with_key replaces it, and a layer's stream is
    fold_in(key, name_salt(name))."""
    base = fold_in(0, 0xD17E)
    ctx = DitherCtx(DitherPolicy(), seed=base, step=5, worker=2, device="cpu")
    assert ctx.key == fold_in(fold_in(base, 5), 2) and ctx.step == 5
    micro = ctx.with_key(fold_in(ctx.key, 1))
    assert micro.cotangent_key("L.mlp.up") == fold_in(
        fold_in(ctx.key, 1), name_salt("L.mlp.up"))
    # every block of the scan shares one name, so one stream a step
    assert micro.cotangent_key("L.mlp.up") != micro.cotangent_key("L.mlp.down")
