"""Port parity for the ``--program`` front door
(``repro_torch.launch.program``) against ``repro.launch.program``: section
splitting, the round trip, the deprecated per-DSL flags and their
conflicts, and the resolution of the sections the port has. The ``comm:``
and ``quant:`` sections split as in the reference but raise when resolved
(not ported)."""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro.launch import program as jprog  # noqa: E402
from repro_torch.core.policy import DitherPolicy  # noqa: E402
from repro_torch.core.schedule import parse_program as parse_dither  # noqa: E402
from repro_torch.launch import program  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.memory.policy import parse_memory_program  # noqa: E402

FULL = ("dither: phase@0=off;phase@30=paper;rule lm_head:off "
        "memory: default=nsd;rule fc0:int8 "
        "comm: topology=butterfly;pods=4;bucket_bytes=1048576")
SPECS = [FULL, "dither: rule lm_head:off rule fc0:int8",
         "comm:topology=ring;s=2.0", "memory: default=int8",
         "dither:phase@0=off quant: grad=int4@g32;mu=m8;nu=u8",
         "memory: default=nsd dither: phase@0=kernel;rule lm_head:off",
         "  dither:   s=lin(2,6,4.0,2.0)   ", "", "dither:"]
BAD = ["phase@0=off;phase@30=paper", "dither: a=b dither: c=d", "s=1 dither: a"]


def _fields(spec):
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("spec", SPECS)
def test_split_and_round_trip_match_reference(spec):
    got, want = program.parse_program(spec), jprog.parse_program(spec)
    assert _fields(got) == _fields(want)
    assert program.format_program(got) == jprog.format_program(want)
    assert program.parse_program(program.format_program(got)) == got


@pytest.mark.parametrize("spec", BAD)
def test_parse_errors_match_reference(spec):
    with pytest.raises(ValueError) as jerr:
        jprog.parse_program(spec)
    with pytest.raises(ValueError) as err:
        program.parse_program(spec)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("flags", [
    ("", "phase@0=off", ""), ("comm: s=2.0", "", "default=nsd"),
    ("", "phase@0=off;rule lm_head:off", "default=int8"),
    ("dither: phase@0=off", "", ""), ("", "", "")])
def test_legacy_flags_merge_and_warn_as_reference(flags):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jprog.merge_legacy_flags(*flags)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = program.merge_legacy_flags(*flags)
    assert _fields(got) == _fields(want)
    assert [str(x.message) for x in w] == [str(x.message) for x in jw]
    assert all(x.category is DeprecationWarning for x in w)


@pytest.mark.parametrize("flags", [
    ("dither: phase@0=off", "phase@0=paper", ""),
    ("memory: default=nsd", "", "default=int8")])
def test_legacy_conflicts_are_errors_as_reference(flags):
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError) as jerr:
        jprog.merge_legacy_flags(*flags)
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError) as err:
        program.merge_legacy_flags(*flags)
    assert str(err.value) == str(jerr.value)


def test_sections_resolve_through_their_parsers():
    spec = program.parse_program(
        "dither: phase@0=off;phase@2=kernel;rule lm_head:off "
        "memory: default=nsd;rule L.mlp.*:fp32")
    base = DitherPolicy(variant="paper", s=3.0)
    assert spec.dither_program(base) == parse_dither(
        "phase@0=off;phase@2=kernel;rule lm_head:off", base=base)
    assert spec.memory_policy() == parse_memory_program(
        "default=nsd;rule L.mlp.*:fp32")
    empty = program.parse_program("comm: s=1.0")
    assert empty.dither_program(base) is None and empty.memory_policy() is None
    assert spec.comm_policy() is None and spec.quant_overrides() is None


@pytest.mark.parametrize("spec,item", [
    ("comm: topology=ring", "item 7.5"), ("quant: mu=m8", "item 1")])
def test_unported_sections_raise(spec, item):
    s = program.parse_program(spec)
    with pytest.raises(NotImplementedError, match=item):
        s.comm_policy() if s.comm else s.quant_overrides()
    with pytest.raises(NotImplementedError, match=item):
        launch_train.main(["--arch", "gemma-2b", "--steps", "1",
                           "--device", "cpu", "--program", spec])
