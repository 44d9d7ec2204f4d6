"""Port parity for the observability subsystem (``repro_torch.obs``) against
``repro.obs``: the stream schema, the metrics bus (order, suffix reads,
cursors, events, the generation cache, concurrent recorders, device rows
drained to the host), the span tracer, the health monitors and their suite,
the run directory (each package reads the other's) and the offline report,
the JSON log format, and the obs bench's monitor and report results.

Tolerances: none. Rows are f32 on both sides and compare exactly; monitor
events compare as dicts; the two reports of one run directory agree on
every line after the header (which names torch where the reference names
jax).
"""
import json
import logging
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import bus as jbus  # noqa: E402
from repro.obs import monitor as jmon  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import runlog as jrunlog  # noqa: E402
from repro.obs import streams as jstreams  # noqa: E402
from repro_torch.core.nsd import QuantStats  # noqa: E402
from repro_torch.obs import bus as tbus  # noqa: E402
from repro_torch.obs import metrics, monitor, report, runlog, streams  # noqa: E402
from repro_torch.obs.trace import Tracer, annotate  # noqa: E402
from repro_torch.train import obs_bench  # noqa: E402


@pytest.fixture
def bus():
    """A fresh port default bus per test; the old default comes back."""
    old = tbus.get_bus()
    b = tbus.set_bus(tbus.MetricsBus())
    yield b
    tbus.set_bus(old)


@pytest.fixture
def jbus_():
    """A fresh reference default bus per test."""
    old = jbus.get_bus()
    b = jbus.set_bus(jbus.MetricsBus())
    yield b
    jbus.set_bus(old)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def test_builtin_streams_equal_reference():
    got = [(s.name, s.columns, s.description) for s in streams.BUILTIN_STREAMS]
    want = [(s.name, s.columns, s.description)
            for s in jstreams.BUILTIN_STREAMS]
    assert got == want
    assert tbus.MetricsBus().registry.schema() == \
        jbus.MetricsBus().registry.schema()


def test_register_idempotent_by_value(bus):
    s = streams.MetricStream("custom", ("a", "b"), "test stream")
    assert bus.registry.register(s) is not None
    bus.registry.register(streams.MetricStream("custom", ("a", "b"),
                                               "test stream"))
    with pytest.raises(ValueError):
        bus.registry.register(streams.MetricStream("custom", ("a", "c"), "x"))


@pytest.mark.parametrize("name,cols", [("", ("a",)), ("has/slash", ("a",)),
                                       ("nocols", ())])
def test_invalid_stream_names(name, cols):
    with pytest.raises(ValueError):
        streams.MetricStream(name, cols, "")
    with pytest.raises(ValueError):
        jstreams.MetricStream(name, cols, "")


@pytest.mark.parametrize("row", [[1.0, 2.0], torch.ones(2),
                                 (torch.tensor(1.0), 2.0)])
def test_record_arity_validated(bus, row):
    with pytest.raises(ValueError):
        bus.record("dither", "t", row)  # needs 3 columns
    with pytest.raises(KeyError):
        bus.record("no_such_stream", "t", [1.0])


# ---------------------------------------------------------------------------
# the bus
# ---------------------------------------------------------------------------

def test_device_rows_land_after_drain(bus):
    """Emitted tensor rows stay as they are until a reader drains them, and
    then read as f32 rows."""
    for i in range(3):
        bus.emit("dither", "L0", torch.stack([torch.tensor(float(i)),
                                              torch.tensor(4.0),
                                              torch.tensor(0.5)]))
    assert len(bus._pending) == 3
    rows = bus.rows("dither", "L0")
    assert not bus._pending and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, 0], [0.0, 1.0, 2.0])


def test_mixed_rows_round_once_to_f32(bus):
    """A row of device scalars (f32, int64) and host numbers reads as the
    f32 rounding of each value, as ``float(x)`` then f32 would give."""
    big = 2 ** 40 + 3  # not an f32
    vals = [(torch.tensor(big, dtype=torch.int64), 7.0, 3.25),
            (torch.tensor(0.1, dtype=torch.float32), float(big), 1),
            [5, 6, 7]]
    for v in vals:
        bus.record("memory", "m", v)
    want = np.array([[float(big), 7.0, 3.25],
                     [float(torch.tensor(0.1)), float(big), 1.0],
                     [5.0, 6.0, 7.0]], np.float32)
    np.testing.assert_array_equal(bus.rows("memory", "m"), want)


def test_per_tag_ordering_preserved(bus):
    for i in range(20):
        v = torch.tensor(float(i))
        bus.emit("train", "seq", torch.stack([v, v * 10]))
        if i % 3 == 0:
            bus.record("train", "seq2", [float(i), 0.0])
    rows = bus.rows("train", "seq")
    np.testing.assert_array_equal(rows[:, 0], np.arange(20, dtype=np.float32))
    np.testing.assert_array_equal(bus.rows("train", "seq2")[:, 0],
                                  np.arange(0, 20, 3, dtype=np.float32))


def test_stacked_view_cached_per_generation(bus):
    for i in range(50):
        bus.record("train", "t", [float(i), 0.0])
    assert bus.stack_calls == 0
    for _ in range(10):
        r = bus.rows("train", "t")
    assert r.shape == (50, 2)
    assert bus.stack_calls == 1  # one stack for ten reads
    bus.record("train", "t", [50.0, 0.0])
    assert bus.rows("train", "t").shape == (51, 2)
    assert bus.stack_calls == 2


def test_rows_since_stacks_only_suffix(bus):
    for i in range(10):
        bus.record("train", "t", [float(i), 0.0])
    new = bus.rows_since("train", "t", 7)
    assert new.shape == (3, 2)
    np.testing.assert_array_equal(new[:, 0], [7.0, 8.0, 9.0])
    assert bus.rows_since("train", "t", 10).shape == (0, 2)


def test_concurrent_recorders(bus):
    """Threads appending host and device rows to their own and a shared
    tag: no row lost, each thread's order kept (a short switch interval
    forces interleaving)."""
    n_threads, n_rows = 8, 200
    errs = []

    def worker(t):
        try:
            for i in range(n_rows):
                row = ([float(i), float(t)] if i % 2
                       else torch.tensor([float(i), float(t)]))
                bus.record("train", f"w{t}", row)
                bus.record("train", "shared", [float(t), float(i)])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errs
    assert bus.row_count("train", "shared") == n_threads * n_rows
    for t in range(n_threads):
        np.testing.assert_array_equal(bus.rows("train", f"w{t}")[:, 0],
                                      np.arange(n_rows, dtype=np.float32))


def test_events_and_cursors(bus):
    bus.log_event({"kind": "a"})
    bus.log_event({"kind": "b"})
    assert [e["kind"] for e in bus.events()] == ["a", "b"]
    assert [e["kind"] for e in bus.events(1)] == ["b"]
    assert bus.event_count() == 2
    bus.record("train", "t", [0.0, 0.0])
    bus.record("dither", "z", [0.0, 0.0, 0.0])
    bus.record("dither", "a", torch.zeros(3))
    assert bus.cursors() == {("train", "t"): 1, ("dither", "z"): 1,
                             ("dither", "a"): 1}
    assert bus.tags("dither") == ["a", "z"]
    assert bus.streams_present() == ["dither", "train"]
    bus.reset()
    assert bus.cursors() == {} and bus.events() == []


# ---------------------------------------------------------------------------
# obs.metrics over the bus
# ---------------------------------------------------------------------------

def test_metrics_round_trip(bus):
    metrics.emit("fc0", QuantStats(torch.tensor(0.75), torch.tensor(4.0),
                                   torch.tensor(0.25)))
    metrics.emit("fc0", QuantStats(torch.tensor(0.25), torch.tensor(6.0),
                                   torch.tensor(0.5)))
    assert metrics.overall_sparsity() == 0.5
    assert metrics.overall_max_bits() == 6.0
    assert metrics.row_count("fc0") == 2
    np.testing.assert_array_equal(metrics.rows_since("fc0", 1),
                                  [[0.25, 6.0, 0.5]])
    metrics.emit_comm("comm/", torch.tensor(25.0), torch.tensor(100.0))
    assert metrics.comm_summary()["comm/"]["ratio"] == 0.25
    metrics.emit_memory("fc0", torch.tensor(100), 200, 400)
    assert metrics.overall_residual_compression() == 4.0
    assert metrics.memory_summary()["fc0"]["capacity_compression"] == 2.0
    metrics.reset()
    assert metrics.tags() == [] and np.isnan(metrics.overall_sparsity())


def test_metrics_tags_in_first_row_order(bus):
    """The aggregations visit tags in the order of their first row (the
    port's order since its first slice), the bus's ``tags`` sorted."""
    for name in ("fc2", "fc0", "fc1"):
        metrics.emit(name, QuantStats(torch.tensor(0.5), torch.tensor(3.0),
                                      torch.tensor(0.1)))
    assert metrics.tags() == ["fc2", "fc0", "fc1"]
    assert bus.tags("dither") == ["fc0", "fc1", "fc2"]


def test_emit_kernel_fallbacks(bus, monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "KERNEL_FALLBACKS", {"grouped_conv": 3})
    other = tbus.MetricsBus()
    assert metrics.emit_kernel_fallbacks(bus=other) == {"grouped_conv": 3}
    np.testing.assert_array_equal(other.rows("fallback",
                                             "kernels/grouped_conv"), [[3.0]])
    assert bus.cursors() == {}


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_span_paths_and_step_stamp(bus):
    tr = Tracer(bus)
    tr.set_step(7)
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    outer = bus.rows("phase", "outer")
    inner = bus.rows("phase", "outer/inner")
    assert outer.shape == (1, 2) and inner.shape == (1, 2)
    assert outer[0, 0] == 7 and inner[0, 0] == 7
    assert outer[0, 1] >= inner[0, 1] >= 0


def test_span_records_on_exception(bus):
    tr = Tracer(bus)
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    assert bus.row_count("phase", "boom") == 1
    with tr.span("after"):
        pass
    assert bus.row_count("phase", "after") == 1


def test_spans_and_annotate_reach_the_profiler(bus):
    """A span opens a profiler range under its path; ``annotate`` a range
    under its name."""
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer(bus)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("dispatch"):
            with annotate("step/grad"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"dispatch", "step/grad"} <= names


# ---------------------------------------------------------------------------
# monitors: the same rows into both packages give the same events
# ---------------------------------------------------------------------------

# (stream, tag, row) fed before each tick; the pathologies of every
# detector, some persisting (rate-limited), some healthy
def _script():
    nan, inf = float("nan"), float("inf")
    ticks = []
    for step in range(1, 13):
        rows = [("train", "train", [float(step), 3.0 - 0.1 * step])]
        rows.append(("dither", "fc0", [0.95, 4.0, 0.1]))
        rows.append(("dither", "fc1", [0.2 if step > 3 else 0.95, 5.0, 0.2]))
        rows.append(("comm", "step", [90.0 if step > 3 else 10.0, 100.0]))
        rows.append(("memory", "fc0", [350.0 if step > 2 else 50.0, 120.0,
                                       400.0]))
        rows.append(("bound", "reduce", [float(step),
                                         inf if step == 9 else 0.5]))
        if step == 5:
            rows[0] = ("train", "train", [5.0, nan])
        if step == 11:
            rows[0] = ("train", "train", [nan, inf])
        ticks.append(rows)
    return ticks


@pytest.mark.parametrize("setpoint,reemit", [(None, 50), (0.9, 50), (0.9, 3)])
def test_monitor_events_match_reference(bus, jbus_, setpoint, reemit):
    suite = monitor.MonitorSuite(
        monitor.default_monitors(sparsity_setpoint=setpoint, bus=bus),
        reemit_every=reemit, bus=bus)
    jsuite = jmon.MonitorSuite(
        jmon.default_monitors(sparsity_setpoint=setpoint, bus=jbus_),
        reemit_every=reemit, bus=jbus_)
    got, want = [], []
    for step, rows in enumerate(_script(), 1):
        for stream, tag, row in rows:
            bus.record(stream, tag, row)
            jbus_.record(stream, tag, row)
        got += [e.to_dict() for e in suite.tick(step)]
        want += [e.to_dict() for e in jsuite.tick(step)]
    assert got == want
    assert {e["kind"] for e in got} >= {"loss_nonfinite", "comm_ratio_drift",
                                        "residual_compression_drift",
                                        "error_bound_blowup"}
    assert bus.events() == jbus_.events()


def test_monitor_escalation_raises_in_both(bus, jbus_):
    for b, mod in ((bus, monitor), (jbus_, jmon)):
        suite = mod.MonitorSuite([mod.LossMonitor(bus=b)], escalate=True,
                                 bus=b)
        b.record("train", "train", [3.0, float("inf")])
        with pytest.raises(mod.MonitorAlert) as err:
            suite.tick(3)
        assert str(err.value) == "non-finite loss at step 3"


def test_default_monitors_setpoint_arms_sparsity(bus):
    assert [m.kind for m in monitor.default_monitors(bus=bus)] == [
        m.kind for m in jmon.default_monitors()]
    kinds = {m.kind for m in monitor.default_monitors(sparsity_setpoint=0.9,
                                                      bus=bus)}
    assert "sparsity_collapse" in kinds


# ---------------------------------------------------------------------------
# run directories: each package reads the other's, the reports agree
# ---------------------------------------------------------------------------

def _fill(b, tracer_cls):
    for i in range(4):
        b.record("dither", "fc0", [0.9, 4.0, 0.25])
        b.record("dither", "lm_head", [0.99, 5.0, 0.5])
        b.record("comm", "step", [250.0, 1000.0])
        b.record("memory", "fc0", [100.0, 120.0, 400.0])
        b.record("train", "train", [float(i), 3.0 - 0.1 * i])
    b.record("train", "train", [4.0, float("nan")])  # -> null
    tr = tracer_cls(b)
    for step in range(3):
        tr.set_step(step)
        for name in ("data", "dispatch", "controller"):
            b.record("phase", name, [float(step), 0.01 * (step + 1)])
    b.log_event({"kind": "loss_nonfinite", "severity": "critical",
                 "step": 4, "message": "non-finite loss at step 4",
                 "value": float("nan"), "threshold": float("inf"), "tag": ""})


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_run_dirs_cross_read_and_reports_agree(bus, jbus_, tmp_path, writer):
    from repro.obs.trace import Tracer as JTracer

    rd = str(tmp_path / "run")
    ctx = {"tool": "test", "arch": "toy"}
    if writer == "reference":
        rl = jrunlog.RunLog(rd, bus=jbus_, context=ctx)
        _fill(jbus_, JTracer)
    else:
        rl = runlog.RunLog(rd, bus=bus, context=ctx)
        _fill(bus, Tracer)
    assert rl.flush() == 31 and rl.flush() == 0
    m, s = runlog.read_run(rd)
    jm, js = jrunlog.read_run(rd)
    assert (m, s) == (jm, js)
    assert m["context"] == ctx and s["train"][4]["loss"] is None
    assert s["monitor"][0]["value"] is None
    version = "torch_version" if writer == "port" else "jax_version"
    assert version in m and m["streams"]["dither"] == [
        "sparsity", "bits", "delta"]
    for fname in os.listdir(rd):
        with open(os.path.join(rd, fname)) as f:
            text = f.read()
        assert "NaN" not in text and "Infinity" not in text
    got, want = report.render(rd).splitlines(), jreport.render(rd).splitlines()
    assert got[1:] == want[1:]
    assert got[0].startswith(f"run {m['run_id']}  [git ")
    assert "torch" in got[0]


def test_incremental_flush(bus, tmp_path):
    rl = runlog.RunLog(str(tmp_path / "run"), bus=bus)
    bus.record("train", "t", [0.0, 1.0])
    assert rl.flush() == 1
    bus.emit("train", "t", torch.tensor([1.0, 2.0]))
    bus.record("comm", "t", [10.0, 100.0])
    assert rl.flush() == 2
    _, s = runlog.read_run(str(tmp_path / "run"))
    assert len(s["train"]) == 2 and len(s["comm"]) == 1


@pytest.mark.parametrize("const", ["NaN", "Infinity", "-Infinity"])
def test_read_rejects_nonstrict_json(bus, tmp_path, const):
    rd = str(tmp_path / "run")
    runlog.RunLog(rd, bus=bus)
    with open(os.path.join(rd, "train.jsonl"), "w") as f:
        f.write('{"tag": "t", "step": 1, "loss": %s}\n' % const)
    with pytest.raises(ValueError):
        runlog.read_run(rd)
    with pytest.raises(ValueError):
        jrunlog.read_run(rd)


def test_run_obs_lifecycle(bus, tmp_path, monkeypatch):
    monkeypatch.setattr(runlog, "FLUSH_EVERY", 2)
    rd = str(tmp_path / "run")
    obs = runlog.run_obs(rd, context={"t": 1}, bus=bus)
    obs.set_step(0)
    with obs.span("dispatch"):
        pass
    obs.on_step(1, {"loss": 1.5})
    assert not os.path.exists(os.path.join(rd, "train.jsonl"))
    obs.on_step(2, {"loss": float("nan")})
    assert len(runlog.read_run(rd)[1]["train"]) == 2  # flushed at step 2
    obs.finish()
    _, s = runlog.read_run(rd)
    assert len(s["train"]) == 2 and s["train"][1]["loss"] is None
    assert any(e["kind"] == "loss_nonfinite" for e in s["monitor"])
    assert any(r["tag"] == "monitor" for r in s["phase"])


def test_report_cli(bus, tmp_path, capsys):
    rd = str(tmp_path / "run")
    rl = runlog.RunLog(rd, bus=bus)
    bus.record("train", "train", [1.0, 2.0])
    rl.close()
    assert report.main([rd]) == 0
    assert "train: 1 steps, loss 2.0000 (step 1)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# JSON logging
# ---------------------------------------------------------------------------

def test_json_log_mode_carries_context(monkeypatch):
    from repro_torch.utils.logging import (JsonFormatter, get_logger,
                                           get_log_context, set_log_context)

    monkeypatch.setenv("REPRO_LOG_FORMAT", "json")
    log = get_logger("repro_torch.test_json_mode")
    assert isinstance(log.handlers[0].formatter, JsonFormatter)
    set_log_context(run_id="r123", step=7)
    try:
        assert get_log_context() == {"run_id": "r123", "step": 7}
        rec = log.makeRecord(log.name, logging.INFO, "f", 1, "hello %s",
                             ("world",), None)
        obj = json.loads(log.handlers[0].formatter.format(rec))
    finally:
        set_log_context(run_id=None, step=None)
    assert obj["msg"] == "hello world" and obj["level"] == "INFO"
    assert obj["run_id"] == "r123" and obj["step"] == 7


def test_default_log_mode(monkeypatch):
    from repro_torch.utils.logging import JsonFormatter, get_logger

    monkeypatch.delenv("REPRO_LOG_FORMAT", raising=False)
    log = get_logger("repro_torch.test_default_mode")
    assert not isinstance(log.handlers[0].formatter, JsonFormatter)
    assert not log.propagate


# ---------------------------------------------------------------------------
# the obs bench (its training results run on the card in chip_smoke.py)
# ---------------------------------------------------------------------------

def test_obs_bench_monitor_trips_exact():
    r = obs_bench.monitor_trip()
    assert r.derived == {"loss_trips": 1.0, "sparsity_trips": 1.0,
                         "rate_limited_reemits": 0.0, "escalate_raised": 1.0}


def test_obs_bench_report_render_at_few_steps(bus):
    """The report run at 4 steps: 3 dither and 3 memory rows a step, one
    phase and one train row (the quick recipe's 25 steps give 152)."""
    r = obs_bench.report_render(steps=4, device="cpu")
    assert r.derived["jsonl_lines"] == 6 * 4 + 2
    assert all(r.derived[f"has_{s}"] == 1.0
               for s in ("dither", "memory", "phase", "train"))
    assert 50.0 < r.derived["overall_sparsity_pct"] < 100.0
    assert tbus.get_bus() is bus  # the default bus came back
