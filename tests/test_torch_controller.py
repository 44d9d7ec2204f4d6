"""Port parity for the closed-loop sparsity controller
(``repro_torch.core.schedule``: ``SparsityController``, ``TelemetryWindow``,
``ControllerDriver``, ``discover_layer_names``) and its callers (the LM
trainer with a run directory, the launcher's ``--run-dir``, the classifier
trainer under a ``PolicyProgram``, the layer-sparsity bench) against
``repro.core.schedule``, ``repro.train`` and ``benchmarks/harness.py``.

Tolerances. The controller's state is bit-equal to the reference's over fed
measurements (the same f32 operations on the same values). A resolved
``s = s0 * exp(log_scale)`` is held at one f32 ulp: the port rounds a
double ``exp`` to f32, XLA's f32 ``exp`` may be an ulp from that. Telemetry windows read the same f32 rows and
agree exactly. A trainer run on the two packages compares the stream names
and row counts of the run directories, not the rows (the draws differ).
A universal-rule program and the plain policy train bit for bit alike.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_model as j_get_smoke  # noqa: E402
from repro.configs import paper_models as jpm  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core.policy import DitherCtx as JCtx, DitherPolicy as JPolicy  # noqa: E402
from repro.data import ClassifConfig as JClassif, classification_batch as j_cbatch  # noqa: E402
from repro.data.synthetic import TokenStreamConfig as JTok, token_batch as j_token_batch  # noqa: E402
from repro.obs import bus as jbus  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import runlog as jrunlog  # noqa: E402
from repro.optim import OptConfig as JOpt  # noqa: E402
from repro.train import Trainer as JTrainer, TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_smoke_model, paper_models  # noqa: E402
from repro_torch.core import schedule as sched  # noqa: E402
from repro_torch.core.nsd import QuantStats  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.data.synthetic import (ClassifConfig, TokenStreamConfig,  # noqa: E402
                                        classification_batch, token_batch)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.cnn import CNN, loss_fn  # noqa: E402
from repro_torch.obs import bus as tbus  # noqa: E402
from repro_torch.obs import metrics, report, runlog  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.train import classifier, layer_sparsity  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402


@pytest.fixture
def buses():
    """Fresh default buses in both packages; the old ones come back."""
    old, jold = tbus.get_bus(), jbus.get_bus()
    pair = tbus.set_bus(tbus.MetricsBus()), jbus.set_bus(jbus.MetricsBus())
    yield pair
    tbus.set_bus(old)
    jbus.set_bus(jold)


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.uint32))


# ---------------------------------------------------------------------------
# the controller's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(target=0.9), dict(target=0.93, gain=4.0),
    dict(target=0.5, gain=3.0, min_scale=0.5, max_scale=2.0),
    dict(target=0.99, gain=0.37, min_scale=0.9, max_scale=1.1)])
def test_update_bit_equal_to_reference(kw):
    """A fed sequence of measurements (runs of 0 and 1 drive the state to
    both clip bounds; random values in between) gives the reference's state
    bit for bit at every tick."""
    rng = np.random.default_rng(0)
    seq = ([0.0] * 12 + [1.0] * 60 + list(rng.uniform(0, 1, 60))
           + [float(np.float32(v)) for v in rng.uniform(0.8, 1.0, 30)]
           + [0.0] * 20)
    names = ["fc0", "fc1", "L.mlp.down"]
    c, jc = sched.SparsityController(**kw), jsched.SparsityController(**kw)
    state, jstate = c.init_state(names), jc.init_state(names)
    assert list(state) == list(jstate) == sorted(names)
    hit = set()
    for i, v in enumerate(seq):
        meas = {"fc0": v, "fc1": 1.0 - v, "other": 0.5}
        if i % 3:
            meas["L.mlp.down"] = v * 0.5
        state, jstate = c.update(state, meas), jc.update(jstate, meas)
        assert set(state) == set(names)
        for n in names:
            assert isinstance(state[n], np.float32)
            assert _bits(state[n]) == _bits(jstate[n]), (i, n)
            hit.add(float(state[n]))
    assert float(np.float32(np.log(kw.get("min_scale", 0.25)))) in hit
    assert float(np.float32(np.log(kw.get("max_scale", 4.0)))) in hit


@pytest.mark.parametrize("kw,match", [
    (dict(target=1.0), r"target must be in \(0, 1\)"),
    (dict(target=0.0), r"target must be in \(0, 1\)"),
    (dict(target=0.9, gain=0.0), "gain must be > 0"),
    (dict(target=0.9, min_scale=1.5), "min_scale <= 1 <= max_scale"),
    (dict(target=0.9, max_scale=0.5), "min_scale <= 1 <= max_scale")])
def test_controller_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match) as err:
        sched.SparsityController(**kw)
    with pytest.raises(ValueError) as jerr:
        jsched.SparsityController(**kw)
    assert str(err.value) == str(jerr.value)


def test_program_with_controller_needs_stats():
    c = sched.SparsityController(target=0.9)
    with pytest.raises(ValueError, match="collect_stats=True"):
        sched.PolicyProgram(base=DitherPolicy(), controller=c)
    prog = sched.PolicyProgram(base=DitherPolicy(collect_stats=True),
                               controller=c)
    assert prog.controller is c


@pytest.mark.parametrize("spec", [
    "s=lin(0,10,4.0,2.0);rule fc0:s=3.0",
    "phase@0=off;phase@2=kernel;s=lin(2,6,4.0,2.0);rule lm_head:off",
    "rule fc*:s=step(0:1.5,5:3.0);rule fc1:variant=int8"])
def test_resolved_s_follows_the_state(spec):
    """Each layer's resolved s is s0 * exp(log_scale) in f32, within one
    ulp of the reference's traced value, over log-scales across the clip
    range; a layer without a log-scale keeps s0."""
    spec += ";controller:target=0.9"
    prog, jprog = sched.parse_program(spec), jsched.parse_program(spec)
    names = ["fc0", "fc1", "fc2", "L.attn.q"]
    scales = np.float32(np.linspace(np.log(0.25), np.log(4.0), 9))
    checked = 0
    for step in (0, 3, 7):
        phase, jphase = prog.phase_policy_at(step), jprog.phase_policy_at(step)
        for ls in scales:
            ctrl = {n: np.float32(ls) for n in names[:3]}
            ctx = DitherCtx(phase, step=step, program=prog, device="cpu",
                            ctrl=ctrl)
            jctx = JCtx.for_step(jax.random.PRNGKey(0), step, jphase,
                                 program=jprog,
                                 ctrl={n: jnp.float32(v) for n, v in ctrl.items()})
            for n in names:
                got, want = ctx.resolve(n), jctx.resolve(n)
                assert (got is None) == (want is None)
                if got is None:
                    continue
                ws = np.float32(np.asarray(want.knobs)[0])
                assert abs(_bits(got.s) - _bits(ws)) <= 1, (n, step, ls)
                assert got.variant == want.spec.variant
                if n == "L.attn.q":  # no log-scale: s0 as it was
                    assert got.s == prog.resolve_layer(DitherCtx(
                        phase, step=step, program=prog, device="cpu"), n).s
                checked += 1
    assert checked > 50


def test_with_key_carries_ctrl_and_recorder():
    rec = set()
    ctx = DitherCtx(DitherPolicy(), device="cpu", ctrl={"fc0": np.float32(1)},
                    recorder=rec)
    sub = ctx.with_key(123)
    assert sub.key == 123 and sub.ctrl is ctx.ctrl and sub.recorder is rec
    sub.resolve("fc9")
    assert rec == {"fc9"}


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "controller:target=0.9",
    "phase@0=paper;controller:target=0.9,gain=3.0,min=0.5,max=2.0",
    "phase@0=off;phase@30=paper;s=lin(30,200,4.0,2.0);rule lm_head:off;"
    "controller:target=0.93,gain=4.0",
    "dummy", "controller:gain=2.0", "controller:target=1.5",
    "controller:target=0.9,wat=1", "controller:target", "controller:"])
@pytest.mark.parametrize("base", [dict(), dict(collect_stats=True),
                                  dict(variant="off", s=3.0)])
def test_parse_controller_matches_reference(spec, base):
    try:
        jprog = jsched.parse_program(spec, JPolicy(**base))
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            sched.parse_program(spec, DitherPolicy(**base))
        assert str(err.value).splitlines()[0] == str(e).splitlines()[0]
        return
    prog = sched.parse_program(spec, DitherPolicy(**base))
    assert dataclasses.asdict(prog.controller) == \
        dataclasses.asdict(jprog.controller)
    assert prog.base.collect_stats and jprog.base.collect_stats
    assert (prog.base.variant, prog.base.s) == (jprog.base.variant,
                                                jprog.base.s)
    assert prog.phases == tuple(sched.PhaseSpec(**dataclasses.asdict(p))
                                for p in jprog.phases)


# ---------------------------------------------------------------------------
# the telemetry window
# ---------------------------------------------------------------------------

def test_window_primes_and_measures_like_reference(buses):
    """Rows recorded before the window exists are not measured; each
    ``measure`` then gives the mean sparsity of the new rows, equal to the
    reference window's on the same rows."""
    tb, jb = buses
    rng = np.random.default_rng(1)

    def feed(n):
        for _ in range(n):
            for tag in ("fc0", "fc1"):
                row = np.float32([rng.uniform(0.6, 1.0), 4.0, 0.1])
                metrics.emit(tag, QuantStats(*map(torch.tensor, row)))
                jb.record("dither", tag, row)

    feed(5)
    win, jwin = sched.TelemetryWindow(), jsched.TelemetryWindow()
    assert win.measure() == {} and jwin.measure() == {}
    for n in (3, 1, 0, 7):
        feed(n)
        got, want = win.measure(), jwin.measure()
        assert got == want and len(got) == (2 if n else 0)
    assert metrics.row_count("fc0") == jmetrics.row_count("fc0") == 16


# ---------------------------------------------------------------------------
# layer-name discovery
# ---------------------------------------------------------------------------

def test_discover_names_lenet300100():
    jm = jpm.lenet300100()
    params, _ = jm.init(jax.random.PRNGKey(0))
    jb = j_cbatch(JClassif(n_classes=10, img_size=28, channels=1), 0, batch=4)
    want = jsched.discover_layer_names(
        lambda p, b, ctx: jm.loss(p, b, ctx=ctx), params, jb)
    cfg = paper_models.lenet300100()
    net = CNN(cfg, seed=0, device="cpu")
    b = classification_batch(ClassifConfig(n_classes=10, img_size=28,
                                           channels=1), 0, 4, device="cpu")
    got = sched.discover_layer_names(
        lambda n, bb, ctx: loss_fn(n, bb, ctx=ctx), net, b, device="cpu")
    assert got == want == ["fc0", "fc1", "fc2"]
    assert all(p.grad is None for p in net.parameters())


def test_discover_names_gemma_smoke():
    jm, m = j_get_smoke("gemma-2b"), get_smoke_model("gemma-2b")
    params, _ = jm.init(jax.random.PRNGKey(0))
    want = jsched.discover_layer_names(
        lambda p, b, ctx: jm.loss(p, b, ctx=ctx), params,
        j_token_batch(JTok(vocab=512, seq_len=16, batch=2), 0))
    net = m.init(0, "cpu")
    got = sched.discover_layer_names(
        lambda n, b, ctx: m.loss(n, b, ctx=ctx), net,
        token_batch(TokenStreamConfig(vocab=512, seq_len=16, batch=2), 0,
                    device="cpu"), device="cpu")
    assert got == want
    assert "lm_head" in got and len(got) == 8


# ---------------------------------------------------------------------------
# the LM trainer and the launcher
# ---------------------------------------------------------------------------

def test_trainer_run_dir_matches_reference(buses, tmp_path, monkeypatch):
    """gemma-2b smoke, 3 steps under ``phase@0=paper;controller:
    target=0.9`` with a run directory on both trainers: the same stream
    files and the same row count in each, spans data / dispatch /
    controller / monitor every step, and the same controller names."""
    from repro.kernels import ops as jops

    monkeypatch.setattr(jops, "KERNEL_FALLBACKS", {})
    monkeypatch.setattr(ops, "KERNEL_FALLBACKS", {})
    spec, steps = "phase@0=paper;controller:target=0.9", 3
    kw = dict(name="adamw", lr=3e-3, schedule="cosine", warmup_steps=1,
              total_steps=steps)
    tcfg = dict(vocab=512, seq_len=16, batch=4)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jt = JTrainer(j_get_smoke("gemma-2b"), JOpt(**kw), JTrainerConfig(
        total_steps=steps, log_every=1),
        policy=jsched.parse_program(spec, JPolicy(s=2.0)),
        obs=jrunlog.run_obs(jdir, context={"tool": "test"}))
    jt.fit(iter([j_token_batch(JTok(**tcfg), i) for i in range(steps)]))
    tr = trainer_mod.Trainer(
        get_smoke_model("gemma-2b"), opt.OptConfig(**kw),
        trainer_mod.TrainerConfig(total_steps=steps, log_every=1),
        policy=sched.parse_program(spec, DitherPolicy(s=2.0)), device="cpu",
        obs=runlog.run_obs(tdir, context={"tool": "test"}))
    tr.fit(iter([token_batch(TokenStreamConfig(**tcfg), i, device="cpu")
                 for i in range(steps)]))
    _, ts = runlog.read_run(tdir)
    _, js = jrunlog.read_run(jdir)
    counts = {k: len(v) for k, v in ts.items()}
    jcounts = {k: len(v) for k, v in js.items()}
    # the memory stream: the port records each block's forward, the
    # reference one row a scanned tag a step (its scan's forward under
    # autodiff runs the fp32 emit once); lm_head is not scanned
    assert counts.pop("memory") == counts["dither"] == steps * (2 * 7 + 1)
    assert jcounts.pop("memory") == steps * (7 + 1)
    assert counts == jcounts
    # fp32 residuals compress 1x: both packages' MemoryRatioMonitor warns
    assert sorted(ts) == ["dither", "memory", "monitor", "phase", "train"]
    assert {e["kind"] for e in ts["monitor"]} == \
        {e["kind"] for e in js["monitor"]} == {"residual_compression_drift"}
    spans = {}
    for r in ts["phase"]:
        spans.setdefault(r["tag"], []).append(r["step"])
    assert spans == {"data": [0, 1, 2], "dispatch": [0, 1, 2],
                     "controller": [0, 1, 2], "monitor": [0, 1, 2]}
    assert [r["step"] for r in ts["train"]] == [1.0, 2.0, 3.0]
    assert list(tr._ctrl.state) == list(jt._ctrl.state) == [
        n for n in sched.discover_layer_names(
            lambda n, b, ctx: tr.model.loss(n, b, ctx=ctx), tr.net,
            token_batch(TokenStreamConfig(**tcfg), 0, device="cpu"),
            device="cpu")]
    assert all(v != 0 for v in tr._ctrl.state.values())


@pytest.mark.parametrize("memory", [None, "default=nsd"])
def test_remat_records_memory_once_a_block(buses, memory):
    """Under per-block remat a block's forward runs twice (once more in
    the backward): its memory rows are recorded once, by the first run, so
    a step has one memory row per dither row, equal to the rows without
    remat (exact: the same forward on the same inputs)."""
    from repro_torch.memory.policy import as_memory_policy
    from repro_torch.models.api import lm_model

    base = get_smoke_model("gemma-2b")
    batch = token_batch(TokenStreamConfig(vocab=512, seq_len=16, batch=2), 0,
                        device="cpu")
    got = {}
    for remat in (False, True):
        m = lm_model(dataclasses.replace(base.cfg, remat=remat), "dense")
        net = m.init(0, "cpu")
        metrics.reset()
        ctx = DitherCtx(DitherPolicy(s=2.0, collect_stats=True), seed=0,
                        memory=as_memory_policy(memory), device="cpu")
        m.loss(net, batch, ctx=ctx).backward()
        dither = sum(metrics.row_count(t) for t in metrics.tags())
        got[remat] = {t: metrics.memory_rows(t) for t in metrics.memory_tags()}
        assert sum(len(r) for r in got[remat].values()) == dither == 2 * 7 + 1
    assert got[True].keys() == got[False].keys()
    for t, r in got[False].items():
        np.testing.assert_array_equal(got[True][t], r)


def test_launcher_run_dir_and_report(tmp_path, capsys):
    """The launcher's ``--run-dir`` with a controller program writes a
    strict-JSON run directory that the report renders; the monitors' setpoint
    is the controller's target."""
    rd = str(tmp_path / "run")
    spec = "dither: phase@0=paper;controller:target=0.9"
    tr = launch_train.main(["--arch", "gemma-2b", "--preset", "smoke",
                            "--steps", "3", "--batch", "2", "--seq", "16",
                            "--device", "cpu", "--run-dir", rd,
                            "--escalate-monitors", "--program", spec])
    manifest, streams = runlog.read_run(rd)
    assert manifest["context"]["program"] == spec
    assert manifest["platform"] == "cpu" and "torch_version" in manifest
    assert {"dither", "phase", "train"} <= set(streams)
    assert tr.obs.monitors.escalate
    assert any(m.kind == "sparsity_collapse" and m.setpoint == 0.9
               for m in tr.obs.monitors.monitors)
    assert len(tr._ctrl.state) == 8
    assert report.main([rd]) == 0
    out = capsys.readouterr().out
    assert "per-layer dither telemetry" in out and "dispatch" in out


def test_launcher_without_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the launcher would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "gemma-2b", "--preset", "smoke",
                           "--steps", "1", "--run-dir", str(tmp_path / "r"),
                           "--program", "dither: controller:target=0.9"])


# ---------------------------------------------------------------------------
# the classifier trainer under a program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,memory", [("paper", None),
                                            ("kernel", None),
                                            ("int8", "default=nsd")])
def test_universal_rule_trains_like_the_plain_policy(variant, memory):
    """A program whose one rule is universal trains LeNet-300-100 exactly
    as the plain policy does: results and every telemetry row."""
    pol = DitherPolicy(variant=variant, s=2.0, collect_stats=True)
    out = []
    for p in (pol, sched.PolicyProgram(base=pol, rules=(sched.LayerRule(),))):
        res = classifier.train_classifier(paper_models.lenet300100(), p,
                                          steps=2, memory=memory,
                                          device="cpu")
        res.pop("ms_per_step")
        rows = {t: metrics.rows(t).copy() for t in metrics.tags()}
        mem = {t: metrics.memory_rows(t).copy() for t in metrics.memory_tags()}
        out.append((res, rows, mem))
    (a, ra, ma), (b, rb, mb) = out
    assert a == b
    assert ra.keys() == rb.keys() == {"fc0", "fc1", "fc2"}
    for t in ra:
        np.testing.assert_array_equal(ra[t], rb[t])
    assert ma.keys() == mb.keys()
    for t in ma:
        np.testing.assert_array_equal(ma[t], mb[t])


def test_classifier_controller_moves_s_on_the_kernel_path(monkeypatch):
    """The kernel variant under a controller: each NSD call's s is the
    layer's s0 times exp of its log-scale, which moves toward the target
    (sparsity under it raises s), with no fallback; the discovery forward
    leaves no telemetry."""
    seen = []
    real = ops.quantize_and_mask

    def spy(g, noise, s):
        seen.append(s)
        return real(g, noise, s)

    monkeypatch.setattr(ops, "quantize_and_mask", spy)
    monkeypatch.setattr(ops, "KERNEL_FALLBACKS", {})
    states = []
    real_tick = sched.ControllerDriver.tick

    def tick(self):
        real_tick(self)
        states.append(dict(self.state))

    monkeypatch.setattr(sched.ControllerDriver, "tick", tick)
    prog = sched.parse_program("phase@0=kernel;controller:target=0.93,gain=4.0",
                               DitherPolicy(s=2.0))
    classifier.train_classifier(paper_models.lenet300100(), prog, steps=5,
                                device="cpu")
    assert not ops.KERNEL_FALLBACKS
    assert len(seen) == 15 and len(states) == 5
    # the backward visits fc2, fc1, fc0; step i runs on states[i - 1]
    for i in range(1, 5):
        for j, name in enumerate(("fc2", "fc1", "fc0")):
            want = float(np.float32(2.0)
                         * np.float32(np.exp(float(states[i - 1][name]))))
            assert seen[3 * i + j] == want
    rows = {t: metrics.rows(t) for t in metrics.tags()}
    assert sorted(rows) == sorted(states[0])
    for i in range(1, 5):
        # one row a layer a step: the tick folds in exactly that row
        assert states[i] == prog.controller.update(
            states[i - 1], {n: float(r[i, 0]) for n, r in rows.items()})
        for name, r in rows.items():
            moved = states[i][name] - states[i - 1][name]
            assert np.sign(moved) in (np.sign(0.93 - r[i, 0]), 0)


def test_layer_sparsity_bench_at_few_steps():
    """The bench's four runs at 6 steps: the universal-rule parity is exact
    and every result the reference gates is there (its bands hold at the
    recipe's 40 steps: ``python -m repro_torch.train.layer_sparsity
    --device cpu --check ...``)."""
    res = {r.name: r for r in layer_sparsity.bench(steps=6, device="cpu")}
    assert set(res) == {"layer_sparsity/parity", "layer_sparsity/fc0",
                        "layer_sparsity/fc1", "layer_sparsity/fc2",
                        "layer_sparsity/rule_contrast",
                        "layer_sparsity/controller"}
    p = res["layer_sparsity/parity"].derived
    assert p["max_abs_diff"] == 0.0
    assert p["global_sparsity"] == p["program_sparsity"]
    assert res["layer_sparsity/rule_contrast"].derived[
        "fc0_w0_minus_fc1_w0"] > 0
