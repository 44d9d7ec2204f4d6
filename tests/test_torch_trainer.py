"""Port parity for the LM training path: AdamW with its schedule and clip
(``repro_torch.optim.optimizers``), the trainer (``repro_torch.train.
trainer``) and the launcher (``repro_torch.launch.train``), against
``repro.optim``, ``repro.train`` and ``repro.launch.train`` on the CPU.

Bands. The optimizer runs the reference's f32 arithmetic on the same
gradients: parameters, masters and moments within rtol 1e-6 (in-place
updates round the same operations; the learning rate and bias corrections
are the reference's f32 values, the learning rate within 2 ulps: numpy's
and XLA's f32 cosines differ by an ulp). A trainer run: gemma-2b smoke from the
reference's initial parameters, the reference's draws and Delta fed
(tests/test_torch_lm.py says why), 3 AdamW steps: the loss history within
1e-4 (measured <= 1e-6); the final parameters within rel L2 1e-4 under
plain backprop and 5e-3 under the dithered program with accumulation
(measured 7e-6 and 1.1e-3: AdamW's first updates are about lr x sign(g),
so an entry whose gradient is rounding noise moves by a whole step either
way). The same two runs in bf16 with two micro-batches, the f32 sums handed
to AdamW: loss within 5e-3 and parameters within 2e-2 plain (measured
2.5e-3 and 9.3e-3), 3e-2 and 6e-2 dithered (measured 1.6e-2 and 3.4e-2: a
bf16 rounding that differs moves a cotangent across an NSD step, and the
draws then part).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_model as j_get_smoke  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy, nsd as jnsd  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data.synthetic import TokenStreamConfig as JTok, token_batch as j_token_batch  # noqa: E402
from repro.models.api import lm_model as j_lm_model  # noqa: E402
from repro.optim import OptConfig as JOpt, apply_updates as j_apply, init_opt_state as j_init  # noqa: E402
from repro.optim import clip_by_global_norm as j_clip, schedule_lr as j_schedule_lr  # noqa: E402
from repro.train import Trainer as JTrainer, TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_smoke_model  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.core import nsd, schedule  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy, fold_in  # noqa: E402
from repro_torch.data.synthetic import TokenStreamConfig, token_batch  # noqa: E402
from repro_torch.kernels import build, bsp_matmul, ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.api import lm_model  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.quant import wire  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH, SEED = "gemma-2b", 0
CPU_ARGS = ["--arch", ARCH, "--preset", "smoke", "--batch", "4", "--seq", "16",
            "--lr", "3e-3", "--device", "cpu"]


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_opt_config_defaults_match_reference():
    got, want = opt.OptConfig(), JOpt()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.b2, got.grad_clip, got.min_lr_ratio) == (0.95, 1.0, 0.1)
    assert (got.mu_codec, got.nu_codec) == (None, None)
    for spec, field in (("quant: mu=m8", "mu_codec"), ("quant: nu=u8", "nu_codec")):
        args = launch_train.parse_args(CPU_ARGS + ["--steps", "1", "--program", spec])
        trainer = launch_train.build(args)[0]
        assert getattr(trainer.opt_cfg, field) == spec.split("=")[1]
    with pytest.raises(ValueError):
        opt.OptConfig(name="lion")


@pytest.mark.parametrize("kw", [
    dict(schedule="constant"), dict(schedule="constant", warmup_steps=3),
    dict(schedule="cosine", warmup_steps=1, total_steps=6),
    dict(schedule="cosine", warmup_steps=5, total_steps=100, min_lr_ratio=0.0),
    dict(schedule="step", step_decay_every=2, lr=0.05)], ids=str)
def test_schedule_lr_matches_reference(kw):
    got = [opt.schedule_lr(opt.OptConfig(**kw), s) for s in range(12)]
    want = [j_schedule_lr(JOpt(**kw), jnp.asarray(s, jnp.int32)) for s in range(12)]
    # f32 throughout; numpy's and XLA's f32 cosines differ by an ulp
    np.testing.assert_array_max_ulp(np.float32(got), np.float32(want), maxulp=2)


def _tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in shapes.items()}


SHAPES = {"w": (6, 5), "b": (5,), "emb": (11, 4)}


def test_clip_by_global_norm_matches_reference():
    g = _tree(1, SHAPES, 3.0)
    want, jgn = j_clip({n: jnp.asarray(a) for n, a in g.items()}, 1.0)
    got, gn = opt.clip_by_global_norm(
        {n: torch.from_numpy(a.copy()) for n, a in g.items()}, 1.0)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for n in g:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [
    dict(name="adamw", lr=1e-2, schedule="cosine", warmup_steps=1,
         total_steps=4),
    dict(name="adamw", lr=1e-2, weight_decay=0.1, grad_clip=0.5),
    dict(name="sgd", lr=0.05, weight_decay=5e-4, grad_clip=1.0)], ids=str)
def test_apply_updates_matches_reference(kw, dtype):
    """Four steps from the same gradients: parameters, f32 masters (bf16
    parameters) and moments against the reference's."""
    params = _tree(2, SHAPES)
    grads = [_tree(10 + i, SHAPES, 2.0) for i in range(4)]
    jcfg, cfg = JOpt(**kw), opt.OptConfig(**kw)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {n: jnp.asarray(a, jdt) for n, a in params.items()}
    js = j_init(jp, jcfg)
    tp = {n: torch.nn.Parameter(torch.from_numpy(a).to(tdt))
          for n, a in params.items()}
    ts = opt.init_opt_state(tp, cfg)
    assert set(ts["master"]) == (set(tp) if dtype == "bfloat16" else set())
    for g in grads:
        jp, js, jm = j_apply(jp, {n: jnp.asarray(a, jdt) for n, a in g.items()},
                             js, jcfg)
        for n in tp:
            tp[n].grad = torch.from_numpy(g[n]).to(tdt)
        m = opt.apply_updates(tp, ts, cfg)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-7)
        if cfg.grad_clip is not None:
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-6)
    assert ts["step"] == int(js["step"]) == 4
    for n in tp:
        np.testing.assert_allclose(tp[n].detach().float().numpy(),
                                   np.asarray(jp[n], np.float32), rtol=1e-6,
                                   atol=1e-7)
        for k in ("mu", "nu") if cfg.name == "adamw" else ("mu",):
            np.testing.assert_allclose(ts[k][n].numpy(), np.asarray(js[k][n]),
                                       rtol=1e-6, atol=1e-9)
        if dtype == "bfloat16":
            np.testing.assert_allclose(ts["master"][n].numpy(),
                                       np.asarray(js["master"][n]), rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# the trainer and the launcher
# ---------------------------------------------------------------------------

def test_launcher_builds_the_reference_recipe():
    """AdamW with the reference launcher's cosine schedule and warmup
    max(steps // 20, 1), log_every max(steps // 10, 1), the program over a
    paper base, the memory section."""
    for steps in (3, 40, 100):
        args = launch_train.parse_args(CPU_ARGS + ["--steps", str(steps), "--program",
                                                   "dither: phase@0=off;phase@2=kernel "
                                                   "memory: default=nsd"])
        trainer, batches = launch_train.build(args)
        want = JOpt(name="adamw", lr=3e-3, schedule="cosine",
                    warmup_steps=max(steps // 20, 1), total_steps=steps)
        assert dataclasses.asdict(trainer.opt_cfg) == dataclasses.asdict(want)
        assert trainer.tcfg.log_every == max(steps // 10, 1)
        assert trainer.program.base == DitherPolicy(variant="paper", s=2.0)
        assert trainer.program.phase_policy_at(2).variant == "kernel"
        assert trainer.memory_policy.default == "nsd"
        b = next(batches)
        assert tuple(b["tokens"].shape) == (4, 16)
    off = launch_train.build(launch_train.parse_args(
        CPU_ARGS + ["--dither", "off"]))[0]
    assert off.program is None and off.step_ctx(0) is None


@dataclasses.dataclass
class FedCtx(DitherCtx):
    """The trainer's context carrying the reference's: each layer draws the
    reference's noise, and a micro-batch's ``with_key`` folds both keys."""

    jctx: object = None

    def unit_noise(self, name, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.jctx.key_for(name), tuple(shape), jnp.float32, -0.5, 0.5)))

    def with_key(self, key):
        i = next(i for i in range(64) if fold_in(self.key, i) == key)
        return dataclasses.replace(self, key=key, jctx=self.jctx.with_key(
            jax.random.fold_in(self.jctx.key, i)))


@pytest.mark.parametrize("spec,grad_accum,dtype,loss_band,band", [
    ("", 1, "float32", 1e-4, 1e-4),
    ("phase@0=off;phase@1=paper;s=lin(1,3,3.0,2.0)", 2, "float32", 1e-4, 5e-3),
    ("", 2, "bfloat16", 5e-3, 2e-2),
    ("phase@0=off;phase@1=paper;s=lin(1,3,3.0,2.0)", 2, "bfloat16", 3e-2,
     6e-2)],
    ids=["off", "paper-accum", "off-accum-bf16", "paper-accum-bf16"])
def test_trainer_matches_reference(spec, grad_accum, dtype, loss_band, band,
                                   monkeypatch):
    """Three steps of the launcher's recipe on both trainers from the same
    parameters: the loss history and the final parameters. Under the
    program, steps 1-2 dither with the micro-batch fold. The bf16 cases
    accumulate the micro-batches' gradients in f32 and hand them to AdamW's
    f32 masters, as the reference does."""
    steps, batch = 3, 4
    jm, m = j_get_smoke(ARCH), get_smoke_model(ARCH)
    if dtype == "bfloat16":
        jm = j_lm_model(dataclasses.replace(jm.cfg, dtype=jnp.bfloat16),
                        family=jm.family)
        m = lm_model(dataclasses.replace(m.cfg, dtype=torch.bfloat16),
                     family=m.family)
    jprog = jsched.parse_program(spec, JPolicy(s=2.0)) if spec else None
    kw = dict(name="adamw", lr=3e-3, schedule="cosine", warmup_steps=1,
              total_steps=steps)
    jt = JTrainer(jm, JOpt(**kw), JTrainerConfig(
        total_steps=steps, grad_accum=grad_accum, log_every=1), policy=jprog)
    tcfg = dict(vocab=512, seq_len=16, batch=batch)
    jout = jt.fit(iter([j_token_batch(JTok(**tcfg), i) for i in range(steps)]))

    params0, _ = jm.init(jax.random.PRNGKey(SEED))
    net = m.init(SEED, "cpu")
    net.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params0)))
    prog = schedule.parse_program(spec, DitherPolicy(s=2.0)) if spec else None
    tr = trainer_mod.Trainer(m, opt.OptConfig(**kw), trainer_mod.TrainerConfig(
        total_steps=steps, grad_accum=grad_accum, log_every=1), policy=prog,
        device="cpu")
    jbase = jax.random.fold_in(jax.random.PRNGKey(SEED), 0xD17E)
    real = trainer_mod.Trainer.step_ctx

    def fed_step_ctx(self, step):
        c = real(self, step)
        if c is None:
            return None
        jc = JCtx.for_step(jbase, step, jprog.phase_policy_at(step),
                           program=jprog)
        return FedCtx(**{f.name: getattr(c, f.name)
                         for f in dataclasses.fields(DitherCtx)}, jctx=jc)

    monkeypatch.setattr(trainer_mod.Trainer, "step_ctx", fed_step_ctx)
    # both compute Delta from the cotangent in f32
    monkeypatch.setattr(nsd, "compute_delta", lambda x, s: torch.from_numpy(
        np.array(jnsd.compute_delta(jnp.asarray(x.detach().float().numpy()),
                                    s))))
    out = tr.fit(iter([token_batch(TokenStreamConfig(**tcfg), i, device="cpu")
                       for i in range(steps)]), params=net)
    assert [r["step"] for r in out["history"]] == [1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in out["history"]],
                               [r["loss"] for r in jout["history"]],
                               atol=loss_band)
    got = lm_params_to_jax(dict(net.named_parameters()))
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jout["params"]))[0]
    for (path, want), g in zip(flat, jax.tree.leaves(got)):
        g = np.asarray(g, np.float32)
        rel = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert rel <= band, jax.tree_util.keystr(path)
    assert out["opt_state"]["step"] == int(jout["opt_state"]["step"]) == steps


def _counting(monkeypatch, module, name, counts):
    real = getattr(module, name)

    def wrapper(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return real(*a, **kw)
    monkeypatch.setattr(module, name, wrapper)


def test_launcher_off_matches_reference_trainer(monkeypatch):
    """``main`` with --dither off: its loss history against the reference
    trainer's on the launcher's recipe, both from the reference's
    parameters (the port's draw replaced by them)."""
    steps = 3
    jm = j_get_smoke(ARCH)
    jt = JTrainer(jm, JOpt(name="adamw", lr=3e-3, schedule="cosine",
                           warmup_steps=1, total_steps=steps),
                  JTrainerConfig(total_steps=steps, log_every=1))
    tcfg = JTok(vocab=512, seq_len=16, batch=4)
    jout = jt.fit(iter([j_token_batch(tcfg, i) for i in range(steps)]))
    params0, _ = jm.init(jax.random.PRNGKey(SEED))

    def ref_init(self):
        net = self.model.init(SEED, self.device)
        net.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params0)))
        return net

    monkeypatch.setattr(trainer_mod.Trainer, "init_params", ref_init)
    tr = launch_train.main(CPU_ARGS + ["--steps", str(steps), "--dither", "off"])
    np.testing.assert_allclose([r["loss"] for r in tr.history],
                               [r["loss"] for r in jout["history"]], atol=1e-4)


def test_launcher_kernel_phase_runs_on_plain_versions(monkeypatch):
    """The card's program at smoke size on the CPU: step 0 plain backprop,
    steps 1-2 the kernel variant on the kernels' plain versions (one NSD
    and two int8 products a dithered dense, 2 blocks x 7 denses, lm_head
    off), no kernel launch, no fallback."""
    per_step = []
    counts = {}
    _counting(monkeypatch, ops, "quantize_and_mask", counts)
    _counting(monkeypatch, bsp_matmul, "bsp_matmul_int8", counts)
    real = trainer_mod.Trainer.train_step

    def recording(self, batch, step):
        counts.clear()
        out = real(self, batch, step)
        per_step.append(dict(counts))
        return out

    monkeypatch.setattr(trainer_mod.Trainer, "train_step", recording)
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    tr = launch_train.main(CPU_ARGS + [
        "--steps", "3", "--program",
        "dither: phase@0=off;phase@1=kernel;rule lm_head:off"])
    assert per_step == [{}, {"quantize_and_mask": 14, "bsp_matmul_int8": 28},
                        {"quantize_and_mask": 14, "bsp_matmul_int8": 28}]
    assert not any(build.LAUNCHES.values()) and not ops.KERNEL_FALLBACKS
    assert [r["step"] for r in tr.history] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in tr.history)


def test_launcher_memory_section_encodes_residuals(monkeypatch):
    """``memory: default=nsd`` reaches every dithered dense: one wire encode
    a layer a step (the smoke preset runs without remat), and the deprecated
    ``--memory-program`` does the same with a warning."""
    counts = {}
    _counting(monkeypatch, wire, "pack_nsd", counts)
    launch_train.main(CPU_ARGS + [
        "--steps", "2", "--program",
        "dither: phase@0=kernel;rule lm_head:off memory: default=nsd"])
    assert counts == {"pack_nsd": 2 * 14}
    counts.clear()
    with pytest.warns(DeprecationWarning, match="--memory-program"):
        launch_train.main(CPU_ARGS + [
            "--steps", "1", "--policy-program", "rule lm_head:off",
            "--memory-program", "default=nsd;rule L.attn.*:fp32"])
    assert counts == {"pack_nsd": 2 * 3}  # the three mlp denses of 2 blocks


def test_launcher_module_runs_from_the_command_line():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--preset", "smoke", "--steps", "3", "--device", "cpu", "--program",
         "dither: phase@0=off;phase@1=kernel;rule lm_head:off"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert "step 3 loss" in res.stderr and "final loss" in res.stderr


def test_trainer_rejects_bad_accumulation():
    with pytest.raises(ValueError, match="grad_accum"):
        trainer_mod.Trainer(get_smoke_model(ARCH), opt.OptConfig(),
                            trainer_mod.TrainerConfig(grad_accum=0),
                            device="cpu")
    tr = trainer_mod.Trainer(get_smoke_model(ARCH), opt.OptConfig(),
                             trainer_mod.TrainerConfig(total_steps=1,
                                                       grad_accum=3),
                             device="cpu")
    b = token_batch(TokenStreamConfig(vocab=512, seq_len=8, batch=4), 0,
                    device="cpu")
    with pytest.raises(ValueError, match="micro-batches"):
        tr.fit(iter([b]))
