"""The port's package-level rules and its smaller modules: no JAX or
reference import, CUDA unless the caller asks for the CPU, the noise
seeding scheme, and the optimizer, BatchNorm and data generator against
the reference."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import ClassifConfig as JData, classification_batch as j_batch  # noqa: E402
from repro.core.policy import name_salt as j_name_salt  # noqa: E402
from repro.models.cnn import batchnorm as j_batchnorm  # noqa: E402
from repro.optim import OptConfig as JOpt, apply_updates as j_apply, init_opt_state as j_init  # noqa: E402
from repro_torch.configs.paper_models import vgg11_cifar  # noqa: E402
from repro_torch.core import nsd  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy, layer_seed, name_salt  # noqa: E402
from repro_torch.data.synthetic import ClassifConfig, classification_batch  # noqa: E402
from repro_torch.kernels import nsd_quant  # noqa: E402
from repro_torch.models.cnn import CNN, batchnorm  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, apply_updates, init_opt_state, schedule_lr  # noqa: E402
from repro_torch.train.classifier import train_classifier  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# an import of jax or of the reference package; repro_torch does not match
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s,]|$)", re.M)


def test_forbidden_import_pattern():
    for bad in ("import jax", "from jax.numpy import x", "import repro",
                "from repro.core import nsd", "  from repro import quant"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import nsd",
               "import numpy", "# not from repro"):
        assert not FORBIDDEN.search(ok), ok


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_source_imports_neither_jax_nor_reference(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_port_modules_load_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = vgg11_cifar()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_classifier(cfg, DitherPolicy(variant="kernel"), steps=1, batch=2)
    with pytest.raises(RuntimeError):
        CNN(cfg)
    with pytest.raises(RuntimeError):
        DitherCtx(DitherPolicy())
    with pytest.raises(RuntimeError):
        classification_batch(ClassifConfig(), 0, 2)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros(128, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        nsd_quant.nsd_quantize_blocked(x, x, torch.zeros((), device="meta"))


def test_layer_seeds_are_distinct_and_stable():
    seeds = {layer_seed(s, t, w, n) for s in (0, 1) for t in (0, 1, 2)
             for w in (0, 3) for n in ("c0", "c1", "fc0")}
    assert len(seeds) == 2 * 3 * 2 * 3
    assert all(0 <= s < 2**63 for s in seeds)
    assert layer_seed(0, 5, 0, "c3") == layer_seed(0, 5, 0, "c3")
    for n in ("c0", "fc2", "b3_c1"):
        assert name_salt(n) == j_name_salt(n)


def test_unit_noise_reproducible_and_uniform():
    ctx = DitherCtx(DitherPolicy(), seed=3, step=7, device="cpu")
    u = ctx.unit_noise("fc1", (256, 512))
    assert u.dtype == torch.float32 and u.shape == (256, 512)
    assert torch.equal(u, ctx.unit_noise("fc1", (256, 512)))
    assert not torch.equal(u, ctx.unit_noise("fc2", (256, 512)))
    assert float(u.min()) >= -0.5 and float(u.max()) < 0.5
    assert abs(float(u.mean())) < 0.005 and abs(float(u.var()) - 1 / 12) < 0.002


def test_production_noise_meets_paper_eqs_5_and_6():
    """With the port's own draws: E[x~ - x] = 0 and E[(x~ - x)^2] < Delta^2/4
    (paper eqs. 5 and 6), over 256 independent steps."""
    x = torch.linspace(-2.0, 2.0, 401)
    delta = torch.tensor(0.7)
    err = torch.stack([
        nsd.nsd_indices(x, DitherCtx(DitherPolicy(), step=t, device="cpu")
                        .unit_noise("fc", x.shape), delta) * delta - x
        for t in range(256)])
    # an NSD error takes two values Delta apart, so its std is at most
    # Delta / 2: 5 standard errors per element, and over all elements
    assert float(err.mean(0).abs().max()) < 5 * 0.35 / np.sqrt(256)
    assert abs(float(err.mean())) < 5 * 0.35 / np.sqrt(err.numel())
    assert float((err ** 2).mean()) < float(delta) ** 2 / 4


def test_sgd_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    jcfg = JOpt(name="sgd", lr=0.05, momentum=0.9, weight_decay=5e-4,
                grad_clip=None, schedule="step", step_decay_every=2,
                step_decay_rate=0.1)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    js = j_init(jp, jcfg)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    cfg = OptConfig(lr=0.05, step_decay_every=2)
    ts = init_opt_state(tp)
    for g in grads:
        jp, js, _ = j_apply(jp, {n: jnp.asarray(a) for n, a in g.items()}, js, jcfg)
        for n in tp:
            tp[n].grad = torch.from_numpy(g[n])
        apply_updates(tp, ts, cfg)
    for n in tp:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6,
                                   atol=1e-7)
    assert [schedule_lr(cfg, s) for s in range(5)] == pytest.approx(
        [0.05, 0.05, 0.005, 0.005, 0.0005])


def test_batchnorm_matches_reference():
    x = np.random.default_rng(1).standard_normal((4, 5, 5, 6)).astype(np.float32) * 3 + 1
    g = np.linspace(0.5, 1.5, 6).astype(np.float32)
    b = np.linspace(-1, 1, 6).astype(np.float32)
    ref = np.asarray(j_batchnorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    out = batchnorm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                    torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cfg", [dict(), dict(n_classes=7, img_size=32, channels=3,
                                               noise=0.5, seed=4)])
def test_synthetic_batches_identical_to_reference(cfg):
    jb = j_batch(JData(**cfg), 3, 5)
    tb = classification_batch(ClassifConfig(**cfg), 3, 5, device="cpu")
    np.testing.assert_array_equal(tb["images"].numpy(), np.asarray(jb["images"]))
    np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))


def test_metrics_empty_and_reset():
    metrics.reset()
    assert np.isnan(metrics.overall_sparsity()) and metrics.rows("x").shape == (0, 3)
    metrics.emit("x", nsd.quant_stats(torch.tensor([0, 3, 0, 0]), torch.tensor(0.5)))
    assert metrics.overall_sparsity() == 0.75 and metrics.overall_max_bits() == 3.0
    metrics.reset()
    assert metrics.tags() == []


def test_train_classifier_on_cpu():
    res = train_classifier(vgg11_cifar(), DitherPolicy(variant="kernel",
                                                       collect_stats=True),
                           steps=2, batch=2, device="cpu")
    assert np.isfinite(res["final_loss"]) and 0 <= res["acc"] <= 100
    assert 0 < res["sparsity"] < 100 and 1 <= res["max_bits"] <= 8
    assert res["ms_per_step"] > 0
