"""Port parity for the whole slice: one VGG11-CIFAR training step at full
width and batch 2 in ``variant=kernel``, the port against the reference.

Both sides start from the reference's initial parameters (converted with
``params_from_jax``), the same synthetic batch (the port's copy of the numpy
generator) and the reference's per-layer noise draw
(``DitherCtx.for_step(...).key_for(name)``, fed through the port's noise
seam). The reference runs its Pallas kernels in interpret mode; the port
runs its kernels' plain versions.

Bands. The forward runs the same f32 math in another summation order:
loss to rtol 1e-5. Every layer's cotangent then differs from the
reference's by f32 rounding only, so k can flip only where
(g + nu) / Delta + 1/2 lies within rounding of an integer: at most 1e-4 of
a layer's elements, and each flip within 1e-3 of such a boundary in the
reference's own value (seed 0 flips none). A flip moves one dW entry by a
whole Delta-sized term; without flips dW differs by rounding (rel 1.2e-6 at
most for seed 0), so per-layer weight gradients must agree to rel 1e-3 in
the L2 norm. A wrong layout, noise order or scale misses these by orders of
magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import vgg11_cifar as j_vgg11  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy, nsd as jnsd  # noqa: E402
from repro.data.synthetic import ClassifConfig as JData, classification_batch as j_batch  # noqa: E402
from repro.models.cnn import loss_fn as j_loss, tap_shapes  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.configs.paper_models import vgg11_cifar  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import dithered, nsd  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.data.synthetic import ClassifConfig, classification_batch  # noqa: E402
from repro_torch.models.cnn import CNN, loss_fn  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

B, S, SEED = 2, 2.0, 0
LAYERS = [f"c{i}" for i in range(8)] + ["fc0", "fc1", "fc2"]


class FedCtx(DitherCtx):
    def __init__(self, policy, fed):
        super().__init__(policy, device="cpu")
        self.fed = fed

    def unit_noise(self, name, shape):
        assert tuple(shape) == self.fed[name].shape, (name, shape)
        return torch.from_numpy(self.fed[name])


@pytest.fixture(scope="module")
def step():
    """One step on each side; returns everything the tests compare."""
    model = j_vgg11()
    # the reference's parameter names and HWIO shapes, filled from numpy
    # with its initialisation's distribution
    rng = np.random.default_rng(SEED)
    params = {}
    for n, sd in sorted(jax.eval_shape(model.init,
                                       jax.random.PRNGKey(SEED))[0].items()):
        if n.endswith("_w"):
            fan_in = int(np.prod(sd.shape[:-1]))
            params[n] = (rng.standard_normal(sd.shape) / np.sqrt(fan_in)
                         ).astype(np.float32)
        else:
            params[n] = (np.ones if n.endswith("_g") else np.zeros)(
                sd.shape, np.float32)
    dcfg = dict(n_classes=10, img_size=32, channels=3, noise=0.5, seed=SEED)
    jb = j_batch(JData(**dcfg), 0, B)
    jctx = JCtx.for_step(jax.random.PRNGKey(SEED), 0,
                         JPolicy(variant="kernel", s=S, collect_stats=True))
    shapes = tap_shapes(model.cfg, B)
    taps = {n: jnp.zeros(s, jnp.float32) for n, s in shapes.items()}
    jmetrics.reset()
    f = jax.jit(jax.value_and_grad(
        lambda p, tp: j_loss(p, model.cfg, jb, ctx=jctx, taps=tp),
        argnums=(0, 1)))
    loss_j, (grads_j, cot_j) = f(params, taps)
    jax.effects_barrier()
    rows_j = {n: jmetrics.rows(n) for n in LAYERS}
    draw = jax.jit(lambda: {n: jax.random.uniform(
        jctx.key_for(n), (int(np.prod(s[:-1])), s[-1]), jnp.float32, -0.5, 0.5)
        for n, s in shapes.items()})
    fed = {n: np.array(u) for n, u in draw().items()}

    seen = {}
    real = dithered._kernel_products

    def recording(g2d, x2d, w, u, pol, name, need_dx):
        seen[name] = (g2d.detach().clone(), need_dx)
        return real(g2d, x2d, w, u, pol, name, need_dx)

    net = CNN(vgg11_cifar(), device="cpu")
    net.load_state_dict(params_from_jax(params))
    tb = classification_batch(ClassifConfig(**dcfg), 0, B, device="cpu")
    metrics.reset()
    dithered._kernel_products = recording
    try:
        loss_t = loss_fn(net, tb, ctx=FedCtx(
            DitherPolicy(variant="kernel", s=S, collect_stats=True), fed))
        loss_t.backward()
    finally:
        dithered._kernel_products = real
    grads_t = {n: p.grad for n, p in net.named_parameters()}
    return dict(params=params, jb=jb, tb=tb, loss_j=float(loss_j),
                loss_t=float(loss_t.detach()), grads_j=grads_j, grads_t=grads_t,
                cot_j=cot_j, seen=seen, fed=fed, jctx=jctx, rows_j=rows_j,
                rows_t={n: metrics.rows(n) for n in LAYERS})


def test_same_batch_and_conversion_round_trip(step):
    np.testing.assert_array_equal(step["tb"]["images"].numpy(),
                                  np.asarray(step["jb"]["images"]))
    np.testing.assert_array_equal(step["tb"]["labels"].numpy(),
                                  np.asarray(step["jb"]["labels"]))
    back = params_to_jax(params_from_jax(step["params"]))
    assert back.keys() == step["params"].keys()
    for n, a in step["params"].items():
        np.testing.assert_array_equal(back[n], a)
    assert tuple(params_from_jax(step["params"])["c1_w"].shape) == (128, 64, 3, 3)


def test_loss(step):
    assert step["loss_t"] == pytest.approx(step["loss_j"], rel=1e-5)


def test_every_layer_took_the_kernel_path(step):
    assert list(step["seen"]) == LAYERS[::-1]  # backward order
    assert step["seen"]["c0"][1] is False  # images need no gradient: no dx
    assert all(need for n, (_, need) in step["seen"].items() if n != "c0")


@pytest.mark.parametrize("name", LAYERS)
def test_layer_indices(step, name):
    """k from the port's cotangent against k from the reference's (the
    tap gradient), both with the reference's noise and their own Delta."""
    g_t, _ = step["seen"][name]
    g_j = np.asarray(step["cot_j"][name]).reshape(g_t.shape)
    u = step["fed"][name]
    d_j = jnsd.compute_delta(jnp.asarray(g_j), S)
    k_j = np.asarray(jnsd.nsd_indices(jnp.asarray(g_j),
                                      step["jctx"].key_for(name), d_j))
    d_t = nsd.compute_delta(g_t, S)
    k_t = nsd.nsd_indices(g_t, torch.from_numpy(u), d_t).numpy()
    assert float(d_t) == pytest.approx(float(d_j), rel=1e-4)
    flips = k_t != k_j
    assert flips.mean() <= 1e-4, (name, int(flips.sum()))
    v = (g_j + u * np.asarray(d_j)) / np.asarray(d_j) + 0.5
    assert np.all(np.abs(v[flips] - np.round(v[flips])) < 1e-3)


@pytest.mark.parametrize("name", LAYERS)
def test_layer_weight_gradients(step, name):
    w_j = np.asarray(step["grads_j"][f"{name}_w"])
    w_t = step["grads_t"][f"{name}_w"].numpy()
    if w_t.ndim == 4:
        w_t = w_t.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    assert np.linalg.norm(w_t - w_j) <= 1e-3 * np.linalg.norm(w_j), name


def test_biases_and_batchnorm_gradients(step):
    """Exact-cotangent reductions. A conv bias feeds BatchNorm, which removes
    it: its true gradient is 0 and both sides return rounding noise, held to
    1e-6 of the summed |cotangent|. BatchNorm and dense-bias gradients sum
    cotangents that carry the rounding differences of the layers above
    (BatchNorm over 8 to 32 values per channel amplifies them): the weight
    gradients' band, rel 1e-3 in the L2 norm."""
    for n, g in step["grads_t"].items():
        if n.endswith("_w"):
            continue
        j = np.asarray(step["grads_j"][n])
        if n.startswith("c"):  # c{i}_b
            cot = np.abs(np.asarray(step["cot_j"][n[:-2]])).sum()
            assert np.abs(g.numpy()).max() <= 1e-6 * cot, n
            assert np.abs(j).max() <= 1e-6 * cot, n
        else:
            assert np.linalg.norm(g.numpy() - j) <= 1e-3 * np.linalg.norm(j), n


def test_telemetry_matches_reference(step):
    for n in LAYERS:
        r_t, r_j = step["rows_t"][n], step["rows_j"][n]
        assert r_t.shape == r_j.shape == (1, 3)
        # sparsity to one f32 ulp (see test_torch_ops: the jitted reference
        # may round 1 - count * (1/n) once), bits exactly
        np.testing.assert_array_max_ulp(r_t[:, 0], r_j[:, 0], maxulp=1)
        np.testing.assert_array_equal(r_t[:, 1], r_j[:, 1], n)
        np.testing.assert_allclose(r_t[:, 2], r_j[:, 2], rtol=1e-4, err_msg=n)
    all_t = np.concatenate([step["rows_t"][n] for n in LAYERS])
    all_j = np.concatenate([step["rows_j"][n] for n in LAYERS])
    assert float(all_t[:, 0].mean()) == pytest.approx(float(all_j[:, 0].mean()),
                                                      rel=1e-6)
    assert metrics.overall_max_bits() == float(all_j[:, 1].max())
