"""Port parity for the paper's other five Table-1 models (MLP-(500, 500),
LeNet-300-100, LeNet5, AlexNet-CIFAR, ResNet18) at full width and batch 2:
parameter trees, logits, probe taps and one training step's gradients,
the port against the reference.

Both sides start from the same parameters (the reference's names and HWIO
shapes, filled from numpy with its initialisation's distribution, converted
with ``params_from_jax``), the same synthetic batch and, for a dithered
step, the reference's per-layer noise draw (``DitherCtx.for_step(...)
.key_for(name)``) fed through the port's noise seam.

Bands. Logits run the same f32 math in another summation order: rtol 1e-5
(atol 1e-6 of the largest entry). Tap gradients too, but ResNet18's pass
back through up to 20 BatchNorms over two-image batches, which spread the
rounding over the small entries: each tap is held to rel 1e-5 in the L2
norm (the worst measured is 3e-6). Step-1 weight gradients
of a dithered step are held to rel 1e-3 in the L2 norm, the band and
reasoning of tests/test_torch_slice.py: a k can flip only where
(g + nu) / Delta + 1/2 lies within rounding of an integer, and a flip moves
one dW entry by a Delta-sized term; without flips dW differs by rounding.
The kernel-variant steps (the plain versions of the port's kernels against
the reference's Pallas kernels in interpret mode) take the same band. A
conv bias that feeds BatchNorm has a true gradient of 0; both sides return
rounding noise, held to 1e-6 of the layer's summed |cotangent|.

Delta. A dithered step here takes Delta from the reference's function
(``jnp.std``) on the port's own cotangent, as tests/test_torch_memory.py
feeds the reference's Delta. ``torch.std`` and ``jnp.std`` reduce in other
orders and differ by up to ~1e-5 relative, enough to move a k that sits at
a rounding boundary; the flipped Delta-sized term then reaches every layer
below it (AlexNet at seed 0: one flip among c2's 12,288 elements puts c2's
to c0's weight gradients 1% to 12% apart; ResNet18's stem to b2_c1 drift
0.8% to 44%). With the reference's Delta the port's quantizer is the
reference's on the same cotangent, and the cotangents differ by rounding
only (ResNet18's weight gradients then agree to 3e-6). The port's own Delta is held to the
reference's (rel 1e-4) in tests/test_torch_slice.py and
tests/test_torch_nsd.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_models as jpm  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy, nsd as jnsd  # noqa: E402
from repro.data.synthetic import ClassifConfig as JData, classification_batch as j_batch  # noqa: E402
from repro.models.cnn import cnn_forward as j_forward, loss_fn as j_loss  # noqa: E402
from repro.models.cnn import tap_shapes as j_tap_shapes  # noqa: E402
from repro_torch.configs import paper_models as pm  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import nsd, probe  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.data.synthetic import ClassifConfig, classification_batch  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.cnn import CNN, loss_fn, tap_shapes  # noqa: E402

B, S, SEED = 2, 2.0, 0
ARCHS = {"mlp": (jpm.mlp_mnist, pm.mlp_mnist),
         "lenet300100": (jpm.lenet300100, pm.lenet300100),
         "lenet5": (jpm.lenet5, pm.lenet5),
         "alexnet": (jpm.alexnet_cifar, pm.alexnet_cifar),
         "resnet18": (jpm.resnet18_cifar, pm.resnet18_cifar)}
KERNEL_ARCHS = ("mlp", "lenet300100", "lenet5")
# dithered layers of each model, in forward order
LAYERS = {
    "mlp": ["fc0", "fc1", "fc2"],
    "lenet300100": ["fc0", "fc1", "fc2"],
    "lenet5": ["c1", "c2", "fc1", "fc2", "fc3"],
    "alexnet": [f"c{i}" for i in range(5)] + ["fc0", "fc1", "fc2"],
    "resnet18": ["stem"] + [f"b{i}_{c}" for i in range(8)
                            for c in ("c1", "c2", "cd")
                            if c != "cd" or i in (2, 4, 6)] + ["fc"],
}


class FedCtx(DitherCtx):
    """Hands the port the reference's draw of each layer, (T, N) as the
    port asks: the same numbers as the reference's draw of the NHWC
    cotangent, row-major."""

    def __init__(self, policy, jctx):
        super().__init__(policy, device="cpu")
        self.jctx = jctx

    def unit_noise(self, name, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.jctx.key_for(name), tuple(shape), jnp.float32, -0.5, 0.5)))


def _ref_params(jmodel):
    rng = np.random.default_rng(SEED)
    params = {}
    for n, sd in sorted(jax.eval_shape(jmodel.init,
                                       jax.random.PRNGKey(SEED))[0].items()):
        if len(sd.shape) >= 2:  # the weights: fc*_w, c*_w, b*_w1, b*_wd, ...
            fan_in = int(np.prod(sd.shape[:-1]))
            params[n] = (rng.standard_normal(sd.shape) / np.sqrt(fan_in)
                         ).astype(np.float32)
        else:
            params[n] = (np.ones if n.endswith("_g") else np.zeros)(
                sd.shape, np.float32)
    return params


_CACHE = {}


def _setup(arch):
    """Reference model and parameters, the port's net loaded with them, and
    one batch on both sides."""
    if arch not in _CACHE:
        jm = ARCHS[arch][0]()
        cfg = ARCHS[arch][1]()
        params = _ref_params(jm)
        net = CNN(cfg, device="cpu")
        net.load_state_dict(params_from_jax(params))
        dcfg = dict(n_classes=10, img_size=cfg.img_size,
                    channels=cfg.in_channels, noise=0.5, seed=SEED)
        _CACHE[arch] = dict(jm=jm, cfg=cfg, params=params, net=net,
                            jb=j_batch(JData(**dcfg), 0, B),
                            tb=classification_batch(ClassifConfig(**dcfg), 0, B,
                                                    device="cpu"))
    return _CACHE[arch]


def _close(got, want, rtol=1e-5, atol_frac=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port_grads(net):
    out = {}
    for n, p in net.named_parameters():
        g = p.grad.numpy()
        out[n] = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g  # OIHW -> HWIO
        p.grad = None
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_names_and_shapes(arch):
    st = _setup(arch)
    ref = {n: a.shape for n, a in st["params"].items()}
    port = {n: tuple(p.shape) for n, p in CNN(st["cfg"], device="cpu")
            .named_parameters()}
    assert port.keys() == ref.keys()
    for n, shape in ref.items():
        want = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape
        assert port[n] == want, n


@pytest.mark.parametrize("arch", ARCHS)
def test_logits(arch):
    st = _setup(arch)
    with torch.no_grad():
        got = st["net"](st["tb"]["images"]).numpy()
    want = jax.jit(lambda p, x: j_forward(p, st["jm"].cfg, x))(
        st["params"], st["jb"]["images"])
    assert got.shape == (B, 10)
    _close(got, want)


@pytest.mark.parametrize("arch", list(ARCHS) + ["vgg11"])
def test_tap_shapes(arch):
    jm, cfg = ((jpm.vgg11_cifar(), pm.vgg11_cifar()) if arch == "vgg11"
               else (ARCHS[arch][0](), ARCHS[arch][1]()))
    assert tap_shapes(cfg, 3) == j_tap_shapes(jm.cfg, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_tap_gradients(arch):
    """The probe's pre-activation gradients (plain backprop), NHWC as the
    reference's, at every tapped site."""
    st = _setup(arch)
    shapes = tap_shapes(st["cfg"], B)
    got = probe.grad_wrt_taps(lambda taps: loss_fn(st["net"], st["tb"], taps=taps),
                              probe.make_taps(shapes))
    taps = {n: jnp.zeros(s, jnp.float32) for n, s in shapes.items()}
    want = jax.jit(jax.grad(lambda tp: j_loss(st["params"], st["jm"].cfg,
                                              st["jb"], taps=tp)))(taps)
    assert got.keys() == want.keys()
    for n in want:
        assert tuple(got[n].shape) == shapes[n]
        assert _rel_l2(got[n].numpy(), np.asarray(want[n])) <= 1e-5, n


def _reference_delta(nhwc):
    """The reference's Delta = s * jnp.std(g) on the port's tensor, taken
    over the shape the reference reduces: the paper path quantizes a
    convolution's NHWC cotangent (``nhwc`` maps the port's (T, N) view to
    it), the kernel path its (T, N) view. (XLA's f32 sum of a 131,072-long
    tensor differs by up to 4e-5 relative between the two shapes.)"""
    def delta(x, s):
        a = x.detach().numpy()
        return torch.from_numpy(np.array(jnsd.compute_delta(
            jnp.asarray(a.reshape(nhwc.get(a.shape, a.shape))), s)))
    return delta


def _recording(monkeypatch, nhwc):
    """Record the dithered layers' names in the order the port's model
    runs them, and each convolution's (T, N) -> NHWC cotangent shape in
    ``nhwc``."""
    names = []
    for kind in ("conv2d", "dense"):
        def wrapper(x, w, b=None, _real=getattr(cnn, kind), **kw):
            y = _real(x, w, b, **kw)
            if y.dim() == 4:
                B_, C, H, W = y.shape
                nhwc[(B_ * H * W, C)] = (B_, H, W, C)
            names.append(kw["name"])
            return y
        monkeypatch.setattr(cnn, kind, wrapper)
    return names


def _step(arch, variant, monkeypatch):
    """One dithered step on each side: losses, gradients and the
    reference's cotangents at the taps."""
    st = _setup(arch)
    nhwc = {}
    monkeypatch.setattr(nsd, "compute_delta",
                        _reference_delta(nhwc if variant == "paper" else {}))
    jctx = JCtx.for_step(jax.random.PRNGKey(SEED), 0,
                         JPolicy(variant=variant, s=S))
    shapes = tap_shapes(st["cfg"], B)
    taps = {n: jnp.zeros(s, jnp.float32) for n, s in shapes.items()}
    f = jax.jit(jax.value_and_grad(
        lambda p, tp: j_loss(p, st["jm"].cfg, st["jb"], ctx=jctx, taps=tp),
        argnums=(0, 1)))
    loss_j, (grads_j, cot_j) = f(st["params"], taps)
    layers = _recording(monkeypatch, nhwc)
    ctx = FedCtx(DitherPolicy(variant=variant, s=S), jctx)
    loss_t = loss_fn(st["net"], st["tb"], ctx=ctx)
    loss_t.backward()
    assert layers == LAYERS[arch]  # every layer dithered, in forward order
    return dict(loss_j=float(loss_j), loss_t=float(loss_t.detach()),
                grads_j=grads_j, grads_t=_port_grads(st["net"]), cot_j=cot_j)


def _hold_step(step):
    """The whole step's gradients against the reference's step."""
    assert step["loss_t"] == pytest.approx(step["loss_j"], rel=1e-5)
    grads_t, grads_j = step["grads_t"], step["grads_j"]
    bn = any(n.startswith("bn") or "_bn" in n for n in grads_t)
    assert grads_t.keys() == set(grads_j)
    for n, g in grads_t.items():
        j = np.asarray(grads_j[n])
        if bn and n.startswith("c") and n.endswith("_b"):
            # c{i}_b feeds BatchNorm: a true gradient of 0
            cot = np.abs(np.asarray(step["cot_j"][n[:-2]])).sum()
            assert np.abs(g).max() <= 1e-6 * cot, n
            assert np.abs(j).max() <= 1e-6 * cot, n
        else:
            assert _rel_l2(g, j) <= 1e-3, (n, _rel_l2(g, j))


@pytest.mark.parametrize("arch", ARCHS)
def test_paper_step_gradients(arch, monkeypatch):
    _hold_step(_step(arch, "paper", monkeypatch))


@pytest.mark.parametrize("arch", KERNEL_ARCHS)
def test_kernel_step_gradients(arch, monkeypatch):
    """variant=kernel: the port's plain versions against the reference's
    Pallas kernels (interpret mode); no fallback, one NSD and two products
    a layer but for the first layer's dx, and no launch on the CPU."""
    before = dict(ops.KERNEL_FALLBACKS)
    launches = dict(build.LAUNCHES)
    _hold_step(_step(arch, "kernel", monkeypatch))
    assert ops.KERNEL_FALLBACKS == before
    assert build.LAUNCHES == launches
