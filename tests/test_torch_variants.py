"""Port parity for this slice's ops: SAME and strided convolutions, the
``int8``, ``row`` and ``meprop`` variants of the dithered ops, and the
modules behind them (``core.int8``, ``core.meprop``, ``core.rowdither``),
against ``repro.core``.

The reference's draws are fed to the port: each layer's cotangent draw
(``key_for(name)``) through ``DitherCtx.unit_noise``, its residual draw
through ``resid_noise``, and the row and rounding uniforms as tensors.

Delta is the reference's (``jnp.std`` over the shape the reference reduces)
wherever a test compares k or a product built from it: ``torch.std``
reduces in another order and may move a k that sits at a rounding
boundary (tests/test_torch_models.py). Then k is the reference's bit for
bit and the int32 products agree exactly: int8 products to rel 1e-6 (the
rescale), a dx folded back by ``F.fold`` to rtol 1e-5 (atol 1e-6 of the
largest entry), f32 products and convolution gradients to rtol 1e-4 (atol
1e-5 of the largest entry), the bands of tests/test_torch_ops.py.
Elementwise functions of the same f32 operations (meProp, the row masks,
absmax int8) are compared exactly; those with a reduction (row norms,
range BatchNorm) to rtol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy, nsd as jnsd  # noqa: E402
from repro.core import conv2d as jconv2d, dense as jdense  # noqa: E402
from repro.core import int8 as jint8, meprop as jmeprop, rowdither as jrow  # noqa: E402
from repro.core.policy import VARIANTS as J_VARIANTS  # noqa: E402
from repro.memory import parse_memory_program as j_parse  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.core import dithered, int8, meprop, nsd, rowdither  # noqa: E402
from repro_torch.core.policy import VARIANTS, DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.kernels import bsp_matmul, build  # noqa: E402
from repro_torch.memory.policy import parse_memory_program  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.quant import wire  # noqa: E402

S = 2.0


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _draw(key, shape, lo=-0.5, hi=0.5):
    return np.array(jax.random.uniform(key, tuple(shape), jnp.float32, lo, hi))


class FedCtx(DitherCtx):
    """Hands the port the reference's draws of each layer: its cotangent's
    (as the port asks: (T, N), or (T, 1) for the row variant, whose
    uniform in [0, 1) the port reads as u + 1/2) and its residual's."""

    def __init__(self, policy, jctx, memory=None):
        super().__init__(policy, device="cpu", memory=memory)
        self.jctx = jctx

    def unit_noise(self, name, shape):
        key = self.jctx.key_for(name)
        if shape[-1] == 1 and self.policy.variant == "row":
            return torch.from_numpy(_draw(key, shape[:1], 0.0, 1.0) - 0.5
                                    ).reshape(shape)
        return torch.from_numpy(_draw(key, shape))

    def resid_noise(self, name, shape):
        return torch.from_numpy(_draw(jquant.resid_key(self.jctx.key_for(name)),
                                      shape))


@pytest.fixture
def reference_delta(monkeypatch):
    """Route the port's Delta through the reference's function, reduced
    over the shape the reference reduces (``shapes`` maps the port's 2-D
    view to it)."""
    shapes = {}

    def delta(x, s):
        a = x.detach().numpy()
        return torch.from_numpy(np.array(jnsd.compute_delta(
            jnp.asarray(a.reshape(shapes.get(a.shape, a.shape))), s)))

    monkeypatch.setattr(nsd, "compute_delta", delta)
    return shapes


def _jctx(variant, **kw):
    return JCtx.for_step(jax.random.PRNGKey(3), 0,
                         JPolicy(variant=variant, s=S, **kw))


def _jit_vjp(f, primals, cotangent):
    def run(primals, ct):
        y, vjp = jax.vjp(f, *primals)
        return y, vjp(ct)
    return jax.jit(run)(tuple(map(jnp.asarray, primals)), jnp.asarray(cotangent))


def _close(actual, desired, rtol, atol_frac=0.0):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=rtol,
                               atol=atol_frac * float(np.abs(desired).max()))


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# SAME and strided convolutions (the models' cases)
# ---------------------------------------------------------------------------

# (x NHWC, kernel, out channels, stride, XLA's SAME pads)
SAME_CASES = {
    "alexnet_c0": ((2, 32, 32, 3), 3, 8, 2, ((0, 1), (0, 1))),
    "resnet18_3x3_s2": ((2, 16, 16, 8), 3, 16, 2, ((0, 1), (0, 1))),
    "resnet18_downsample": ((2, 16, 16, 8), 1, 16, 2, ((0, 0), (0, 0))),
    "lenet5_c1": ((2, 28, 28, 1), 5, 6, 1, ((2, 2), (2, 2))),
}


@pytest.mark.parametrize("case", SAME_CASES)
def test_same_pads(case):
    shape, k, _, stride, pads = SAME_CASES[case]
    assert dithered.conv_pads("SAME", shape[1:3], (k, k), stride, 1) == pads
    assert dithered.conv_pads("VALID", shape[1:3], (k, k), stride, 1) == ((0, 0), (0, 0))
    assert dithered.conv_pads(1, shape[1:3], (k, k), stride, 1) == ((1, 1), (1, 1))
    assert dithered.conv_pads(((0, 1), (2, 3)), shape[1:3], (k, k), stride, 1) == (
        (0, 1), (2, 3))
    with pytest.raises(ValueError):  # torch's (ph, pw) is not taken
        dithered.conv_pads((1, 2), shape[1:3], (k, k), stride, 1)


def _conv_case(case, variant, reference_delta, memory=None, x_grad=True):
    """y and (dx, dW, db) of one SAME convolution on both sides, NHWC/HWIO,
    the port's dx None when x needs no gradient."""
    shape, k, co, stride, _ = SAME_CASES[case]
    x = _np(shape, 10)
    if memory:
        x = np.maximum(x, 0)  # a post-ReLU activation, as the models save
    w, b = _np((k, k, shape[-1], co), 11, 0.2), _np((co,), 12)
    jc = JCtx.for_step(jax.random.PRNGKey(3), 0, JPolicy(variant=variant, s=S),
                       memory=j_parse(memory) if memory else None)
    f = lambda x, w, b: jconv2d(x, w, b, strides=(stride, stride),  # noqa: E731
                                padding="SAME", ctx=jc, name="cv")
    g = _np(jax.eval_shape(f, x, w, b).shape, 13, 0.1)
    y_j, grads_j = _jit_vjp(f, (x, w, b), g)
    if variant != "kernel":  # the generic path reduces the NHWC cotangent
        reference_delta[(int(np.prod(g.shape[:3])), co)] = g.shape
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(x_grad)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    ctx = FedCtx(DitherPolicy(variant=variant, s=S), jc,
                 parse_memory_program(memory) if memory else None)
    y_t = dithered.conv2d(xt, wt, bt, stride=stride, padding="SAME", ctx=ctx,
                          name="cv")
    y_t.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    _close(y_t.detach().permute(0, 2, 3, 1), y_j, 1e-5, 1e-6)
    dx_t = None if xt.grad is None else xt.grad.permute(0, 2, 3, 1)
    return grads_j, (dx_t, wt.grad.permute(2, 3, 1, 0), bt.grad)


@pytest.mark.parametrize("variant", ["paper", "kernel"])
@pytest.mark.parametrize("case", SAME_CASES)
def test_same_conv_backward_vs_vjp(case, variant, reference_delta):
    (dx_j, dw_j, db_j), (dx_t, dw_t, db_t) = _conv_case(case, variant,
                                                        reference_delta)
    assert dx_t.shape == dx_j.shape
    if variant == "kernel":
        _close(dx_t, dx_j, 1e-5, 1e-6)
        _close(dw_t, dw_j, 1e-6)
    else:
        _close(dx_t, dx_j, 1e-4, 1e-5)
        _close(dw_t, dw_j, 1e-4, 1e-5)
    _close(db_t, db_j, 1e-5, 1e-6)


def test_stride2_conv_nsd_container_matches_reference(monkeypatch,
                                                      reference_delta):
    """memory="default=nsd" on AlexNet's stride-2 c0: the saved residual is
    the unpadded x, encoded in NHWC; with the reference's residual draw and
    Delta its wire container equals the reference's byte for byte, and dW
    from it the reference's."""
    shape = SAME_CASES["alexnet_c0"][0]
    x = np.maximum(_np(shape, 10), 0)
    key = JCtx.for_step(jax.random.PRNGKey(3), 0, JPolicy()).key_for("cv")
    want = jax.jit(lambda x: jquant.encode("nsd", x, jquant.resid_key(key)))(
        jnp.asarray(x))
    seen = []
    real = wire.pack_nsd

    def recording(xx, noise, s, **kw):
        p = real(xx, noise, s, delta=torch.tensor(np.asarray(want.deltas[0])))
        seen.append(p)
        return p

    monkeypatch.setattr(wire, "pack_nsd", recording)
    (_, dw_j, _), (_, dw_t, _) = _conv_case("alexnet_c0", "paper",
                                            reference_delta, memory="default=nsd")
    (got,) = seen
    assert got.shape == shape  # NHWC, unpadded
    np.testing.assert_array_equal(got.levels.numpy(), np.asarray(want.levels))
    np.testing.assert_array_equal(got.bitmap.numpy(), np.asarray(want.bitmap))
    np.testing.assert_array_equal(got.deltas.numpy(), np.asarray(want.deltas))
    assert int(got.nnz) == int(want.nnz)
    assert int(got.wire_bytes()) == int(want.wire_bytes())
    _close(dw_t, dw_j, 1e-4, 1e-5)


# ---------------------------------------------------------------------------
# the int8 variant
# ---------------------------------------------------------------------------

# (T, K, N): batch-64 dense layers of the MNIST models, T below one tile
INT8_DENSE = [(64, 784, 500), (64, 120, 84), (37, 300, 6)]


@pytest.mark.parametrize("tkn", INT8_DENSE, ids=str)
def test_int8_dense_vs_vjp(tkn, monkeypatch, reference_delta):
    """dx and dW of the int8 variant against the reference's int8 products:
    k (from the NSD kernel's plain version) equal to the reference's, both
    products on the int8 kernel's plain version, rel 1e-6."""
    T, K, N = tkn
    x, w, g = _np((T, K), 1), _np((K, N), 2, 0.1), _np((T, N), 3, 0.1)
    jc = _jctx("int8")
    _, (dx_j, dw_j) = _jit_vjp(lambda x, w: jdense(x, w, ctx=jc, name="fc"),
                               (x, w), g)
    ks, products = [], []
    real_q, real_mm = dithered.ops.quantize_and_mask, bsp_matmul.bsp_matmul_int8

    def q_rec(*a, **kw):
        ks.append(real_q(*a, **kw))
        return ks[-1]

    def mm_rec(*a, **kw):
        products.append(kw)
        return real_mm(*a, **kw)

    monkeypatch.setattr(dithered.ops, "quantize_and_mask", q_rec)
    monkeypatch.setattr(bsp_matmul, "bsp_matmul_int8", mm_rec)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    launches = dict(build.LAUNCHES)
    dithered.dense(xt, wt, ctx=FedCtx(DitherPolicy(variant="int8", s=S), jc),
                   name="fc").backward(torch.from_numpy(g))
    assert build.LAUNCHES == launches
    assert len(ks) == 1 and len(products) == 2
    d_j = jnsd.compute_delta(jnp.asarray(g), S)
    k_j = np.asarray(jnsd.nsd_indices(jnp.asarray(g), jc.key_for("fc"), d_j))
    np.testing.assert_array_equal(ks[0].k[:T, :N].numpy(), k_j)
    assert not ks[0].k[T:].any() and not ks[0].k[:, N:].any()
    assert _rel_l2(xt.grad, dx_j) <= 1e-6
    assert _rel_l2(wt.grad, dw_j) <= 1e-6


def test_int8_telemetry_matches_reference(reference_delta):
    T, K, N = INT8_DENSE[1]
    x, w, g = _np((T, K), 4), _np((K, N), 5, 0.1), _np((T, N), 6, 0.1)
    jc = _jctx("int8", collect_stats=True)
    jmetrics.reset()
    _jit_vjp(lambda w: jdense(jnp.asarray(x), w, ctx=jc, name="fc"), (w,), g)
    jax.effects_barrier()
    metrics.reset()
    wt = torch.from_numpy(w).requires_grad_()
    pol = DitherPolicy(variant="int8", s=S, collect_stats=True)
    dithered.dense(torch.from_numpy(x), wt, ctx=FedCtx(pol, jc),
                   name="fc").backward(torch.from_numpy(g))
    assert metrics.tags() == ["fc"]
    row_t, row_j = metrics.rows("fc")[0], jmetrics.rows("fc")[0]
    np.testing.assert_array_max_ulp(row_t[0], row_j[0], maxulp=1)
    assert row_t[1] == row_j[1]
    assert row_t[2] == row_j[2]


@pytest.mark.parametrize("case", ["alexnet_c0", "lenet5_c1"])
def test_int8_conv_equals_paper(case, reference_delta):
    """A convolution's int8 variant takes the generic (paper) path."""
    (_, dw_j, _), got = _conv_case(case, "int8", reference_delta)
    _, paper = _conv_case(case, "paper", reference_delta)
    for a, b in zip(got, paper):
        assert torch.equal(a, b)
    _close(got[1], dw_j, 1e-4, 1e-5)


# ---------------------------------------------------------------------------
# meProp and row dither: the modules, and the variants through dense
# ---------------------------------------------------------------------------

def _ties():
    """Rows with repeated magnitudes around the top-k threshold."""
    g = np.tile(np.array([3.0, -3.0, 2.0, -2.0, 2.0, 1.0, -1.0, 0.5, 0.0, 2.0],
                         np.float32), (4, 1))
    g[1] *= -1
    g[2, ::2] = 0.0
    return g


@pytest.mark.parametrize("k_frac", [0.1, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_meprop_matches_reference(case, k_frac):
    g = _np((6, 40), 7) if case == "random" else _ties()
    got = meprop.meprop_sparsify(torch.from_numpy(g), k_frac).numpy()
    want = np.asarray(jmeprop.meprop_sparsify(jnp.asarray(g), k_frac))
    np.testing.assert_array_equal(got, want)
    assert float(meprop.meprop_sparsity(torch.from_numpy(g), k_frac)) == float(
        jmeprop.meprop_sparsity(jnp.asarray(g), k_frac))
    if k_frac == 1.0:
        np.testing.assert_array_equal(got, g)


def test_meprop_keeps_ties_on_both_sides():
    g = _ties()
    got = meprop.meprop_sparsify(torch.from_numpy(g), 0.2).numpy()  # k = 2
    # row 0: 3 and -3 are the top two; row 2 (0, -3, 0, -2, 0, 1, 0, 0.5,
    # 0, 2): -3 and a 2 are, and the other 2 ties with the threshold
    assert (got[0] != 0).sum() == 2
    assert (got[2] != 0).sum() == 3


def _row_case(seed, shape=(48, 20)):
    g = _np(shape, seed)
    g[::5] *= 0.05  # rows of small norm: kept with p < 1
    key = jax.random.PRNGKey(seed)
    return g, key, _draw(key, shape[:1], 0.0, 1.0)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 2.0])
def test_row_dither_matches_reference(alpha):
    g, key, u = _row_case(1)
    got = rowdither.row_dither(torch.from_numpy(g), torch.from_numpy(u), alpha)
    want = np.asarray(jrow.row_dither(jnp.asarray(g), key, alpha))
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    _close(got, want, 1e-6)
    assert float(rowdither.row_sparsity(torch.from_numpy(g), torch.from_numpy(u),
                                        alpha)) == float(
        jrow.row_sparsity(jnp.asarray(g), key, alpha))


@pytest.mark.parametrize("capacity", [8, 48])
def test_row_dither_compact_matches_reference(capacity):
    g, key, u = _row_case(2)
    got = rowdither.row_dither_compact(torch.from_numpy(g), torch.from_numpy(u),
                                       2.0, capacity)
    want = jrow.row_dither_compact(jnp.asarray(g), key, 2.0, capacity)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.n_rows) == int(want.n_rows)
    _close(got.rows, want.rows, 1e-6)
    _close(rowdither.scatter_rows(got, g.shape[0]),
           jrow.scatter_rows(want, g.shape[0]), 1e-6)


def test_row_then_nsd_matches_reference(reference_delta):
    g, key, _ = _row_case(3)
    k1, k2 = jax.random.split(key)
    u_rows = _draw(k1, g.shape[:1], 0.0, 1.0)
    u_nsd = _draw(k2, g.shape)
    got = rowdither.row_then_nsd(torch.from_numpy(g), torch.from_numpy(u_rows),
                                 torch.from_numpy(u_nsd), 1.0, S)
    want = np.asarray(jrow.row_then_nsd(jnp.asarray(g), key, 1.0, S))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant,layer", [("row", "dense"), ("row", "conv"),
                                           ("meprop", "dense"),
                                           ("meprop", "conv")])
def test_row_and_meprop_variants_vs_vjp(variant, layer):
    """The variants through the dithered ops, f32 products, and their
    telemetry rows (the zero share, 32 bits, Delta 0)."""
    jc = _jctx(variant, collect_stats=True)
    pol = DitherPolicy(variant=variant, s=S, collect_stats=True)
    if layer == "dense":
        x, w, g = _np((40, 24), 8), _np((24, 16), 9, 0.2), _np((40, 16), 10, 0.1)
        g[::3] *= 0.05
        f = lambda x, w: jdense(x, w, ctx=jc, name="fc")  # noqa: E731
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        run = lambda xt, wt, ctx: dithered.dense(xt, wt, ctx=ctx, name="fc")  # noqa: E731
        gt = torch.from_numpy(g)
    else:
        x, w = _np((2, 8, 8, 4), 8), _np((3, 3, 4, 6), 9, 0.2)
        f = lambda x, w: jconv2d(x, w, strides=(2, 2), padding="SAME",  # noqa: E731
                                 ctx=jc, name="fc")
        g = _np(jax.eval_shape(f, x, w).shape, 10, 0.1)
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
        run = lambda xt, wt, ctx: dithered.conv2d(xt, wt, stride=2,  # noqa: E731
                                                  padding="SAME", ctx=ctx, name="fc")
        gt = torch.from_numpy(g.transpose(0, 3, 1, 2).copy())
    jmetrics.reset()
    _, (dx_j, dw_j) = _jit_vjp(f, (x, w), g)
    jax.effects_barrier()
    metrics.reset()
    xt, wt = xt.requires_grad_(), wt.requires_grad_()
    run(xt, wt, FedCtx(pol, jc)).backward(gt)
    dx_t, dw_t = xt.grad, wt.grad
    if layer == "conv":
        dx_t, dw_t = dx_t.permute(0, 2, 3, 1), dw_t.permute(2, 3, 1, 0)
    _close(dx_t, dx_j, 1e-4, 1e-5)
    _close(dw_t, dw_j, 1e-4, 1e-5)
    row_t, row_j = metrics.rows("fc")[0], jmetrics.rows("fc")[0]
    # the zero share is a count over g.size, and the count must agree; its
    # f32 value may not to the bit: the jitted reference fuses 1 - c * (1/n)
    # into one rounding (c = 496 of 640 here: 2 ulp from the unfused form)
    assert np.rint(row_t[0] * g.size) == np.rint(row_j[0] * g.size)
    assert row_t[1] == row_j[1] == 32.0 and row_t[2] == row_j[2] == 0.0
    assert 0.0 < row_t[0] < 1.0


# ---------------------------------------------------------------------------
# core.int8 and the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_int8_matches_reference(stochastic):
    x = _np((33, 17), 11)
    key = jax.random.PRNGKey(5) if stochastic else None
    u = torch.from_numpy(_draw(key, x.shape)) if stochastic else None
    got = int8._quantize_int8(torch.from_numpy(x), u)
    want = jint8._quantize_int8(jnp.asarray(x), key)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert float(got.scale) == float(want.scale)
    assert torch.equal(int8.absmax_int8(torch.from_numpy(x)).q,
                       int8._quantize_int8(torch.from_numpy(x)).q)


def test_int8_matmul_and_dense_ste_match_reference():
    """Forward: the exact int32 sum times the scales (the int8 kernel's
    plain version on the CPU), rel 1e-6; backward straight through in f32,
    rtol 1e-5."""
    x, w, g = _np((5, 7, 40), 12), _np((40, 9), 13, 0.2), _np((5, 7, 9), 14)
    xq, wq = jint8._quantize_int8(jnp.asarray(x)), jint8._quantize_int8(jnp.asarray(w))
    want = np.asarray(jint8.int8_matmul(xq, wq))
    got = int8.int8_matmul(int8.absmax_int8(torch.from_numpy(x)),
                           int8.absmax_int8(torch.from_numpy(w)))
    assert got.shape == (5, 7, 9)
    assert _rel_l2(got, want) <= 1e-6
    y_j, (dx_j, dw_j) = _jit_vjp(jint8.int8_dense_ste, (x, w), g)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y_t = int8.int8_dense_ste(xt, wt)
    y_t.backward(torch.from_numpy(g))
    assert _rel_l2(y_t.detach(), y_j) <= 1e-6
    _close(xt.grad, dx_j, 1e-5, 1e-6)
    _close(wt.grad, dw_j, 1e-5, 1e-6)


@pytest.mark.parametrize("axis", [0, (0, 1, 2)])
def test_range_batchnorm_matches_reference(axis):
    x = _np((6, 4, 4, 5), 15)
    gamma, beta = _np((5,), 16), _np((5,), 17)
    got = int8.range_batchnorm(torch.from_numpy(x), torch.from_numpy(gamma),
                               torch.from_numpy(beta), axis=axis)
    want = jint8.range_batchnorm(jnp.asarray(x), jnp.asarray(gamma),
                                 jnp.asarray(beta), axis=axis)
    _close(got, want, 1e-6, 1e-7)


def test_policy_variants_and_knobs():
    assert VARIANTS == J_VARIANTS
    # the port's row and meProp variants run at the reference's defaults
    assert (meprop.MEPROP_K_FRAC, rowdither.ROW_ALPHA) == (
        JPolicy().meprop_k_frac, JPolicy().row_alpha)
    for kw in ({"s": -1.0}, {"s": 0.0}, {"variant": "bogus"}):
        with pytest.raises(ValueError):
            DitherPolicy(**kw)
        with pytest.raises(ValueError):
            JPolicy(**kw)
