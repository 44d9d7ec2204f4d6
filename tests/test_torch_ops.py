"""Port parity: the kernel-path backward of one layer
(``repro_torch.kernels.ops``) and the dithered ``dense`` / ``conv2d`` ops
(``repro_torch.core.dithered``) against ``repro.kernels.ops`` and
``jax.vjp`` of ``repro.core.dense`` / ``conv2d``, with the cotangent and
the reference's own noise draw fed to both sides.

Tolerances. k, nnz, bitmap and mask are compared bit for bit. The int32
sums are exact, so a product differs only through Delta = s * std(g), a
reduction whose order differs between the frameworks (a few f32 ulps):
rtol 1e-6. A dx that folds im2col columns back (``F.fold`` against XLA's
transposed patch extraction) adds up to 9 f32 terms in another order:
rtol 1e-5 plus atol 1e-6 of the largest entry. The paper variant's f32
products and convolution gradients run in other summation orders (XLA's
dot and convolution against torch's): rtol 1e-4 plus atol 1e-5 of the
largest entry. A flipped k moves an entry by a whole Delta-sized term, far
outside all of these.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy  # noqa: E402
from repro.core import conv2d as jconv2d, dense as jdense  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.core import dithered  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.kernels import bsp_matmul, ops  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

S = 1.5


class FedCtx(DitherCtx):
    """Hands the port the reference's noise instead of drawing its own."""

    def __init__(self, policy, fed):
        super().__init__(policy, device="cpu")
        self.fed = fed

    def unit_noise(self, name, shape):
        return torch.from_numpy(self.fed[name].reshape(shape))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _jctx(variant, **kw):
    return JCtx.for_step(jax.random.PRNGKey(3), 0,
                         JPolicy(variant=variant, s=S, **kw))


def _unit(key, shape):
    return np.array(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))


def _jit_vjp(f, primals, cotangent):
    """(f(*primals), vjp(cotangent)) of the reference, under one jit."""
    def run(primals, ct):
        y, vjp = jax.vjp(f, *primals)
        return y, vjp(ct)
    return jax.jit(run)(tuple(map(jnp.asarray, primals)), jnp.asarray(cotangent))


def _close(actual, desired, rtol, atol_frac=0.0):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=rtol,
                               atol=atol_frac * float(np.abs(desired).max()))


# two padded shape families, shared by the tests below so the reference's
# interpret-mode kernels compile once per family
TNK = [(100, 200, 72), (300, 64, 10)]


@pytest.mark.parametrize("tnk", TNK)
def test_quantize_and_mask_bit_exact(tnk):
    T, N, _ = tnk
    g = _np((T, N), 1, 0.1)
    key = jax.random.PRNGKey(11)
    qj = jax.jit(lambda g: jops.quantize_and_mask(g, key, S))(jnp.asarray(g))
    qt = ops.quantize_and_mask(torch.from_numpy(g),
                               torch.from_numpy(_unit(key, (T, N))), S)
    assert float(qt.delta) == pytest.approx(float(qj.delta), rel=1e-6)
    for name in ("k", "nnz", "bitmap", "mask"):
        np.testing.assert_array_equal(getattr(qt, name).numpy(),
                                      np.asarray(getattr(qj, name)), name)
    assert qt.shape == (T, N)


@pytest.mark.parametrize("tnk", TNK)
def test_dithered_backward_matmuls(tnk):
    T, N, K = tnk
    g, x, w = _np((T, N), 2, 0.1), _np((T, K), 3), _np((K, N), 4, 0.2)
    key = jax.random.PRNGKey(12)
    dx_j, dw_j = jax.jit(lambda *a: jops.dithered_backward_matmuls(*a, key, S))(
        jnp.asarray(g), jnp.asarray(x), jnp.asarray(w))
    dx_t, dw_t = ops.dithered_backward_matmuls(
        torch.from_numpy(g), torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(_unit(key, (T, N))), S)
    assert dx_t.shape == (T, K) and dw_t.shape == (K, N)
    _close(dx_t, dx_j, 1e-6)
    _close(dw_t, dw_j, 1e-6)


def test_quantized_from_indices_matches_reference():
    k = np.random.default_rng(5).integers(-3, 4, (150, 70)).astype(np.int8)
    qj = jops.quantized_from_indices(jnp.asarray(k), jnp.float32(0.5))
    qt = ops.quantized_from_indices(torch.from_numpy(k), torch.tensor(0.5))
    for name in ("k", "nnz", "bitmap", "mask"):
        np.testing.assert_array_equal(getattr(qt, name).numpy(),
                                      np.asarray(getattr(qj, name)), name)


def _dense_vjp(variant, T, K, N, x_grad=True):
    x, w, b, g = _np((T, K), 6), _np((K, N), 7, 0.2), _np((N,), 8), _np((T, N), 9, 0.1)
    jc = _jctx(variant)
    y_j, grads_j = _jit_vjp(lambda x, w, b: jdense(x, w, b, ctx=jc, name="fc"),
                            (x, w, b), g)
    fed = {"fc": _unit(jc.key_for("fc"), (T, N))}
    xt = torch.from_numpy(x).requires_grad_(x_grad)
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y_t = dithered.dense(xt, wt, bt,
                         ctx=FedCtx(DitherPolicy(variant=variant, s=S), fed),
                         name="fc")
    y_t.backward(torch.from_numpy(g))
    _close(y_t.detach(), y_j, 1e-5, 1e-6)
    return grads_j, (xt.grad, wt.grad, bt.grad)


@pytest.mark.parametrize("tnk", TNK)
def test_dense_kernel_backward_vs_vjp(tnk):
    T, N, K = tnk
    (dx_j, dw_j, db_j), (dx_t, dw_t, db_t) = _dense_vjp("kernel", T, K, N)
    _close(dx_t, dx_j, 1e-6)
    _close(dw_t, dw_j, 1e-6)
    _close(db_t, db_j, 1e-5, 1e-6)  # exact cotangent, summed in another order


def test_dense_paper_backward_vs_vjp():
    (dx_j, dw_j, db_j), (dx_t, dw_t, db_t) = _dense_vjp("paper", 100, 72, 200)
    _close(dx_t, dx_j, 1e-4, 1e-5)
    _close(dw_t, dw_j, 1e-4, 1e-5)
    _close(db_t, db_j, 1e-5, 1e-6)


def _conv_vjp(variant, stride, padding_j, padding_t, x_grad=True,
              shape=(2, 10, 10, 7), co=13):
    B, H, W, Ci = shape
    x, w = _np(shape, 10), _np((3, 3, Ci, co), 11, 0.2)
    b = _np((co,), 12)
    jc = _jctx(variant)
    f = lambda x, w, b: jconv2d(x, w, b, strides=(stride, stride),  # noqa: E731
                                padding=padding_j, ctx=jc, name="cv")
    g = _np(jax.eval_shape(f, x, w, b).shape, 13, 0.1)
    y_j, grads_j = _jit_vjp(f, (x, w, b), g)
    T = int(np.prod(y_j.shape[:3]))
    # the reference draws (T, Co) on the kernel path and the cotangent's own
    # NHWC shape on the paper path; fed to the port as (T, Co) either way
    draw = (T, co) if variant == "kernel" else y_j.shape
    fed = {"cv": _unit(jc.key_for("cv"), draw).reshape(T, co)}
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(x_grad)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y_t = dithered.conv2d(xt, wt, bt, stride=stride, padding=padding_t,
                          ctx=FedCtx(DitherPolicy(variant=variant, s=S), fed),
                          name="cv")
    y_t.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    _close(y_t.detach().permute(0, 2, 3, 1), y_j, 1e-4, 1e-5)
    dx_t = None if xt.grad is None else xt.grad.permute(0, 2, 3, 1)
    return grads_j, (dx_t, wt.grad.permute(2, 3, 1, 0), bt.grad)


@pytest.mark.parametrize("stride,pj,pt", [(1, "SAME", 1), (2, "VALID", 0)])
def test_conv_kernel_backward_vs_vjp(stride, pj, pt):
    (dx_j, dw_j, db_j), (dx_t, dw_t, db_t) = _conv_vjp("kernel", stride, pj, pt)
    _close(dx_t, dx_j, 1e-5, 1e-6)
    _close(dw_t, dw_j, 1e-6)
    _close(db_t, db_j, 1e-5, 1e-6)


def test_conv_paper_backward_vs_vjp():
    (dx_j, dw_j, _), (dx_t, dw_t, _) = _conv_vjp("paper", 1, "SAME", 1)
    _close(dx_t, dx_j, 1e-4, 1e-5)
    _close(dw_t, dw_j, 1e-4, 1e-5)


def test_conv_kernel_skips_dx_without_input_grad(monkeypatch):
    """As for a network's first layer: no dx product is launched when the
    input needs no gradient, and dW is unchanged."""
    calls = []
    real = bsp_matmul.bsp_matmul_int8

    def counting(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(bsp_matmul, "bsp_matmul_int8", counting)
    (_, dw_j, _), (dx_t, dw_t, _) = _conv_vjp("kernel", 1, "SAME", 1,
                                              x_grad=False)
    assert dx_t is None
    assert calls == [{"trans_a": True}]
    _close(dw_t, dw_j, 1e-6)


def test_grouped_conv_is_a_counted_fallback():
    x = torch.from_numpy(_np((1, 4, 6, 6), 14))
    w = torch.from_numpy(_np((4, 2, 3, 3), 15, 0.2))
    fed = {"gcv": _unit(jax.random.PRNGKey(4), (36, 4))}
    before = ops.KERNEL_FALLBACKS.get("conv:groups", 0)
    grads = {}
    for variant in ("kernel", "paper"):
        wt = w.clone().requires_grad_()
        y = dithered.conv2d(x, wt, padding=1, groups=2, name="gcv",
                            ctx=FedCtx(DitherPolicy(variant=variant, s=S), fed))
        (y ** 2).sum().backward()
        grads[variant] = wt.grad
    assert ops.KERNEL_FALLBACKS["conv:groups"] == before + 1
    assert torch.equal(grads["kernel"], grads["paper"])


def test_kernel_telemetry_matches_reference():
    """The kernel path's stats come from the k the matmuls consume and equal
    the row the reference emits for the same layer."""
    T, N, K = TNK[0]
    x, w, g = _np((T, K), 16), _np((K, N), 17, 0.1), _np((T, N), 18, 0.1)
    jc = _jctx("kernel", collect_stats=True)
    jmetrics.reset()
    _jit_vjp(lambda w: jdense(jnp.asarray(x), w, ctx=jc, name="fc"), (w,), g)
    jax.effects_barrier()
    row_j = jmetrics.rows("fc")[0]
    metrics.reset()
    pol = DitherPolicy(variant="kernel", s=S, collect_stats=True)
    wt = torch.from_numpy(w).requires_grad_()
    y = dithered.dense(torch.from_numpy(x), wt, name="fc",
                       ctx=FedCtx(pol, {"fc": _unit(jc.key_for("fc"), (T, N))}))
    y.backward(torch.from_numpy(g))
    row_t = metrics.rows("fc")[0]
    # sparsity = 1 - count * (1/n): the port rounds twice, like the
    # reference's quant_stats run op by op; under jit XLA may fuse it into
    # one FMA and round once, so the two agree to one f32 ulp
    np.testing.assert_array_max_ulp(row_t[0], row_j[0], maxulp=1)
    assert row_t[1] == row_j[1]  # bits
    assert row_t[2] == pytest.approx(row_j[2], rel=1e-6)  # delta
