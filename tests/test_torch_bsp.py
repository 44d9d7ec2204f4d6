"""Port parity: the tile-skipping products (``repro_torch.kernels.
bsp_matmul``'s plain versions) against the Pallas ``bsp_matmul_int8`` and
``bsp_matmul`` (interpret mode).

The int8 product: integer sums are exact in any order and both sides
rescale with one f32 multiply, so the f32 outputs are bit-exact.

The dequant product (int8 k times an f32 operand, f32 accumulation) sums in
another order on each side (torch's f32 dot against XLA's, within each
128-long tile). Both are within gamma_K * (|k| . |B|) * Delta of the exact
value, gamma_K = K u / (1 - K u), u = 2^-24, for a contraction of length K
in any order (plus one rounding of the Delta multiply), so they are held
elementwise to twice that plus 2u of the product: a rigorous band, 4.6e-5
of |k| . |B| at K = 384, while a skipped or doubled tile moves an entry by
a whole tile's sum.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nsd as jnsd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.bsp_matmul.bsp_matmul import bsp_matmul as j_bsp_f32, bsp_matmul_int8 as j_bsp  # noqa: E402
from repro.kernels.bsp_matmul.ref import bsp_matmul_blocked_ref  # noqa: E402
from repro_torch.kernels import bsp_matmul, build, ops  # noqa: E402

U = 2.0 ** -24


def _i8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8)


def _mask(shape, kind, seed):
    if kind == "full":
        return np.ones(shape, np.int32)
    if kind == "empty":
        return np.zeros(shape, np.int32)
    return (np.random.default_rng(seed).random(shape) < 0.5).astype(np.int32)


@pytest.mark.parametrize("mkn", [(128, 128, 128), (256, 384, 128),
                                 (128, 256, 256)])
@pytest.mark.parametrize("kind", ["random", "full", "empty"])
def test_bsp_plain_vs_pallas(mkn, kind):
    M, K, N = mkn
    a, b = _i8((M, K), 1), _i8((K, N), 2)
    mask = _mask((M // 128, K // 128), kind, 3)
    scale = np.float32(1.7e-3)
    ref = np.asarray(j_bsp(jnp.asarray(a), jnp.asarray(b), jnp.float32(scale),
                           jnp.asarray(mask)))
    before = dict(build.LAUNCHES)
    out = bsp_matmul.bsp_matmul_int8(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.tensor(scale), torch.from_numpy(mask))
    assert build.LAUNCHES == before  # CPU tensors take the plain version
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    if kind == "empty":
        assert not out.any()


@pytest.mark.parametrize("trans_a,trans_b", [(True, False), (False, True),
                                             (True, True)])
def test_bsp_transposed_operands_vs_pallas(trans_a, trans_b):
    """A flag reads an operand stored transposed: the product equals the
    reference's on the logical (untransposed) operands, the mask given as
    A is stored."""
    M, K, N = 256, 384, 128
    a, b = _i8((M, K), 4), _i8((K, N), 5)
    mask = _mask((M // 128, K // 128), "random", 6)
    scale = np.float32(0.25)
    ref = np.asarray(j_bsp(jnp.asarray(a), jnp.asarray(b), jnp.float32(scale),
                           jnp.asarray(mask)))
    a_st = np.ascontiguousarray(a.T) if trans_a else a
    m_st = np.ascontiguousarray(mask.T) if trans_a else mask
    b_st = np.ascontiguousarray(b.T) if trans_b else b
    out = bsp_matmul.bsp_matmul_int8(
        torch.from_numpy(a_st), torch.from_numpy(b_st), torch.tensor(scale),
        torch.from_numpy(m_st), trans_a=trans_a, trans_b=trans_b)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", [(100, 200), (128, 128), (1, 129)])
def test_pad_to_matches_reference(shape):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        ops._pad_to(torch.from_numpy(x), 128, 128).numpy(),
        np.asarray(jops._pad_to(jnp.asarray(x), 128, 128)))


def test_bsp_on_padded_operands_vs_pallas():
    """Operands of a non-aligned layer, zero-padded by _pad_to on both
    sides: padding tiles are masked off and the live region agrees."""
    a = np.pad(_i8((100, 200), 8), ((0, 28), (0, 56)))
    b = _i8((200, 72), 9)
    mask = np.array([[1, 0]], np.int32)
    scale = np.float32(3e-4)
    ref = np.asarray(j_bsp(jnp.asarray(a), jops._pad_to(jnp.asarray(b), 128, 128),
                           jnp.float32(scale), jnp.asarray(mask)))
    out = bsp_matmul.bsp_matmul_int8(
        torch.from_numpy(a), ops._pad_to(torch.from_numpy(b), 128, 128),
        torch.tensor(scale), torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert not out[:, 72:].any() and not out[100:].any()


def test_bsp_plain_sums_exactly_at_the_int32_edge():
    """The longest contraction of VGG11 at batch 128 (dW of c0, 131072 rows)
    with every product at 127^2: 2,114,060,288, below 2^31 - 1, summed
    without rounding (an f32 accumulator would round its partial sums)."""
    K = 131072
    a = torch.full((K, 128), 127, dtype=torch.int8)  # stored (K, M): trans_a
    b = torch.full((K, 128), 127, dtype=torch.int8)
    mask = torch.ones(K // 128, 1, dtype=torch.int32)
    out = bsp_matmul.bsp_matmul_int8(a, b, torch.tensor(1.0), mask, trans_a=True)
    assert float(out[0, 0]) == float(np.float32(127 * 127 * K))
    assert 127 * 127 * K < 2**31 - 1


def test_bsp_rejects_bad_operands():
    a = torch.zeros(128, 256, dtype=torch.int8)
    b = torch.zeros(128, 128, dtype=torch.int8)
    with pytest.raises(ValueError):  # contraction mismatch
        bsp_matmul.bsp_matmul_int8(a, b, torch.tensor(1.0),
                                   torch.ones(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError):  # mask of the wrong tile grid
        bsp_matmul.bsp_matmul_int8(b, b, torch.tensor(1.0),
                                   torch.ones(2, 1, dtype=torch.int32))


def _f32_sum_band(a, b, delta, K):
    """Elementwise band of two f32 evaluations of (a . b) * delta with a
    K-long contraction in any two orders (module docstring)."""
    gamma = K * U / (1 - K * U)
    mag = (np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))) * abs(float(delta))
    return 2 * (gamma + U) * mag


@pytest.mark.parametrize("mkn", [(128, 128, 128), (256, 384, 128),
                                 (128, 256, 256)])
@pytest.mark.parametrize("kind", ["random", "full", "empty"])
def test_dequant_plain_vs_pallas(mkn, kind):
    M, K, N = mkn
    k = _i8((M, K), 11)
    b = np.random.default_rng(12).standard_normal((K, N)).astype(np.float32)
    mask = _mask((M // 128, K // 128), kind, 13)
    delta = np.float32(1.7e-3)
    args = (jnp.asarray(k), jnp.float32(delta), jnp.asarray(b), jnp.asarray(mask))
    ref = np.asarray(j_bsp_f32(*args, interpret=True))
    ref_blocked = np.asarray(bsp_matmul_blocked_ref(*args))
    before = dict(build.LAUNCHES)
    out = bsp_matmul.bsp_matmul(torch.from_numpy(k), torch.tensor(delta),
                                torch.from_numpy(b), torch.from_numpy(mask))
    assert build.LAUNCHES == before  # CPU tensors take the plain version
    assert out.dtype == torch.float32 and out.shape == (M, N)
    keep = np.repeat(np.repeat(mask != 0, 128, 0), 128, 1)
    band = _f32_sum_band(np.where(keep, k, 0), b, delta, K)
    for want in (ref, ref_blocked):
        assert np.all(np.abs(out.numpy() - want) <= band)
    if kind == "empty":
        assert not out.any()


def test_dequant_transposed_operand_vs_pallas():
    """trans_a reads k stored (K, M), as dW = k^T . x does; the mask is
    given as k is stored."""
    M, K, N = 256, 384, 128
    k = _i8((M, K), 14)
    b = np.random.default_rng(15).standard_normal((K, N)).astype(np.float32)
    mask = _mask((M // 128, K // 128), "random", 16)
    delta = np.float32(0.25)
    ref = np.asarray(j_bsp_f32(jnp.asarray(k), jnp.float32(delta), jnp.asarray(b),
                               jnp.asarray(mask), interpret=True))
    out = bsp_matmul.bsp_matmul(
        torch.from_numpy(np.ascontiguousarray(k.T)), torch.tensor(delta),
        torch.from_numpy(b), torch.from_numpy(np.ascontiguousarray(mask.T)),
        trans_a=True)
    keep = np.repeat(np.repeat(mask != 0, 128, 0), 128, 1)
    band = _f32_sum_band(np.where(keep, k, 0), b, delta, K)
    assert np.all(np.abs(out.numpy() - ref) <= band)


TNK = [(100, 200, 72), (300, 64, 10)]


@pytest.mark.parametrize("tnk", TNK)
def test_dithered_backward_matmuls_f32_operands_vs_reference(tnk):
    """``int8_operands=False``: both products on the dequant path, the
    reference's noise fed. Delta = s * std(g) differs by f32 reduction
    order (rel 1e-6, as in test_torch_ops), which scales every entry; the
    sums add the band above: rtol 2e-6 plus 2 (gamma_K + u) |k| . |B|
    Delta, with K the contraction of each product."""
    T, N, K = tnk
    rng = np.random.default_rng(17)
    g = (rng.standard_normal((T, N)) * 0.1).astype(np.float32)
    x = rng.standard_normal((T, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    key = jax.random.PRNGKey(18)
    dx_j, dw_j = jax.jit(lambda *a: jops.dithered_backward_matmuls(
        *a, key, 1.5, int8_operands=False))(jnp.asarray(g), jnp.asarray(x),
                                            jnp.asarray(w))
    u = np.array(jax.random.uniform(key, (T, N), jnp.float32, -0.5, 0.5))
    before = dict(build.LAUNCHES)
    dx_t, dw_t = ops.dithered_backward_matmuls(
        torch.from_numpy(g), torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(u), 1.5, int8_operands=False)
    assert build.LAUNCHES == before
    assert dx_t.shape == (T, K) and dw_t.shape == (K, N)
    delta = float(jnsd.compute_delta(jnp.asarray(g), 1.5))
    k = np.asarray(jnsd.nsd_indices(jnp.asarray(g), key, jnp.float32(delta)))
    for got, want, band in (
            (dx_t, dx_j, _f32_sum_band(k, w.T, delta, N)),
            (dw_t, dw_j, _f32_sum_band(x.T, k, delta, T))):
        want = np.asarray(want)
        assert np.all(np.abs(got.numpy() - want) <= 2e-6 * np.abs(want) + band)


def test_f32_operand_products_match_paper_products():
    """The dequant path's products against the paper variant's f32
    ``gq @ w^T`` and ``x^T @ gq`` for the same k: the JAX test's own
    tolerance (rtol 1e-3, atol 1e-4) and the rigorous sum band."""
    T, N, K = 256, 256, 128
    rng = np.random.default_rng(19)
    g = torch.from_numpy((rng.standard_normal((T, N)) * 0.01).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.1).astype(np.float32))
    u = torch.from_numpy(rng.random((T, N)).astype(np.float32) - 0.5)
    q = ops.quantize_and_mask(g, u, 2.0)
    dx, dw = ops.bsp_backward_from_quantized(q, x, w, int8_operands=False)
    gq = q.k[:T, :N].to(torch.float32) * q.delta
    for got, want in ((dx, gq @ w.t()), (dw, x.t() @ gq)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-4)


def test_dequant_rejects_bad_operands():
    k = torch.zeros(128, 256, dtype=torch.int8)
    with pytest.raises(ValueError, match="contraction"):
        bsp_matmul.bsp_matmul(k, torch.tensor(1.0), torch.zeros(128, 128),
                              torch.ones(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="mask"):
        bsp_matmul.bsp_matmul(k, torch.tensor(1.0), torch.zeros(256, 128),
                              torch.ones(2, 1, dtype=torch.int32))
    meta = torch.zeros(128, 128, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        bsp_matmul.bsp_matmul(meta, torch.tensor(1.0, device="meta"),
                              torch.zeros(128, 128, device="meta"),
                              torch.ones(1, 1, dtype=torch.int32, device="meta"))
