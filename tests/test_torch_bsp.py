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


# -- split-K: the plan and the partials' reduction, emulated on the CPU ----

H100_SMS = 132
# VGG11-CIFAR's products at batch 128 as ops.py forms them, in 128-tiles:
# (m_tiles, n_tiles, k_tiles); dW^T = k^T . x is (N_out, T) x (T, K_in) and
# dx = k . w^T is (T, N_out) x (N_out, K_in), padded to 128
VGG11_PRODUCTS = {
    "c0 dW": (1, 1, 1024), "c1 dW": (1, 5, 256), "c2 dW": (2, 9, 64),
    "c3 dW": (2, 18, 64), "c4 dW": (4, 18, 16), "c5 dW": (4, 36, 16),
    "c7 dW": (4, 36, 4), "fc0 dW": (4, 4, 1), "c1 dx": (256, 5, 1),
    "c3 dx": (64, 18, 2), "c7 dx": (4, 36, 4), "fc2 dx": (1, 4, 4),
}


@pytest.mark.parametrize("tiles", list(VGG11_PRODUCTS.values()) +
                         [(1, 1, 37), (3, 2, 5), (1, 1, 1), (1, 2, 3), (7, 1, 129)],
                         ids=list(VGG11_PRODUCTS) + ["ragged", "odd", "one",
                                                     "short", "prime"])
def test_split_plan_covers_every_k_tile_once(tiles):
    m, n, k = tiles
    splits = bsp_matmul.split_k(m, n, k, H100_SMS)
    bounds = bsp_matmul.split_bounds(k, splits)
    assert [kt for lo, hi in bounds for kt in range(lo, hi)] == list(range(k))
    assert all(hi > lo for lo, hi in bounds)  # no empty split
    if m * n >= H100_SMS:
        assert splits == 1  # the output tiles fill the card: one pass
    if splits > 1:
        assert all(hi - lo >= bsp_matmul.MIN_SPLIT_TILES for lo, hi in bounds)
        assert m * n * splits <= 2 * H100_SMS + m * n  # about two waves


def test_split_plan_spreads_c0_dw_over_the_card():
    assert bsp_matmul.split_k(*VGG11_PRODUCTS["c0 dW"], H100_SMS) >= 100


def _split_k_int8_emulation(a, b, scale, mask, bounds, order):
    """Split-K as the int8 kernel reduces it: each K-range's partial sum
    as int32 (two's complement, wrapped), the partials added in ``order``
    with int32 wrap-around, then one f32 conversion and one f32 multiply.
    a (M, K) and b (K, N) int8 as the logical operands, mask (M/128, K/128).
    """
    keep = np.repeat(np.repeat(mask != 0, 128, 0), 128, 1)
    a_kept = np.where(keep, a, 0)
    partials = []
    for lo, hi in bounds:
        sl = slice(lo * 128, hi * 128)
        # float64 sums int8 products exactly (far below 2^53)
        exact = a_kept[:, sl].astype(np.float64) @ b[sl].astype(np.float64)
        partials.append(exact.astype(np.int64).astype(np.int32))
    acc = np.zeros_like(partials[0])
    for i in order:
        acc = acc + partials[i]  # int32 arrays wrap
    return acc.astype(np.float32) * np.float32(scale)


@pytest.mark.parametrize("k_tiles,kind", [(37, "random"), (37, "full"),
                                          (64, "random"), (5, "random")])
def test_split_int8_partials_reduce_to_the_plain_bits(k_tiles, kind):
    M, N, K = 256, 128, 128 * k_tiles
    a, b = _i8((M, K), 30 + k_tiles), _i8((K, N), 31)
    mask = _mask((M // 128, k_tiles), kind, 32)
    scale = np.float32(2.3e-4)
    splits = bsp_matmul.split_k(M // 128, N // 128, k_tiles, H100_SMS)
    order = np.random.default_rng(k_tiles).permutation(splits)
    got = _split_k_int8_emulation(a, b, scale, mask,
                                  bsp_matmul.split_bounds(k_tiles, splits), order)
    want = bsp_matmul.bsp_matmul_int8_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.tensor(scale),
        torch.from_numpy(mask))
    np.testing.assert_array_equal(got, want.numpy())


def test_split_int8_partials_wrap_to_the_plain_bits():
    """A K-range whose int32 partial wraps: 1,025 tiles of (-128) x (-128)
    sum to 2,149,580,800 > 2^31 - 1, and the last tile adds
    -128 * 127 * 128. The wrapped partials, added in either order, give
    the bits of the plain version's wrapped exact sum."""
    k_tiles = 1026
    M = N = 128
    a = np.full((M, 128 * k_tiles), -128, np.int8)
    b = np.full((128 * k_tiles, N), -128, np.int8)
    b[-128:] = 127
    mask = np.ones((1, k_tiles), np.int32)
    bounds = [(0, k_tiles - 1), (k_tiles - 1, k_tiles)]
    want = bsp_matmul.bsp_matmul_int8_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.tensor(1.0),
        torch.from_numpy(mask)).numpy()
    assert 128 * 128 * 128 * (k_tiles - 1) > 2**31 - 1  # partial 0 wraps
    for order in ([0, 1], [1, 0]):
        got = _split_k_int8_emulation(a, b, np.float32(1.0), mask, bounds, order)
        np.testing.assert_array_equal(got, want)


def _tf32_rna(x):
    """f32 -> TF32 (10 stored mantissa bits), round to nearest, ties away:
    the dequant kernel's bit arithmetic (that of cvt.rna.tf32.f32)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


REDUCE_ROWS = 8  # bsp_split.cuh's kReduceRows


def _split_k_tf32_emulation(k, delta, b, mask, splits, parts=("lo", "hi")):
    """The dequant kernel's arithmetic in numpy: B split into TF32 parts
    B_hi = tf32(B) and B_lo = tf32(B - B_hi); per split an f32 accumulator
    over its occupied K-tiles, each tile adding k . B_lo, then k . B_hi;
    the split partials added in the reduce kernel's fixed order (row y
    sums partials y, y + 8, ... in turn, then the rows are added in y
    order); one multiply by delta. (The tensor core's own order inside a
    tile is not reproduced.)"""
    M, K = k.shape
    b_hi = _tf32_rna(b)
    b_part = {"hi": b_hi, "lo": _tf32_rna(b - b_hi)}
    kf = k.astype(np.float32)
    partials = []
    for lo, hi in bsp_matmul.split_bounds(K // 128, splits):
        acc = np.zeros((M, b.shape[1]), np.float32)
        for kt in range(lo, hi):
            rows = np.repeat(mask[:, kt] != 0, 128)[:, None]
            sl = slice(kt * 128, (kt + 1) * 128)
            for p in parts:
                acc = acc + np.where(rows, kf[:, sl] @ b_part[p][sl], np.float32(0))
        partials.append(acc)
    if splits == 1:
        total = partials[0]
    else:
        row_sums = [sum(partials[y::REDUCE_ROWS], np.zeros_like(partials[0]))
                    for y in range(REDUCE_ROWS)]
        total = row_sums[0]
        for r in row_sums[1:]:
            total = total + r
    return total * np.float32(delta)


@pytest.mark.parametrize("mkn,kind", [((256, 128, 128), "random"),
                                      ((128, 131072, 128), "full")],
                         ids=["K=128", "c0 dW K=131072"])
def test_split_tf32_emulation_within_band_of_blocked_reference(mkn, kind):
    """The hi/lo TF32 split, summed in the kernel's order, is within
    8 sqrt(K) 2^-24 relative L2 of the reference's blocked f32 oracle; the
    high part alone (plain TF32) is not, at K = 128."""
    M, K, N = mkn
    k = _i8((M, K), 40)
    b = np.random.default_rng(41).standard_normal((K, N)).astype(np.float32)
    mask = _mask((M // 128, K // 128), kind, 42)
    delta = np.float32(1.7e-3)
    ref = np.asarray(bsp_matmul_blocked_ref(
        jnp.asarray(k), jnp.float32(delta), jnp.asarray(b), jnp.asarray(mask)),
        np.float64)
    splits = bsp_matmul.split_k(M // 128, N // 128, K // 128, H100_SMS)
    band = 8 * np.sqrt(K) * U

    def rel(x):
        return np.linalg.norm(x.astype(np.float64) - ref) / np.linalg.norm(ref)

    assert rel(_split_k_tf32_emulation(k, delta, b, mask, splits)) <= band
    if K == 128:
        assert rel(_split_k_tf32_emulation(k, delta, b, mask, splits,
                                           parts=("hi",))) > band
