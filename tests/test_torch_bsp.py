"""Port parity: the tile-skipping int8 product (``repro_torch.kernels.
bsp_matmul``'s plain version) against the Pallas ``bsp_matmul_int8``
(interpret mode). Integer sums are exact in any order and both sides
rescale with one f32 multiply, so the f32 outputs are bit-exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.bsp_matmul.bsp_matmul import bsp_matmul_int8 as j_bsp  # noqa: E402
from repro_torch.kernels import bsp_matmul, build, ops  # noqa: E402


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
