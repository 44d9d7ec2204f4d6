"""Port parity: the occupancy-bitmap pack (``repro_torch.kernels.pack``'s
plain version) and the bitmap helpers of ``repro_torch.quant.wire`` against
the Pallas ``bitmap_pack_blocked`` (interpret mode) and
``repro.quant.wire``. Everything here is integer: bit-exact throughout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.pack.pack import bitmap_pack_blocked as j_pack  # noqa: E402
from repro.quant import wire as jwire  # noqa: E402
from repro_torch.kernels import build, pack  # noqa: E402
from repro_torch.quant import wire  # noqa: E402


def _levels(shape, density, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    k[rng.random(shape) >= density] = 0
    return k


def _tile_sparse(shape, seed):
    """Random levels with whole 128 x 128 tiles left empty."""
    k = _levels(shape, 0.2, seed)
    rng = np.random.default_rng(seed + 1)
    for i in range(shape[0] // 128):
        for j in range(shape[1] // 128):
            if rng.random() < 0.5:
                k[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = 0
    return k


CASES = {
    "sparse": lambda: _levels((128, 128), 0.1, 1),
    "dense": lambda: _levels((256, 384), 1.0, 2),
    "all_zero": lambda: np.zeros((128, 256), np.int8),
    "empty_tiles": lambda: _tile_sparse((384, 512), 3),
    "single_bit": lambda: np.pad(np.ones((1, 1), np.int8), ((0, 127), (77, 50))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_plain_vs_pallas(case):
    k = CASES[case]()
    bm_j, nnz_j = j_pack(jnp.asarray(k), bm=128, bn=128)
    mask_j = jwire.tile_mask_from_bitmap(bm_j, 128, 128)
    before = dict(build.LAUNCHES)
    bitmap, nnz, mask = pack.bitmap_pack_blocked(torch.from_numpy(k))
    assert build.LAUNCHES == before  # CPU tensors take the plain version
    assert bitmap.dtype == torch.uint8 and bitmap.shape == (k.shape[0], k.shape[1] // 8)
    np.testing.assert_array_equal(bitmap.numpy(), np.asarray(bm_j))
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(nnz_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(
        nnz.numpy(), np.asarray(jwire.tile_nnz_from_bitmap(bm_j, 128, 128)))
    np.testing.assert_array_equal(mask.numpy(), (nnz.numpy() > 0).astype(np.int32))


@pytest.mark.parametrize("shape", [(5, 24), (3, 4, 16), (1, 8)])
def test_pack_unpack_bitmap_vs_wire(shape):
    bits = _levels(shape, 0.4, 4)
    packed_j = np.asarray(jwire.pack_bitmap(jnp.asarray(bits)))
    packed = wire.pack_bitmap(torch.from_numpy(bits))
    np.testing.assert_array_equal(packed.numpy(), packed_j)
    unpacked = wire.unpack_bitmap(packed)
    np.testing.assert_array_equal(unpacked.numpy(), bits != 0)
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(jwire.unpack_bitmap(jnp.asarray(packed_j))))


def test_popcount_all_bytes():
    b = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        wire.popcount_u8(torch.from_numpy(b)).numpy(),
        np.asarray(jwire.popcount_u8(jnp.asarray(b))))
    np.testing.assert_array_equal(
        wire.popcount_u8(torch.from_numpy(b)).numpy(),
        [bin(i).count("1") for i in range(256)])


@pytest.mark.parametrize("shape,bm,bk", [((200, 9), 128, 64), ((64, 16), 32, 128),
                                         ((300, 40), 128, 128)])
def test_tile_reductions_ragged_vs_wire(shape, bm, bk):
    bitmap = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    bitmap[:, : shape[1] // 2] = 0
    bt, bj = torch.from_numpy(bitmap), jnp.asarray(bitmap)
    np.testing.assert_array_equal(wire.tile_nnz_from_bitmap(bt, bm, bk).numpy(),
                                  np.asarray(jwire.tile_nnz_from_bitmap(bj, bm, bk)))
    np.testing.assert_array_equal(wire.tile_mask_from_bitmap(bt, bm, bk).numpy(),
                                  np.asarray(jwire.tile_mask_from_bitmap(bj, bm, bk)))


def test_pack_rejects_bad_shapes():
    with pytest.raises(ValueError):
        pack.bitmap_pack_blocked(torch.zeros(128, 100, dtype=torch.int8))
    with pytest.raises(ValueError):
        pack.bitmap_pack_blocked(torch.zeros(128, dtype=torch.int8))
