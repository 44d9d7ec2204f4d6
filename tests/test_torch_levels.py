"""Port parity: the levels compact and expand kernels' plain versions
(``repro_torch.kernels.levels``) against the Pallas
``levels_compact_blocked`` / ``levels_expand_blocked`` in interpret mode,
and the wire kernels' plain versions (levels, bitmap and nnz of a whole
chunk stream; its decode) against the reference's
``repro.quant.wire._compact_pallas`` / ``_expand_pallas`` (interpret mode)
and its jnp ``_compact`` / ``_expand``.

The reference keeps each 256-element chunk as a column of a (256, C) array;
the port keeps it as a row of a (C, 256) array, so the port's inputs and
outputs are the reference's transposed. The work is integer: every
comparison is bit-exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.levels.levels import levels_compact_blocked, levels_expand_blocked  # noqa: E402
from repro.quant import wire as jwire  # noqa: E402
from repro_torch.kernels import build, levels  # noqa: E402

CHUNK = 256
COLS = [1, 3, 128, 200]
DENSITIES = [0.0, 0.3, 1.0]


def _chunks(cols, density, seed=0):
    """(cols, 256) int8 rows with about ``density`` of them non-zero."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-127, 128, (cols, CHUNK))
    vals[vals == 0] = 1  # density 1 means every element non-zero
    keep = rng.random((cols, CHUNK)) < density
    return np.where(keep, vals, 0).astype(np.int8)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("cols", COLS)
def test_compact_plain_vs_pallas(cols, density):
    k = _chunks(cols, density)
    lv_j, cnt_j = levels_compact_blocked(jnp.asarray(k.T), interpret=True)
    before = dict(build.LAUNCHES)
    lv_t, cnt_t = levels.levels_compact(torch.from_numpy(k))
    assert build.LAUNCHES == before  # CPU tensors take the plain version
    assert lv_t.dtype == torch.int8 and cnt_t.dtype == torch.int32
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j).T)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(cnt_t.numpy(), (k != 0).sum(1))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("cols", COLS)
def test_expand_plain_vs_pallas(cols, density):
    """Expand of the compacted levels against the reference's expand, and
    the round trip back to k."""
    k = _chunks(cols, density, seed=1)
    lv, _ = levels.levels_compact(torch.from_numpy(k))
    mask = (k != 0).astype(np.int8)
    out_j = levels_expand_blocked(jnp.asarray(lv.numpy().T), jnp.asarray(mask.T),
                                  interpret=True)
    out_t = levels.levels_expand(lv, torch.from_numpy(mask))
    assert out_t.dtype == torch.int8
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j).T)
    np.testing.assert_array_equal(out_t.numpy(), k)


def test_expand_ignores_levels_past_the_count():
    """Slots past a chunk's count are never read: garbage there changes
    nothing (the decode's gather fills them with zeros, but the function
    must not depend on it)."""
    k = _chunks(4, 0.3, seed=2)
    lv, cnt = levels.levels_compact(torch.from_numpy(k))
    noisy = lv.clone()
    for c, n in enumerate(cnt.tolist()):
        noisy[c, n:] = 77
    mask = torch.from_numpy((k != 0).astype(np.int8))
    assert torch.equal(levels.levels_expand(noisy, mask),
                       levels.levels_expand(lv, mask))


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError, match="256"):
        levels.levels_compact(torch.zeros(3, 128, dtype=torch.int8))
    with pytest.raises(ValueError):
        levels.levels_expand(torch.zeros(3, 256, dtype=torch.int8),
                             torch.zeros(2, 256, dtype=torch.int8))
    x = torch.zeros(2, 256, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        levels.levels_compact(x)


# The wire functions: C chunks at three densities, and a stream whose only
# non-zero lies in its last chunk.
WIRE_CASES = ([(C, d) for C in (1, 3, 8, 9, 130) for d in (0.0, 0.2, 1.0)]
              + [(130, "last chunk only")])
_j_compact_pallas = jax.jit(jwire._compact_pallas, static_argnums=1)
_j_expand_pallas = jax.jit(jwire._expand_pallas, static_argnums=2)


def _wire_chunks(C, density, seed):
    if density == "last chunk only":
        k = np.zeros((C, CHUNK), np.int8)
        k[-1, 200] = -3
        return k
    return _chunks(C, density, seed)


@pytest.mark.parametrize("C,density", WIRE_CASES, ids=str)
def test_compact_wire_plain_vs_reference(C, density):
    """Levels, bitmap and nnz of the wire compact against the reference's
    Pallas route and its global jnp route."""
    k = _wire_chunks(C, density, seed=C)
    flat = jnp.asarray(k.reshape(-1))
    lv_p, nnz_p = _j_compact_pallas(flat, CHUNK)
    lv_j, nnz_j = jwire._compact(flat)
    before = dict(build.LAUNCHES)
    lv, bitmap, nnz = levels.levels_compact_wire(torch.from_numpy(k))
    assert build.LAUNCHES == before  # CPU tensors take the plain version
    assert (lv.dtype, bitmap.dtype, nnz.dtype) == (torch.int8, torch.uint8, torch.int32)
    assert lv.shape == (C * CHUNK,) and bitmap.shape == (C, CHUNK // 8) and nnz.dim() == 0
    np.testing.assert_array_equal(lv.numpy(), np.asarray(lv_p))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(lv_j))
    assert int(nnz) == int(nnz_p) == int(nnz_j) == int((k != 0).sum())
    np.testing.assert_array_equal(bitmap.numpy(),
                                  np.asarray(jwire.pack_bitmap(jnp.asarray(k != 0))))


@pytest.mark.parametrize("C,density", WIRE_CASES, ids=str)
def test_expand_wire_plain_vs_reference(C, density):
    """The wire expand of a packed stream against the reference's Pallas
    and jnp decodes, and back to k."""
    k = _wire_chunks(C, density, seed=C + 1)
    lv, bitmap, _ = levels.levels_compact_wire(torch.from_numpy(k))
    # garbage past nnz is never read
    lv = lv.clone()
    lv[int((k != 0).sum()):] = 55
    mask = jwire.unpack_bitmap(jnp.asarray(bitmap.numpy())).reshape(-1)
    want_p = _j_expand_pallas(jnp.asarray(lv.numpy()), mask, CHUNK)
    want_j = jwire._expand(jnp.asarray(lv.numpy()), mask)
    out = levels.levels_expand_wire(lv, bitmap)
    assert out.dtype == torch.int8 and out.shape == (C, CHUNK)
    np.testing.assert_array_equal(out.numpy().reshape(-1), np.asarray(want_p))
    np.testing.assert_array_equal(out.numpy().reshape(-1), np.asarray(want_j))
    np.testing.assert_array_equal(out.numpy(), k)


@pytest.mark.parametrize("per_block", [1, levels.WIRE_CHUNKS_PER_BLOCK])
@pytest.mark.parametrize("seed", range(4))
def test_wire_compact_write_plan_covers_each_byte_once(per_block, seed):
    """The wire compact kernel's index plan, in numpy: a block of
    ``per_block`` chunks starting at chunk c0 with global start S and count
    A writes its levels to [S, S + A) and its zeros to [n - Z - z, n - Z),
    Z = 256 c0 - S the zeros before it, z its own. Over random counts
    (whole, empty and partial chunks, a ragged last block) every byte of
    [0, n) is written exactly once, the levels to [0, nnz)."""
    rng = np.random.default_rng(seed)
    C = int(rng.integers(1, 300))
    counts = rng.integers(0, CHUNK + 1, C)
    counts[rng.random(C) < 0.2] = 0
    counts[rng.random(C) < 0.2] = CHUNK
    n, nnz = C * CHUNK, int(counts.sum())
    written = np.zeros(n, np.int64)
    is_level = np.zeros(n, bool)
    start = 0
    for c0 in range(0, C, per_block):
        A = int(counts[c0:c0 + per_block].sum())
        valid = min(per_block, C - c0)
        Z, z = CHUNK * c0 - start, valid * CHUNK - A
        written[start:start + A] += 1
        is_level[start:start + A] = True
        written[n - Z - z:n - Z] += 1
        start += A
    assert (written == 1).all()
    assert is_level[:nnz].all() and not is_level[nnz:].any()


def test_wire_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError, match="256"):
        levels.levels_compact_wire(torch.zeros(3, 128, dtype=torch.int8))
    with pytest.raises(ValueError, match="bitmap"):
        levels.levels_expand_wire(torch.zeros(512, dtype=torch.int8),
                                  torch.zeros(3, 32, dtype=torch.uint8))
    x = torch.zeros(2, 256, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        levels.levels_compact_wire(x)
    with pytest.raises(ValueError, match="no kernel"):
        levels.levels_expand_wire(x.reshape(-1),
                                  torch.zeros(2, 32, dtype=torch.uint8, device="meta"))
