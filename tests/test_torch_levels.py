"""Port parity: the levels compact and expand kernels' plain versions
(``repro_torch.kernels.levels``) against the Pallas
``levels_compact_blocked`` / ``levels_expand_blocked`` in interpret mode.

The reference keeps each 256-element chunk as a column of a (256, C) array;
the port keeps it as a row of a (C, 256) array, so the port's inputs and
outputs are the reference's transposed. The work is integer: every
comparison is bit-exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.levels.levels import levels_compact_blocked, levels_expand_blocked  # noqa: E402
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
