"""Port parity: NSD quantization (``repro_torch.core.nsd`` and the fused
NSD kernel's plain version) against ``repro.core.nsd`` and the Pallas
``nsd_quantize_blocked`` (interpret mode on the CPU).

Inputs come from numpy with fixed seeds; the dither noise is drawn once in
JAX and fed to both sides, since torch cannot reproduce ``jax.random``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import nsd as jnsd  # noqa: E402
from repro.kernels.nsd_quant.nsd_quant import nsd_quantize_blocked as j_nsd_blocked  # noqa: E402
from repro_torch.core import nsd  # noqa: E402
from repro_torch.kernels import build, nsd_quant  # noqa: E402


def _grad(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _unit(shape, seed):
    key = jax.random.PRNGKey(seed)
    return np.array(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))


@pytest.mark.parametrize("shape", [(1, 1), (37, 513), (128, 128), (200, 72),
                                   (3, 5, 7)])
@pytest.mark.parametrize("s", [0.5, 2.0])
def test_nsd_indices_bit_exact(shape, s):
    g = _grad(shape, 1)
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))
    delta_j = jnsd.compute_delta(jnp.asarray(g), s)
    k_j = np.asarray(jnsd.nsd_indices(jnp.asarray(g), key, delta_j))
    # the same f32 delta on both sides isolates the index arithmetic
    delta_t = torch.tensor(np.array(delta_j))
    k_t = nsd.nsd_indices(torch.from_numpy(g), torch.from_numpy(u), delta_t)
    assert k_t.dtype == torch.int32
    np.testing.assert_array_equal(k_t.numpy(), k_j)


@pytest.mark.parametrize("shape", [(37, 513), (4, 8, 8, 64)])
def test_compute_delta_matches_population_std(shape):
    g = _grad(shape, 2, scale=3.0)
    d_j = float(jnsd.compute_delta(jnp.asarray(g), 2.0))
    d_t = float(nsd.compute_delta(torch.from_numpy(g), 2.0))
    # a reduction: the two frameworks sum in different orders, so agree to
    # f32 rounding (a few ulps), and not to the ddof=1 std (rel 1/n away)
    assert d_t == pytest.approx(d_j, rel=1e-6)


def test_zero_delta_gives_zero_indices():
    g = np.zeros((16, 24), np.float32)
    u = _unit((16, 24), 3)
    d = nsd.compute_delta(torch.from_numpy(g), 2.0)
    assert float(d) == 0.0
    k = nsd.nsd_indices(torch.from_numpy(g), torch.from_numpy(u), d)
    assert not k.any()
    st = nsd.quant_stats(k, d)
    assert float(st.sparsity) == 1.0 and float(st.max_bitwidth) == 0.0


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quant_stats_bit_exact(scale):
    k = np.clip(np.round(_grad((64, 96), 4, scale)), -127, 127).astype(np.int32)
    delta = np.float32(0.37)
    j = jnsd.quant_stats(jnp.asarray(k), jnp.float32(delta))
    t = nsd.quant_stats(torch.from_numpy(k), torch.tensor(delta))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shape,bn,s", [((128, 128), 128, 1.0),
                                        ((256, 512), 512, 2.0),
                                        ((384, 128), 128, 2.0),
                                        ((256, 512), 128, 4.0)])
def test_nsd_blocked_plain_vs_pallas(shape, bn, s):
    x = _grad(shape, 5)
    delta = np.float32(s * x.std())
    nu = (_unit(shape, 6) * delta).astype(np.float32)
    k_j, nnz_j = j_nsd_blocked(jnp.asarray(x), jnp.asarray(nu),
                               jnp.float32(delta), bm=128, bn=bn)
    args = (torch.from_numpy(x), torch.from_numpy(nu), torch.tensor(delta))
    k_p, nnz_p = nsd_quant.nsd_quantize_blocked_plain(*args, bm=128, bn=bn)
    np.testing.assert_array_equal(k_p.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(nnz_p.numpy(), np.asarray(nnz_j))
    # the wrapper takes the plain version for CPU tensors, without a launch
    before = dict(build.LAUNCHES)
    k_w, nnz_w = nsd_quant.nsd_quantize_blocked(*args, bm=128, bn=bn)
    assert torch.equal(k_w, k_p) and torch.equal(nnz_w, nnz_p)
    assert build.LAUNCHES == before


def test_nsd_blocked_zero_delta_vs_pallas():
    x = _grad((128, 256), 8)
    nu = np.zeros_like(x)
    k_j, nnz_j = j_nsd_blocked(jnp.asarray(x), jnp.asarray(nu), jnp.float32(0),
                               bm=128, bn=128)
    k_p, nnz_p = nsd_quant.nsd_quantize_blocked(
        torch.from_numpy(x), torch.from_numpy(nu), torch.tensor(0.0))
    assert not k_p.any() and not nnz_p.any()
    np.testing.assert_array_equal(k_p.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(nnz_p.numpy(), np.asarray(nnz_j))


def test_nsd_blocked_agrees_with_core_indices():
    """The blocked quantizer on (g, u * delta) equals nsd_indices(g, u, delta)
    in the live region, and padding (g = nu = 0) quantizes to zero."""
    g = _grad((100, 200), 9)
    u = _unit((100, 200), 10)
    gt, ut = torch.from_numpy(g), torch.from_numpy(u)
    d = nsd.compute_delta(gt, 2.0)
    import torch.nn.functional as F
    k, nnz = nsd_quant.nsd_quantize_blocked(
        F.pad(gt, (0, 56, 0, 28)), F.pad(nsd.dither_noise(ut, d), (0, 56, 0, 28)),
        d)
    core = nsd.nsd_indices(gt, ut, d)
    assert torch.equal(k[:100, :200].to(torch.int32), core)
    assert not k[100:].any() and not k[:, 200:].any()
    assert int(nnz.sum()) == int((core != 0).sum())


def test_nsd_blocked_rejects_bad_shapes():
    x = torch.zeros(100, 128)
    with pytest.raises(ValueError):
        nsd_quant.nsd_quantize_blocked(x, x, torch.tensor(1.0))
    with pytest.raises(ValueError):
        nsd_quant.nsd_quantize_blocked(torch.zeros(128, 128),
                                       torch.zeros(128, 256), torch.tensor(1.0))
