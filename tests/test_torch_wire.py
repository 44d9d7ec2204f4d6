"""Port parity: the NSD wire container (``repro_torch.quant.wire``'s
``pack_nsd`` / ``pack_indices`` / ``unpack_nsd``) against
``repro.quant.wire``.

Both sides get the same x, the reference's noise draw and the reference's
Delta, so k is the same and every byte of the container must be too:
levels, bitmap, deltas, nnz and wire_bytes are compared exactly, for both of
the port's routes (the chunk-local kernel route, here through the kernels'
plain versions, and the plain global cumsum) and for sizes that are and are
not chunk multiples.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.quant import wire as jwire  # noqa: E402
from repro_torch.kernels import build, levels, pack  # noqa: E402
from repro_torch.quant import wire  # noqa: E402

S = 1.0
SHAPES = [(256,), (768,), (1000,), (7,), (2, 5, 5, 8)]
BACKENDS = ["kernel", "plain"]


# the reference under one jit per shape: far fewer compilations than its
# op-by-op dispatch
_j_pack = jax.jit(lambda x, key: jwire.pack_nsd(x, key, S))
_j_unpack = jax.jit(jwire.unpack_nsd)


def _case(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    u = np.array(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))
    return x, key, u


def _same_container(pt, pj):
    np.testing.assert_array_equal(pt.levels.numpy(), np.asarray(pj.levels))
    np.testing.assert_array_equal(pt.bitmap.numpy(), np.asarray(pj.bitmap))
    np.testing.assert_array_equal(pt.deltas.numpy(), np.asarray(pj.deltas))
    assert int(pt.nnz) == int(pj.nnz)
    assert int(pt.wire_bytes()) == int(pj.wire_bytes())
    assert pt.dense_bytes() == pj.dense_bytes()
    assert (pt.shape, pt.dtype, pt.chunk) == (pj.shape, pj.dtype, pj.chunk)
    assert pt.levels.dtype == torch.int8 and pt.bitmap.dtype == torch.uint8
    assert pt.nnz.dtype == torch.int32


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pack_nsd_matches_reference(shape, backend):
    x, key, u = _case(shape, 1)
    pj = _j_pack(jnp.asarray(x), key)
    delta = torch.tensor(np.asarray(pj.deltas[0]))  # the reference's Delta
    before = dict(build.LAUNCHES)
    pt = wire.pack_nsd(torch.from_numpy(x), torch.from_numpy(u), S,
                       backend=backend, delta=delta)
    assert build.LAUNCHES == before  # CPU tensors take the plain versions
    _same_container(pt, pj)
    # its own Delta: the population std, to f32 rounding of the reduction
    own = wire.pack_nsd(torch.from_numpy(x), torch.from_numpy(u), S,
                        backend=backend)
    assert float(own.deltas[0]) == pytest.approx(float(delta), rel=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_unpack_nsd_matches_reference(shape, backend):
    x, key, u = _case(shape, 2)
    pj = _j_pack(jnp.asarray(x), key)
    pt = wire.pack_nsd(torch.from_numpy(x), torch.from_numpy(u), S,
                       backend=backend,
                       delta=torch.tensor(np.asarray(pj.deltas[0])))
    out = wire.unpack_nsd(pt, backend=backend)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(_j_unpack(pj)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [256, 768, 1000, 7])
def test_pack_indices_matches_reference(n, backend):
    rng = np.random.default_rng(n)
    k = np.where(rng.random(n) < 0.3, rng.integers(-127, 128, n), 0).astype(np.int8)
    pj = jwire.pack_indices(jnp.asarray(k), jnp.float32(0.25), (n,), jnp.float32)
    pt = wire.pack_indices(torch.from_numpy(k), torch.tensor(0.25), (n,),
                           torch.float32, backend=backend)
    _same_container(pt, pj)
    np.testing.assert_array_equal(wire.unpack_indices(pt, backend=backend)[:n].numpy(), k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_zero_tensor_packs_to_no_levels(backend):
    """Delta = 0 (an all-zero residual) encodes to nnz 0 and decodes to 0."""
    x = np.zeros((3, 100), np.float32)
    pj = _j_pack(jnp.asarray(x), jax.random.PRNGKey(0))
    pt = wire.pack_nsd(torch.from_numpy(x), torch.zeros(3, 100), S,
                       backend=backend)
    assert float(pt.deltas[0]) == 0.0
    _same_container(pt, pj)
    assert not wire.unpack_nsd(pt, backend=backend).any()


def test_unknown_backend_is_refused():
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="backend"):
        wire.pack_nsd(x, x, S, backend="pallas")
    p = wire.pack_nsd(x, x, S, backend="plain")
    assert p.bitmap.shape == (1, 32) and p.chunk == wire.DEFAULT_CHUNK
    with pytest.raises(ValueError, match="backend"):
        wire.unpack_nsd(p, backend="pallas")


# C chunks at three densities, and a stream whose only non-zero lies in its
# last chunk
WIRE_CASES = ([(C, d) for C in (1, 3, 8, 9, 130) for d in (0.0, 0.2, 1.0)]
              + [(130, "last chunk only")])
_WIRE_WRAPPERS = ((levels, "levels_compact_wire"), (levels, "levels_expand_wire"),
                  (levels, "levels_compact"), (levels, "levels_expand"),
                  (pack, "bitmap_pack_blocked"), (pack, "bitmap_unpack"))


@pytest.mark.parametrize("C,density", WIRE_CASES, ids=str)
def test_kernel_route_is_one_wire_call_each_way(C, density, monkeypatch):
    """The kernel route's encode is one call of the wire compact and its
    decode one call of the wire expand, no other levels or bitmap kernel,
    and the container is the reference's Pallas route's byte for byte."""
    calls = {}
    for mod, name in _WIRE_WRAPPERS:
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    rng = np.random.default_rng(C)
    n = C * 256
    if density == "last chunk only":
        k = np.zeros(n, np.int8)
        k[-3] = 9
    else:
        k = np.where(rng.random(n) < density, rng.integers(1, 128, n)
                     * rng.choice([-1, 1], n), 0).astype(np.int8)
    pt = wire.pack_indices(torch.from_numpy(k), torch.tensor(0.5), (n,),
                           torch.float32)
    assert calls == {"levels_compact_wire": 1}
    pj = jwire.pack_indices(jnp.asarray(k), jnp.float32(0.5), (n,), jnp.float32,
                            backend="pallas")
    _same_container(pt, pj)
    out = wire.unpack_indices(pt)
    assert calls == {"levels_compact_wire": 1, "levels_expand_wire": 1}
    np.testing.assert_array_equal(out.numpy(), k)
