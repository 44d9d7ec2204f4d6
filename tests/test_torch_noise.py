"""Port: the dither drawn from a stream key (Philox4x32-10) and the fused NSD
quantizer's plain version, which writes k, the bitmap, the tile counts and
the tile mask from the unpadded cotangent.

* ``philox4x32_10_plain`` against Random123's known-answer vectors;
* the fused plain version on the fed route at unpadded shapes, bit for bit
  against the reference's Pallas ``nsd_quantize_blocked`` (interpret mode)
  and ``bitmap_pack_blocked`` on the padded inputs, and the wire's tile
  reductions;
* the key route against the fed route given the context's own unit draw,
  for the cotangent and for the residual stream;
* the paper's eqs. 5 and 6 on the key route, and independent streams across
  layer, step, worker and the residual.
All integer outputs are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.nsd_quant.nsd_quant import nsd_quantize_blocked as j_nsd_blocked  # noqa: E402
from repro.kernels.pack.pack import bitmap_pack_blocked as j_pack  # noqa: E402
from repro.quant import wire as jwire  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.core import dithered, nsd  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.kernels import build, nsd_quant, ops, pack  # noqa: E402
from repro_torch.memory.policy import MemoryPolicy  # noqa: E402
from repro_torch.quant import wire  # noqa: E402

M32 = 0xFFFFFFFF

# Random123's kat_vectors for philox4x32_10: (counter, key, output)
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((M32, M32, M32, M32), (M32, M32),
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zero", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = nsd_quant.philox4x32_10_plain(counter, key)
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("rows,cols", [(3, 10), (5, 64), (2, 7), (1, 401)])
def test_philox_uniform_maps_counter_and_word(rows, cols):
    """Element (r, c) is word c % 4 of counter (c // 4, r, 0, 0) under the
    key's two 32-bit halves, as u = (word >> 8) 2^-24 - 1/2."""
    key = 0x0123456789ABCDEF
    u = nsd_quant.philox_uniform_plain(key, (rows, cols))
    assert u.dtype == torch.float32 and u.shape == (rows, cols)
    for r in range(rows):
        for c in range(cols):
            w = nsd_quant.philox4x32_10_plain((c // 4, r, 0, 0),
                                              (key & M32, key >> 32))[c % 4]
            assert float(u[r, c]) == (int(w) >> 8) * 2.0 ** -24 - 0.5
    # the draw-only wrapper takes the plain version on the CPU, unlaunched
    before = dict(build.LAUNCHES)
    assert torch.equal(nsd_quant.philox_uniform(key, (rows, cols), device="cpu"), u)
    assert build.LAUNCHES == before


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _pad(a, m=128, n=128):
    return np.pad(a, ((0, (-a.shape[0]) % m), (0, (-a.shape[1]) % n)))


# unpadded cotangents: fc2's width (10), c0's (64), ragged rows and columns
FED = [((128, 10), 2.0), ((300, 64), 2.0), ((130, 200), 1.0), ((37, 513), 4.0),
       ((256, 128), 2.0), ((300, 64), 0.0)]


@pytest.mark.parametrize("shape,s", FED, ids=str)
def test_fused_plain_fed_route_matches_reference(shape, s):
    g = _np(shape, 1, 0.1)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(2), shape, jnp.float32,
                                    -0.5, 0.5))
    delta = np.float32(s * g.std())
    nu = (u * delta).astype(np.float32)
    k_j, nnz_j = j_nsd_blocked(jnp.asarray(_pad(g)), jnp.asarray(_pad(nu)),
                               jnp.float32(delta), bm=128, bn=128)
    bm_j, _ = j_pack(k_j, bm=128, bn=128)
    mask_j = jwire.tile_mask_from_bitmap(bm_j, 128, 128)
    before = dict(build.LAUNCHES)
    q = nsd_quant.nsd_quantize(torch.from_numpy(g), torch.tensor(delta),
                               noise=torch.from_numpy(nu))
    assert build.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(q.k.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(q.bitmap.numpy(), np.asarray(bm_j))
    np.testing.assert_array_equal(q.nnz.numpy(), np.asarray(nnz_j))
    np.testing.assert_array_equal(
        q.nnz.numpy(), np.asarray(jwire.tile_nnz_from_bitmap(bm_j, 128, 128)))
    np.testing.assert_array_equal(q.mask.numpy(), np.asarray(mask_j))
    T, N = shape
    assert not q.k[T:].any() and not q.k[:, N:].any()
    if s == 0.0:
        assert not q.k.any() and not q.mask.any()
    # the bitmap, counts and mask are the pack kernel's on the same k
    for a, b in zip(q[1:], pack.bitmap_pack_blocked_plain(q.k)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(128, 10), (300, 64), (37, 513)], ids=str)
def test_key_route_equals_fed_route_with_the_contexts_draw(shape):
    ctx = DitherCtx(DitherPolicy(), seed=5, step=3, worker=1, device="cpu")
    g = torch.from_numpy(_np(shape, 3, 0.1))
    delta = nsd.compute_delta(g, 2.0)
    key = ctx.cotangent_key("c0")
    u = ctx.unit_noise("c0", shape)
    by_key = nsd_quant.nsd_quantize(g, delta, key=key)
    fed = nsd_quant.nsd_quantize(g, delta, noise=nsd.dither_noise(u, delta))
    for a, b in zip(by_key, fed):
        assert torch.equal(a, b)
    # and the core quantizer (the paper variant's) on the same draw
    T, N = shape
    core = nsd.nsd_indices(g, u, delta)
    assert torch.equal(by_key.k[:T, :N].to(torch.int32), core)
    # ops.quantize_and_mask: the key and the fed draw give one QuantizedGrad
    qk, qf = ops.quantize_and_mask(g, key, 2.0), ops.quantize_and_mask(g, u, 2.0)
    for name in ("k", "delta", "nnz", "bitmap", "mask"):
        assert torch.equal(getattr(qk, name), getattr(qf, name)), name


@pytest.mark.parametrize("shape", [(7,), (1000,), (2, 5, 5, 8), (3, 256)], ids=str)
@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_residual_key_route_equals_fed_route(shape, backend):
    """pack_nsd from the residual stream key equals pack_nsd fed
    ``resid_noise``'s draw, byte for byte, on both routes."""
    ctx = DitherCtx(DitherPolicy(), seed=1, step=2, device="cpu")
    x = torch.relu(torch.from_numpy(_np(shape, 4)))
    by_key = wire.pack_nsd(x, ctx.resid_key("fc0"), 1.0, backend=backend)
    fed = wire.pack_nsd(x, ctx.resid_noise("fc0", shape), 1.0, backend=backend)
    other = wire.pack_nsd(x, ctx.resid_key("fc0"), 1.0,
                          backend="plain" if backend == "kernel" else "kernel")
    for name in ("levels", "bitmap", "deltas", "nnz"):
        assert torch.equal(getattr(by_key, name), getattr(fed, name)), name
        assert torch.equal(getattr(by_key, name), getattr(other, name)), name
    assert torch.equal(quant.decode("nsd", by_key), wire.unpack_nsd(fed))


def test_contexts_route_keys_unless_the_draw_is_fed():
    class Fed(DitherCtx):
        def unit_noise(self, name, shape):
            return torch.zeros(shape)

    ctx = DitherCtx(DitherPolicy(), seed=4, device="cpu")
    assert ctx.cotangent_dither("c1", (8, 8)) == ctx.cotangent_key("c1")
    assert ctx.resid_dither("c1", (8, 8)) == ctx.resid_key("c1")
    fed = Fed(DitherPolicy(), seed=4, device="cpu")
    assert torch.equal(fed.cotangent_dither("c1", (8, 8)), torch.zeros(8, 8))
    assert fed.resid_dither("c1", (8, 8)) == ctx.resid_key("c1")


def test_dense_kernel_step_is_the_fed_step_of_its_own_draw():
    """A kernel-variant dense layer (nsd residual) drawing from its keys
    gives the gradients of the same layer fed the context's own unit draws:
    the seam and the key route agree end to end."""
    class Fed(DitherCtx):
        def unit_noise(self, name, shape):
            return DitherCtx.unit_noise(self, name, shape)

        def resid_noise(self, name, shape):
            return DitherCtx.resid_noise(self, name, shape)

    x0, w0 = _np((100, 200), 5), _np((200, 72), 6, 0.1)
    grads = []
    for cls in (DitherCtx, Fed):
        ctx = cls(DitherPolicy(variant="kernel"), seed=2, step=1, device="cpu",
                  memory=MemoryPolicy(default="nsd"))
        x = torch.from_numpy(x0).requires_grad_()
        w = torch.from_numpy(w0).requires_grad_()
        (dithered.dense(x, w, ctx=ctx, name="fc") ** 2).sum().backward()
        grads.append((x.grad, w.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_key_route_meets_paper_eqs_5_and_6():
    """E[g~ - g] = 0 and E[(g~ - g)^2] < Delta^2/4 (paper eqs. 5 and 6) with
    the dither drawn from the step's stream keys, over 256 steps."""
    g = torch.linspace(-2.0, 2.0, 401).reshape(1, 401)
    delta = torch.tensor(0.7)
    err = torch.stack([
        nsd_quant.nsd_quantize(g, delta, key=DitherCtx(
            DitherPolicy(), step=t, device="cpu").cotangent_key("fc")
        ).k[:1, :401].to(torch.float32) * delta - g
        for t in range(256)])
    # an NSD error takes two values Delta apart, so its std is at most
    # Delta / 2: 5 standard errors per element, and over all elements
    assert float(err.mean(0).abs().max()) < 5 * 0.35 / np.sqrt(256)
    assert abs(float(err.mean())) < 5 * 0.35 / np.sqrt(err.numel())
    assert float((err ** 2).mean()) < float(delta) ** 2 / 4


def test_streams_differ_across_layer_step_worker_and_residual():
    base = dict(seed=0, step=0, worker=0)
    draws = {}
    for what, kw, name in (("base", {}, "c1"), ("layer", {}, "c2"),
                           ("step", {"step": 1}, "c1"),
                           ("worker", {"worker": 1}, "c1")):
        ctx = DitherCtx(DitherPolicy(), device="cpu", **{**base, **kw})
        draws[what] = ctx.unit_noise(name, (64, 64))
    ctx = DitherCtx(DitherPolicy(), device="cpu", **base)
    draws["residual"] = ctx.resid_noise("c1", (64, 64))
    flat = {k: v.reshape(-1) for k, v in draws.items()}
    names = sorted(flat)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            # independent uniform streams: no shared elements and no
            # correlation beyond chance (4096 pairs: |r| < 5 / 64)
            assert not torch.equal(flat[a], flat[b]), (a, b)
            r = float(torch.corrcoef(torch.stack([flat[a], flat[b]]))[0, 1])
            assert abs(r) < 5 / 64, (a, b, r)


def test_fused_wrapper_rejects_bad_routes_and_devices():
    g = torch.zeros(4, 8)
    d = torch.tensor(1.0)
    with pytest.raises(ValueError, match="exactly one"):
        nsd_quant.nsd_quantize(g, d)
    with pytest.raises(ValueError, match="exactly one"):
        nsd_quant.nsd_quantize(g, d, noise=g, key=1)
    with pytest.raises(ValueError, match="shape"):
        nsd_quant.nsd_quantize(g, d, noise=torch.zeros(8, 4))
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        nsd_quant.nsd_quantize(meta, torch.zeros((), device="meta"), key=1)
    with pytest.raises(ValueError, match="no kernel"):
        nsd_quant.philox_uniform(1, (4, 8), device="meta")
