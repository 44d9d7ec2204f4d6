"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and nvcc;
without one they skip (marker ``cuda``). On a machine with the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
need not have.)
"""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402

from repro_torch import quant  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.core import dithered  # noqa: E402
from repro_torch.kernels import build, bsp_matmul, levels, nsd_quant, pack  # noqa: E402
from repro_torch.memory.policy import MemoryPolicy  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in f32
    return torch.device("cuda")


def _rand(shape, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, device=cuda, generator=g)


@pytest.mark.parametrize("shape", [(128, 128), (384, 256)])
@pytest.mark.parametrize("s", [2.0, 0.0])
def test_nsd_kernel_matches_plain(cuda, shape, s):
    x = _rand(shape, cuda, 1)
    delta = (s * x.std(correction=0)).reshape(())
    nu = (torch.rand(shape, device=cuda) - 0.5) * delta
    before = build.LAUNCHES["nsd_quant"]
    got = nsd_quant.nsd_quantize_blocked(x, nu, delta)
    assert build.LAUNCHES["nsd_quant"] == before + 1
    want = nsd_quant.nsd_quantize_blocked_plain(x, nu, delta)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_nsd_blocked_kernel_sums_wide_tiles(cuda):
    """A (bm, bn) tile wider than the kernel's sums its 128 x 128 counts."""
    x = _rand((256, 512), cuda, 2)
    delta = (2.0 * x.std(correction=0)).reshape(())
    nu = (torch.rand(x.shape, device=cuda) - 0.5) * delta
    got = nsd_quant.nsd_quantize_blocked(x, nu, delta, bm=128, bn=512)
    want = nsd_quant.nsd_quantize_blocked_plain(x, nu, delta, bm=128, bn=512)
    assert got[1].shape == (2, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# unpadded cotangents: fc2 (128 x 10), c0's width 64, ragged rows and
# columns, a width that is not a multiple of 4
FUSED_SHAPES = [(128, 10), (1000, 64), (130, 200), (37, 513), (300, 6)]


@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=str)
@pytest.mark.parametrize("route", ["key", "fed"])
@pytest.mark.parametrize("s", [2.0, 0.0])
def test_fused_nsd_kernel_matches_plain(cuda, shape, route, s):
    """One launch: k, bitmap, nnz and mask bit for bit against the plain
    version, zeros in the padding, and the bitmap, nnz and mask those of
    the pack's plain version on the same k."""
    g = _rand(shape, cuda, 21) * 1e-3
    delta = (s * g.std(correction=0)).reshape(())
    key = 0x9E3779B97F4A7C15
    kw = ({"key": key} if route == "key" else
          {"noise": nsd_quant.philox_uniform_plain(key, shape, device=cuda) * delta})
    before = dict(build.LAUNCHES)
    got = nsd_quant.nsd_quantize(g, delta, **kw)
    assert build.LAUNCHES == {**before, "nsd_quant": before["nsd_quant"] + 1}
    want = nsd_quant.nsd_quantize_plain(g, delta, **kw)
    for a, b, what in zip(got, want, ("k", "bitmap", "nnz", "mask")):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        assert torch.equal(a, b), what
    for a, b in zip(got[1:], pack.bitmap_pack_blocked_plain(got.k)):
        assert torch.equal(a, b)
    T, N = shape
    assert not got.k[T:].any() and not got.k[:, N:].any()
    if route == "key":  # the same numbers as the fed draw of the same key
        fed = nsd_quant.nsd_quantize(g, delta, noise=nsd_quant.philox_uniform(
            key, shape, device=cuda) * delta)
        assert all(torch.equal(a, b) for a, b in zip(got, fed))


@pytest.mark.parametrize("n", [7, 1000, 2_097_152 + 100])
def test_fused_nsd_kernel_on_the_chunk_view(cuda, n):
    """The residual encode's call: a flat tensor over (n_chunks, 256), the
    last chunk partly live, no bitmap."""
    x = torch.relu(_rand((n,), cuda, 22))
    delta = x.std(correction=0).reshape(())
    got = nsd_quant.nsd_quantize(x, delta, key=77, cols=256, bitmap=False)
    want = nsd_quant.nsd_quantize_plain(x, delta, key=77, cols=256, bitmap=False)
    assert got.bitmap is None
    assert torch.equal(got.k, want.k) and torch.equal(got.nnz, want.nnz)
    assert not got.k.reshape(-1)[n:].any()


@pytest.mark.parametrize("shape,cols", [((131072, 64), None), ((3, 10), None),
                                        ((1000,), 256), ((5, 7), None)])
def test_philox_uniform_kernel_matches_plain(cuda, shape, cols):
    before = build.LAUNCHES["philox_uniform"]
    got = nsd_quant.philox_uniform(0xDEADBEEF12345678, shape, cols=cols,
                                   device=cuda)
    assert build.LAUNCHES["philox_uniform"] == before + 1
    want = nsd_quant.philox_uniform_plain(0xDEADBEEF12345678, shape, cols=cols,
                                          device=cuda)
    assert torch.equal(got, want)


def test_paper_variant_draws_with_the_draw_kernel(cuda):
    x = _rand((100, 200), cuda, 23).requires_grad_()
    w = (_rand((200, 72), cuda, 24) * 0.1).requires_grad_()
    ctx = DitherCtx(DitherPolicy(variant="paper"), device=cuda)
    build.reset_launches()
    dithered.dense(x, w, ctx=ctx, name="fc").sum().backward()
    torch.cuda.synchronize()
    assert build.LAUNCHES == {**dict.fromkeys(build.LAUNCHES, 0),
                              "philox_uniform": 1}


@pytest.mark.parametrize("shape", [(256, 384), (131072, 128), (128, 32)])
def test_pack_kernel_matches_plain_at_sizes(cuda, shape):
    k = (_rand(shape, cuda, 25) * 1.5).round().clamp(-127, 127).to(torch.int8)
    k[:128, :32] = 0  # an empty tile (or its first 32 columns)
    before = build.LAUNCHES["bitmap_pack"]
    got = pack.bitmap_pack_blocked(k, bn=32 if shape[1] == 32 else 128)
    assert build.LAUNCHES["bitmap_pack"] == before + 1
    want = pack.bitmap_pack_blocked_plain(k, bn=32 if shape[1] == 32 else 128)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pack_kernel_matches_plain(cuda):
    k = (_rand((256, 384), cuda, 2) * 2).round().clamp(-127, 127).to(torch.int8)
    k[:128, 128:256] = 0
    got = pack.bitmap_pack_blocked(k)
    want = pack.bitmap_pack_blocked_plain(k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[2][0, 1]) == 0


@pytest.mark.parametrize("trans_a,trans_b", [(False, True), (True, False),
                                             (False, False), (True, True)])
def test_bsp_kernel_matches_plain(cuda, trans_a, trans_b):
    a = (_rand((256, 384), cuda, 3) * 40).clamp(-127, 127).to(torch.int8)
    b = (_rand((384, 128), cuda, 4) * 40).clamp(-127, 127).to(torch.int8)
    mask = torch.tensor([[1, 0, 1], [0, 0, 1]], dtype=torch.int32, device=cuda)
    if trans_a:
        a, mask = a.t().contiguous(), mask.t().contiguous()
    if trans_b:
        b = b.t().contiguous()
    scale = torch.tensor(3e-3, device=cuda)
    got = bsp_matmul.bsp_matmul_int8(a, b, scale, mask, trans_a=trans_a,
                                     trans_b=trans_b)
    want = bsp_matmul.bsp_matmul_int8_plain(a, b, scale, mask, trans_a=trans_a,
                                            trans_b=trans_b)
    assert torch.equal(got, want)


def test_wrapper_rejects_unaligned_cuda_operands(cuda):
    x = torch.zeros(128 * 128 + 1, device=cuda)[1:].reshape(128, 128)
    with pytest.raises(ValueError, match="aligned"):
        nsd_quant.nsd_quantize_blocked(x, x, torch.zeros((), device=cuda))


def test_dense_kernel_backward_launches_each_kernel(cuda):
    x = _rand((100, 200), cuda, 5).requires_grad_()
    w = (_rand((200, 72), cuda, 6) * 0.1).requires_grad_()
    ctx = DitherCtx(DitherPolicy(variant="kernel"), device=cuda)
    build.reset_launches()
    dithered.dense(x, w, ctx=ctx, name="fc").sum().backward()
    torch.cuda.synchronize()
    assert build.LAUNCHES == {**dict.fromkeys(build.LAUNCHES, 0),
                              "nsd_quant": 1, "bsp_matmul_int8": 2}
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


def _levels_input(C, density, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    vals = torch.randint(1, 128, (C, 256), device=cuda, generator=g)
    sign = torch.randint(0, 2, (C, 256), device=cuda, generator=g) * 2 - 1
    keep = torch.rand((C, 256), device=cuda, generator=g) < density
    return torch.where(keep, vals * sign, 0).to(torch.int8)


@pytest.mark.parametrize("C", [1, 7, 1000, 8192])
@pytest.mark.parametrize("density", [0.0, 0.2, 1.0])
def test_levels_kernels_match_plain(cuda, C, density):
    k = _levels_input(C, density, cuda, C)
    before = dict(build.LAUNCHES)
    lv, cnt = levels.levels_compact(k)
    assert build.LAUNCHES["levels_compact"] == before["levels_compact"] + 1
    want_lv, want_cnt = levels.levels_compact_plain(k)
    assert torch.equal(lv, want_lv) and torch.equal(cnt, want_cnt)
    mask = (k != 0).to(torch.int8)
    out = levels.levels_expand(lv, mask)
    assert build.LAUNCHES["levels_expand"] == before["levels_expand"] + 1
    assert torch.equal(out, levels.levels_expand_plain(lv, mask))
    assert torch.equal(out, k)


@pytest.mark.parametrize("shape", [(1, 32), (1000, 32), (256, 16)])
def test_unpack_kernel_matches_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(7)
    bitmap = torch.randint(0, 256, shape, device=cuda, generator=g,
                           dtype=torch.uint8)
    got = pack.bitmap_unpack(bitmap)
    assert torch.equal(got, pack.bitmap_unpack_plain(bitmap))
    k = (torch.randn(256, 128, device=cuda) * 2).round().clamp(-127, 127).to(torch.int8)
    bm, _, _ = pack.bitmap_pack_blocked(k)
    assert torch.equal(pack.bitmap_unpack(bm), (k != 0).to(torch.int8))


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("kind", ["full", "random", "empty"])
def test_dequant_kernel_within_band(cuda, trans_a, kind):
    """Summation order differs from the plain version's: relative L2 within
    8 sqrt(K) 2^-24 (the rounding of a K-term f32 sum of random-sign terms
    grows as sqrt(K) u relative to the result); an empty mask gives exact
    zeros."""
    M, K, N = 256, 2048, 384
    g = torch.Generator(device=cuda).manual_seed(8)
    k = torch.randint(-6, 7, (K, M) if trans_a else (M, K), device=cuda,
                      generator=g, dtype=torch.int8)
    b = torch.randn(K, N, device=cuda, generator=g)
    shape = (K // 128, M // 128) if trans_a else (M // 128, K // 128)
    mask = {"full": torch.ones(shape, dtype=torch.int32, device=cuda),
            "empty": torch.zeros(shape, dtype=torch.int32, device=cuda),
            "random": (torch.rand(shape, device=cuda, generator=g) < 0.5
                       ).to(torch.int32)}[kind]
    delta = torch.tensor(3e-3, device=cuda)
    before = build.LAUNCHES["bsp_matmul_dequant"]
    got = bsp_matmul.bsp_matmul(k, delta, b, mask, trans_a=trans_a)
    assert build.LAUNCHES["bsp_matmul_dequant"] == before + 1
    want = bsp_matmul.bsp_matmul_plain(k, delta, b, mask, trans_a=trans_a)
    if kind == "empty":
        assert not got.any()
        return
    rel = float((got - want).norm() / want.norm())
    assert rel <= 8 * math.sqrt(K) * 2.0 ** -24


def test_new_wrappers_reject_unaligned_or_strided_cuda_operands(cuda):
    k = torch.zeros(2 * 256 + 1, dtype=torch.int8, device=cuda)[1:].reshape(2, 256)
    with pytest.raises(ValueError, match="aligned"):
        levels.levels_compact(k)
    ok = torch.zeros(2, 256, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        levels.levels_expand(ok, torch.zeros(256, 2, dtype=torch.int8, device=cuda).t())
    with pytest.raises(TypeError):
        levels.levels_expand(ok, ok.to(torch.int32))
    with pytest.raises(TypeError):
        pack.bitmap_unpack(ok)
    b = torch.zeros(128 * 128 + 1, device=cuda)[1:].reshape(128, 128)
    with pytest.raises(ValueError, match="aligned"):
        bsp_matmul.bsp_matmul(torch.zeros(128, 128, dtype=torch.int8, device=cuda),
                              torch.ones((), device=cuda), b,
                              torch.ones(1, 1, dtype=torch.int32, device=cuda))


def test_nsd_codec_kernel_route_matches_plain_route(cuda):
    """The wire container through the kernels (NSD and the wire compact;
    the wire expand) is byte-identical to the plain global route on the
    card."""
    x = torch.relu(_rand((3, 17, 17, 40), cuda, 9))
    u = torch.rand(x.shape, device=cuda) - 0.5
    build.reset_launches()
    p = quant.wire.pack_nsd(x, u, 1.0)
    assert (build.LAUNCHES["nsd_quant"], build.LAUNCHES["bitmap_pack"],
            build.LAUNCHES["levels_compact"]) == (1, 0, 1)
    want = quant.wire.pack_nsd(x, u, 1.0, backend="plain")
    for name in ("levels", "bitmap", "deltas", "nnz"):
        assert torch.equal(getattr(p, name), getattr(want, name)), name
    # the key route: the draw inside the NSD launch, no separate draw
    pk = quant.wire.pack_nsd(x, 12345, 1.0)
    assert (build.LAUNCHES["nsd_quant"], build.LAUNCHES["philox_uniform"]) == (2, 0)
    pk_plain = quant.wire.pack_nsd(x, 12345, 1.0, backend="plain")
    for name in ("levels", "bitmap", "deltas", "nnz"):
        assert torch.equal(getattr(pk, name), getattr(pk_plain, name)), name
    out = quant.wire.unpack_nsd(p)
    assert (build.LAUNCHES["bitmap_unpack"], build.LAUNCHES["levels_expand"]) == (0, 1)
    assert torch.equal(out, quant.wire.unpack_nsd(want, backend="plain"))


@pytest.mark.parametrize("case", ["segment", "bias500", "leaf500x10",
                                  "unaligned257"])
@pytest.mark.parametrize("route", ["key", "fed"])
def test_pack_nsd_on_comm_leaves_matches_plain(cuda, case, route):
    """The comm wire's inputs: a 1-D ring segment (a chunk multiple), a
    500-element bias, a 500 x 10 leaf, and a node's slice of a stacked
    257-element leaf (its data 4-byte aligned only, copied before the NSD
    launch): kernel route byte-identical to the plain route, and the
    decode too; one NSD, one compact and one expand launch."""
    if case == "unaligned257":
        x = (_rand((2, 257), cuda, 20) * 0.01)[1]
        assert x.data_ptr() % 16
    else:
        shape = {"segment": (2048,), "bias500": (500,),
                 "leaf500x10": (500, 10)}[case]
        x = _rand(shape, cuda, 21) * 0.01
    noise = 777 if route == "key" else torch.rand(x.shape, device=cuda) - 0.5
    build.reset_launches()
    p = quant.wire.pack_nsd(x, noise, 2.0)
    out = quant.wire.unpack_nsd(p)
    assert (build.LAUNCHES["nsd_quant"], build.LAUNCHES["levels_compact"],
            build.LAUNCHES["levels_expand"]) == (1, 1, 1)
    want = quant.wire.pack_nsd(x, noise, 2.0, backend="plain")
    for name in ("levels", "bitmap", "deltas", "nnz"):
        assert torch.equal(getattr(p, name), getattr(want, name)), name
    assert int(p.wire_bytes()) == int(want.wire_bytes())
    assert torch.equal(out, quant.wire.unpack_nsd(want, backend="plain"))
    assert out.shape == x.shape
    # the comm int8 mode: the same k in a dense (int8, Delta) pair
    q = quant.nsd_int8(x, noise, 2.0)
    k_plain = quant.wire.quantize_chunks(x, noise, p.deltas[0],
                                         backend="plain")
    assert torch.equal(q.k, k_plain.reshape(-1)[:x.numel()].reshape(x.shape))
    assert build.LAUNCHES["nsd_quant"] == 2


def test_dense_nsd_residual_launches_each_kernel(cuda):
    """One dithered layer with an nsd residual: the cotangent's NSD (which
    writes the bitmap and tile mask itself) and two products, the residual's
    NSD and one wire compact in the forward, one wire expand in the
    backward; no pack, unpack or separate draw."""
    x = _rand((100, 200), cuda, 10).requires_grad_()
    w = (_rand((200, 72), cuda, 11) * 0.1).requires_grad_()
    ctx = DitherCtx(DitherPolicy(variant="kernel"), device=cuda,
                    memory=MemoryPolicy(default="nsd"))
    build.reset_launches()
    dithered.dense(x, w, ctx=ctx, name="fc").sum().backward()
    torch.cuda.synchronize()
    assert build.LAUNCHES == {"nsd_quant": 2, "bitmap_pack": 0,
                              "bsp_matmul_int8": 2, "bitmap_unpack": 0,
                              "levels_compact": 1, "levels_expand": 1,
                              "bsp_matmul_dequant": 0, "philox_uniform": 0}
    assert torch.isfinite(w.grad).all()


# The wire kernels: C chunks at three densities, c1's residual at batch 128
# (8,192 chunks), a stream whose only non-zero lies in its last chunk, and
# 2^18 chunks: 8,192 blocks, more than the card holds at once, so blocks
# wait on tickets taken by blocks that are running.
WIRE_CASES = ([(C, d) for C in (1, 3, 8, 9, 130, 8192) for d in (0.0, 0.2, 1.0)]
              + [(130, "last chunk only"), (8192, "last chunk only"),
                 (1 << 18, 0.6), (1 << 18, "last chunk only")])


def _wire_input(C, density, cuda, seed):
    if density == "last chunk only":
        k = torch.zeros(C, 256, dtype=torch.int8, device=cuda)
        k[-1, 200] = -3
        return k
    return _levels_input(C, density, cuda, seed)


def _wire_round_trip(k):
    """The wire kernels' outputs (levels, bitmap, nnz, decoded k), one
    launch each way."""
    before = dict(build.LAUNCHES)
    lv, bitmap, nnz = levels.levels_compact_wire(k)
    out = levels.levels_expand_wire(lv, bitmap)
    assert build.LAUNCHES == {**before,
                              "levels_compact": before["levels_compact"] + 1,
                              "levels_expand": before["levels_expand"] + 1}
    return lv, bitmap, nnz, out


@pytest.mark.parametrize("C,density", WIRE_CASES, ids=str)
def test_wire_kernels_match_plain(cuda, C, density):
    k = _wire_input(C, density, cuda, C)
    lv, bitmap, nnz, out = _wire_round_trip(k)
    want = levels.levels_compact_wire_plain(k)
    for got, w, what in zip((lv, bitmap, nnz), want, ("levels", "bitmap", "nnz")):
        assert got.shape == w.shape and got.dtype == w.dtype, what
        assert torch.equal(got, w), what
    assert torch.equal(out, levels.levels_expand_wire_plain(lv, bitmap))
    assert torch.equal(out, k)


def test_wire_kernels_repeat_over_a_reused_workspace(cuda):
    """The same bits on a second call, with a call of another chunk count
    in between (the allocator hands the workspace back)."""
    k = _wire_input(8192, 0.6, cuda, 12)
    first = _wire_round_trip(k)
    _wire_round_trip(_wire_input(9, 0.2, cuda, 13))
    second = _wire_round_trip(k)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wire_kernels_replay_in_a_cuda_graph(cuda):
    """Both wire kernels captured in one CUDA graph (the workspace's clear
    is a node of it): each replay gives the eager bytes, also for new
    data in the captured input."""
    k = _wire_input(8192, 0.6, cuda, 14)
    eager = _wire_round_trip(k)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _wire_round_trip(k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _wire_round_trip(k)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)
    k.copy_(_wire_input(8192, 0.2, cuda, 15))
    graph.replay()
    torch.cuda.synchronize()
    want = levels.levels_compact_wire_plain(k)
    for a, b in zip(captured[:3], want):
        assert torch.equal(a, b)
    assert torch.equal(captured[3], k)


def test_wire_wrappers_reject_bad_cuda_operands(cuda):
    k = torch.zeros(2 * 256 + 1, dtype=torch.int8, device=cuda)[1:].reshape(2, 256)
    with pytest.raises(ValueError, match="aligned"):
        levels.levels_compact_wire(k)
    lv = torch.zeros(512, dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        levels.levels_expand_wire(lv, torch.zeros(2, 32, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        levels.levels_expand_wire(
            lv, torch.zeros(32, 2, dtype=torch.uint8, device=cuda).t())


# The split-K edges of both tile-skipping products, with A stored transposed
# as in dW = k^T . x: c0's dW at batch 128 (one output tile over 1,024
# K-tiles), a K-tile count the split count does not divide, a split whose
# K-tiles are all masked, only the last K-tile occupied, and no tile at all.
SPLIT_CASES = {"c0_dw": 1024, "ragged": 37, "masked_split": 37,
               "last_tile_only": 37, "all_masked": 37}


def _split_case(kind, case, cuda):
    """(k or a, b, scale or delta, mask) stored as dW reads them, and the
    product's split count."""
    k_tiles = SPLIT_CASES[case]
    M, N, K = 128, 128, 128 * k_tiles
    g = torch.Generator(device=cuda).manual_seed(k_tiles)
    lim = 128 if kind == "int8" else 7
    a = torch.randint(-lim + 1, lim, (K, M), device=cuda, generator=g,
                      dtype=torch.int8)
    if kind == "int8":
        b = torch.randint(-127, 128, (K, N), device=cuda, generator=g,
                          dtype=torch.int8)
    else:
        b = torch.randn(K, N, device=cuda, generator=g)
    splits = bsp_matmul.splits_for(M, N, K, cuda)
    mask = torch.ones(k_tiles, 1, dtype=torch.int32, device=cuda)
    if case == "masked_split":
        lo, hi = bsp_matmul.split_bounds(k_tiles, splits)[1]
        mask[lo:hi] = 0
    elif case == "last_tile_only":
        mask.zero_()
        mask[-1] = 1
    elif case == "all_masked":
        mask.zero_()
    return a, b, torch.tensor(3e-3, device=cuda), mask, splits


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("kind", ["int8", "dequant"])
def test_split_k_edges_match_plain(cuda, kind, case):
    a, b, scale, mask, splits = _split_case(kind, case, cuda)
    k_tiles = mask.shape[0]
    assert splits > 1
    if case == "c0_dw":
        assert splits >= 100
    else:
        assert k_tiles % splits != 0
    name = "bsp_matmul_int8" if kind == "int8" else "bsp_matmul_dequant"
    before = build.LAUNCHES[name]
    if kind == "int8":
        got = bsp_matmul.bsp_matmul_int8(a, b, scale, mask, trans_a=True)
        want = bsp_matmul.bsp_matmul_int8_plain(a, b, scale, mask, trans_a=True)
    else:
        got = bsp_matmul.bsp_matmul(a, scale, b, mask, trans_a=True)
        want = bsp_matmul.bsp_matmul_plain(a, scale, b, mask, trans_a=True)
    assert build.LAUNCHES[name] == before + 1  # one launch per product
    if case == "all_masked":
        assert not got.any()
    if kind == "int8" or case == "all_masked":
        assert torch.equal(got, want)
        return
    rel = float((got - want).norm() / want.norm())
    assert rel <= 8 * math.sqrt(a.shape[0]) * 2.0 ** -24


def test_split_dequant_is_deterministic(cuda):
    """The f32 partials add in a fixed order, never by atomics: two launches
    on the same inputs give the same bits."""
    a, b, delta, mask, splits = _split_case("dequant", "c0_dw", cuda)
    first = bsp_matmul.bsp_matmul(a, delta, b, mask, trans_a=True)
    second = bsp_matmul.bsp_matmul(a, delta, b, mask, trans_a=True)
    assert splits > 1 and torch.equal(first, second)


# The dense cotangents of the Table-1 models at batch 64: T = 64 rows, less
# than one 128-row tile, at widths of one half-live 4-column group (LeNet5's
# c1 has 6 channels), 84 (LeNet5's fc2) and 500 (the MLP's hidden layers).
@pytest.mark.parametrize("N", [6, 84, 500])
@pytest.mark.parametrize("route", ["key", "fed"])
def test_nsd_kernel_at_table1_widths(cuda, N, route):
    g = _rand((64, N), cuda, N) * 1e-3
    delta = (2.0 * g.std(correction=0)).reshape(())
    key = 0x5DEECE66D
    kw = ({"key": key} if route == "key" else
          {"noise": nsd_quant.philox_uniform_plain(key, g.shape, device=cuda) * delta})
    before = build.LAUNCHES["nsd_quant"]
    got = nsd_quant.nsd_quantize(g, delta, **kw)
    assert build.LAUNCHES["nsd_quant"] == before + 1
    want = nsd_quant.nsd_quantize_plain(g, delta, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got.k.shape == (128, -(-N // 128) * 128)
    assert not got.k[64:].any() and not got.k[:, N:].any()


@pytest.mark.parametrize("tkn", [(64, 784, 500), (64, 120, 84), (37, 300, 6)])
def test_int8_variant_dense_products(cuda, tkn):
    """variant="int8" on a dense layer: one NSD launch and two int8
    products, bit for bit the plain versions' on the same cotangent, Delta
    and key."""
    T, K, N = tkn
    x = _rand((T, K), cuda, 1).requires_grad_()
    w = (_rand((K, N), cuda, 2) * 0.1).requires_grad_()
    g = _rand((T, N), cuda, 3) * 0.1
    ctx = DitherCtx(DitherPolicy(variant="int8", s=2.0), seed=5, step=1)
    before = dict(build.LAUNCHES)
    dithered.dense(x, w, ctx=ctx, name="fc").backward(g)
    launched = {k: v - before[k] for k, v in build.LAUNCHES.items() if v != before[k]}
    assert launched == {"nsd_quant": 1, "bsp_matmul_int8": 2}
    from repro_torch.core.int8 import absmax_int8

    delta = 2.0 * g.std(correction=0)
    q = nsd_quant.nsd_quantize_plain(g, delta, key=ctx.cotangent_key("fc"))
    pad = lambda t: torch.nn.functional.pad(  # noqa: E731
        t, (0, -t.shape[1] % 128, 0, -t.shape[0] % 128)).contiguous()
    xq, wq = absmax_int8(x.detach()), absmax_int8(w.detach())
    dx = bsp_matmul.bsp_matmul_int8_plain(q.k, pad(wq.q), delta * wq.scale, q.mask,
                                          trans_b=True)[:T, :K]
    dw = bsp_matmul.bsp_matmul_int8_plain(q.k, pad(xq.q), delta * xq.scale, q.mask,
                                          trans_a=True)[:N, :K].t()
    assert torch.equal(x.grad, dx)
    assert torch.equal(w.grad, dw)


def test_gemma_mlp_down_bf16_kernel_dense_matches_plain(cuda, monkeypatch):
    """gemma-2b's mlp.down at batch 8 x seq 128 in bf16, the kernel variant
    as the LM launcher runs it: x (1024, 16384), w (16384, 2048), cotangent
    (1024, 2048). One NSD launch and two int8 products; k, bitmap, nnz and
    mask and both int32 products (their f32 outputs, int32 x scale) bit for
    bit the plain versions'; dx and dW in bf16 equal to the op's on the
    plain versions."""
    from repro_torch.core.int8 import absmax_int8
    from repro_torch.kernels import ops

    T, K, N = 1024, 16384, 2048
    x = _rand((T, K), cuda, 31).to(torch.bfloat16).requires_grad_()
    w = (_rand((K, N), cuda, 32) / K ** 0.5).to(torch.bfloat16).requires_grad_()
    g = (_rand((T, N), cuda, 33) * 1e-3).to(torch.bfloat16)
    ctx = DitherCtx(DitherPolicy(variant="kernel", s=2.0), seed=5, step=2)
    before = dict(build.LAUNCHES)
    dithered.dense(x, w, ctx=ctx, name="L.mlp.down").backward(g)
    launched = {k: v - before[k] for k, v in build.LAUNCHES.items() if v != before[k]}
    assert launched == {"nsd_quant": 1, "bsp_matmul_int8": 2}
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16

    key = ctx.cotangent_key("L.mlp.down")
    q = ops.quantize_and_mask(g, key, 2.0)
    want = nsd_quant.nsd_quantize_plain(g.float(), q.delta, key=key)
    for a, b in zip((q.k, q.bitmap, q.nnz, q.mask), want):
        assert torch.equal(a, b)
    xq, wq = absmax_int8(x.detach()), absmax_int8(w.detach())
    for args, kw in (((q.k, wq.q, q.delta * wq.scale, q.mask), {"trans_b": True}),
                     ((q.k, xq.q, q.delta * xq.scale, q.mask), {"trans_a": True})):
        assert torch.equal(bsp_matmul.bsp_matmul_int8(*args, **kw),
                           bsp_matmul.bsp_matmul_int8_plain(*args, **kw))

    dx, dw = x.grad, w.grad
    x.grad = w.grad = None
    monkeypatch.setattr(nsd_quant, "nsd_quantize", nsd_quant.nsd_quantize_plain)
    monkeypatch.setattr(bsp_matmul, "bsp_matmul_int8", bsp_matmul.bsp_matmul_int8_plain)
    dithered.dense(x, w, ctx=ctx, name="L.mlp.down").backward(g)
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)


@pytest.mark.parametrize("spec", ["ecd,edf->ecf", "ecf,efd->ecd"])
def test_moe_expert_einsum_kernel_route_matches_plain(cuda, spec, monkeypatch):
    """moonshot's expert products at batch 8 x seq 128 in bf16 (64 experts,
    120 slots each, d 2048, f 1408), the kernel variant's batched form: one
    NSD launch over the (7680, N) cotangent, then a pack and two int8
    products per expert. Every launch is held to its plain version on the
    same inputs (k, the bitmaps, tile nnz and masks, the int8 products'
    f32 outputs: bit for bit), and dx and dW against the op on the plain
    versions within relative L2 1e-5."""
    E, C, d, f = 64, 120, 2048, 1408
    K, N = (d, f) if spec == "ecd,edf->ecf" else (f, d)
    x = (_rand((E, C, K), cuda, 41)).to(torch.bfloat16).requires_grad_()
    w = (_rand((E, K, N), cuda, 42) / K ** 0.5).to(torch.bfloat16).requires_grad_()
    g = (_rand((E, C, N), cuda, 43) * 1e-3).to(torch.bfloat16)
    ctx = DitherCtx(DitherPolicy(variant="kernel", s=2.0), seed=7, step=3)
    held = {"nsd_quant": 0, "bitmap_pack": 0, "bsp_matmul_int8": 0}

    def holding(kname, mod, attr):
        kern, plain = getattr(mod, attr), getattr(mod, attr + "_plain")

        def run(*a, **kw):
            got = kern(*a, **kw)
            want = plain(*a, **kw)
            for u, v in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert (u is None and v is None) or torch.equal(u, v), kname
            held[kname] += 1
            return got
        monkeypatch.setattr(mod, attr, run)
    holding("nsd_quant", nsd_quant, "nsd_quantize")
    holding("bitmap_pack", pack, "bitmap_pack_blocked")
    holding("bsp_matmul_int8", bsp_matmul, "bsp_matmul_int8")
    before = dict(build.LAUNCHES)
    dithered.dithered_einsum(spec, x, w, ctx=ctx, name="L.moe.up").backward(g)
    launched = {k: v - before[k] for k, v in build.LAUNCHES.items()
                if v != before[k]}
    assert launched == held == {"nsd_quant": 1, "bitmap_pack": E,
                                "bsp_matmul_int8": 2 * E}
    dx, dw = x.grad, w.grad
    assert dx.dtype == dw.dtype == torch.bfloat16
    monkeypatch.undo()
    x.grad = w.grad = None
    monkeypatch.setattr(nsd_quant, "nsd_quantize", nsd_quant.nsd_quantize_plain)
    monkeypatch.setattr(pack, "bitmap_pack_blocked", pack.bitmap_pack_blocked_plain)
    monkeypatch.setattr(bsp_matmul, "bsp_matmul_int8", bsp_matmul.bsp_matmul_int8_plain)
    before = dict(build.LAUNCHES)
    dithered.dithered_einsum(spec, x, w, ctx=ctx, name="L.moe.up").backward(g)
    assert build.LAUNCHES == before
    for got, want in ((dx, x.grad), (dw, w.grad)):
        rel = float((got.double() - want.double()).norm() / want.double().norm())
        assert rel <= 1e-5, rel


# ---------------------------------------------------------------------------
# the quant engine's codecs and encoded optimizer moments on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8_absmax", "int4@g32", "int4@g64", "m8",
                                  "u8"])
@pytest.mark.parametrize("shape", [(512, 2048), (37,), ()], ids=str)
def test_codecs_on_the_card_match_the_cpu(cuda, mode, shape):
    """Encode, decode and the bound on CUDA tensors: the same f32 operations
    as on the CPU, so the same bits (int8_absmax with the stream key's draw,
    the draw kernel's on the card and the plain draw on the CPU). u8 takes
    a square root, which CUDA's ``torch.sqrt`` does not round correctly (an
    ulp off the CPU's on ~0.6% of random inputs): its codes may differ by
    one on at most 1% of the elements, its scales by an ulp."""
    x = _rand(shape, cuda, 5) * 3.0
    if mode == "u8":
        x = torch.square(x)
    noise = 987654321 if mode == "int8_absmax" else None
    enc_c, enc_g = quant.encode(mode, x.cpu(), noise), quant.encode(mode, x, noise)
    if mode == "u8":
        dq = (enc_g.q.cpu().int() - enc_c.q.int()).abs()
        assert int(dq.max()) <= 1 and int(dq.sum()) <= max(1, dq.numel() // 100)
        torch.testing.assert_close(enc_g.scale.cpu(), enc_c.scale,
                                   rtol=2.0 ** -22, atol=0)
        return
    for name in ("q", "scale", "packed"):
        if hasattr(enc_g, name):
            assert torch.equal(getattr(enc_g, name).cpu(), getattr(enc_c, name)), name
    assert torch.equal(quant.decode(mode, enc_g).cpu(), quant.decode(mode, enc_c))
    assert torch.equal(quant.error_bound(mode, enc_g).cpu(),
                       quant.error_bound(mode, enc_c))


@pytest.mark.parametrize("chunk", [None, 4096])
def test_adamw_m8u8_step_on_the_card_matches_the_cpu(cuda, chunk, monkeypatch):
    """Two AdamW steps with m8 / u8 moments (a bf16 parameter with its f32
    master, an f32 one, a bias), from the same state and gradients on the
    card and on the CPU. ``chunk`` cuts each parameter into slices of rows.
    No clip: the global norm is a sum, whose order differs between the
    devices. The momentum takes no square root: its codes and scales are
    equal. CUDA's ``torch.sqrt`` is not correctly rounded (an ulp off the
    CPU's on ~0.6% of random inputs), and both the update and u8's encode
    take one: u8's codes may differ by one on at most 1% of the elements
    and its scales by an ulp; masters agree to rtol 1e-6, bf16 parameters
    to one bf16 ulp."""
    from repro_torch.optim import optimizers as opt

    if chunk is not None:
        monkeypatch.setattr(opt, "CHUNK_ELEMS", chunk)
    cfg = opt.OptConfig(name="adamw", lr=1e-2, weight_decay=0.1, grad_clip=None,
                        mu_codec="m8", nu_codec="u8")
    shapes = {"emb": ((300, 64), torch.bfloat16), "w": ((64, 96), torch.float32),
              "b": ((96,), torch.float32)}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = {n: torch.nn.Parameter(_rand(s, cuda, i).to(dev, dt))
                  for i, (n, (s, dt)) in enumerate(shapes.items())}
        state = opt.init_opt_state(params, cfg)
        for step in range(2):
            for i, (n, p) in enumerate(params.items()):
                p.grad = _rand(p.shape, cuda, 10 + 3 * step + i).to(dev, p.dtype)
            opt.apply_updates(params, state, cfg)
        out[dev.type] = (params, state)
    (pg, sg), (pc, sc) = out["cuda"], out["cpu"]
    for n in pg:
        torch.testing.assert_close(
            pg[n].detach().cpu().float(), pc[n].detach().float(), atol=0,
            rtol=2.0 ** -7 if pg[n].dtype == torch.bfloat16 else 1e-6)
        assert torch.equal(sg["mu"][n].q.cpu(), sc["mu"][n].q), n
        assert torch.equal(sg["mu"][n].scale.cpu(), sc["mu"][n].scale), n
        dq = (sg["nu"][n].q.cpu().int() - sc["nu"][n].q.int()).abs()
        assert int(dq.max()) <= 1 and int(dq.sum()) <= max(1, dq.numel() // 100), n
        torch.testing.assert_close(sg["nu"][n].scale.cpu(), sc["nu"][n].scale,
                                   rtol=2.0 ** -22, atol=0)
    torch.testing.assert_close(sg["master"]["emb"].cpu(), sc["master"]["emb"],
                               rtol=1e-6, atol=0)


# The paged expand: a stack of wire containers decoded in one launch, the
# container index in the grid (gemma-2b's KV pages are 16 chunks; 40-chunk
# pages take two blocks each, so the look-back runs inside a page).
PAGE_CASES = [(64, 16, 64), (4096, 16, 4096), (9, 1, 17), (20, 40, 33), (3, 2, 1)]


@pytest.mark.parametrize("n,c,m", PAGE_CASES, ids=str)
def test_paged_expand_matches_plain(cuda, n, c, m):
    k = _wire_input(n * c, 0.6, cuda, n + c).reshape(n, c, 256)
    k[0] = 0
    k[-1] = _wire_input(c, 1.0, cuda, 7).reshape(c, 256)
    lv = torch.empty(n, c * 256, dtype=torch.int8, device=cuda)
    bm = torch.empty(n, c, 32, dtype=torch.uint8, device=cuda)
    for i in range(n):
        lv[i], bm[i], _ = levels.levels_compact_wire_plain(k[i])
    g = torch.Generator(device=cuda).manual_seed(m)
    ids = torch.randint(0, n, (m,), device=cuda, generator=g)
    ids[0] = n - 1
    before = build.LAUNCHES["levels_expand"]
    out = levels.levels_expand_pages(lv, bm, ids)
    assert build.LAUNCHES["levels_expand"] == before + 1
    assert torch.equal(out, levels.levels_expand_pages_plain(lv, bm, ids))
    assert torch.equal(out, k[ids])
    assert torch.equal(out, levels.levels_expand_pages(lv, bm, ids))  # again


def test_nsd_pages_serve_on_the_kernels(cuda):
    """The engine with nsd pages on gemma-2b's smoke model: every request
    served, the launches the run's micro-steps and sealed pages imply, and
    each layer's pools decoded by the paged expand equal to its plain
    version."""
    import numpy as np

    from repro_torch.configs import get_smoke_model
    from repro_torch.serve import Engine, Request, ServeConfig, kvcache

    m = get_smoke_model("gemma-2b")
    eng = Engine(m, m.init(0, cuda), ServeConfig(max_batch=4, max_len=32,
                                                 kv_mode="nsd", kv_page=8))
    rng = np.random.default_rng(0)
    for uid in range(6):
        eng.submit(Request(uid, rng.integers(0, 512, 3 + uid), max_new_tokens=6))
    micro = []
    real = eng._run_chunk
    eng._run_chunk = lambda tb, nf, p0: micro.append(tb.shape[1]) or real(tb, nf, p0)
    build.reset_launches()
    out = eng.run(max_ticks=64)
    assert sorted(out) == list(range(6)) and all(len(v) == 6 for v in out.values())
    # positions written: the prompt and all but the last generated token
    seals = sum((3 + uid + 5) // 8 for uid in range(6))
    assert build.LAUNCHES["levels_expand"] == 2 * m.cfg.n_layers * sum(micro)
    assert build.LAUNCHES["nsd_quant"] == build.LAUNCHES["levels_compact"] \
        == 2 * m.cfg.n_layers * seals
    ids = torch.arange(eng.sched.pool.n_pages, device=cuda)
    for c in eng.cache:
        assert isinstance(c, kvcache.PagedKV)
        for pool in (c.pool_k, c.pool_v):
            assert torch.equal(
                levels.levels_expand_pages(pool.levels, pool.bitmap, ids),
                levels.levels_expand_pages_plain(pool.levels, pool.bitmap, ids))


def test_loader_copies_pinned_batches_on_a_side_stream(cuda):
    """ShardedLoader on the card: each host batch is pinned, copied on the
    loader's stream, and handed over after the consumer's stream waits on
    the copy's event; the values are the host batch's."""
    from repro_torch.data import ShardedLoader

    def host(step):
        g = torch.Generator().manual_seed(step)
        return {"x": torch.randn(256, 1024, generator=g),
                "i": torch.arange(step, step + 8)}

    loader = ShardedLoader(host, prefetch=2, start_step=3, device=cuda)
    try:
        for want in (3, 4, 5, 6):
            step, batch = next(loader)
            assert step == want
            assert loader._stream != torch.cuda.current_stream(cuda)
            for k, v in host(step).items():
                assert batch[k].device.type == "cuda"
                assert torch.equal(batch[k].cpu(), v), k
            # consume on the current stream and drop the batch: its memory
            # goes back to the allocator only after this use
            (batch["x"] * 2).sum().item()
    finally:
        loader.close()
    assert not loader._thread.is_alive()
