"""Port parity for serving (the dense family): decode and prefill, the
paged KV cache, the scheduler, the engine, the workers, ``ServeMonitor``,
the launcher's spec and the serve bench, ``repro_torch`` against ``repro``
on the CPU.

Both sides run gemma-2b's smoke configuration (2 layers, d 128, 4 heads
with one KV head, vocab 512, f32) from the same parameters: the
reference's ``init_lm`` draw, converted with
``repro_torch.convert.lm_params_from_jax``. Paged caches feed the
reference's unit draw of each page (``PagedKV.page_noise``) and its Delta
(``jnp.std``, patched into ``nsd.compute_delta``): threefry draws cannot be
reproduced, and ``torch.std`` may round Delta's last bit otherwise. The
reference runs eagerly: under ``jit`` XLA turns int8's division by 255
into a product with its reciprocal and fuses its decode into one
multiply-add, an ulp off the true operations that both sides run here.

Bands (f32): logits and caches of ``decode_step`` and ``prefill`` within
rtol 1e-5 (atol 1e-6 of the largest entry), the same math summed in
another order. Sealed pages bit for bit: fp32, bf16 and int8 pages field
by field, nsd pages in levels, bitmap, deltas and nnz. Tokens exactly: the
engine against the port's own ``greedy_generate``, and that against the
reference's.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.configs import get_smoke_model as j_get_smoke  # noqa: E402
from repro.launch.serve import parse_serve_spec as j_parse_spec, serve_config as j_serve_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.obs.bus import MetricsBus as JBus  # noqa: E402
from repro.obs.monitor import ServeMonitor as JServeMonitor  # noqa: E402
from repro.serve import greedy_generate as j_greedy  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch.configs import get_smoke_model  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core import nsd  # noqa: E402
from repro_torch.kernels import levels  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.obs.bus import MetricsBus, set_bus  # noqa: E402
from repro_torch.obs.monitor import ServeMonitor  # noqa: E402
from repro_torch.obs.runlog import read_run  # noqa: E402
from repro_torch.serve import (Engine, PagePool, Request, Scheduler,  # noqa: E402
                               SchedulerConfig, ServeConfig, Supervisor,
                               greedy_generate, kvcache)
from repro_torch.serve.kvcache import PagedKV, init_paged, pages_for  # noqa: E402
from repro_torch.train import serve_bench  # noqa: E402

ARCH = "gemma-2b"


@functools.lru_cache(maxsize=None)
def _models():
    """(reference model, its params, port model, port net) from one draw."""
    jm, m = j_get_smoke(ARCH), get_smoke_model(ARCH)
    params, _ = jm.init(jax.random.PRNGKey(0))
    net = m.init(0, "cpu")
    net.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, m, net


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=n).astype(np.int32) for n in sizes]


@functools.lru_cache(maxsize=None)
def _ref(prompt: tuple, n_new: int, max_len: int = 64):
    _, _, m, net = _models()
    return greedy_generate(m, net, np.asarray(prompt, np.int32), n_new,
                           max_len=max_len)


def _refs(prompts, n_new, max_len=64):
    return {uid: _ref(tuple(int(x) for x in p), n_new, max_len)
            for uid, p in enumerate(prompts)}


def _close(got, want, rtol=1e-5, atol_frac=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the decode-time layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0, 5, [3, 0, -1, 11]])
def test_decode_positions_match_reference(t):
    got = L.decode_positions(torch.tensor(t))
    want = JL.decode_positions(jnp.asarray(t, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s_buf", [8, 16])
@pytest.mark.parametrize("t", [-1, 0, 3, 7, 8, 21])
def test_ring_helpers_match_reference(t, s_buf):
    tt = torch.tensor(t)
    assert int(L.ring_write_slot(tt, s_buf)) == int(
        JL.ring_write_slot(jnp.asarray(t), s_buf, 0))
    pos, valid = L.ring_slot_positions(tt, s_buf)
    jpos, jvalid = JL.ring_slot_positions(jnp.asarray(t), s_buf, 0)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_attention_mask_with_valid_keys_matches_reference():
    q = np.array([[3], [0], [5]])
    k = np.broadcast_to(np.arange(8), (3, 8))
    valid = np.random.default_rng(1).random((3, 8)) < 0.7
    got = L.attention_mask(torch.from_numpy(q), torch.from_numpy(k.copy()),
                           valid_k=torch.from_numpy(valid))
    cfg = JL.AttnConfig(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4)
    want = JL.attention_mask(jnp.asarray(q), jnp.asarray(k), cfg,
                             valid_k=jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# decode_step and prefill against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prefilled():
    """Both sides' prefill of one (2, 7) prompt into a 16-position cache."""
    jm, params, m, net = _models()
    toks = np.random.default_rng(2).integers(0, 512, (2, 7))
    jl, jc, jt = jm.prefill(params, jnp.asarray(toks), 16)
    tl, tc, tt = m.prefill(net, torch.from_numpy(toks), 16)
    return dict(jl=jl, jc=jc, jt=int(jt), tl=tl, tc=tc, tt=tt)


def _close_caches(got, want):
    assert len(got) == len(want)
    for (gk, gv), (wk, wv) in zip(got, want):
        _close(gk, wk)
        _close(gv, wv)


def test_prefill_matches_reference(prefilled):
    p = prefilled
    assert p["tt"] == p["jt"] == 6
    assert tuple(p["tl"].shape) == (2, 7, 512)
    _close(p["tl"], p["jl"])
    _close_caches(p["tc"], p["jc"])
    with pytest.raises(ValueError, match="does not fit"):
        _models()[2].prefill(_models()[3], torch.zeros(1, 17, dtype=torch.int64), 16)


@pytest.mark.parametrize("branch", ["scalar", "per-slot", "inactive"])
def test_decode_step_matches_reference(prefilled, branch):
    """One step from the prefilled cache: one shared position, per-slot
    positions, and a slot that is inactive (t < 0: it writes nothing)."""
    jm, params, m, net = _models()
    p = prefilled
    tok = np.array([[17], [300]])
    t = {"scalar": 7, "per-slot": [7, 9], "inactive": [7, -1]}[branch]
    jl, jc = jm.decode_step(params, p["jc"], jnp.asarray(tok),
                            jnp.asarray(t, jnp.int32))
    tt = t if branch == "scalar" else torch.tensor(t)
    tl, tc = m.decode_step(net, p["tc"], torch.from_numpy(tok), tt)
    assert tuple(tl.shape) == (2, 1, 512)
    if branch == "inactive":  # the row's output is discarded by callers
        _close(tl[:1], jl[:1])
        for (gk, gv), (k0, v0) in zip(tc, p["tc"]):
            assert torch.equal(gk[1], k0[1]) and torch.equal(gv[1], v0[1])
    else:
        _close(tl, jl)
    _close_caches(tc, jc)


def test_prefill_then_decode_equals_stepwise_decode():
    """The prompt through prefill, or one token at a time from an empty
    cache: the same cache and the same next-token logits (rtol 1e-5)."""
    _, _, m, net = _models()
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (1, 6)))
    lp, cp, t = m.prefill(net, toks, 16)
    cache = m.init_cache(1, 16, device="cpu")
    for j in range(6):
        ls, cache = m.decode_step(net, cache, toks[:, j:j + 1], j)
    _close(ls[:, 0], lp[:, -1])
    _close_caches(cache, cp)


# ---------------------------------------------------------------------------
# the paged KV cache against the reference
# ---------------------------------------------------------------------------

def test_paged_view_equals_dense_buffer():
    """decode_step over fp32 pages and over dense buffers of the same
    length: the same logits bit for bit, step after step, with a slot
    that starts late and one that idles now and then (the view is the
    buffer, paged), past the seal of the first pages."""
    _, _, m, net = _models()
    B, max_len, page = 3, 16, 8
    dense = m.init_cache(B, max_len, device="cpu")
    table = kvcache.PageTable(B, pages_for(max_len, page), "cpu")
    table.set(np.array([[4, 0], [1, 5], [2, 3]]))
    paged = [init_paged("fp32", B, max_len, 6, page, 1, 32, torch.float32,
                        kvcache.layer_key(i), device="cpu", table=table)
             for i in range(2)]
    rng = np.random.default_rng(13)
    pos = np.array([0, -3, 0])  # slot 1 starts late; slot 2 idles at times
    for step in range(14):
        idle = np.array([False, False, step % 4 == 1])
        t = np.where(idle | (pos < 0), -1, pos)
        pos = pos + ~idle
        tok = torch.from_numpy(rng.integers(0, 512, (B, 1)))
        ld, dense = m.decode_step(net, dense, tok, torch.from_numpy(t))
        lp, paged = m.decode_step(net, paged, tok, torch.from_numpy(t),
                                  t_host=t)
        live = t >= 0
        assert torch.equal(ld[live], lp[live]), step


class FedPagedKV(PagedKV):
    """Hands the port the reference's unit draw of each page."""

    jkey = None

    def page_noise(self, pid, shape):
        key = jquant.resid_key(jax.random.fold_in(self.jkey, pid))
        u = jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5)
        return torch.from_numpy(np.array(u))


def _jnp_delta(monkeypatch):
    """The port's Delta computed by jnp.std, as the reference's."""
    monkeypatch.setattr(nsd, "compute_delta", lambda x, s: torch.from_numpy(
        np.array(s * jnp.std(jnp.asarray(x.numpy(), jnp.float32)))))


def _fields(enc):
    if isinstance(enc, torch.Tensor):
        return {"": enc.numpy()}
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in vars(enc).items() if isinstance(v, torch.Tensor)}


def _jfields(enc):
    if isinstance(enc, jax.Array):
        return {"": np.asarray(enc)}
    return {f: np.asarray(getattr(enc, f), np.float32)
            if getattr(enc, f).dtype == jnp.bfloat16 else np.asarray(getattr(enc, f))
            for f in ("data", "q", "scale", "lo", "levels", "bitmap", "deltas", "nnz")
            if hasattr(enc, f)}


@pytest.mark.parametrize("mode", kvcache.KV_MODES)
def test_paged_cache_matches_reference(mode, monkeypatch):
    """Slots at staggered positions write, seal and read through
    ``update_and_view`` on both sides: every pool page bit for bit (the
    ones sealed and the ones never sealed: a row that does not seal, or is
    inactive, writes no page), the tails, and the view."""
    _jnp_delta(monkeypatch)
    B, page, n_pages, max_len, KV, hd = 3, 4, 7, 12, 1, 32
    jkey = jax.random.PRNGKey(9)
    jpk = jkv.init_paged(mode, B, max_len, n_pages, page, KV, hd,
                         jnp.float32, jkey)
    pk = init_paged(mode, B, max_len, n_pages, page, KV, hd, torch.float32,
                    kvcache.layer_key(0), device="cpu")
    pk.__class__ = FedPagedKV
    pk.jkey = jkey
    # slot 2's second logical page is unmapped: filling it seals nothing
    table = np.array([[5, 0, 2], [1, 6, -1], [3, -1, -1]], np.int32)
    jpk = jpk.with_table(jnp.asarray(table))
    pk.with_table(table)
    rng = np.random.default_rng(4)
    starts = np.array([0, 2, 5])
    for step in range(9):
        t = starts + step
        t[1] = -1 if step in (1, 6) else t[1]  # slot 1 idles on two steps
        t[2] = -1 if t[2] >= 8 else t[2]
        kvals = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
        vvals = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
        jK, jV, jpos, jvalid, jpk = jpk.update_and_view(
            jnp.asarray(kvals), jnp.asarray(vvals), jnp.asarray(t, jnp.int32))
        K, V, pos, valid, pk = pk.update_and_view(
            torch.from_numpy(kvals), torch.from_numpy(vvals),
            torch.from_numpy(t), t_host=t)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        # the view where it is valid (elsewhere both hold stale pages)
        m = np.asarray(jvalid)[..., None, None]
        for got, want in ((K, jK), (V, jV)):
            np.testing.assert_array_equal(np.where(m, got.numpy(), 0),
                                          np.where(m, want, 0))
    # the pages sealed (slot 0's two, slot 1's second: its first page's
    # last position fell on an idle step, slot 2's second is unmapped) bit
    # for bit; every other page still the port's encoding of a zero page
    # (the reference's differs there only in int8's scale, which XLA's CPU
    # flushes to zero where torch keeps the subnormal tiny / 255)
    init = init_paged(mode, B, max_len, n_pages, page, KV, hd,
                      torch.float32, 0, device="cpu")
    sealed = [5, 0, 6]
    for got, want, zero in ((pk.pool_k, jpk.pool_k, init.pool_k),
                            (pk.pool_v, jpk.pool_v, init.pool_v)):
        g, w, z = _fields(got), _jfields(want), _fields(zero)
        assert sorted(g) == sorted(w)
        for f in g:
            np.testing.assert_array_equal(g[f][sealed], w[f][sealed],
                                          err_msg=f)
            rest = [i for i in range(n_pages) if i not in sealed]
            np.testing.assert_array_equal(g[f][rest], z[f][rest], err_msg=f)
            assert not np.array_equal(g[f][sealed], z[f][sealed]), f
    np.testing.assert_array_equal(pk.tail_k.numpy(), np.asarray(jpk.tail_k))
    np.testing.assert_array_equal(pk.tail_v.numpy(), np.asarray(jpk.tail_v))


def test_inactive_slot_never_writes():
    pk = init_paged("fp32", batch=2, max_len=8, n_pages=4, page=4, n_kv=1,
                    hd=4, dtype=torch.float32, key=0, device="cpu")
    pk.with_table(np.array([[0, 1], [2, 3]]))
    one = torch.ones(2, 1, 1, 4)
    t = np.array([3, -1])
    _, _, _, valid, pk = pk.update_and_view(one, one, torch.from_numpy(t),
                                            t_host=t)
    assert not bool(valid[1].any())  # the inactive slot fully masked
    assert float(pk.tail_k[1].abs().max()) == 0.0  # its write dropped
    # slot 0 filled page 0's last position and sealed it; nothing else
    assert pk.pool_k[0, 3].eq(1).all() and not pk.pool_k[0, :3].any()
    assert not pk.pool_k[1:].any()


def test_step_plan_is_shared_and_follows_in_place_positions():
    """Layers that share a page table share one step plan for the same t;
    a t written in place since is a new step."""
    a = init_paged("fp32", 1, 8, 2, 4, 1, 4, torch.float32, 0, device="cpu")
    b = init_paged("fp32", 1, 8, 2, 4, 1, 4, torch.float32, 1, device="cpu",
                   table=a.table)
    a.with_table(np.array([[0, 1]]))
    assert b.table.host.tolist() == [[0, 1]]
    one = torch.ones(1, 1, 1, 4)
    t = torch.tensor([2])
    _, _, _, v1, _ = a.update_and_view(one, one, t, t_host=np.array([2]))
    assert b.table.plan(t, None, 4, 2) is a.table.plan(t, None, 4, 2)
    t += 1  # position 3: the write that fills page 0
    _, _, _, v2, _ = a.update_and_view(2 * one, 2 * one, t, t_host=np.array([3]))
    assert v1[0].tolist() == [True] * 3 + [False] * 5
    assert v2[0].tolist() == [True] * 4 + [False] * 4
    assert a.pool_k[0, 2:].flatten().tolist() == [1.0] * 4 + [2.0] * 4


@pytest.mark.parametrize("mode", kvcache.KV_MODES)
def test_page_bytes_match_reference(mode):
    assert kvcache.page_stored_nbytes(mode, 16, 1, 256) == \
        jkv.page_stored_nbytes(mode, 16, 1, 256)
    assert kvcache.page_dense_nbytes(16, 1, 32) == jkv.page_dense_nbytes(16, 1, 32)
    if mode in ("int8", "nsd"):  # the serve bench's 3x floor, statically
        assert (kvcache.page_dense_nbytes(16, 1, 32)
                / kvcache.page_stored_nbytes(mode, 16, 1, 32)) >= 3.0


def test_pages_for_and_mode_validation():
    for n, page in ((1, 8), (8, 8), (9, 8), (0, 4), (17, 16)):
        assert pages_for(n, page) == jkv.pages_for(n, page)
    for bad in ("int4@g32", "m8", "nosuch"):
        with pytest.raises(ValueError, match="kv mode"):
            init_paged(bad, 1, 8, 2, 4, 1, 4, torch.float32, 0, device="cpu")
    pk = init_paged("nsd@0.5", 1, 8, 2, 4, 1, 4, torch.float32, 0,
                    device="cpu")
    assert (pk.codec, pk.max_pages, pk.view_len) == ("nsd", 2, 8)


@pytest.mark.parametrize("n,c,ids", [(6, 16, [5, 0, 0, 3, 1]), (3, 1, [2, 2]),
                                     (4, 40, [1, 3, 0, 2]), (2, 2, [])])
def test_paged_expand_plain_equals_per_page_wire_expand(n, c, ids):
    """The paged expand's plain version, against the wire expand of each
    page alone (and the compact it inverts), with an all-zero and an
    all-non-zero page."""
    g = torch.Generator().manual_seed(n * c)
    k = torch.randint(-127, 128, (n, c, 256), generator=g, dtype=torch.int8)
    k = torch.where(torch.rand(n, c, 256, generator=g) < 0.4, k, 0)
    k[0] = 0
    k[-1] = torch.randint(1, 128, (c, 256), generator=g, dtype=torch.int8)
    lv, bm = zip(*(levels.levels_compact_wire_plain(k[i])[:2] for i in range(n)))
    lv, bm = torch.stack(lv), torch.stack(bm)
    idx = torch.tensor(ids, dtype=torch.int64)
    got = levels.levels_expand_pages(lv, bm, idx)
    assert got.shape == (len(ids), c, 256)
    for m, i in enumerate(ids):
        assert torch.equal(got[m], levels.levels_expand_wire_plain(lv[i], bm[i]))
        assert torch.equal(got[m], k[i])
    with pytest.raises(ValueError, match="levels_expand_pages"):
        levels.levels_expand_pages(lv[0], bm, idx)


# ---------------------------------------------------------------------------
# the scheduler (host rules, the reference's)
# ---------------------------------------------------------------------------

def test_pool_alloc_all_or_nothing_and_double_free():
    pool = PagePool(4, page=8)
    got = pool.alloc(3)
    assert got == [0, 1, 2] and pool.free_pages == 1
    assert pool.alloc(2) is None and pool.free_pages == 1  # short: nothing
    pool.free(got)
    assert pool.free_pages == 4 and pool.alloc(1) == [2]  # LIFO reuse
    with pytest.raises(ValueError, match="double"):
        pool.free([0])
    with pytest.raises(ValueError):
        PagePool(0, 4)


def test_queue_bound_budget_and_impossible_requests():
    sched = Scheduler(SchedulerConfig(max_queue=2), max_batch=2)
    assert sched.submit("a", tokens_worst_case=4)
    assert sched.submit("b", tokens_worst_case=4)
    assert not sched.submit("c", tokens_worst_case=4)
    assert sched.rejected == 1 and sched.queue_depth == 2
    sched = Scheduler(SchedulerConfig(max_active_tokens=10), max_batch=4)
    sched.submit("a", tokens_worst_case=6)
    assert sched.next_request(8, lambda r: 6) is None  # 8 + 6 > 10
    assert sched.next_request(4, lambda r: 6) == "a"
    sched.requeue_front("z")
    sched.submit("y", tokens_worst_case=1)
    assert sched.next_request(0, lambda r: 1) == "z"
    pool = PagePool(2, page=4)
    sched = Scheduler(SchedulerConfig(), max_batch=2, max_pages_per_slot=8,
                      pool=pool)
    with pytest.raises(ValueError, match="pool caps"):
        sched.submit("big", tokens_worst_case=100)


def test_scheduler_table_matches_reference():
    from repro.serve.scheduler import PagePool as JPool, Scheduler as JSched, \
        SchedulerConfig as JCfg
    ours = Scheduler(SchedulerConfig(), 3, 4, PagePool(7, 4))
    theirs = JSched(JCfg(), 3, 4, JPool(7, 4))
    for op, slot, n in (("ensure", 0, 6), ("ensure", 1, 3), ("ensure", 2, 9),
                        ("release", 1, 0), ("ensure", 0, 13),
                        ("ensure", 1, 16), ("ensure", 1, 5)):
        if op == "ensure":
            assert ours.ensure(slot, n) == theirs.ensure(slot, n)
        else:
            ours.release(slot)
            theirs.release(slot)
        np.testing.assert_array_equal(ours.table(), theirs.table())
        assert ours.pool.free_pages == theirs.pool.free_pages


# ---------------------------------------------------------------------------
# the engine against greedy_generate, token for token
# ---------------------------------------------------------------------------

def test_greedy_generate_matches_reference():
    jm, params, m, net = _models()
    p = _prompts((9,), seed=12)[0]
    want = j_greedy(jm, params, p, 6, max_len=32)
    assert greedy_generate(m, net, p, 6, max_len=32) == want
    assert greedy_generate(m, net, np.array([1, 2], np.int32), 0) == []


def _engine(cfg, prompts, n_new, name="engine"):
    _, _, m, net = _models()
    eng = Engine(m, net, cfg, name=name)
    for uid, p in enumerate(prompts):
        assert eng.submit(Request(uid, p, max_new_tokens=n_new))
    return eng


@pytest.mark.parametrize("kv", ["dense", "fp32", "bf16"])
def test_engine_matches_greedy_generate(kv):
    """Multi-token prompts, chunked prefill; dense buffers and paged fp32
    and bf16 pages (bf16 holds on this model: its K and V sit well inside
    bf16's range, as in the reference's test)."""
    prompts = _prompts((3, 17, 5, 11), seed=5)
    cfg = ServeConfig(max_batch=4, max_len=64) if kv == "dense" else \
        ServeConfig(max_batch=4, max_len=64, kv_mode=kv, kv_page=8)
    out = _engine(cfg, prompts, 6).run(max_ticks=64)
    assert out == _refs(prompts, 6)


def test_staggered_admission_and_chunk_size_invariance():
    """A request admitted mid-run writes cache position 0, not the
    engine's tick; prefill chunking is a scheduling choice, not a numerics
    one."""
    prompts = _prompts((9, 11), seed=1)
    refs = _refs(prompts, 8)
    eng = _engine(ServeConfig(max_batch=2, max_len=64, chunk=4), prompts[:1], 8)
    for _ in range(3):  # slot 0 is several positions in before slot 1
        eng.step()
    assert eng.submit(Request(1, prompts[1], max_new_tokens=8))
    done = dict(eng._finished)
    done.update(eng.run(max_ticks=64))
    assert done == refs
    for chunk in (1, 16):
        eng = _engine(ServeConfig(max_batch=2, max_len=64, chunk=chunk),
                      prompts, 8)
        assert eng.run(max_ticks=96) == refs


@pytest.mark.parametrize("mode", ["int8", "nsd"])
def test_engine_quantized_pages_complete(mode):
    prompts = _prompts((3, 9), seed=5)
    eng = _engine(ServeConfig(max_batch=2, max_len=64, kv_mode=mode,
                              kv_page=8), prompts, 5)
    out = eng.run(max_ticks=64)
    assert sorted(out) == [0, 1] and all(len(v) == 5 for v in out.values())


def test_engine_edge_cases():
    """max_new_tokens 0 completes without a slot; an EOS on the first
    token stops the request; work left when the tick budget runs out
    stays pending and completes on the next run()."""
    _, _, m, net = _models()
    eng = Engine(m, net, ServeConfig(max_batch=2, max_len=32))
    eng.submit(Request(0, np.array([1, 2, 3], np.int32), max_new_tokens=0))
    assert eng.run(max_ticks=8) == {0: []}
    p = _prompts((5,), seed=8)[0]
    first = _ref(tuple(int(x) for x in p), 1, 32)[0]
    eng = Engine(m, net, ServeConfig(max_batch=2, max_len=32, eos_id=first))
    eng.submit(Request(0, p, max_new_tokens=16))
    assert eng.run(max_ticks=32) == {0: [first]}
    prompts = _prompts((4, 4, 4), seed=9)
    eng = _engine(ServeConfig(max_batch=1, max_len=32, chunk=4), prompts, 6)
    done = dict(eng.run(max_ticks=3))  # not enough for even one request
    assert len(done) < 3 and eng.sched.queue_depth > 0
    for _ in range(10):
        done.update(eng.run(max_ticks=16))
        if len(done) == 3:
            break
    assert done == _refs(prompts, 6, max_len=32)


def test_pool_exhaustion_preempts_and_completes():
    prompts = _prompts((9, 11, 6, 4), seed=10)
    eng = _engine(ServeConfig(max_batch=4, max_len=32, kv_mode="fp32",
                              kv_page=4, kv_pool_pages=6), prompts, 8)
    out = eng.run(max_ticks=400)
    assert eng.preemptions > 0  # the pool really was short
    assert out == _refs(prompts, 8)  # recompute is lossless


# ---------------------------------------------------------------------------
# telemetry, workers, monitor
# ---------------------------------------------------------------------------

def test_engine_records_serve_rows():
    bus = set_bus(MetricsBus())
    try:
        eng = _engine(ServeConfig(max_batch=2, max_len=32, kv_mode="int8",
                                  kv_page=8), [np.array([1, 2, 3, 4], np.int32)],
                      3, name="rowtest")
        eng.run(max_ticks=16)
        rows = bus.rows_since("serve", "rowtest", 0)
    finally:
        set_bus(None)
    # tick, active, queue, fed, gen, kv bytes, kv dense: admit + prefill of
    # 4 tokens emits the first token, then two decode ticks
    assert rows[:, 0].tolist() == [0, 1, 2]
    assert rows[:, 3].tolist() == [4, 1, 1] and rows[:, 4].tolist() == [1, 1, 1]
    # one page mapped: int8 capacity against the dense fp32 counterfactual
    assert rows[0, 5] == 2 * kvcache.page_stored_nbytes("int8", 8, 1, 32)
    assert rows[0, 6] == 2 * kvcache.page_dense_nbytes(8, 1, 32)


@pytest.mark.parametrize("case", ["healthy", "stall", "backlog"])
def test_serve_monitor_matches_reference(case):
    rows = {"healthy": [[i, 2, 0, 8, 2, 0, 0] for i in range(6)],
            "stall": [[i, 2, 0, 8 * (i < 3), 2 * (i < 3), 0, 0]
                      for i in range(6)],
            "backlog": [[i, 1, 9, 4, 1, 0, 0] for i in range(6)]}[case]
    bus, jbus = MetricsBus(), JBus()
    mon = ServeMonitor(max_backlog=4.0, min_rows=3, bus=bus)
    jmon = JServeMonitor(max_backlog=4.0, min_rows=3, bus=jbus)
    for r in rows:
        bus.record("serve", "w0", r)
        jbus.record("serve", "w0", r)
    got = [e.to_dict() for e in mon.tick(6)]
    want = [e.to_dict() for e in jmon.tick(6)]
    assert got == want
    kinds = {e["kind"] for e in got}
    assert kinds == {"healthy": set(), "stall": {"serve_stall"},
                     "backlog": {"serve_backlog"}}[case]


def test_supervisor_routes_and_drains():
    _, _, m, net = _models()
    sup = Supervisor()
    for name in ("a", "b"):
        sup.add_worker(name, m, net, ServeConfig(max_batch=2, max_len=32,
                                                 chunk=4))
    with pytest.raises(ValueError, match="duplicate"):
        sup.add_worker("a", m, net, ServeConfig())
    with pytest.raises(ValueError, match="model name required"):
        sup.submit([1, 2], 3)
    prompts = _prompts((4, 4), seed=11)
    uids = [sup.submit(p, 3, model=w) for p, w in zip(prompts, ("a", "b"))]
    out = sup.run(max_ticks=32)
    assert sorted(out) == sorted(uids)
    for h in sup.health():
        assert h.idle and h.finished == 1 and h.model == m.name
    assert sup.result(uids[0]) == out[uids[0]] == _refs(prompts, 3, 32)[0]


# ---------------------------------------------------------------------------
# the launcher and the bench
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "worker gemma-2b: batch=4;kv=int8;page=16;chunk=8",
    "worker gemma-2b: batch=2;queue=8 worker gemma-2b: kv=nsd;page=8;pool=5;budget=64",
    "worker gemma-2b:"])
def test_parse_serve_spec_matches_reference(spec):
    got = launch_serve.parse_serve_spec(spec)
    assert got == j_parse_spec(spec)
    for (_, kv), (_, jkv_) in zip(got, j_parse_spec(spec)):
        assert vars(launch_serve.serve_config(kv)) == vars(j_serve_config(jkv_))


@pytest.mark.parametrize("spec,err,match", [
    ("batch=4", ValueError, "must start"),
    ("worker nosuch: batch=1", ValueError, "unknown arch"),
    ("worker gemma-2b: widgets=7", ValueError, "unknown serve key"),
    ("worker gemma-2b: batch", ValueError, "not key=value"),
    ("worker gemma-2b", ValueError, "followed by"),
    ("worker whisper-small: batch=2", ValueError, "greedy_generate"),
])
def test_parse_serve_spec_rejects(spec, err, match):
    """A malformed spec raises in the parser; whisper-small's parses, as
    in the reference, and its worker's engine raises the reference's
    ``ValueError`` (the audio family needs per-request encoder frames)."""
    with pytest.raises(err, match=match):
        for arch, kv in launch_serve.parse_serve_spec(spec):
            m = get_smoke_model(arch)
            Supervisor().add_worker(arch, m, m.init(0, "cpu"),
                                    launch_serve.serve_config(kv))


def test_launcher_serves_on_the_cpu_with_a_run_dir(tmp_path, capsys):
    set_bus(MetricsBus())  # the run directory drains the process's bus
    try:
        sup = launch_serve.main([
            "--serve", "worker gemma-2b: batch=2;max_len=32;kv=nsd;page=8",
            "--requests", "3", "--new-tokens", "5", "--device", "cpu",
            "--run-dir", str(tmp_path)])
    finally:
        set_bus(None)
    assert "served 3/3 requests" in capsys.readouterr().out
    assert all(len(v) == 5 for v in sup.workers["gemma-2b"].results.values())
    manifest, streams = read_run(str(tmp_path))
    assert manifest["context"]["launcher"] == "serve"
    rows = streams["serve"]
    assert rows and {r["tag"] for r in rows} == {"gemma-2b"}
    assert sum(r["gen_tokens"] for r in rows) == 15
    assert "monitor" not in streams  # a healthy run trips nothing
    with pytest.raises(ValueError, match="greedy_generate"):
        launch_serve.main(["--arch", "whisper-small", "--device", "cpu"])


def test_launcher_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "gemma-2b"])


def test_serve_bench_trace_and_arms_match_reference():
    import benchmarks.serve_bench as jb
    for n in (24, 96):
        for (p, n_new, tick), (jp, jn, jt) in zip(serve_bench._trace(512, n),
                                                  jb._trace(512, n)):
            np.testing.assert_array_equal(p, jp)
            assert (n_new, tick) == (jn, jt)


def test_serve_bench_preempt_arm_on_the_cpu():
    """The bench's preempt arm at the quick recipe against the reference's
    committed row: every request completes, tokens equal greedy_generate's,
    and the preemptions and KV bytes a token are the reference's exactly
    (host bookkeeping: the same trace gives the same schedule). Its
    wall-clock metrics are the card's to gate (``chip_smoke.py``)."""
    res = serve_bench.run_arm("preempt", *serve_bench.setup(device="cpu"))
    base = json.loads(open("benchmarks/baselines/BENCH_serve_bench.json").read())
    want = next(r for r in base["results"] if r["name"] == "serve/preempt")
    for k in ("completed_frac", "token_disagree_frac", "preemptions",
              "preempted_any", "kv_bytes_per_token"):
        assert res.derived[k] == want["derived"][k], k
    assert set(res.gates) == set(want["gates"])
