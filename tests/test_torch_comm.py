"""Port parity: the compressed gradient wire (``repro_torch.comm``) against
``repro.comm``.

Both sides get the same gradients (numpy, from a seed) and the same
quantizer inputs: the port is handed the reference's unit draw of every
pack through its seams (``compress_leaf``'s ``noise``, the ring's
``noise=`` callable, ``Reducer.pack_noise``), and its Delta is the
reference's function (``jnp.std``) on the port's tensor, as
tests/test_torch_memory.py feeds Delta: ``torch.std`` and ``jnp.std``
reduce in other orders, and a Delta one ulp apart may move a k that sits at
a rounding boundary. With both fed, each pack's k is the reference's and
every sum adds the same f32 terms in the same order.

Held: ``compress_leaf``'s output bit for bit and its wire bytes exactly in
every mode; the ring's mean within rel 1e-6 and its wire bytes, hops and
packs per segment exactly, its error bound within rel 1e-6; the reducer's
numbers equal to the direct calls' and to the reference's reducer, and
one comm telemetry row per reduce.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import compression as jcomp  # noqa: E402
from repro.comm import reduce_base as jbase  # noqa: E402
from repro.comm.reducer import reducer as j_reducer  # noqa: E402
from repro.comm import ring as jring  # noqa: E402
from repro.core import nsd as jnsd  # noqa: E402
from repro.core.policy import name_salt as j_name_salt  # noqa: E402
from repro_torch import comm  # noqa: E402
from repro_torch.comm import reduce_base, ring  # noqa: E402
from repro_torch.core import nsd  # noqa: E402
from repro_torch.core.policy import fold_in, name_salt  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

S = 2.0


@pytest.fixture
def ref_delta(monkeypatch):
    """The port's Delta through the reference's ``compute_delta``."""
    def delta(x, s):
        return torch.from_numpy(np.array(jnsd.compute_delta(
            jnp.asarray(x.detach().numpy()), s)))
    monkeypatch.setattr(nsd, "compute_delta", delta)


def _u(key, shape):
    """The reference's unit draw of a pack keyed ``key``."""
    return torch.from_numpy(np.array(jax.random.uniform(
        key, tuple(shape), jnp.float32, -0.5, 0.5)))


def _grads(n, shape, seed=0):
    return (np.random.default_rng(seed).standard_normal((n,) + tuple(shape))
            * 0.01).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# reduce helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,n", [(1, 1), (256, 1), (1000, 3), (4096, 4),
                                    (16384, 8), (257, 8), (100, 2)])
def test_seg_len_and_segment_match_reference(size, n):
    assert reduce_base.seg_len(size, n, 256) == jbase.seg_len(size, n, 256)
    x = np.arange(size, dtype=np.float32)
    got, seg = reduce_base.segment(torch.from_numpy(x), n, 256)
    want, jseg = jbase.segment(jnp.asarray(x), n, 256)
    assert seg == jseg and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the stacked form segments each row the same way
    two, _ = reduce_base.segment(torch.from_numpy(np.stack([x, -x])), n, 256)
    np.testing.assert_array_equal(two[1].numpy(), -np.asarray(want))


def test_dense_reduce_bytes_matches_reference():
    for size, n in [(1000, 3), (16384, 8), (10, 2)]:
        assert ring.dense_reduce_bytes(size, n) == jring.dense_reduce_bytes(
            size, n)


def test_hop_keys_are_distinct_and_stable():
    keys = {reduce_base.hop_key(7, salt, a, b) for salt in (0x51D5, 0xA11C)
            for a in range(8) for b in range(8)}
    assert len(keys) == 128
    assert all(0 <= k < 2**63 for k in keys)
    # one fold per index, as the reference's fold_in chain
    assert reduce_base.hop_key(7, 1, 2) == fold_in(fold_in(7, 1), 2)
    assert reduce_base.hop_key(7, 1, 2, 0) != reduce_base.hop_key(7, 1, 2)
    assert ring._REDUCE_SALT == jring._REDUCE_SALT
    assert ring._GATHER_SALT == jring._GATHER_SALT


# ---------------------------------------------------------------------------
# compress_leaf, every mode
# ---------------------------------------------------------------------------

MODES = ["dense", "int8", "nsd"]
LEAF_SHAPES = [(500,), (40, 30), (300,), (257,), (500, 10), (64, 3, 3, 3)]


@pytest.mark.parametrize("shape", LEAF_SHAPES, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_compress_leaf_matches_reference(mode, shape, ref_delta):
    g = _grads(1, shape, seed=3)[0]
    key = jax.random.PRNGKey(11)
    jpol = jcomp.CommPolicy(s=S)
    pol = comm.CommPolicy(s=S)
    gj, wj, _ = jcomp.compress_leaf(jnp.asarray(g), key, mode, jpol)
    before = dict(build.LAUNCHES)
    gt, wt, st = comm.compress_leaf(torch.from_numpy(g), _u(key, shape), mode,
                                    pol)
    assert build.LAUNCHES == before  # CPU tensors launch nothing
    assert st is None
    assert gt.dtype == torch.float32 and tuple(gt.shape) == shape
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert int(wt) == int(wj)


def test_topk_error_feedback_matches_reference_over_two_steps():
    g = _grads(2, (40, 30), seed=5)
    pol_frac = 0.05
    state_j = state_t = None
    for step in range(2):
        sj, state_j = jcomp.topk_error_feedback(jnp.asarray(g[step]), state_j,
                                                pol_frac)
        st, state_t = comm.topk_error_feedback(torch.from_numpy(g[step]),
                                               state_t, pol_frac)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(state_t.residual.numpy(),
                                      np.asarray(state_j.residual))
    # the leaf path: the same tensor, bytes charging k
    pol = comm.CommPolicy(default="topk_ef", topk_frac=pol_frac)
    jpol = jcomp.CommPolicy(default="topk_ef", topk_frac=pol_frac)
    gt, wt, _ = comm.compress_leaf(torch.from_numpy(g[0]), 0, "topk_ef", pol)
    gj, wj, _ = jcomp.compress_leaf(jnp.asarray(g[0]), jax.random.PRNGKey(0),
                                    "topk_ef", jpol)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert int(wt) == int(wj)


def test_topk_keeps_every_tie():
    g = torch.tensor([3.0, -3.0, 3.0, 1.0, 0.5, -0.25])
    sent, state = comm.topk_error_feedback(g, None, k_frac=0.2)  # k = 1
    np.testing.assert_array_equal(sent.numpy(), [3.0, -3.0, 3.0, 0, 0, 0])
    np.testing.assert_array_equal(state.residual.numpy(),
                                  [0, 0, 0, 1.0, 0.5, -0.25])


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _ring_pair(n, shape, seed=0):
    g = _grads(n, shape, seed)
    key = jax.random.PRNGKey(seed + 100)
    mj, tj = jring.ring_allreduce_nsd(jnp.asarray(g), key,
                                      jring.RingConfig(s=S))

    def noise(salt, a, b, seg_shape):
        return _u(jbase.hop_key(key, salt, a, b), seg_shape)

    mt, tt = comm.ring_allreduce_nsd(torch.from_numpy(g), 5,
                                     comm.RingConfig(s=S), noise=noise)
    return g, (mj, tj), (mt, tt)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(64, 32), (1000,)], ids=str)
def test_ring_matches_reference(n, shape, ref_delta):
    g, (mj, tj), (mt, tt) = _ring_pair(n, shape)
    assert tuple(mt.shape) == shape and mt.dtype == torch.float32
    assert _rel(mt.numpy(), mj) <= 1e-6
    assert float(tt.wire_bytes) == float(tj.wire_bytes)
    assert float(tt.dense_bytes) == float(tj.dense_bytes)
    assert tt.n_hops == tj.n_hops == 2 * n * (n - 1)
    assert tt.packs_per_segment == tj.packs_per_segment
    assert float(tt.error_bound) == pytest.approx(float(tj.error_bound),
                                                  rel=1e-6, abs=0)
    if n > 1:  # the bound holds pointwise against the dense mean
        err = np.abs(mt.numpy() - g.mean(0)).max()
        assert err <= float(tt.error_bound) * (1 + 1e-5)


def test_ring_key_route_is_the_fed_route_of_its_draw(ref_delta):
    """The default (stream key) route equals feeding the wire's own draw of
    those keys: the key is all the ring needs."""
    from repro_torch.quant import wire
    g = torch.from_numpy(_grads(4, (700,), 2))
    m_key, t_key = comm.ring_allreduce_nsd(g, 17, comm.RingConfig(s=S))

    def noise(salt, a, b, shape):
        return wire.unit_draw(reduce_base.hop_key(17, salt, a, b), shape,
                              device="cpu")

    m_fed, t_fed = comm.ring_allreduce_nsd(g, 17, comm.RingConfig(s=S),
                                           noise=noise)
    assert torch.equal(m_key, m_fed)
    assert float(t_key.wire_bytes) == float(t_fed.wire_bytes)
    assert float(t_key.error_bound) == float(t_fed.error_bound)


def test_ring_packs_read_the_partial_sums_of_the_step_before(ref_delta):
    """Step t's packs read the accumulators as step t - 1's adds left them:
    node i sends segment (i - t) % n, its own value plus what node i - 1
    sent it at step t - 1 (never a segment it receives in the same step)."""
    from repro_torch.quant import wire
    n, seg = 4, 256
    g = torch.from_numpy(_grads(n, (n * seg,), 8))
    seen, packs = [], []
    real = wire.pack_nsd

    def spy(x, noise, s, **kw):
        seen.append(x.clone())
        packs.append(real(x, noise, s, **kw))
        return packs[-1]

    wire.pack_nsd = spy
    try:
        comm.ring_allreduce_nsd(g, 1, comm.RingConfig(s=S))
    finally:
        wire.pack_nsd = real
    assert len(seen) == n * n  # n - 1 reduce steps and n gather packs
    acc = g.reshape(n, n, seg).clone()
    for t in range(n - 1):
        for i in range(n):
            assert torch.equal(seen[t * n + i], acc[i, (i - t) % n]), (t, i)
        for i in range(n):
            acc[(i + 1) % n, (i - t) % n] += wire.unpack_nsd(packs[t * n + i])
    for c in range(n):  # the gather packs each completed segment once
        assert torch.equal(seen[(n - 1) * n + c], acc[(c - 1) % n, c])


def test_comm_policy_refuses_another_chunk():
    with pytest.raises(ValueError, match="one chunk"):
        comm.CommPolicy(chunk=128)
    assert comm.CommPolicy(chunk=256).chunk == 256


# ---------------------------------------------------------------------------
# the reducer
# ---------------------------------------------------------------------------

SHAPES = {"fc0_w": (40, 30), "fc0_b": (30,), "fc1_w": (300,),
          "fc1_b": (10,), "c0_w": (16, 3, 3, 3)}


def _stacked(n, seed=0):
    return {name: _grads(n, s, seed + i)
            for i, (name, s) in enumerate(SHAPES.items())}


class _FedReducer:
    """Hands a port reducer the reference's draw of every pack."""

    def __init__(self, jkey):
        self.jkey = jkey

    def __call__(self, key, step, name, path, shape):
        k = jax.random.fold_in(jax.random.fold_in(self.jkey, step),
                               j_name_salt(name))
        for i in path:
            k = jax.random.fold_in(k, i)
        return _u(k, shape)


@pytest.mark.parametrize("topology,n", [("ps", 1), ("ps", 2), ("ps", 4),
                                        ("ring", 2), ("ring", 3)])
def test_reducer_matches_reference(topology, n, ref_delta):
    g = _stacked(n, seed=n)
    jkey, step = jax.random.PRNGKey(21), 3
    overrides = (("fc1", "int8"),) if topology == "ps" else ()
    jpol = jcomp.CommPolicy(s=S, topology=topology, overrides=overrides)
    pol = comm.CommPolicy(s=S, topology=topology, overrides=overrides)
    jred = j_reducer(jpol, n_nodes=n, stacked=True)
    red = comm.reducer(pol, n_nodes=n)
    red.pack_noise = _FedReducer(jkey)
    mj, tj, _ = jred.reduce({k: jnp.asarray(v) for k, v in g.items()}, jkey,
                            step)
    mt, tt, _ = red.reduce({k: torch.from_numpy(v) for k, v in g.items()}, 0,
                           step)
    assert list(mt) == sorted(SHAPES)
    for name in SHAPES:
        assert _rel(mt[name].numpy(), mj[name]) <= 1e-6, name
    assert float(tt.wire_bytes) == float(tj.wire_bytes)
    assert float(tt.dense_bytes) == float(tj.dense_bytes)
    assert float(tt.error_bound) == pytest.approx(float(tj.error_bound),
                                                  rel=1e-6, abs=0)
    assert (tt.n_hops, tt.packs_per_segment) == (tj.n_hops,
                                                 tj.packs_per_segment)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ps_reducer_equals_direct_calls(n):
    g = {k: torch.from_numpy(v) for k, v in _stacked(n, seed=7).items()}
    pol = comm.CommPolicy(s=S, overrides=(("fc1", "int8"),))
    red = comm.reducer(pol, n_nodes=n)
    out, tele, _ = red.reduce(g, 9, 2)
    wire_bytes, dense_bytes = 0.0, 0.0
    for name, gn in sorted(g.items()):
        size = gn[0].numel()
        mode = pol.mode_for(name, size)
        dense_bytes += 4 * size * n
        k0 = fold_in(fold_in(9, 2), name_salt(name))
        hats = []
        for w in range(n):
            gh, b, _ = comm.compress_leaf(gn[w], fold_in(k0, w), mode, pol)
            hats.append(gh)
            wire_bytes += float(b)
        assert torch.equal(out[name], reduce_base.node_mean(hats)), name
    assert float(tele.wire_bytes) == wire_bytes
    assert float(tele.dense_bytes) == dense_bytes
    assert (tele.n_hops, tele.packs_per_segment) == (n, 1)
    assert float(tele.error_bound) == 0.0


@pytest.mark.parametrize("n", [2, 3])
def test_ring_reducer_equals_direct_calls(n):
    g = {k: torch.from_numpy(v) for k, v in _stacked(n, seed=5).items()}
    pol = comm.CommPolicy(s=S, topology="ring")
    red = comm.reducer(pol, n_nodes=n)
    out, tele, _ = red.reduce(g, 9, 2)
    wire_bytes = dense_bytes = bound = 0.0
    hops = 0
    for name, gn in sorted(g.items()):
        if pol.mode_for(name, gn[0].numel()) == "dense":
            db = ring.dense_reduce_bytes(gn[0].numel(), n)
            wire_bytes += db
            dense_bytes += db
            assert torch.equal(out[name], reduce_base.node_mean(gn))
            continue
        m, t = comm.ring_allreduce_nsd(
            gn, fold_in(fold_in(9, 2), name_salt(name)), comm.RingConfig(s=S))
        assert torch.equal(out[name], m), name
        wire_bytes += float(t.wire_bytes)
        dense_bytes += float(t.dense_bytes)
        bound = max(bound, float(t.error_bound))
        hops += t.n_hops
    assert float(tele.wire_bytes) == wire_bytes
    assert float(tele.dense_bytes) == dense_bytes
    assert float(tele.error_bound) == bound
    assert (tele.n_hops, tele.packs_per_segment) == (hops, n)


def test_min_leaf_size_and_first_match_overrides():
    pol = comm.CommPolicy(overrides=(("fc1", "int8"), ("fc", "dense"),
                                     ("fc1", "topk_ef")))
    assert pol.mode_for("fc1_w", 10_000) == "int8"  # first match wins
    assert pol.mode_for("fc0_w", 10_000) == "dense"
    assert pol.mode_for("c0_w", 10_000) == "nsd"
    assert pol.mode_for("c0_b", 255) == "dense"  # under min_leaf_size
    assert pol.mode_for("c0_b", 256) == "nsd"
    assert comm.CommPolicy(min_leaf_size=1).mode_for("c0_b", 5) == "nsd"
    assert comm.DENSE.mode_for("c0_w", 10**6) == "dense"
    assert pol.replace(s=3.0).s == 3.0 and pol.s == 1.0


def test_topk_ef_state_threads_through_the_ps_reducer():
    n = 2
    g = {"w": torch.from_numpy(_grads(n, (40, 30), 1))}
    pol = comm.CommPolicy(default="topk_ef", topk_frac=0.05)
    red = comm.reducer(pol, n_nodes=n)
    state = red.init_state(g)
    assert set(state) == {"w"} and not state["w"].residual.any()
    out, tele, state = red.reduce(g, 0, 0, state)
    sent, st = comm.topk_error_feedback(g["w"].mean(0), None, 0.05)
    assert torch.equal(out["w"], sent)
    assert torch.equal(state["w"].residual, st.residual)
    assert float(tele.wire_bytes) == n * (8 * 60 + 4)


@pytest.mark.parametrize("kw", [dict(topology="hier", pods=2),
                                dict(topology="butterfly", pods=2),
                                dict(bucket_bytes=1 << 10)])
def test_reducer_refuses_what_is_not_ported(kw, ref_delta):
    """The three policies this test once saw refused are ported now: each
    reducer is built, and its reduce equals the reference reducer's under
    the same policy, given its draws."""
    n, step, jkey = 4, 1, jax.random.PRNGKey(5)
    g = _stacked(n, seed=11)
    red = comm.reducer(comm.CommPolicy(s=S, **kw), n_nodes=n)
    jred = j_reducer(jcomp.CommPolicy(s=S, **kw), n_nodes=n, stacked=True)
    getattr(red, "base", red).pack_noise = _FedReducer(jkey)
    mt, tt, _ = red.reduce({k: torch.from_numpy(v) for k, v in g.items()}, 0,
                           step)
    mj, tj, _ = jred.reduce({k: jnp.asarray(v) for k, v in g.items()}, jkey,
                            step)
    assert list(mt) == sorted(SHAPES)
    for name in SHAPES:
        np.testing.assert_array_equal(mt[name].numpy(), np.asarray(mj[name]),
                                      err_msg=name)
    for f in ("wire_bytes", "dense_bytes", "error_bound", "wire_ici_bytes",
              "wire_dcn_bytes", "peak_dcn_bytes", "n_hops",
              "packs_per_segment", "pods", "per_pod", "n_buckets"):
        assert float(getattr(tt, f)) == float(getattr(tj, f)), f


@pytest.mark.parametrize("kw", [dict(topology="mesh"), dict(default="int3"),
                                dict(overrides=(("fc", "bf16"),)),
                                dict(bucket_bytes=-1), dict(chunk=512)])
def test_comm_policy_rejects(kw):
    with pytest.raises(ValueError):
        comm.CommPolicy(**kw)


@pytest.mark.parametrize("topology", ["ps", "ring"])
def test_reducer_emits_one_comm_row_per_reduce(topology):
    g = {k: torch.from_numpy(v) for k, v in _stacked(2, seed=2).items()}
    pol = comm.CommPolicy(s=S, topology=topology)
    metrics.reset()
    comm.reducer(pol, n_nodes=2).reduce(g, 5, 1)
    assert metrics.comm_summary() == {}  # collect_stats off: no row
    red = comm.reducer(pol.replace(collect_stats=True), n_nodes=2)
    teles = [red.reduce(g, 5, step)[1] for step in (1, 2)]
    assert metrics.comm_tags() == [comm.telemetry.TAG]
    rows = metrics.comm_rows(comm.telemetry.TAG)
    assert rows.shape == (2, 2)
    for row, tele in zip(rows, teles):
        assert row[0] == float(tele.wire_bytes)
        assert row[1] == float(tele.dense_bytes)
    summ = metrics.comm_summary()[comm.telemetry.TAG]
    assert summ["n_records"] == 2
    assert summ["ratio"] == pytest.approx(
        float(rows[:, 0].sum()) / float(rows[:, 1].sum()))
    metrics.reset()
    assert metrics.comm_summary() == {}
