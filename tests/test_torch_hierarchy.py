"""Port parity: the two-level reduces (``repro_torch.comm.hierarchy``,
``repro_torch.comm.butterfly``), overlap bucketing
(``repro_torch.comm.overlap``) and the reducer's ``hier`` and ``butterfly``
topologies against ``repro.comm``.

Both sides get the same gradients (numpy, from a seed) and the same
quantizer inputs: every pack of the port is handed the reference's unit
draw of that pack (the reduces' ``noise=`` callable,
``Reducer.pack_noise``), and Delta is the reference's ``compute_delta`` on
the port's tensor, as tests/test_torch_comm.py feeds them. Given those, the
mean and every telemetry field equal the reference's bit for bit: each
pack's k is the reference's and every sum adds the same f32 terms in the
same order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import butterfly as jbfly  # noqa: E402
from repro.comm import compression as jcomp  # noqa: E402
from repro.comm import hierarchy as jhier  # noqa: E402
from repro.comm import overlap as jover  # noqa: E402
from repro.comm import reduce_base as jbase  # noqa: E402
from repro.comm.reducer import reducer as j_reducer  # noqa: E402
from repro.core import nsd as jnsd  # noqa: E402
from repro.core.policy import name_salt as j_name_salt  # noqa: E402
from repro_torch import comm  # noqa: E402
from repro_torch.comm import butterfly, hierarchy  # noqa: E402
from repro_torch.core import nsd  # noqa: E402
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


def _fed(key):
    """The reduces' ``noise``: the reference's draw of hop (salt, *idx)."""
    def noise(*args):
        return _u(jbase.hop_key(key, *args[:-1]), args[-1])
    return noise


def _same_telemetry(tt, tj):
    assert type(tt)._fields == type(tj)._fields
    for f in tj._fields:
        assert float(getattr(tt, f)) == float(getattr(tj, f)), f


# ---------------------------------------------------------------------------
# the two reduces against the reference
# ---------------------------------------------------------------------------

CASES = [(1, 1), (4, 2), (4, 4), (6, 2), (6, 3), (8, 2), (8, 4), (8, 8)]


@pytest.mark.parametrize("n,pods", CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("topology", ["hier", "butterfly"])
def test_reduce_matches_reference(topology, n, pods, ref_delta):
    """Mean and every telemetry field bit for bit, ragged pod counts (3, 6)
    included: the butterfly's pre- and post-fold."""
    g = _grads(n, (700,), seed=n + pods)
    key = jax.random.PRNGKey(n * 10 + pods)
    if topology == "hier":
        mj, tj = jhier.hier_allreduce_nsd(jnp.asarray(g), key,
                                          jhier.HierConfig(pods=pods, s=S))
        fn, cfg = comm.hier_allreduce_nsd, comm.HierConfig(pods=pods, s=S)
    else:
        mj, tj = jbfly.butterfly_allreduce_nsd(
            jnp.asarray(g), key, jbfly.ButterflyConfig(pods=pods, s=S))
        fn, cfg = (comm.butterfly_allreduce_nsd,
                   comm.ButterflyConfig(pods=pods, s=S))
    before = dict(build.LAUNCHES)
    mt, tt = fn(torch.from_numpy(g), 0, cfg, noise=_fed(key))
    assert build.LAUNCHES == before  # CPU tensors launch nothing
    assert mt.dtype == torch.float32 and tuple(mt.shape) == (700,)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    _same_telemetry(tt, tj)
    if n > 1:  # the bound holds pointwise against the dense mean
        err = np.abs(mt.numpy() - g.mean(0)).max()
        assert err <= float(tt.error_bound) * (1 + 1e-5)


def test_key_route_is_the_fed_route_of_its_draw(ref_delta):
    """The default (stream key) route equals feeding the wire's own draw of
    those keys."""
    from repro_torch.quant import wire
    g = torch.from_numpy(_grads(6, (900,), 4))

    def noise(*args):
        return wire.unit_draw(comm.hop_key(17, *args[:-1]), args[-1],
                              device="cpu")

    for fn, cfg in ((comm.hier_allreduce_nsd, comm.HierConfig(pods=3, s=S)),
                    (comm.butterfly_allreduce_nsd,
                     comm.ButterflyConfig(pods=3, s=S))):
        m_key, t_key = fn(g, 17, cfg)
        m_fed, t_fed = fn(g, 17, cfg, noise=noise)
        assert torch.equal(m_key, m_fed)
        for f in t_key._fields:
            assert float(getattr(t_key, f)) == float(getattr(t_fed, f)), f


@pytest.mark.parametrize("n", [2, 4, 6, 8])
def test_butterfly_at_one_pod_is_the_tree(n):
    g = torch.from_numpy(_grads(n, (1300,), n))
    mh, th = comm.hier_allreduce_nsd(g, 3, comm.HierConfig(pods=1, s=S))
    mb, tb = comm.butterfly_allreduce_nsd(g, 3,
                                          comm.ButterflyConfig(pods=1, s=S))
    assert torch.equal(mh, mb)
    for f in ("wire_bytes", "error_bound", "wire_ici_bytes", "wire_dcn_bytes",
              "packs_per_segment", "pods", "per_pod"):
        assert float(getattr(th, f)) == float(getattr(tb, f)), f


def test_helpers_and_salts_match_reference():
    for pods in range(1, 17):
        assert comm.tree_rounds(pods) == jhier.tree_rounds(pods)
        assert comm.butterfly_rounds(pods) == jbfly.butterfly_rounds(pods)
        for seg in (256, 768, 2048):
            assert butterfly._piece_len(seg, pods) == jbfly._piece_len(
                seg, pods)
    for size, pods, per_pod in [(1000, 2, 4), (16384, 4, 2), (700, 3, 2),
                                (10, 1, 8), (4096, 6, 1)]:
        assert hierarchy.dense_reduce_bytes(size, pods, per_pod) == \
            jhier.dense_reduce_bytes(size, pods, per_pod)
        assert butterfly.dense_reduce_bytes(size, pods, per_pod) == \
            jbfly.dense_reduce_bytes(size, pods, per_pod)
        assert hierarchy._hop_counts(pods, per_pod) == jhier._hop_counts(
            pods, per_pod)
        assert butterfly._hop_counts(pods, per_pod) == jbfly._hop_counts(
            pods, per_pod)
    assert (hierarchy._INTRA_SALT, hierarchy._TREE_UP_SALT,
            hierarchy._TREE_DOWN_SALT) == (jhier._INTRA_SALT,
                                           jhier._TREE_UP_SALT,
                                           jhier._TREE_DOWN_SALT)
    assert (butterfly._FOLD_SALT, butterfly._HALVE_SALT) == (
        jbfly._FOLD_SALT, jbfly._HALVE_SALT)


@pytest.mark.parametrize("kw", [dict(pods=0), dict(pods=-2)])
def test_configs_reject_pods(kw):
    for cls in (comm.HierConfig, comm.ButterflyConfig):
        with pytest.raises(ValueError):
            cls(**kw)
    with pytest.raises(ValueError):
        comm.CommPolicy(**kw)


def test_ragged_node_count_is_refused():
    g = torch.zeros(6, 300)
    for fn, cfg in ((comm.hier_allreduce_nsd, comm.HierConfig(pods=4)),
                    (comm.butterfly_allreduce_nsd,
                     comm.ButterflyConfig(pods=4))):
        with pytest.raises(ValueError, match="divisible"):
            fn(g, 0, cfg)
    with pytest.raises(ValueError, match="divisible"):
        comm.reducer(comm.CommPolicy(topology="hier", pods=4), n_nodes=6)


def test_allreduce_dispatchers_run_the_simulation():
    g = torch.from_numpy(_grads(4, (300,), 9))
    with pytest.warns(DeprecationWarning):
        m, t = comm.allreduce_hier(g, 5, comm.HierConfig(pods=2))
    assert torch.equal(m, comm.hier_allreduce_nsd(
        g, 5, comm.HierConfig(pods=2))[0])
    m, t = comm.allreduce_butterfly(g, 5, comm.ButterflyConfig(pods=2))
    assert torch.equal(m, comm.butterfly_allreduce_nsd(
        g, 5, comm.ButterflyConfig(pods=2))[0])
    # with a mesh they run the process reduce (tests/test_torch_mesh.py),
    # which needs the mesh's pod axis
    class FlatMesh:
        shape = {"nodes": 4}

    with pytest.raises(ValueError, match="pods"):
        comm.allreduce_butterfly(g[0], 5, comm.ButterflyConfig(pods=2),
                                 mesh=FlatMesh())


# ---------------------------------------------------------------------------
# overlap bucketing
# ---------------------------------------------------------------------------

NAMED = [("a", 100), ("b", 300), ("c", 50), ("d", 1000), ("e", 20),
         ("f", 20), ("g", 700)]
# a VGG-like list: large convolution and fc weights between small biases
VGG_LIKE = [("c0_w", 6912), ("c0_b", 256), ("c1_w", 294912), ("c1_b", 512),
            ("fc0_w", 2097152), ("fc0_b", 2048), ("fc1_w", 20480)]


@pytest.mark.parametrize("target", [1, 64, 256, 400, 1024, 10**6])
@pytest.mark.parametrize("named", [NAMED, VGG_LIKE], ids=["mixed", "vgg"])
def test_plan_buckets_matches_reference(target, named):
    got = comm.plan_buckets(named, target)
    want = jover.plan_buckets(named, target)
    assert got.buckets == want.buckets
    assert got.bucket_bytes == want.bucket_bytes
    assert (got.n_buckets, got.total_bytes) == (want.n_buckets,
                                                want.total_bytes)


def test_plan_buckets_rejects_a_zero_target():
    with pytest.raises(ValueError):
        comm.plan_buckets(NAMED, 0)


SHAPES = {"fc0_w": (40, 30), "fc0_b": (30,), "fc1_w": (300,),
          "fc1_b": (10,), "c0_w": (16, 3, 3, 3), "c1_w": (8, 16, 3, 3)}


def _stacked(n, seed=0):
    return {name: _grads(n, s, seed + i)
            for i, (name, s) in enumerate(SHAPES.items())}


@pytest.mark.parametrize("topology,n,pods", [("ps", 4, 1), ("ring", 3, 1),
                                             ("hier", 4, 2),
                                             ("butterfly", 6, 3)])
def test_overlap_reducer_equals_the_blocking_reduce(topology, n, pods):
    g = {k: torch.from_numpy(v) for k, v in _stacked(n, seed=n).items()}
    over = (("fc1", "topk_ef"),) if topology == "ps" else ()
    pol = comm.CommPolicy(s=S, topology=topology, pods=pods, min_leaf_size=16,
                          overrides=over)
    block = comm.reducer(pol, n_nodes=n)
    bucketed = comm.reducer(pol.replace(bucket_bytes=2048), n_nodes=n)
    assert isinstance(bucketed, comm.OverlapReducer)
    plan = bucketed.plan_for(g)
    assert plan.n_buckets > 2
    assert plan.buckets[0][0] == sorted(SHAPES)[-1]  # reverse flatten order
    state = block.init_state(g)
    mb, tb, sb = block.reduce(g, 11, 2, state)
    mo, to, so = bucketed.reduce(g, 11, 2, state)
    assert list(mo) == list(mb) == sorted(SHAPES)
    for name in SHAPES:
        assert torch.equal(mo[name], mb[name]), name
    assert set(so) == set(sb)
    for name in sb:
        assert torch.equal(so[name].residual, sb[name].residual)
    for f in ("wire_bytes", "dense_bytes", "error_bound", "wire_ici_bytes",
              "wire_dcn_bytes"):
        assert float(getattr(to, f)) == float(getattr(tb, f)), f
    if topology != "ps":  # ps counts n hops a reduce, the reference too
        assert to.n_hops == tb.n_hops
    assert to.n_buckets == plan.n_buckets and tb.n_buckets == 1


def test_overlap_emits_one_comm_row_a_bucket():
    g = {k: torch.from_numpy(v) for k, v in _stacked(2, seed=1).items()}
    pol = comm.CommPolicy(s=S, bucket_bytes=2048, collect_stats=True)
    red = comm.reducer(pol, n_nodes=2)
    metrics.reset()
    _, tele, _ = red.reduce(g, 1, 0)
    rows = metrics.comm_rows(comm.telemetry.TAG)
    assert rows.shape == (red.plan_for(g).n_buckets, 2)
    assert float(rows[:, 0].sum()) == float(tele.wire_bytes)
    metrics.reset()


# ---------------------------------------------------------------------------
# the reducer's two-level topologies against the reference's reducer
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("topology,n,pods", [("hier", 4, 2), ("hier", 6, 3),
                                             ("butterfly", 4, 2),
                                             ("butterfly", 6, 3),
                                             ("butterfly", 8, 4)])
def test_reducer_matches_reference(topology, n, pods, ref_delta):
    g = _stacked(n, seed=n)
    jkey, step = jax.random.PRNGKey(21), 3
    over = (("fc1_w", "int8"),)  # travels as nsd on an all-reduce
    jpol = jcomp.CommPolicy(s=S, topology=topology, pods=pods,
                            overrides=over)
    pol = comm.CommPolicy(s=S, topology=topology, pods=pods, overrides=over)
    jred = j_reducer(jpol, n_nodes=n, stacked=True)
    red = comm.reducer(pol, n_nodes=n)
    red.pack_noise = _FedReducer(jkey)
    mj, tj, _ = jred.reduce({k: jnp.asarray(v) for k, v in g.items()}, jkey,
                            step)
    mt, tt, _ = red.reduce({k: torch.from_numpy(v) for k, v in g.items()}, 0,
                           step)
    assert list(mt) == sorted(SHAPES)
    for name in SHAPES:
        np.testing.assert_array_equal(mt[name].numpy(), np.asarray(mj[name]),
                                      err_msg=name)
    for f in tj._fields:
        assert float(getattr(tt, f)) == float(getattr(tj, f)), f
