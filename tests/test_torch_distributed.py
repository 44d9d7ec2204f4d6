"""Port parity: data-parallel SSGD (``repro_torch.distributed``) and the
figs. 5/6 sweep (``repro_torch.train.distributed_nodes``) against
``repro.distributed`` and ``benchmarks/distributed_nodes.py``.

One SSGD step of MLP-(32, 32) at N = 1, 2, 4 with the comm off, ``ps``
``nsd`` and ``ring``: both sides start from the reference's parameters and
the same synthetic batch; every node of the port is handed the reference's
per-worker dither draws (``SSGDStep.node_ctx`` returns a context whose
``unit_noise`` is the reference's), the reducer the reference's pack draws
(``Reducer.pack_noise``), and Delta is the reference's function
(``jnp.std``) on the port's tensors, as in tests/test_torch_comm.py.

Bands. The loss is a forward pass: rel 1e-6. The node gradients differ by
rounding (another summation order), so a k at a rounding boundary may
flip on a node (a Delta-sized term in one dW entry, tests/test_torch_models.py);
the parameters after one step are held to rel 1e-5 in the L2 norm, which
such a flip stays far inside (one entry of lr * dW against the whole
parameter). The comm telemetry is held exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import CommPolicy as JComm  # noqa: E402
from repro.configs import paper_models as jpm  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy  # noqa: E402
from repro.core import nsd as jnsd  # noqa: E402
from repro.core.policy import name_salt as j_name_salt  # noqa: E402
from repro.data.synthetic import ClassifConfig as JData  # noqa: E402
from repro.data.synthetic import classification_batch as j_batch  # noqa: E402
from repro.distributed import SSGDConfig as JSSGD  # noqa: E402
from repro.distributed import make_ssgd_step as j_make_ssgd_step  # noqa: E402
from repro.distributed import shard_batch as j_shard_batch  # noqa: E402
from repro.optim import OptConfig as JOpt, init_opt_state as j_init_opt  # noqa: E402
from repro_torch.bench import BenchResult, SuiteRun  # noqa: E402
from repro_torch.comm import CommPolicy, init_comm_state  # noqa: E402
from repro_torch.comm.reducer import _StackedPSReducer  # noqa: E402
from repro_torch.configs import paper_models as pm  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import nsd  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.data.synthetic import ClassifConfig, classification_batch  # noqa: E402
from repro_torch.distributed import (SSGDConfig, make_ssgd_step,  # noqa: E402
                                     shard_batch)
from repro_torch.models.cnn import CNN  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train import distributed_nodes  # noqa: E402

HIDDEN, B, SEED, LR = (32, 32), 16, 0, 0.05
# the paper's recipe, as the reference's distributed bench runs it
SGD = OptConfig(name="sgd", lr=LR, momentum=0.9, weight_decay=5e-4,
                grad_clip=None)
BASELINE = "benchmarks/baselines/BENCH_distributed_nodes.json"


class FedCtx(DitherCtx):
    """A node's context that hands the port the reference's draw of each
    layer (the reference's ``DitherCtx.for_step(key, step, policy,
    worker=w).key_for(name)``)."""

    def __init__(self, policy, jctx):
        super().__init__(policy, device="cpu")
        self.jctx = jctx

    def unit_noise(self, name, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.jctx.key_for(name), tuple(shape), jnp.float32, -0.5, 0.5)))


def _fed_pack_noise(jkey):
    """``Reducer.pack_noise`` with the reference's draw of each pack."""
    def noise(key, step, name, path, shape):
        k = jax.random.fold_in(jax.random.fold_in(jkey, step),
                               j_name_salt(name))
        for i in path:
            k = jax.random.fold_in(k, i)
        return torch.from_numpy(np.array(jax.random.uniform(
            k, tuple(shape), jnp.float32, -0.5, 0.5)))
    return noise


@pytest.fixture
def ref_delta(monkeypatch):
    def delta(x, s):
        return torch.from_numpy(np.array(jnsd.compute_delta(
            jnp.asarray(x.detach().numpy()), s)))
    monkeypatch.setattr(nsd, "compute_delta", delta)


_PARAMS = {}


def _ref_params():
    if not _PARAMS:
        params, _ = jpm.mlp_mnist(hidden=HIDDEN).init(jax.random.PRNGKey(SEED))
        _PARAMS.update({k: np.asarray(v) for k, v in params.items()})
    return dict(_PARAMS)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _step_pair(n, topology=None, grad_accum=1, steps=1):
    """``steps`` SSGD steps on each side: (reference params, metrics),
    (port net, metrics, step)."""
    dcfg = dict(n_nodes=n, s_schedule="sqrt", s_base=2.0)
    s_comm = JSSGD(**dcfg).s_for_n()
    jkey = jax.random.PRNGKey(SEED)
    data = dict(n_classes=10, img_size=28, channels=1, noise=0.5, seed=SEED)
    params = {k: jnp.asarray(v) for k, v in _ref_params().items()}
    jstep, jpol = j_make_ssgd_step(
        jpm.mlp_mnist(hidden=HIDDEN),
        JOpt(name="sgd", lr=LR, momentum=0.9, weight_decay=5e-4,
             grad_clip=None),
        JSSGD(**dcfg), JPolicy(variant="paper"),
        comm_policy=(JComm(default="nsd", s=s_comm, topology=topology)
                     if topology else None),
        grad_accum=grad_accum)
    jstate = j_init_opt(params, JOpt(name="sgd", lr=LR, momentum=0.9,
                                     weight_decay=5e-4, grad_clip=None))
    net = CNN(pm.mlp_mnist(hidden=HIDDEN), device="cpu")
    net.load_state_dict(params_from_jax(_ref_params()))
    opt_cfg = OptConfig(name="sgd", lr=LR, momentum=0.9, weight_decay=5e-4,
                        grad_clip=None)
    step, pol = make_ssgd_step(
        net, opt_cfg,
        SSGDConfig(**dcfg), DitherPolicy(variant="paper"),
        comm_policy=(CommPolicy(default="nsd", s=s_comm, topology=topology)
                     if topology else None),
        grad_accum=grad_accum, device="cpu")
    assert pol.s == jpol.s == s_comm

    def node_ctx(seed, st, worker, micro):
        k = jkey if grad_accum == 1 else jax.random.fold_in(jkey, micro)
        return FedCtx(pol, JCtx.for_step(k, st, jpol, worker=worker))

    step.node_ctx = node_ctx
    if step.reducer is not None:
        step.reducer.pack_noise = _fed_pack_noise(jkey)
    state = init_opt_state(dict(net.named_parameters()), opt_cfg)
    for i in range(steps):
        jb = j_shard_batch(j_batch(JData(**data), i, batch=B), n)
        params, jstate, jm, _ = jstep(params, jstate, jb, jkey)
        tb = shard_batch(classification_batch(ClassifConfig(**data), i, B,
                                              device="cpu"), n)
        tm, _ = step(state, tb, SEED)
    assert state["step"] == int(jstate["step"]) == steps
    return (params, jm), (net, tm, step)


def _hold(pair, comm):
    (params, jm), (net, tm, _) = pair
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    got = dict(net.named_parameters())
    assert set(got) == set(params)
    for name, p in params.items():
        assert _rel(got[name].detach().numpy(), p) <= 1e-5, name
    if comm:
        assert float(tm["comm_wire_bytes"]) == float(jm["comm_wire_bytes"])
        assert float(tm["comm_dense_bytes"]) == float(jm["comm_dense_bytes"])
        assert ("comm_error_bound" in tm) == ("comm_error_bound" in jm)
        if "comm_error_bound" in jm:  # the ring with N > 1
            assert float(tm["comm_error_bound"]) == pytest.approx(
                float(jm["comm_error_bound"]), rel=1e-6)
    else:
        assert "comm_wire_bytes" not in tm


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("topology", [None, "ps", "ring"])
def test_ssgd_step_matches_reference(n, topology, ref_delta):
    _hold(_step_pair(n, topology), topology)


def test_ssgd_grad_accum_matches_reference(ref_delta):
    _hold(_step_pair(2, "ps", grad_accum=2), "ps")


def test_ssgd_two_steps_match_reference(ref_delta):
    """The momentum and the per-step streams carry over a second step."""
    _hold(_step_pair(2, "ring", steps=2), "ring")


@pytest.mark.parametrize("schedule", ["fixed", "linear", "sqrt"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_s_for_n_matches_reference(schedule, n):
    assert SSGDConfig(n, schedule, 1.5).s_for_n() == JSSGD(
        n, schedule, 1.5).s_for_n()


def test_shard_batch_matches_reference():
    data = dict(n_classes=10, img_size=28, channels=1, noise=0.5, seed=3)
    jb = j_shard_batch(j_batch(JData(**data), 2, batch=12), 4)
    tb = shard_batch(classification_batch(ClassifConfig(**data), 2, 12,
                                          device="cpu"), 4)
    assert tuple(tb["images"].shape) == jb["images"].shape == (4, 3, 28, 28, 1)
    np.testing.assert_array_equal(tb["images"].numpy(), np.asarray(jb["images"]))
    np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))
    with pytest.raises(ValueError, match="split"):
        shard_batch({"labels": torch.zeros(10)}, 4)


def test_one_node_ring_runs_as_ps():
    net = CNN(pm.mlp_mnist(hidden=HIDDEN), device="cpu")
    step, _ = make_ssgd_step(net, SGD, SSGDConfig(n_nodes=1),
                             DitherPolicy(variant="paper"),
                             comm_policy=CommPolicy(topology="ring"),
                             device="cpu")
    assert isinstance(step.reducer, _StackedPSReducer)
    assert step.reducer.policy.topology == "ps"
    b = shard_batch(classification_batch(ClassifConfig(), 0, 4, device="cpu"), 1)
    m, _ = step(init_opt_state(dict(net.named_parameters()), SGD), b, 0)
    assert "comm_error_bound" not in m and "comm_wire_bytes" in m


def test_topk_ef_state_threads_through_steps():
    net = CNN(pm.mlp_mnist(hidden=HIDDEN), device="cpu")
    step, _ = make_ssgd_step(net, SGD, SSGDConfig(n_nodes=2),
                             DitherPolicy(variant="paper"),
                             comm_policy=CommPolicy(default="topk_ef"),
                             device="cpu")
    state = init_opt_state(dict(net.named_parameters()), SGD)
    cs = init_comm_state(dict(net.named_parameters()), step.reducer.policy)
    assert set(cs) == {"fc0_w", "fc1_w", "fc2_w"}
    for i in range(2):
        b = shard_batch(classification_batch(ClassifConfig(), i, 4,
                                             device="cpu"), 2)
        _, cs = step(state, b, 0, cs)
    assert all(bool(v.residual.any()) for v in cs.values())


def test_grad_accum_must_be_positive():
    net = CNN(pm.mlp_mnist(hidden=HIDDEN), device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        make_ssgd_step(net, OptConfig(), SSGDConfig(), DitherPolicy(),
                       grad_accum=0, device="cpu")


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    net = CNN(pm.mlp_mnist(hidden=HIDDEN), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ssgd_step(net, OptConfig(), SSGDConfig(), DitherPolicy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_nodes.run(node_counts=(1,), steps=1)


# ---------------------------------------------------------------------------
# the figs. 5/6 sweep
# ---------------------------------------------------------------------------

_BASE = {}


def _baseline():
    import json
    from pathlib import Path
    if not _BASE:
        _BASE["run"] = SuiteRun.from_dict(json.loads(
            (Path(__file__).resolve().parents[1] / BASELINE).read_text()))
    return _BASE["run"]


# the reference's TPU-link pricing, which the port does not compute
PRICING = {"comm_speedup", "ici_us", "dcn_us", "total_us"}


def test_bench_rows_carry_the_reference_keys():
    res, rows, topo = distributed_nodes.bench(steps=2, device="cpu")
    base = _baseline().by_name()
    assert [r.name for r in res] == ["fig5-6/N=1", "fig5-6/N=2", "fig5-6/N=4",
                                     "topology/ring/N=8", "topology/hier/N=8",
                                     "topology/butterfly/N=8",
                                     "butterfly/vs-tree/N=8"]
    for r in res:
        assert set(r.derived) == set(base[r.name].derived) - PRICING, r.name
        assert r.gates == base[r.name].gates, r.name
        assert r.context == base[r.name].context, r.name
    assert [row["n_nodes"] for row in rows] == [1, 2, 4]
    for row in rows:
        assert 0 < row["wire_ratio"] < 1 and row["max_bits"] <= 8
    ring, hier, bfly = topo["rows"]
    assert ring["packs_per_segment"] == 8
    assert ring["dense_bytes"] == 2 * 8 * 7 * 2048 * 4
    for row in (ring, hier, bfly):
        assert row["max_err"] <= row["error_bound"]
    for row in (hier, bfly):  # (P - 1) + ceil(log2 G) + 1 at 4 nodes a pod
        assert row["packs_per_segment"] == 3 + 1 + 1
        assert row["wire_ici_bytes"] + row["wire_dcn_bytes"] == \
            row["wire_bytes"]
    vs = topo["butterfly"]
    assert (vs["maxdiff_g1"], vs["packs_diff"], vs["peak_excess"]) == (0, 0, 0)
    assert 0 < vs["peak_ratio"] < 1


def test_check_gates_the_ported_rows_and_names_the_rest():
    baseline = _baseline()
    names = [n for n, _ in distributed_nodes.not_ported(baseline)]
    assert names == ["overlap/hier-bucketed/N=4"]
    assert all("ROADMAP.md" in item and "item 9" in item
               for _, item in distributed_nodes.not_ported(baseline))
    ported = [r for r in baseline.results if r.name not in names]

    def current(scale=None):
        out = []
        for r in ported:
            derived = {k: v for k, v in r.derived.items() if k not in PRICING}
            if scale and scale[0] in derived:
                derived[scale[0]] *= scale[1]
            out.append(BenchResult(name=r.name, value=r.value, unit=r.unit,
                                   derived=derived, gates=r.gates))
        return out

    report = distributed_nodes.check(current(), baseline)
    assert report.ok
    gated = {(f.bench, f.metric) for f in report.findings if f.status == "ok"}
    assert ("fig5-6/N=4", "wire_ratio") in gated
    assert ("topology/ring/N=8", "packs_per_segment") in gated
    for name in ("topology/hier/N=8", "topology/butterfly/N=8"):
        for metric in ("error_bound", "packs_per_segment", "wire_kb"):
            assert (name, metric) in gated
    for metric in ("maxdiff_g1", "packs_diff", "peak_excess", "error_bound"):
        assert ("butterfly/vs-tree/N=8", metric) in gated
    assert len(gated) == 3 * 4 + 3 * 3 + 4
    assert not distributed_nodes.check(current(("wire_ratio", 1.2)),
                                       baseline).ok
    assert not distributed_nodes.check(current()[:-1], baseline).ok  # missing
