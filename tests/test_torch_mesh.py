"""Port parity: the compressed reduces over real processes
(``repro_torch.comm`` with a ``repro_torch.launch.mesh.NodeMesh``), the
SSGD step and the loader over a mesh, and the launcher's
``--distributed``.

The gloo ranks (tests/mesh_ranks.py) are spawned once per world size (4,
6, 8) on the CPU, each spawn running every case of its size; a case over
fewer ranks runs on a sub-group. Each rank's mean and telemetry are held to
the port's one-process simulation of the same reduce on the same inputs
(``ring_allreduce_nsd``, ``hier_allreduce_nsd``, ``butterfly_allreduce_nsd``,
``reducer(...)`` without a mesh), bit for bit, on stream keys and on fed
draws; the bytes each rank received to the wire bytes of the packs that
reached it. The reference's own shard_map programs (tests/mesh_reference.py,
in a subprocess on 8 host devices) are held to the reference's simulation,
and the port's process reduce, fed the reference's draws and Delta, to the
reference's mesh means.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.multiprocessing as mp  # noqa: E402

import mesh_ranks as mr  # noqa: E402
from repro_torch import comm  # noqa: E402
from repro_torch.core.policy import name_salt  # noqa: E402
from repro_torch.quant import wire  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

# (topology, nodes, pods): the process reduces held to their simulation
REDUCES = {4: [("ring", 2, 1), ("ring", 3, 1), ("ring", 4, 1)],
           6: [("hier", 6, 3), ("butterfly", 6, 3)],
           8: [("ring", 8, 1), ("hier", 8, 2), ("butterfly", 8, 4)]}
SSGD = [("ps", 1), ("ring", 1), ("hier", 2)]
BUCKET = 2048
REF_RUNS = {"ring": (4, 1), "hier": (8, 2), "butterfly": (8, 4)}


def _reduce_kw(topology, n, pods, fed):
    kw = dict(topology=topology, n=n, fed=fed)
    if pods > 1:
        kw["pods"] = pods
    return kw


def _spawn(world, cases, tmp):
    mp.spawn(mr.run, args=(world, str(tmp / "store"), cases, str(tmp)),
             nprocs=world, join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's mesh programs, started in a subprocess now and read
    when a test needs them."""
    out = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "mesh_reference.py"),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    class Ref:
        def load(self):
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log
            return np.load(out)

    ref = Ref()
    yield ref
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world4(reference, tmp_path_factory):
    cases = [("reduce", _reduce_kw(*c, fed)) for c in REDUCES[4]
             for fed in (False, True)]
    cases += [("reducer", dict(topology="ps", n=4, fed=fed))
              for fed in (False, True)]
    cases += [("reducer", dict(topology="hier", n=4, pods=2, fed=True,
                               bucket_bytes=BUCKET))]
    cases += [("ssgd", dict(topology=t, n=4, pods=p)) for t, p in SSGD]
    cases += [("loader", {}), ("errors", {})]
    return _spawn(4, cases, tmp_path_factory.mktemp("w4"))


@pytest.fixture(scope="module")
def world6(tmp_path_factory):
    cases = [("reduce", _reduce_kw(*c, fed)) for c in REDUCES[6]
             for fed in (False, True)]
    return _spawn(6, cases, tmp_path_factory.mktemp("w6"))


@pytest.fixture(scope="module")
def world8(reference, tmp_path_factory):
    ref_file = tmp_path_factory.mktemp("reff") / "ref.npz"
    np.savez(ref_file, **reference.load())
    cases = [("reduce", _reduce_kw(*c, fed)) for c in REDUCES[8]
             for fed in (False, True)]
    cases += [("ref_fed", dict(topology=t, n=n, pods=p, ref_file=str(ref_file)))
              for t, (n, p) in REF_RUNS.items()]
    return _spawn(8, cases, tmp_path_factory.mktemp("w8"))


@pytest.fixture
def one_thread():
    """The simulation on one thread, as the ranks run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _worlds(request, n):
    return request.getfixturevalue(f"world{4 if n <= 4 else n}")


def _simulate(topology, n, pods, fed, monkeypatch):
    """The one-process reduce of the same gradients, with each pack's wire
    bytes by id."""
    g = torch.from_numpy(mr.node_grads(n, 100 * n + pods))
    noise = mr.fed_noise(mr.KEY) if fed else None
    by_pid, last = {}, []
    inner = noise or (lambda *a: comm.hop_key(mr.KEY, *a[:-1]))

    def recording_noise(*args):
        last[:] = [args[:-1]]
        return inner(*args)

    real_pack = wire.pack_nsd

    def recording_pack(*a, **kw):
        p = real_pack(*a, **kw)
        by_pid[last[0]] = int(p.wire_bytes())
        return p

    monkeypatch.setattr(wire, "pack_nsd", recording_pack)
    if topology == "ring":
        mean, tele = comm.ring_allreduce_nsd(g, mr.KEY, comm.RingConfig(s=mr.S),
                                             noise=recording_noise)
    elif topology == "hier":
        mean, tele = comm.hier_allreduce_nsd(
            g, mr.KEY, comm.HierConfig(pods=pods, s=mr.S), noise=recording_noise)
    else:
        mean, tele = comm.butterfly_allreduce_nsd(
            g, mr.KEY, comm.ButterflyConfig(pods=pods, s=mr.S),
            noise=recording_noise)
    monkeypatch.undo()
    return mean, mr.telemetry(tele), by_pid


@pytest.mark.parametrize("fed", [False, True], ids=["keys", "fed"])
@pytest.mark.parametrize("topology,n,pods",
                         [c for w in (4, 6, 8) for c in REDUCES[w]],
                         ids=lambda v: str(v))
def test_process_reduce_equals_simulation(topology, n, pods, fed, request,
                                          monkeypatch):
    """Every rank's mean and every telemetry field bit for bit; each rank
    received exactly the wire bytes of the packs addressed to it, and all
    ranks together the telemetry's wire bytes."""
    ranks = _worlds(request, n)
    mean, tele, by_pid = _simulate(topology, n, pods, fed, monkeypatch)
    cid = mr.case_id("reduce", _reduce_kw(topology, n, pods, fed))
    total = 0
    for r in range(n):
        got = ranks[r][cid]
        assert torch.equal(got["mean"], mean), f"rank {r}"
        assert got["tele"] == tele, f"rank {r}"
        received = sum(b for _, b in got["packs"])
        assert received == sum(by_pid[pid] for pid, _ in got["packs"])
        assert all(b == by_pid[pid] for pid, b in got["packs"])
        total += received
        if topology == "ring":  # make_ring_allreduce: (mean, wire, bound)
            b_mean, b_wire, b_bound = got["builder"]
            assert torch.equal(b_mean, mean)
            assert (float(b_wire), float(b_bound)) == (tele["wire_bytes"],
                                                       tele["error_bound"])
        if topology == "hier":
            assert got["warned"] == ["DeprecationWarning"]
    assert total == tele["wire_bytes"]


@pytest.mark.parametrize("fed", [False, True], ids=["keys", "fed"])
def test_ps_over_a_mesh_equals_simulation(fed, world4):
    """``ps`` over 4 ranks: nsd, int8, topk_ef and dense leaves; every
    rank's means, telemetry and EF residuals equal the stacked reducer's,
    and each rank received the other ranks' packs of the nsd leaves."""
    n, pol = 4, comm.CommPolicy(s=mr.S, topology="ps", overrides=mr.OVERRIDES)
    grads = {k: torch.from_numpy(v) for k, v in mr.leaf_grads(n, 7 * n + 1).items()}
    red = comm.reducer(pol, n_nodes=n)
    noise = mr.fed_pack_noise if fed else red.pack_noise
    red.pack_noise = noise
    means, tele, state = red.reduce(grads, mr.KEY, 3, red.init_state(grads))
    pack_bytes = [sum(int(wire.pack_nsd(g[w], noise(mr.KEY, 3, k, (w,), g.shape[1:]),
                                        mr.S).wire_bytes())
                      for k, g in grads.items()
                      if pol.mode_for(k, g[0].numel()) == "nsd")
                  for w in range(n)]
    for r in range(n):
        got = world4[r][mr.case_id("reducer", dict(topology="ps", n=n, fed=fed))]
        got = got["blocking"]
        for k in grads:
            assert torch.equal(got["means"][k], means[k]), (r, k)
        assert got["tele"] == mr.telemetry(tele)
        assert set(got["state"]) == set(state) == {"fc0_b"}
        assert torch.equal(got["state"]["fc0_b"], state["fc0_b"].residual)
        assert got["pack_bytes"] == sum(pack_bytes) - pack_bytes[r]
        assert got["gathers"] == 0  # ps reads each pack's bytes itself


def test_overlap_over_a_mesh_equals_blocking(world4):
    """Buckets of ~2 KiB over a (2, 2) mesh under ``hier``: the means the
    blocking mesh reduce's (and the simulation's) bit for bit, the bucketed
    telemetry the simulated bucketed reducer's."""
    n, pods = 4, 2
    pol = comm.CommPolicy(s=mr.S, topology="hier", pods=pods,
                          overrides=mr.OVERRIDES)
    grads = {k: torch.from_numpy(v)
             for k, v in mr.leaf_grads(n, 7 * n + pods).items()}
    sim = comm.reducer(pol.replace(bucket_bytes=BUCKET), n_nodes=n)
    sim.base.pack_noise = mr.fed_pack_noise
    means, tele, _ = sim.reduce(grads, mr.KEY, 3, sim.init_state(grads))
    assert tele.n_buckets > 2
    # one gather of the hops' records a reduce, or a bucket with a
    # compressed leaf, however many leaves it holds
    compressed = [any(pol.mode_for(k, grads[k][0].numel()) != "dense"
                      for k in names) for names in sim.plan_for(grads).buckets]
    assert sum(compressed) > 1
    cid = mr.case_id("reducer", dict(topology="hier", n=n, pods=pods, fed=True,
                                     bucket_bytes=BUCKET))
    for r in range(n):
        got = world4[r][cid]
        assert got["blocking"]["gathers"] == 1
        assert got["bucketed"]["gathers"] == sum(compressed)
        for k in grads:
            assert torch.equal(got["bucketed"]["means"][k], got["blocking"]["means"][k])
            assert torch.equal(got["bucketed"]["means"][k], means[k])
        assert got["bucketed"]["tele"] == mr.telemetry(tele)


@pytest.mark.parametrize("topology,pods", SSGD, ids=[t for t, _ in SSGD])
def test_ssgd_over_a_mesh_equals_simulated_step(topology, pods, world4,
                                                one_thread):
    """LeNet5, 4 ranks, 2 steps, the paper variant: after each step every
    rank's parameters, optimizer state and metrics equal the simulated
    step's bit for bit (batches through ``ShardedLoader(mesh=)``)."""
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.distributed import make_ssgd_step, shard_batch
    from repro_torch.models.cnn import CNN
    from repro_torch.optim.optimizers import init_opt_state

    n = 4
    mcfg, dcfg, cpol, opt, data = mr.ssgd_setup(topology, pods, n)
    net = CNN(mcfg, seed=0, device="cpu")
    step, _ = make_ssgd_step(net, opt, dcfg, DitherPolicy(variant="paper"),
                             cpol, device="cpu")
    state = init_opt_state(dict(net.named_parameters()), opt)
    for i in range(mr.SSGD_STEPS):
        b = shard_batch(classification_batch(data, i, mr.SSGD_NODE_BATCH * n,
                                             device="cpu"), n)
        metrics, _ = step(state, b, 0)
        flat = mr._flat_state(state)
        for r in range(n):
            got = world4[r][mr.case_id("ssgd", dict(topology=topology, n=n,
                                                    pods=pods))][i]
            for k, p in net.named_parameters():
                assert torch.equal(got["params"][k], p), (i, r, k)
            assert set(got["state"]) == set(flat)
            for k, v in got["state"].items():
                assert (torch.equal(v, flat[k]) if isinstance(v, torch.Tensor)
                        else v == flat[k]), (i, r, k)
            assert got["metrics"] == {k: float(v) for k, v in metrics.items()}


def test_sharded_loader_gives_each_rank_its_rows(world4):
    for r in range(4):
        got = world4[r][("loader",)]
        assert [s for s, _ in got] == [1, 2]
        for step, batch in got:
            rows = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
            assert torch.equal(batch["x"], rows[2 * r:2 * r + 2] + 100 * step)
            assert torch.equal(batch["y"], torch.arange(2 * r, 2 * r + 2)
                               + 100 * step)


def test_mesh_mismatches_raise(world4):
    msgs = world4[0][("errors",)]
    assert "4 ranks but the topology has 1 pods x 3 nodes" in msgs["world_size"]
    assert "n_nodes (2) != the mesh's extent (4)" in msgs["n_nodes"]
    assert "stacked=True" in msgs["stacked"]
    assert msgs["stacked_false"] == "_FlatPSReducer"
    assert "batch_axes ('data',) with mesh axes ('nodes',)" in msgs["loader_axes"]
    assert msgs["loader_axes_ok"] is None
    assert "pods (4) != mesh 'pods' axis size (2)" in msgs["pods"]
    for k in ("pod_axis", "pod_axis_fn"):
        assert "missing ['pods']" in msgs[k]
    assert "have no 'pods' axis" in msgs["ring_axis"]


@pytest.mark.parametrize("topology", list(REF_RUNS))
def test_reference_mesh_equals_its_simulation(topology, reference):
    ref = reference.load()
    for m in ref[f"{topology}_mesh"]:
        np.testing.assert_array_equal(m, ref[f"{topology}_sim"])
    assert ref[f"{topology}_mesh_wire"] == ref[f"{topology}_sim_wire"]


@pytest.mark.parametrize("topology", list(REF_RUNS))
def test_process_reduce_equals_reference_mesh(topology, reference, world8):
    """Fed the reference's draws and its Delta, every rank's mean is the
    reference's shard_map mean bit for bit, and its wire bytes the
    reference's."""
    ref = reference.load()
    n, pods = REF_RUNS[topology]
    cid = mr.case_id("ref_fed", dict(topology=topology, n=n, pods=pods))
    for r in range(n):
        got = world8[r][cid]
        np.testing.assert_array_equal(got["mean"].numpy(),
                                      ref[f"{topology}_mesh"][r])
        assert got["tele"]["wire_bytes"] == ref[f"{topology}_mesh_wire"]


@pytest.mark.parametrize("topology", ["ps", "ring", "hier", "butterfly"])
def test_reducer_flat_selection_builds_the_flat_reducer(topology):
    """``stacked=False`` builds the reference's flat single-participant
    reducer whatever the topology: unstacked leaves through
    ``compress_tree``, one pack a leaf, the leaf's first axis never read
    as nodes; with ``bucket_bytes`` the overlap scheduler around it, bit
    for bit."""
    pol = comm.CommPolicy(topology=topology, s=2.0, pods=2 if topology in
                          ("hier", "butterfly") else 1)
    g = {"w": torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 96)).astype(np.float32)), "b": torch.ones(8)}
    for red in (comm.reducer(pol, stacked=False),
                comm.reducer(pol, n_nodes=1, stacked=False)):
        assert type(red).__name__ == "_FlatPSReducer"
        assert set(red.init_state(g)) == set()
        got, tele, _ = red.reduce(g, mr.KEY, 2)
        want, _, wt = comm.compress_tree(
            g, lambda n, shape: comm.hop_key(mr.KEY, 2, name_salt(n)), pol)
        for n in g:
            assert torch.equal(got[n], want[n]) and got[n].shape == g[n].shape
        assert float(tele.wire_bytes) == float(wt["wire_bytes"])
        assert (tele.n_hops, tele.packs_per_segment) == (1, 1)
    bucketed = comm.reducer(pol.replace(bucket_bytes=512), stacked=False)
    assert type(bucketed.base).__name__ == "_FlatPSReducer"
    got_b, tele_b, _ = bucketed.reduce(g, mr.KEY, 2)
    assert all(torch.equal(got_b[n], got[n]) for n in g)
    assert float(tele_b.wire_bytes) == float(tele.wire_bytes)
    assert tele_b.n_buckets == 2


def test_loader_batch_axes_need_the_mesh_axes():
    """``batch_axes`` without a mesh raises; it is never ignored."""
    from repro_torch.data import ShardedLoader

    with pytest.raises(ValueError, match="with no mesh"):
        ShardedLoader(lambda i: {}, batch_axes=("data",), device="cpu")


def test_node_topology_matches_reference():
    """The descriptor and its link classes, field for field."""
    from repro.launch.mesh import NodeTopology as JTopo
    from repro_torch.launch.mesh import NodeTopology

    for kw in ({}, {"pods": 2, "nodes_per_pod": 4},
               {"pods": 3, "nodes_per_pod": 2, "pod_axis": "pod"}):
        t, j = NodeTopology(**kw), JTopo(**kw)
        assert (t.pods, t.nodes_per_pod, t.n_nodes) == (j.pods, j.nodes_per_pod,
                                                       j.n_nodes)
        for axis in ("pods", "pod", "nodes", "data", "model"):
            assert t.link_kind(axis) == j.link_kind(axis), (kw, axis)
    assert NodeTopology.flat(6) == NodeTopology(pods=1, nodes_per_pod=6)
    with pytest.raises(ValueError, match="degenerate"):
        NodeTopology(pods=0)


def test_launcher_distributed_at_world_size_1(monkeypatch):
    """``--distributed --device cpu`` joins a one-rank gloo group from
    torchrun's variables and trains as the run without the flag."""
    import socket

    from repro_torch.launch import train

    argv = ["--arch", "gemma-2b", "--preset", "smoke", "--steps", "2",
            "--batch", "1", "--seq", "8", "--device", "cpu"]
    plain = train.main(argv)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    dist = train.main(argv + ["--distributed"])
    assert not torch.distributed.is_initialized()
    assert [h["loss"] for h in dist.history] == [h["loss"] for h in plain.history]
    for (k, a), (_, b) in zip(dist.net.named_parameters(),
                              plain.net.named_parameters()):
        assert torch.equal(a, b), k
