"""The rank side of tests/test_torch_mesh.py: one process per rank over
gloo on the CPU, started with ``torch.multiprocessing.spawn``.

:func:`run` joins the process group through a ``FileStore``, runs every
case of its list in order (a case over fewer ranks than the world runs on
a sub-group of the first ranks; the others skip it), and saves each case's
result to ``<out>/rank<r>.pt`` for the test to hold against the one-process
simulation. The cases rebuild their inputs from seeds, as the test does.
This module imports no JAX at the top: only the cases that feed the
reference's draws and Delta import it.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

SIZE = 700  # elements of a reduced gradient
S = 2.0
KEY = 11
# a dict of leaves for the reducer cases: nsd, int8, topk_ef and dense
LEAVES = {"c3_w": (16, 8, 3, 3), "fc0_w": (40, 30), "fc0_b": (300,),
          "fc1_w": (30, 20), "b257": (257,), "c0_b": (8,)}
OVERRIDES = (("fc1", "int8"), ("fc0_b", "topk_ef"))
SSGD_NODE_BATCH, SSGD_STEPS = 4, 2


def node_grads(n: int, seed: int, size: int = SIZE) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((n, size))
            * 0.01).astype(np.float32)


def leaf_grads(n: int, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((n,) + s) * 0.01).astype(np.float32)
            for k, s in sorted(LEAVES.items())}


def fed_noise(key: int):
    """A reduce's ``noise``: a unit draw of each pack, seeded by its id."""
    def noise(*args):
        rng = np.random.default_rng([key, *args[:-1]])
        return torch.from_numpy(
            rng.uniform(-0.5, 0.5, args[-1]).astype(np.float32))
    return noise


def fed_pack_noise(key, step, name, path, shape):
    """``Reducer.pack_noise`` with a seeded unit draw of each pack."""
    from repro_torch.core.policy import name_salt

    rng = np.random.default_rng([key, step, name_salt(name), *path])
    return torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32))


def telemetry(t) -> Dict[str, float]:
    return {f: float(v) if isinstance(v, torch.Tensor) else v
            for f, v in t._asdict().items()}


def ssgd_setup(topology: str, pods: int, n: int):
    """The narrow CNN (LeNet5), its optimizer and data, and the comm policy
    of an SSGD case; the test builds the same for the simulated step."""
    from repro_torch.comm import CommPolicy
    from repro_torch.configs import paper_models
    from repro_torch.data.synthetic import ClassifConfig
    from repro_torch.distributed import SSGDConfig
    from repro_torch.optim.optimizers import OptConfig

    mcfg = paper_models.MODELS["lenet5"]()
    dcfg = SSGDConfig(n_nodes=n, s_schedule="sqrt", s_base=2.0)
    cpol = CommPolicy(default="nsd", s=dcfg.s_for_n(), topology=topology,
                      pods=pods)
    opt = OptConfig(name="sgd", lr=0.05, momentum=0.9, weight_decay=5e-4,
                    grad_clip=None)
    data = ClassifConfig(n_classes=mcfg.n_classes, img_size=mcfg.img_size,
                         channels=mcfg.in_channels, noise=0.5, seed=0)
    return mcfg, dcfg, cpol, opt, data


# ---------------------------------------------------------------------------
# the cases: each returns what its rank saves
# ---------------------------------------------------------------------------

def _reduce_case(mesh, topology: str, n: int, pods: int, fed: bool):
    """The reduce through the reference's builders: the ring's share
    through ``ring_allreduce_mesh`` (full telemetry) and again through
    ``make_ring_allreduce`` (mean, wire bytes, bound); the two-level ones
    through ``make_hier_allreduce`` (deprecated: it warns) and
    ``make_butterfly_allreduce``."""
    import warnings

    from repro_torch import comm
    from repro_torch.comm.p2p import TRAFFIC

    g = torch.from_numpy(node_grads(n, 100 * n + pods)[mesh.index])
    noise = fed_noise(KEY) if fed else None
    TRAFFIC.reset()
    out = {}
    if topology == "ring":
        cfg = comm.RingConfig(s=S)
        mean, tele = comm.ring_allreduce_mesh(g, KEY, mesh, cfg, noise=noise)
        packs = list(TRAFFIC.packs)
        out["builder"] = comm.make_ring_allreduce(mesh, "nodes", cfg)(
            g, KEY, noise=noise)
    elif topology == "hier":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn = comm.make_hier_allreduce(mesh, comm.HierConfig(pods=pods, s=S))
        out["warned"] = [str(w.category.__name__) for w in caught]
        mean, tele = fn(g, KEY, noise=noise)
        packs = list(TRAFFIC.packs)
    else:
        fn = comm.make_butterfly_allreduce(mesh,
                                           comm.ButterflyConfig(pods=pods, s=S))
        mean, tele = fn(g, KEY, noise=noise)
        packs = list(TRAFFIC.packs)
    out.update(mean=mean, tele=telemetry(tele), packs=packs)
    return out


def _reducer_case(mesh, topology: str, n: int, pods: int, fed: bool,
                  bucket_bytes: int = 0):
    from repro_torch import comm
    from repro_torch.comm.p2p import TRAFFIC, Exchange

    pol = comm.CommPolicy(s=S, topology=topology, pods=pods,
                          overrides=OVERRIDES)
    grads = {k: torch.from_numpy(v[mesh.index])
             for k, v in leaf_grads(n, 7 * n + pods).items()}
    out = {}
    # count the record gathers: one a reduce (or a bucket), not one a leaf
    gathers, records = [0], Exchange.records

    def counted(self):
        gathers[0] += 1
        return records(self)

    Exchange.records = counted
    try:
        for label, bb in (("blocking", 0), ("bucketed", bucket_bytes)):
            if label == "bucketed" and not bb:
                continue
            red = comm.reducer(pol.replace(bucket_bytes=bb), mesh)
            if fed:
                red.pack_noise = fed_pack_noise
                if bb:
                    red.base.pack_noise = fed_pack_noise
            state = red.init_state(grads)
            TRAFFIC.reset()
            gathers[0] = 0
            means, tele, state = red.reduce(grads, KEY, 3, state)
            out[label] = {"means": means, "tele": telemetry(tele),
                          "state": {k: v.residual for k, v in state.items()},
                          "pack_bytes": TRAFFIC.pack_bytes,
                          "dense_bytes": TRAFFIC.dense_bytes,
                          "gathers": gathers[0]}
    finally:
        Exchange.records = records
    return out


def _ssgd_case(mesh, topology: str, n: int, pods: int):
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.data import ShardedLoader
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.distributed import make_ssgd_step
    from repro_torch.models.cnn import CNN
    from repro_torch.optim.optimizers import init_opt_state

    mcfg, dcfg, cpol, opt, data = ssgd_setup(topology, pods, n)
    net = CNN(mcfg, seed=0, device="cpu")
    step, _ = make_ssgd_step(net, opt, dcfg, DitherPolicy(variant="paper"),
                             cpol, device="cpu", mesh=mesh)
    state = init_opt_state(dict(net.named_parameters()), opt)
    loader = ShardedLoader(
        lambda i: classification_batch(data, i, SSGD_NODE_BATCH * n,
                                       device="cpu"),
        mesh=mesh, device="cpu")
    steps = []
    try:
        for _ in range(SSGD_STEPS):
            _, batch = next(loader)
            metrics, _ = step(state, batch, 0)
            steps.append({
                "params": {k: p.detach().clone()
                           for k, p in net.named_parameters()},
                "state": {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                          for k, v in _flat_state(state).items()},
                "metrics": {k: float(v) for k, v in metrics.items()}})
    finally:
        loader.close()
    return steps


def _flat_state(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _loader_case(mesh):
    from repro_torch.data import ShardedLoader

    def batch(i):
        rows = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) + 100 * i
        return {"x": rows, "y": torch.arange(8) + 100 * i}

    loader = ShardedLoader(batch, mesh=mesh, device="cpu", start_step=1)
    try:
        return [next(loader) for _ in range(2)]
    finally:
        loader.close()


def _errors_case(mesh):
    """Each misuse raises ValueError (``stacked=False``:
    NotImplementedError); returns the messages."""
    from repro_torch import comm
    from repro_torch.data import ShardedLoader
    from repro_torch.launch.mesh import NodeTopology

    def msg(fn, kind=ValueError):
        try:
            fn()
        except kind as e:
            return str(e)
        return None

    hier = comm.CommPolicy(topology="hier", pods=2)
    flat, square = mesh, NodeTopology(pods=2, nodes_per_pod=2).mesh()
    g = torch.zeros(SIZE)
    return {
        "world_size": msg(lambda: NodeTopology(pods=1, nodes_per_pod=3).mesh()),
        "n_nodes": msg(lambda: comm.reducer(hier, mesh, n_nodes=2)),
        "stacked": msg(lambda: comm.reducer(comm.CommPolicy(), mesh,
                                            stacked=True)),
        "stacked_false": msg(lambda: comm.reducer(comm.CommPolicy(), mesh,
                                                  stacked=False),
                             NotImplementedError),
        "loader_axes": msg(lambda: ShardedLoader(lambda i: {}, mesh=mesh,
                                                 batch_axes=("data",),
                                                 device="cpu")),
        "loader_axes_ok": msg(lambda: ShardedLoader(
            lambda i: {"x": torch.zeros(4, 1)}, mesh=mesh, batch_axes=("nodes",),
            device="cpu").close()),
        "pods": msg(lambda: comm.reducer(hier.replace(pods=4), square)),
        "pod_axis": msg(lambda: comm.reducer(hier, flat)),
        "pod_axis_fn": msg(lambda: comm.hierarchy.hier_allreduce_mesh(
            g, KEY, flat, comm.HierConfig(pods=1))),
        "ring_axis": msg(lambda: comm.make_ring_allreduce(flat, "pods")),
    }


def _ref_fed_case(mesh, topology: str, n: int, pods: int, ref_file: str):
    """The process reduce fed the reference's draws and its Delta
    (``jnp.std``), on the reference's gradients."""
    import jax
    import jax.numpy as jnp

    from repro import comm as jcomm
    from repro.core import nsd as jnsd
    from repro_torch import comm
    from repro_torch.core import nsd

    ref = np.load(ref_file)
    jkey = jax.random.PRNGKey(int(ref[f"{topology}_seed"]))

    def delta(x, s):
        return torch.from_numpy(np.array(jnsd.compute_delta(
            jnp.asarray(x.detach().numpy()), s)))

    def noise(*args):
        k = jcomm.reduce_base.hop_key(jkey, *args[:-1])
        return torch.from_numpy(np.array(jax.random.uniform(
            k, tuple(args[-1]), jnp.float32, -0.5, 0.5)))

    nsd.compute_delta = delta
    g = torch.from_numpy(ref[f"{topology}_grads"][mesh.index])
    if topology == "ring":
        mean, tele = comm.ring.ring_allreduce_mesh(
            g, 0, mesh, comm.RingConfig(s=S), noise=noise)
    elif topology == "hier":
        mean, tele = comm.hierarchy.hier_allreduce_mesh(
            g, 0, mesh, comm.HierConfig(pods=pods, s=S), noise=noise)
    else:
        mean, tele = comm.butterfly.butterfly_allreduce_mesh(
            g, 0, mesh, comm.ButterflyConfig(pods=pods, s=S), noise=noise)
    return {"mean": mean, "tele": telemetry(tele)}


CASES = {"reduce": _reduce_case, "reducer": _reducer_case,
         "ssgd": _ssgd_case, "loader": _loader_case, "errors": _errors_case,
         "ref_fed": _ref_fed_case}


def case_id(name: str, kw: dict) -> Tuple:
    """A case's key in the saved results (its arguments but for paths)."""
    return (name,) + tuple(sorted((k, v) for k, v in kw.items()
                                  if k != "ref_file"))


def run(rank: int, world: int, store_path: str, cases: List[Tuple[str, dict]],
        out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import NodeTopology

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    results = {}
    try:
        for name, kw in cases:
            n, pods = kw.get("n", world), kw.get("pods", 1)
            # every rank takes part in making a case's group, in case order
            group = None if n == world else dist.new_group(list(range(n)))
            if rank >= n:
                continue
            mesh = NodeTopology(pods=pods, nodes_per_pod=n // pods).mesh(group)
            args = {k: v for k, v in kw.items() if k not in ("n", "pods")}
            if name in ("reduce", "reducer", "ssgd", "ref_fed"):
                args.update(n=n, pods=pods)
            results[case_id(name, kw)] = CASES[name](mesh, **args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
