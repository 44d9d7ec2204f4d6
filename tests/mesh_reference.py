"""The reference's shard_map reduces on 8 host devices, for
tests/test_torch_mesh.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/mesh_reference.py OUT.npz

Runs ``repro.comm.make_ring_allreduce`` (N = 4), ``_make_hier_allreduce``
(N = 8 in 2 pods) and ``make_butterfly_allreduce`` (N = 8 in 4 pods) on
numpy-seeded gradients and, beside them, the reference's simulations of the
same reduces (eager, as the port's tests run them). Saves the gradients,
the key seeds, both means (read with ``np.asarray``) and the mesh's wire
bytes.
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.comm import butterfly as jbfly
from repro.comm import hierarchy as jhier
from repro.comm import ring as jring

S = 2.0
SHAPE = (37, 13)
# (topology, nodes, pods, key seed, gradient seed)
RUNS = (("ring", 4, 1, 41, 1), ("hier", 8, 2, 42, 2), ("butterfly", 8, 4, 43, 3))


def grads(n: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((n,) + SHAPE)
            * 0.01).astype(np.float32)


def main(out: str) -> None:
    devs = np.array(jax.devices())
    if devs.size < 8:
        raise SystemExit("needs 8 host devices: XLA_FLAGS="
                         "--xla_force_host_platform_device_count=8")
    res = {}
    for topo, n, pods, kseed, gseed in RUNS:
        g = grads(n, gseed)
        key = jax.random.PRNGKey(kseed)
        if topo == "ring":
            mesh = Mesh(devs[:n], ("nodes",))
            cfg = jring.RingConfig(s=S)
            means, wires, _ = jring.make_ring_allreduce(mesh, "nodes", cfg)(
                jnp.asarray(g), key)
            sim, tele = jring.ring_allreduce_nsd(jnp.asarray(g), key, cfg)
            wire = np.asarray(wires).sum()
        else:
            mesh = Mesh(devs[:n].reshape(pods, n // pods), ("pods", "nodes"))
            if topo == "hier":
                cfg = jhier.HierConfig(pods=pods, s=S)
                outs = jhier._make_hier_allreduce(mesh, cfg)(jnp.asarray(g), key)
                sim, tele = jhier.hier_allreduce_nsd(jnp.asarray(g), key, cfg)
            else:
                cfg = jbfly.ButterflyConfig(pods=pods, s=S)
                outs = jbfly.make_butterfly_allreduce(mesh, cfg)(
                    jnp.asarray(g), key)
                sim, tele = jbfly.butterfly_allreduce_nsd(jnp.asarray(g), key,
                                                          cfg)
            means = outs[0]
            wire = np.asarray(outs[1]).sum() + np.asarray(outs[2]).sum()
        res[f"{topo}_grads"] = g
        res[f"{topo}_seed"] = np.int64(kseed)
        res[f"{topo}_mesh"] = np.asarray(means)
        res[f"{topo}_sim"] = np.asarray(sim)
        res[f"{topo}_mesh_wire"] = np.float64(wire)
        res[f"{topo}_sim_wire"] = np.float64(float(tele.wire_bytes))
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1])
