"""Port parity: elastic SSGD (``repro_torch.train.ElasticSSGD``) and the
prefetching loader (``repro_torch.data.ShardedLoader``).

Held: nodes leave and join (4 -> 2 -> 6) with the parameters, moments,
error-feedback residuals and controller state coming through each resize
bit for bit, and training goes on at the new size; a hier policy's pods
snap with the node count (2 -> 2 -> 1) as the reference's do; a resize to
the same size writes no checkpoint; the reference's ElasticSSGD checkpoint
restores into the port's (the same names), and the port's next step on it
runs; the loader hands out (step, batch) in step order from ``start_step``,
raises its function's error, and stops its thread on ``close``.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import comm, train  # noqa: E402
from repro_torch.configs import paper_models as pm  # noqa: E402
from repro_torch.core.policy import DitherPolicy  # noqa: E402
from repro_torch.data import (ClassifConfig, ShardedLoader,  # noqa: E402
                              classification_batch)
from repro_torch.models.cnn import CNN  # noqa: E402
from repro_torch.optim.optimizers import OptConfig  # noqa: E402
from repro_torch.utils.pytree import flatten_with_names  # noqa: E402

MLP = pm.mlp_mnist(hidden=(64, 32))
DATA = ClassifConfig(n_classes=10, img_size=28, channels=1, noise=0.5, seed=0)
BATCH = 12  # divisible by every node count the tests visit (2, 3, 4, 6)
OPT = OptConfig(name="sgd", lr=1e-2, grad_clip=None)


def _batch(step):
    return classification_batch(DATA, step, BATCH, device="cpu")


def _driver(tmp_path, n_nodes, comm_policy, variant="paper"):
    return train.ElasticSSGD(
        CNN(MLP, seed=0, device="cpu"), OPT, DitherPolicy(variant=variant),
        comm_policy, ckpt_dir=str(tmp_path), n_nodes=n_nodes, device="cpu")


def _snapshot(el):
    return [(n, x.detach().clone() if isinstance(x, torch.Tensor) else x)
            for n, x in flatten_with_names(el._ckpt_tree())]


def test_join_leave_migrates_ef_and_ctrl_bit_exact(tmp_path):
    """Shrink then grow (4 -> 2 -> 6): parameters, moments, the EF
    residuals and the controller's state ride the checkpoint unchanged
    (residuals are per leaf on the nodes' mean, so the node count does not
    touch them)."""
    pol = comm.CommPolicy(default="topk_ef", topk_frac=0.25, min_leaf_size=1)
    el = _driver(tmp_path, 4, pol)
    el.init()
    for i in range(2):
        el.step(_batch(i), 100 + i)
    assert el.comm_state and all(st.residual.any()
                                 for st in el.comm_state.values())
    el.ctrl_state = {"fc0": np.float32(0.125), "fc1": np.float32(-0.5)}
    ref = _snapshot(el)
    assert any(n.startswith("comm/") and n.endswith("/.residual")
               for n, _ in ref)
    for n in (2, 6):
        el.resize(n)
        assert el.n_nodes == n and el.step_fn.dcfg.n_nodes == n
        got = _snapshot(el)
        assert [name for name, _ in got] == [name for name, _ in ref]
        for (name, x), (_, y) in zip(got, ref):
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y and type(x) is type(y)), f"{name} @ n={n}"
    m = el.step(_batch(7), 999)  # and training goes on at the new size
    assert np.isfinite(float(m["loss"])) and el.opt_state["step"] == 3


def test_resize_snaps_hier_pods(tmp_path):
    """A hier policy's pods follow the node count: 4 nodes in 2 pods
    resized to 6 keeps 2 pods, to 3 falls to 1."""
    pol = comm.CommPolicy(default="nsd", s=1.0, topology="hier", pods=2)
    el = _driver(tmp_path, 4, pol, variant="kernel")
    el.init()
    assert el.active_comm_policy.pods == 2
    m = el.step(_batch(0), 1)
    assert float(m["comm_wire_dcn_bytes"]) > 0
    before = _snapshot(el)
    el.resize(6)
    assert el.active_comm_policy.pods == 2
    el.resize(3)
    assert el.active_comm_policy.pods == 1
    assert el.step_fn.reducer.cfg.pods == 1
    for (name, x), (_, y) in zip(_snapshot(el), before):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    m = el.step(_batch(1), 2)
    assert np.isfinite(float(m["loss"]))
    assert float(m["comm_wire_dcn_bytes"]) == 0  # one pod: no DCN hop


def test_noop_resize_skips_checkpoint(tmp_path):
    el = _driver(tmp_path, 2, comm.CommPolicy(default="nsd", s=1.0))
    el.init()
    before = el.ckpt.latest_step()
    el.resize(2)
    assert el.ckpt.latest_step() == before is None


def test_init_resumes_from_the_latest_checkpoint(tmp_path):
    el = _driver(tmp_path, 2, None)
    el.init()
    el.step(_batch(0), 5)
    assert el.save() == 1
    want = _snapshot(el)
    fresh = _driver(tmp_path, 4, None)
    fresh.init()
    assert fresh.opt_state["step"] == 1
    for (name, x), (_, y) in zip(_snapshot(fresh), want):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def test_reference_elastic_checkpoint_restores_in_the_port(tmp_path):
    """The reference's ElasticSSGD (the same MLP, its own draws) saves its
    tree; the port's ElasticSSGD resumes from it: the same names, the
    reference's parameters, moments, step and EF residuals."""
    from repro.comm import CommPolicy as JCommPolicy
    from repro.configs import paper_models as jpm
    from repro.core import DitherPolicy as JDitherPolicy
    from repro.optim import OptConfig as JOptConfig
    from repro.train import ElasticSSGD as JElasticSSGD

    jpol = JCommPolicy(default="topk_ef", topk_frac=0.25, min_leaf_size=1)
    jel = JElasticSSGD(jpm.mlp_mnist(hidden=(64, 32)),
                       JOptConfig(name="sgd", lr=1e-2, grad_clip=None),
                       JDitherPolicy(variant="paper"), jpol,
                       ckpt_dir=str(tmp_path), n_nodes=2)
    jel.init(jax.random.PRNGKey(0))
    b = _batch(0)
    jel.step({"images": jnp.asarray(b["images"].numpy()),
              "labels": jnp.asarray(b["labels"].numpy())},
             jax.random.PRNGKey(1))
    assert jel.save() == 1
    el = _driver(tmp_path, 2, comm.CommPolicy(
        default="topk_ef", topk_frac=0.25, min_leaf_size=1))
    el.init()
    assert el.opt_state["step"] == 1
    for name, p in el.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(jel.params[name]))
        np.testing.assert_array_equal(el.opt_state["mu"][name].numpy(),
                                      np.asarray(jel.opt_state["mu"][name]))
        np.testing.assert_array_equal(
            el.comm_state[name].residual.numpy(),
            np.asarray(jel.comm_state[name].residual))
    m = el.step(_batch(1), 3)
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# ShardedLoader
# ---------------------------------------------------------------------------

def test_loader_hands_out_steps_in_order():
    seen = []

    def fn(step):
        seen.append(step)
        return {"x": torch.full((2,), float(step))}

    loader = ShardedLoader(fn, prefetch=2, start_step=5, device="cpu")
    got = [next(loader) for _ in range(4)]
    loader.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, b in got:
        assert torch.equal(b["x"], torch.full((2,), float(s)))
    assert not loader._thread.is_alive()
    assert seen[:4] == [5, 6, 7, 8] and len(seen) <= 4 + 2 + 1


def test_loader_equals_the_batch_function():
    loader = ShardedLoader(_batch, device="cpu")
    for want_step, (step, b) in zip(range(3), loader):
        assert step == want_step
        want = _batch(step)
        assert all(torch.equal(b[k], want[k]) for k in want)
    loader.close()


def test_loader_raises_its_function_error():
    def fn(step):
        if step == 2:
            raise ValueError("no batch 2")
        return {"x": torch.zeros(1)}

    loader = ShardedLoader(fn, device="cpu")
    assert next(loader)[0] == 0 and next(loader)[0] == 1
    with pytest.raises(ValueError, match="no batch 2"):
        next(loader)
    loader.close()
    assert not loader._thread.is_alive()


def test_loader_raises_again_after_its_function_error():
    """The worker has stopped: every later ``next`` raises the same error
    at once instead of waiting on an empty queue."""
    def fn(step):
        raise ValueError(f"no batch {step}")

    loader = ShardedLoader(fn, device="cpu")
    for _ in range(3):
        with pytest.raises(ValueError, match="no batch 0"):
            next(loader)
    loader.close()


def test_loader_close_stops_a_blocked_worker():
    started = threading.Event()

    def fn(step):
        started.set()
        return {"x": torch.zeros(1)}

    loader = ShardedLoader(fn, prefetch=1, device="cpu")
    assert started.wait(10)
    loader.close(timeout=10)
    assert not loader._thread.is_alive()


def test_entry_points_need_a_device_or_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedLoader(_batch)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.ElasticSSGD(CNN(MLP, seed=0, device="cpu"), OPT,
                          DitherPolicy(variant="paper"), None,
                          ckpt_dir=str(tmp_path), n_nodes=2)


def test_elastic_restart_drill(tmp_path, capsys):
    """The drill: 4 steps, a slow rack flagged and lost (256 -> 216 chips:
    data axis 16 -> 8), the resume from step 4 with accumulation doubled,
    to step 8."""
    from repro_torch.train import elastic_restart

    rc = elastic_restart.main(["--device", "cpu", "--steps", "4",
                               "--resume-steps", "8", "--ckpt-every", "2",
                               "--batch", "4", "--seq", "16", "--ckpt-dir",
                               str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    import json
    summary = json.loads(out[0])
    assert summary["stragglers"] == list(elastic_restart.RACK)
    assert (summary["alive_chips"], summary["mesh_shape"],
            summary["grad_accum_scale"]) == (216, [8, 16], 2)
    assert summary["restore_step"] == 4 and summary["final_step"] == 8
    assert train.list_steps(str(tmp_path)) == [4, 6, 8]
    assert rc == 0 and out[1].startswith("elastic restart drill: OK")
