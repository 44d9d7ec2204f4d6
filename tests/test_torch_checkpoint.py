"""Port parity: checkpoints (``repro_torch.train.checkpoint``), the
fault-tolerance logic (``repro_torch.train.fault_tolerance``) and the LM
trainer's and launcher's resume, against ``repro.train``.

Held: the reference's ``CheckpointManager`` cases on the port's manager; a
checkpoint written by either package restores in the other with equal
values, and both write the same manifest (names, shapes, dtypes, crc) for
the same tree; bf16 leaves round-trip exactly; the straggler detector, the
elastic plans and ``snap_pods`` answer as the reference's; the trainer
checkpoints at the step boundary after a preemption notice; the sparsity
controller's state rides the checkpoint; a run resumed at step 2 ends at
step 4 with the parameters and moments of four straight steps, bit for bit;
the launcher's ``--ckpt-dir`` writes ``step_00000002`` and, like the
reference's, restarts its batch counter at 0 on a resume.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import train as jtrain  # noqa: E402
from repro.utils.pytree import flatten_with_names as j_flatten  # noqa: E402
from repro_torch import train  # noqa: E402
from repro_torch.configs import get_smoke_model  # noqa: E402
from repro_torch.core.policy import DitherPolicy  # noqa: E402
from repro_torch.core.schedule import (PolicyProgram,  # noqa: E402
                                       SparsityController)
from repro_torch.data import ShardedLoader, TokenStreamConfig  # noqa: E402
from repro_torch.data import token_batch  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.optim.optimizers import OptConfig  # noqa: E402
from repro_torch.utils.pytree import (flatten_with_names, map_leaves,  # noqa: E402
                                      tree_bytes, tree_size)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
        "nested": {"b": torch.arange(6, dtype=torch.int32),
                   "c": torch.ones(3, dtype=torch.bfloat16) * 1.5},
    }


def _zeros_like(tree):
    return map_leaves(lambda _, x: torch.zeros_like(x), tree)


def _equal(a, b):
    for (na, x), (nb, y) in zip(flatten_with_names(a), flatten_with_names(b)):
        assert na == nb
        assert x.dtype == y.dtype, na
        assert torch.equal(x, y), na


# ---------------------------------------------------------------------------
# the reference's CheckpointManager cases
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = train.CheckpointManager(str(tmp_path), async_write=False)
        tree = _tree()
        mgr.save(5, tree)
        _equal(mgr.restore(_zeros_like(tree)), tree)

    def test_rotation_keeps_k(self, tmp_path):
        mgr = train.CheckpointManager(str(tmp_path), keep=2,
                                      async_write=False)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree())
        assert train.list_steps(str(tmp_path)) == [3, 4]

    def test_uncommitted_ignored(self, tmp_path):
        mgr = train.CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(1, _tree())
        mgr.save(2, _tree())
        os.remove(os.path.join(str(tmp_path), "step_00000002", "_COMMITTED"))
        assert mgr.latest_step() == 1

    def test_corruption_detected(self, tmp_path):
        mgr = train.CheckpointManager(str(tmp_path), async_write=False)
        tree = {"a": torch.ones(4)}
        mgr.save(1, tree)
        shard = os.path.join(str(tmp_path), "step_00000001",
                             "shard_00000.npz")
        np.savez(shard, a=np.zeros((4,), np.float32))  # corrupt payload
        with pytest.raises(IOError):
            mgr.restore(tree)

    def test_async_save(self, tmp_path):
        mgr = train.CheckpointManager(str(tmp_path), async_write=True)
        tree = _tree()
        mgr.save(7, tree)
        mgr.wait()
        assert mgr.latest_step() == 7
        _equal(mgr.restore(_zeros_like(tree)), tree)

    def test_shape_mismatch_raises(self, tmp_path):
        mgr = train.CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(1, {"a": torch.ones(4)})
        with pytest.raises(ValueError):
            mgr.restore({"a": torch.ones(5)})

    def test_missing_leaf_and_mesh_are_refused(self, tmp_path):
        mgr = train.CheckpointManager(str(tmp_path), async_write=False)
        with pytest.raises(FileNotFoundError):
            mgr.restore({"a": torch.ones(4)})
        mgr.save(1, {"a": torch.ones(4)})
        with pytest.raises(KeyError):
            mgr.restore({"a": torch.ones(4), "b": torch.ones(2)})
        with pytest.raises(NotImplementedError, match="7.2"):
            mgr.restore({"a": torch.ones(4)}, shardings={"a": None})

    def test_inplace_restore_fills_the_template(self, tmp_path):
        mgr = train.CheckpointManager(str(tmp_path), async_write=False)
        tree = dict(_tree(), step=3, scale=np.float32(0.25))
        mgr.save(2, tree)
        target = dict(_zeros_like(_tree()), step=0, scale=np.float32(0))
        out = mgr.restore(target, inplace=True)
        assert out["a"] is target["a"] and torch.equal(target["a"], tree["a"])
        assert out["step"] == 3 and type(out["step"]) is int
        assert out["scale"] == np.float32(0.25)
        assert isinstance(out["scale"], np.float32)

    def test_a_failed_write_raises_at_the_next_join(self, tmp_path):
        mgr = train.CheckpointManager(str(tmp_path), async_write=True)
        mgr.base = str(tmp_path / "file")
        (tmp_path / "file").write_text("not a directory")
        mgr.save(1, {"a": torch.ones(2)})
        with pytest.raises(RuntimeError, match="write failed"):
            mgr.wait()


def test_bf16_round_trip_is_exact(tmp_path):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 33)).astype(np.float32)).to(torch.bfloat16)
    mgr = train.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"w": x, "h": x.to(torch.float16)})
    manifest = json.loads((tmp_path / "step_00000001" /
                           "manifest.json").read_text())
    assert [leaf["dtype"] for leaf in manifest["leaves"]] == ["float32"] * 2
    out = mgr.restore({"w": torch.zeros_like(x),
                       "h": torch.zeros_like(x, dtype=torch.float16)})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], x)
    assert torch.equal(out["h"], x.to(torch.float16))


# ---------------------------------------------------------------------------
# the two packages read each other's checkpoints
# ---------------------------------------------------------------------------

def _pair(seed=0):
    """One tree in both packages: the same keys and values, an optimizer-
    like subtree with an int32 step and an m8 moment container."""
    from repro_torch.quant import encode as t_encode
    from repro.quant import encode as j_encode
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    mu = rng.standard_normal((16, 8)).astype(np.float32)
    t = {"params": {"fc0_w": torch.from_numpy(w),
                    "fc0_b": torch.from_numpy(b).to(torch.bfloat16)},
         "opt": {"step": torch.tensor(7, dtype=torch.int32),
                 "mu": {"fc0_w": t_encode("m8", torch.from_numpy(mu))}},
         "ctrl": {"L/wq": np.float32(0.125)}}
    j = {"params": {"fc0_w": jnp.asarray(w),
                    "fc0_b": jnp.asarray(b).astype(jnp.bfloat16)},
         "opt": {"step": jnp.int32(7),
                 "mu": {"fc0_w": j_encode("m8", jnp.asarray(mu))}},
         "ctrl": {"L/wq": jnp.float32(0.125)}}
    return t, j


def test_names_match_the_reference_letter_for_letter():
    t, j = _pair()
    assert [n for n, _ in flatten_with_names(t)] == [n for n, _ in j_flatten(j)]
    assert tree_size(t) == sum(int(np.prod(x.shape)) for _, x in j_flatten(j))
    assert tree_bytes({"a": torch.ones(3, 2), "b": torch.ones(4,
                      dtype=torch.bfloat16)}) == 24 + 8


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    t, j = _pair(1)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    train.CheckpointManager(str(tmp_path / "p"), async_write=False).save(3, t)
    jtrain.CheckpointManager(str(tmp_path / "j"), async_write=False).save(3, j)
    mp = json.loads((tmp_path / "p/step_00000003/manifest.json").read_text())
    mj = json.loads((tmp_path / "j/step_00000003/manifest.json").read_text())
    assert mp == mj  # names, shapes, dtypes and crc
    template = jax.tree.map(jnp.zeros_like, j)
    out = jtrain.CheckpointManager(str(tmp_path / "p")).restore(template)
    for (n, x), (_, y) in zip(j_flatten(out), j_flatten(j)):
        assert x.dtype == y.dtype, n
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32), err_msg=n)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    t, j = _pair(2)
    jtrain.CheckpointManager(str(tmp_path), async_write=False).save(9, j)
    template = map_leaves(lambda _, x: torch.zeros_like(x)
                          if isinstance(x, torch.Tensor) else np.float32(0), t)
    out = train.CheckpointManager(str(tmp_path)).restore(template)
    _equal({k: v for k, v in out.items() if k != "ctrl"},
           {k: v for k, v in t.items() if k != "ctrl"})
    assert out["ctrl"]["L/wq"] == np.float32(0.125)
    assert out["opt"]["mu"]["fc0_w"].shape == t["opt"]["mu"]["fc0_w"].shape


# ---------------------------------------------------------------------------
# stragglers, restart plans and snap_pods against the reference's functions
# ---------------------------------------------------------------------------

STRAGGLER_RUNS = [
    [[1.0, 1.0, 1.0, 3.0]] * 6,  # host 3 always slow
    [[1.0, 1.0, 1.0, 5.0]] + [[1.0] * 4] * 5,  # one blip
    [[1.0, 2.0, 1.0, 1.0], [1.0, 2.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0],
     [1.0, 2.0, 1.0, 1.0]] * 2,
    [[1.0, 1.6, 3.0, 1.0, 1.2]] * 4,
]


@pytest.mark.parametrize("times", STRAGGLER_RUNS)
@pytest.mark.parametrize("factor,patience", [(1.5, 3), (1.5, 1), (2.5, 2)])
def test_straggler_detector_matches_reference(times, factor, patience):
    det = train.StragglerDetector(len(times[0]), train.StragglerConfig(
        factor=factor, patience=patience))
    jdet = jtrain.StragglerDetector(len(times[0]), jtrain.StragglerConfig(
        factor=factor, patience=patience))
    for row in times:
        assert det.observe(row) == jdet.observe(row)
    assert det._strikes == jdet._strikes


@pytest.mark.parametrize("alive,mp", [(240, 16), (10, 16), (256, 16),
                                      (128, 8), (7, 1), (1, 1), (31, 4)])
def test_elastic_plans_match_reference(alive, mp):
    assert train.plan_elastic_mesh(alive, mp) == jtrain.plan_elastic_mesh(
        alive, mp)
    for orig, latest in ((16, 42), (4, None)):
        got = train.make_restart_plan(alive, mp, orig, latest)
        want = jtrain.make_restart_plan(alive, mp, orig, latest)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.mesh_shape, got.mesh_axes, got.restore_step,
                    got.grad_accum_scale) == (want.mesh_shape, want.mesh_axes,
                                              want.restore_step,
                                              want.grad_accum_scale)


@pytest.mark.parametrize("pods,n", [(4, 8), (4, 6), (4, 3), (6, 4), (1, 5),
                                    (0, 7), (2, 6), (8, 8)])
def test_snap_pods_matches_reference(pods, n):
    got = train.snap_pods(pods, n)
    assert got == jtrain.snap_pods(pods, n)
    assert n % got == 0 and got <= max(pods, 1)


def test_snap_pods_rejects_an_empty_world():
    with pytest.raises(ValueError):
        train.snap_pods(4, 0)


def test_preemption_guard_and_health_source():
    guard = train.PreemptionGuard(install=False)
    assert not guard.should_stop
    guard.trigger()
    assert guard.should_stop
    health = train.StaticHealthSource(chips=256)
    health.fail(40)
    health.set_step_time(3, 2.5)
    assert health.alive_chips() == 216 and health.step_times() == {3: 2.5}


# ---------------------------------------------------------------------------
# the LM trainer: preemption, the controller's state, a 2 + 2 resume
# ---------------------------------------------------------------------------

MODEL = get_smoke_model("gemma-2b")
TCFG = TokenStreamConfig(vocab=MODEL.cfg.vocab, seq_len=16, batch=2)


def _trainer(tmp_path, total, policy=None, ckpt_every=2):
    return train.Trainer(
        MODEL, OptConfig(lr=1e-3),
        train.TrainerConfig(total_steps=total, log_every=0,
                            ckpt_every=ckpt_every, ckpt_dir=str(tmp_path)),
        policy=policy, device="cpu")


def _loader(start=0):
    return ShardedLoader(lambda s: token_batch(TCFG, s, device="cpu"),
                         start_step=start, device="cpu")


def test_trainer_checkpoints_on_preemption(tmp_path):
    trainer = _trainer(tmp_path, 50, ckpt_every=100)

    def it():
        i = 0
        while True:
            if i == 3:
                trainer.guard.trigger()  # a preemption notice mid-run
            yield token_batch(TCFG, i, device="cpu")
            i += 1

    out = trainer.fit(it())
    # the trigger fires while batch 3 is fetched, so step 3 still completes;
    # the checkpoint lands at the next boundary, step 4
    assert trainer.ckpt.latest_step() == 4
    assert out["opt_state"]["step"] == 4


def _state(trainer):
    return {"params": {k: v.detach().clone() for k, v in
                       trainer.params.items()},
            "opt": map_leaves(lambda _, x: x.clone()
                              if isinstance(x, torch.Tensor) else x,
                              trainer.opt_state)}


def test_resume_two_plus_two_equals_four_straight(tmp_path):
    policy = PolicyProgram(base=DitherPolicy(variant="kernel", s=2.0))
    straight = _trainer(tmp_path / "a", 4, policy, ckpt_every=0)
    loader = _loader()
    straight.fit(loader)
    loader.close()

    first = _trainer(tmp_path / "b", 2, policy)
    loader = _loader()
    first.fit(loader)
    loader.close()
    assert train.list_steps(str(tmp_path / "b")) == [2]
    resumed = _trainer(tmp_path / "b", 4, policy)
    loader = _loader(start=2)  # the step-indexed loader resumes on step 2
    resumed.fit(loader)
    loader.close()
    assert train.list_steps(str(tmp_path / "b")) == [2, 4]
    want, got = _state(straight), _state(resumed)
    assert got["opt"]["step"] == want["opt"]["step"] == 4
    for (n, x), (_, y) in zip(flatten_with_names(got),
                              flatten_with_names(want)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, n


def test_controller_state_rides_the_checkpoint(tmp_path):
    def program():
        return PolicyProgram(
            base=DitherPolicy(variant="paper", collect_stats=True),
            controller=SparsityController(target=0.95, gain=3.0))

    t1 = _trainer(tmp_path, 4, program(), ckpt_every=4)
    loader = _loader()
    t1.fit(loader)
    loader.close()
    saved = dict(t1._ctrl.state)
    assert saved and any(v != 0.0 for v in saved.values())
    # the restore in isolation: after the main restore (no batch yet), the
    # first batch names the layers and the ctrl subtree comes back exactly
    t2 = _trainer(tmp_path, 6, program(), ckpt_every=4)
    t2.restore_or_init()
    t2._init_ctrl_state(token_batch(TCFG, 0, device="cpu"))
    assert t2._ctrl.state == saved
    loader = _loader(start=4)
    out = t2.fit(loader)
    loader.close()
    assert out["opt_state"]["step"] == 6 and set(t2._ctrl.state) == set(saved)


def test_a_checkpoint_without_ctrl_leaves_the_scales_at_start(tmp_path):
    t1 = _trainer(tmp_path, 2, DitherPolicy(variant="paper"))
    t1.fit(_batches())
    t2 = _trainer(tmp_path, 2, PolicyProgram(
        base=DitherPolicy(variant="paper", collect_stats=True),
        controller=SparsityController(target=0.95)))
    t2.restore_or_init()
    t2._init_ctrl_state(token_batch(TCFG, 0, device="cpu"))
    assert t2._ctrl.state and all(v == 0.0 for v in t2._ctrl.state.values())


def _batches(start=0):
    i = start
    while True:
        yield token_batch(TCFG, i, device="cpu")
        i += 1


# ---------------------------------------------------------------------------
# the launcher's --ckpt-dir
# ---------------------------------------------------------------------------

def test_launcher_checkpoints_and_restarts_its_counter(tmp_path):
    import shutil

    def argv(ckpt_dir, steps):
        return ["--arch", "gemma-2b", "--preset", "smoke", "--device", "cpu",
                "--batch", "2", "--seq", "16", "--ckpt-dir", str(ckpt_dir),
                "--ckpt-every", "2", "--steps", str(steps), "--program",
                "dither: phase@0=off;phase@1=kernel;rule lm_head:off"]

    launch.main(argv(tmp_path / "run", 2))
    assert train.list_steps(str(tmp_path / "run")) == [2]
    shutil.copytree(tmp_path / "run", tmp_path / "two")
    resumed = launch.main(argv(tmp_path / "run", 4))
    assert train.list_steps(str(tmp_path / "run")) == [2, 4]
    # the resumed run trained steps 2 and 3 on batches 0 and 1, as the
    # reference's launcher does: the same resume fed those batches by hand
    # lands on the same parameters, and batches 2 and 3 do not
    for batches, same in (((0, 1), True), ((2, 3), False)):
        shutil.rmtree(tmp_path / "by_hand", ignore_errors=True)
        shutil.copytree(tmp_path / "two", tmp_path / "by_hand")
        trainer, _ = launch.build(launch.parse_args(
            argv(tmp_path / "by_hand", 4)))
        tcfg = TokenStreamConfig(vocab=MODEL.cfg.vocab, seq_len=16, batch=2)
        trainer.fit(iter([token_batch(tcfg, i, device="cpu")
                          for i in batches]))
        assert trainer.opt_state["step"] == 4
        assert same == all(torch.equal(p, trainer.params[name])
                           for name, p in resumed.params.items())
