"""Port parity: the LM trainer's gradient wire against the reference's:
``repro_torch.comm`` (codec specs as comm modes, ``compress_tree``, the flat
reducer, the ``comm:`` program section), ``repro_torch.comm.pricing``'s
link pricing, ``repro_torch.train.trainer``'s comm step and checkpoint
subtree, ``RunObs.on_step``'s comm and bound rows, and the overlap row of
``repro_torch.train.distributed_nodes``.

Both sides get the same gradients and the reference's draws: each pack's
unit draw is the reference's for the leaf key ``fold_in(key,
name_salt(name))`` (``compress_tree``'s ``noise=``, the trainer reducer's
``Reducer.pack_noise``), and Delta is the reference's function
(``jnp.std``) on the port's tensor, as in tests/test_torch_comm.py.

Tolerances. ``compress_tree`` in every mode (a codec spec among them):
g_hat, each leaf's wire bytes and the f32 byte totals equal bit for bit,
the totals summed past 2^24 in the reference's leaf order. The trainer, 3
AdamW steps of gemma-2b smoke from the reference's parameters with
``comm: default=nsd;s=0.5``: the gradients that reach the wire differ by
the backward's f32 rounding (rel L2 <= 1e-5), so a k that sits at its
rounding boundary may flip; each step checks that every k that differs sat
within 1e-3 of it, as tests/test_torch_ssm.py checks dither flips, and
carries on with the reference's reduced gradients (unfed, flips from
step 2 on moved the embedding by rel 4e-4 after 3 steps). Then the wire
bytes are within one byte a flipped k (measured: one k in 3 steps, one
byte), the losses within 1e-4 and the parameters within rel L2 1e-4,
test_torch_trainer.py's band for plain backprop (measured 2.1e-8). The comm
program parses, formats and refuses as the reference's. The link prices
are the H100 platform's (NVLink 450 GB/s, one NDR NIC 50 GB/s), not the
reference's, so they are checked against those rates, and the pricing
functions against the reference's given the same rates.
"""
import dataclasses
import importlib
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import compression as jcomp  # noqa: E402
from repro.comm.reducer import (format_comm_program as j_format,  # noqa: E402
                                parse_comm_program as j_parse)
from repro.configs import get_smoke_model as j_get_smoke  # noqa: E402
from repro.core import nsd as jnsd  # noqa: E402
from repro.core.policy import name_salt as j_name_salt  # noqa: E402
from repro.data.synthetic import TokenStreamConfig as JTok, token_batch as j_token_batch  # noqa: E402
from repro.launch import costmodel as jcost  # noqa: E402
from repro.obs import runlog as jrunlog  # noqa: E402
from repro.optim import OptConfig as JOpt  # noqa: E402
from repro.train import Trainer as JTrainer, TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import comm  # noqa: E402
from repro_torch.bench import SuiteRun, compare_runs  # noqa: E402
from repro_torch.configs import get_smoke_model  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.core import nsd  # noqa: E402
from repro_torch.comm import pricing  # noqa: E402
from repro_torch.core.policy import fold_in  # noqa: E402
from repro_torch.data.synthetic import TokenStreamConfig, token_batch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import NodeTopology  # noqa: E402
from repro_torch.obs import metrics, runlog  # noqa: E402
from repro_torch.obs.bus import MetricsBus  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.train import CheckpointManager, distributed_nodes  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH, SEED, STEPS, S = "gemma-2b", 0, 3, 0.5
TCFG = dict(vocab=512, seq_len=16, batch=4)
# gemma-2b smoke's dense f32 gradient bytes: embed 512 x 128, 2 blocks of
# 139,520, the final norm's 128
DENSE = 4 * (512 * 128 + 2 * 139_520 + 128)
KW = dict(name="adamw", lr=3e-3, schedule="cosine", warmup_steps=1,
          total_steps=STEPS)


@pytest.fixture
def ref_delta(monkeypatch):
    """The port's Delta through the reference's ``compute_delta``."""
    monkeypatch.setattr(nsd, "compute_delta", lambda x, s: torch.from_numpy(
        np.array(jnsd.compute_delta(jnp.asarray(x.detach().float().numpy()),
                                    s))))


def _u(key, shape):
    """The reference's unit draw of a pack keyed ``key``."""
    return torch.from_numpy(np.array(jax.random.uniform(
        key, tuple(shape), jnp.float32, -0.5, 0.5)))


# ---------------------------------------------------------------------------
# the comm: program section
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,base", [
    ("topology=butterfly;pods=4;default=nsd;s=2.0;bucket_bytes=1048576;"
     "stats=1;tag=comm/;rule emb:dense;rule head:topk_ef", None),
    ("s=3.0;rule emb:dense", "default=nsd;s=1.0"),
    ("default=int4@g32;min_leaf_size=64;stats=0;rule ln:dense", None),
    ("topology=moebius", None), ("frobnicate=1", None)],
    ids=["round-trip", "overlay", "codec-spec", "bad-topology", "bad-key"])
def test_comm_program_matches_reference(spec, base):
    """The reference's tests/test_reducer.py cases: the same CommPolicy
    fields, the same formatted text, a round trip, the same refusals."""
    if "moebius" in spec or "frobnicate" in spec:
        with pytest.raises(ValueError):
            j_parse(spec)
        with pytest.raises(ValueError):
            comm.parse_comm_program(spec)
        return
    jpol = j_parse(spec, j_parse(base) if base else None)
    pol = comm.parse_comm_program(
        spec, comm.parse_comm_program(base) if base else None)
    assert dataclasses.asdict(pol) == dataclasses.asdict(jpol)
    assert comm.format_comm_program(pol) == j_format(jpol)
    assert comm.parse_comm_program(comm.format_comm_program(pol)) == pol
    with pytest.raises(ValueError, match="unknown comm mode"):
        comm.CommPolicy(default="int5@g32")


# ---------------------------------------------------------------------------
# compress_tree
# ---------------------------------------------------------------------------

# reference-named leaves whose dense bytes add up past 2^24 (19.4 MB), one
# below min_leaf_size (stays dense in every mode)
TREE = {"embed/table": (2048, 1536), "head/ln_f": (100,),
        "layers/attn/wq": (2, 256, 256), "layers/mlp/w_up": (2, 1024, 768)}


@pytest.mark.parametrize("mode", ["dense", "int8", "nsd", "topk_ef",
                                  "int4@g32"])
def test_compress_tree_matches_reference(mode, ref_delta):
    """g_hat bit for bit, each leaf's wire bytes, the f32 totals and the
    stats row; topk_ef threads its residuals through two rounds."""
    rng = np.random.default_rng(7)
    grads = [{n: (rng.standard_normal(s) * 0.01).astype(np.float32)
              for n, s in TREE.items()} for _ in range(2)]
    jpol = jcomp.CommPolicy(default=mode, s=2.0, topk_frac=0.01,
                            collect_stats=True, stats_tag="tree/")
    pol = comm.CommPolicy(default=mode, s=2.0, topk_frac=0.01,
                          collect_stats=True, stats_tag="tree/")
    jkey = jax.random.PRNGKey(5)

    def fed(name, shape):
        return _u(jax.random.fold_in(jkey, j_name_salt(name)), shape)

    jstate = jcomp.init_comm_state(grads[0], jpol)
    state = comm.init_comm_state({n: torch.from_numpy(g) for n, g in
                                  grads[0].items()}, pol)
    assert set(state) == set(jstate)
    metrics.reset()
    for g in grads:
        jout, jstate, jtele = jcomp.compress_tree(
            {n: jnp.asarray(a) for n, a in g.items()}, jkey, jpol, jstate)
        out, state, tele = comm.compress_tree(
            {n: torch.from_numpy(a) for n, a in g.items()}, fed, pol, state)
        assert list(out) == sorted(TREE)
        for n in TREE:
            np.testing.assert_array_equal(out[n].numpy(), np.asarray(jout[n]),
                                          err_msg=n)
            want = jcomp.compress_leaf(
                jnp.asarray(g[n]), jax.random.fold_in(jkey, j_name_salt(n)),
                jpol.mode_for(n, g[n].size), jpol)[1]
            got = comm.compress_leaf(torch.from_numpy(g[n]),
                                     fed(n, g[n].shape),
                                     pol.mode_for(n, g[n].size), pol)[1]
            assert int(got) == int(want), n
        for k in ("wire_bytes", "dense_bytes"):
            assert float(tele[k]) == float(jtele[k]), k
        assert float(tele["dense_bytes"]) > 2 ** 24
        for n in jstate:
            np.testing.assert_array_equal(state[n].residual.numpy(),
                                          np.asarray(jstate[n].residual))
    summ = comm.telemetry.summary()
    assert list(summ) == ["tree/"] and summ["tree/"].n_records == 2
    assert comm.telemetry.totals().wire_bytes == summ["tree/"].wire_bytes
    if mode == "dense":
        assert summ["tree/"].ratio == 1.0


# ---------------------------------------------------------------------------
# the trainer's comm step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """3 steps of gemma-2b smoke under ``CommPolicy(default="nsd", s=0.5)``
    on both trainers from the reference's parameters. The reference's
    reduced gradients are recorded each step (``jax.debug.callback`` around
    its ``compress_tree``); the port is fed its pack draws and Delta, runs
    with a 2 x 4 topology and a run directory, checks each step's packs
    against the reference's (``_check_packs``) and carries on with the
    reference's reduced gradients."""
    from repro.utils.pytree import flatten_with_names as j_flatten

    # the module (the package's ``reducer`` attribute is the function)
    jred_mod = importlib.import_module("repro.comm.reducer")

    ref = []
    j_compress_tree = jred_mod.compress_tree

    def recording(grads, key, policy, states=None):
        out = j_compress_tree(grads, key, policy, states)
        jax.debug.callback(lambda gi, go: ref.append(
            (dict(j_flatten(jax.tree.map(np.asarray, gi))),
             dict(j_flatten(jax.tree.map(np.asarray, go))))), grads, out[0])
        return out

    jm, m = j_get_smoke(ARCH), get_smoke_model(ARCH)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jred_mod, "compress_tree", recording)
        jt = JTrainer(jm, JOpt(**KW), JTrainerConfig(total_steps=STEPS,
                                                     log_every=1),
                      comm_policy=jcomp.CommPolicy(default="nsd", s=S))
        jout = jt.fit(iter([j_token_batch(JTok(**TCFG), i)
                            for i in range(STEPS)]))
        jax.effects_barrier()
    params0, _ = jm.init(jax.random.PRNGKey(SEED))
    net = m.init(SEED, "cpu")
    net.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params0)))
    rd = str(tmp_path_factory.mktemp("run"))
    obs = runlog.run_obs(rd, bus=MetricsBus())
    tr = trainer_mod.Trainer(
        m, opt.OptConfig(**KW), trainer_mod.TrainerConfig(
            total_steps=STEPS, log_every=1), device="cpu", obs=obs,
        comm_policy=comm.CommPolicy(default="nsd", s=S),
        topology=NodeTopology(pods=2, nodes_per_pod=4))
    jcomm = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(SEED), 0xD17E), 0xC033)
    seen, checks = [], []

    def draw(step, name, shape):
        return _u(jax.random.fold_in(jax.random.fold_in(jcomm, step),
                                     j_name_salt(name)), shape)

    def pack_noise(key, step, name, path, shape):
        assert key == fold_in(fold_in(SEED, 0xD17E), 0xC033) and path == ()
        seen.append((step, name))
        return draw(step, name, shape)

    tr._reducer.pack_noise = pack_noise
    port_reduce = tr._reducer.reduce

    def forced(grads, key, step, state):
        out, tele, state = port_reduce(grads, key, step, state)
        jin, jout = ref[step]
        checks.append(_check_packs(grads, out, jin, jout,
                                   lambda n, sh: draw(step, n, sh)))
        return ({n: torch.from_numpy(np.array(jout[n])) for n in out}, tele,
                state)

    tr._reducer.reduce = forced
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nsd, "compute_delta", lambda x, s: torch.from_numpy(
            np.array(jnsd.compute_delta(
                jnp.asarray(x.detach().float().numpy()), s))))
        out = tr.fit(iter([token_batch(TokenStreamConfig(**TCFG), i,
                                       device="cpu") for i in range(STEPS)]),
                     params=net)
    return dict(jout=jout, out=out, tr=tr, seen=seen, rd=rd, checks=checks,
                ref=ref)


def _check_packs(grads, out, jin, jout, draw):
    """One step's reduced gradients against the reference's: the leaves
    that reach the wire within rel L2 1e-5 of the reference's (measured
    <= 1.1e-6); every k that differs (g_hat / Delta, each side's own Delta)
    sat within 1e-3 of its rounding boundary in the reference's (g + u
    Delta) / Delta + 1/2, at most 4 a leaf; the dense leaves unchanged.
    Returns the number of differing k."""
    flips = 0
    for name, g in grads.items():
        g, jg = g.numpy().astype(np.float64), jin[name].astype(np.float64)
        assert np.linalg.norm(g - jg) <= 1e-5 * np.linalg.norm(jg), name
        if g.size < 256:
            assert torch.equal(out[name], grads[name]), name
            continue
        delta = np.float64(nsd.compute_delta(grads[name], S))
        jdelta = np.float64(jnsd.compute_delta(jnp.asarray(jin[name]), S))
        differ = (np.rint(out[name].numpy() / delta)
                  != np.rint(jout[name] / jdelta))
        r = (jg + draw(name, g.shape).numpy() * jdelta) / jdelta + 0.5
        dist = np.abs(r - np.round(r))[differ]
        assert (dist < 1e-3).all() and differ.sum() <= 4, (name, dist)
        flips += int(differ.sum())
    return flips


def test_trainer_comm_matches_reference(runs):
    """Every leaf of at least 256 elements packed once a step under the
    reference's names (the blocks stacked), each step's packs checked
    against the reference's (``_check_packs``); each step's wire bytes
    within one byte a differing k of the reference's; the losses and final
    parameters within the plain-backprop band."""
    jout, out, tr = runs["jout"], runs["out"], runs["tr"]
    big = sorted(n for n, p in trainer_mod.wire_leaves(
        {n: p.detach() for n, p in tr.params.items()}).items()
        if p.numel() >= 256)
    assert big == ["embed/table", "layers/attn/wk", "layers/attn/wo",
                   "layers/attn/wq", "layers/attn/wv", "layers/ln1",
                   "layers/ln2", "layers/mlp/w_down", "layers/mlp/w_gate",
                   "layers/mlp/w_up"]
    assert runs["seen"] == [(s, n) for s in range(STEPS) for n in big]
    assert len(runs["checks"]) == len(runs["ref"]) == STEPS
    hist, jhist = out["history"], jout["history"]
    for row, jrow, flips in zip(hist, jhist, runs["checks"]):
        assert abs(round(row["comm_wire_mb"] * 1e6)
                   - round(jrow["comm_wire_mb"] * 1e6)) <= flips
    assert all(0 < r["comm_wire_mb"] < DENSE / 1e6 for r in hist)
    np.testing.assert_allclose([r["loss"] for r in hist],
                               [r["loss"] for r in jhist], atol=1e-4)
    got = lm_params_to_jax(dict(tr.net.named_parameters()))
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jout["params"]))[0]
    for (path, want), g in zip(flat, jax.tree.leaves(got)):
        g = np.asarray(g, np.float32)
        rel = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert rel <= 1e-4, jax.tree_util.keystr(path)


def test_trainer_prices_topology_in_history(runs):
    """With a topology that spans pods each row carries the fast- and
    slow-axis seconds of its wire bytes; the slow axis is slower. The
    pricing functions equal the reference's given the H100 link rates: a
    flat ring in one and in two pods, a two-level reduce, an overlap
    schedule."""
    for row in runs["out"]["history"]:
        wire = row["comm_wire_mb"] * 1e6
        assert row["comm_ici_s"] == pytest.approx(wire / 450e9)
        assert row["comm_dcn_s"] == pytest.approx(wire / 50e9)
        assert row["comm_dcn_s"] > row["comm_ici_s"] > 0
    assert pricing.price_step_comm(1e9) == {"comm_ici_s": 1e9 / 450e9,
                                            "comm_dcn_s": 0.0}
    h100 = jcost.LinkPricing(ici_bw=450e9, dcn_bw=50e9)
    ring = types.SimpleNamespace(wire_bytes=3.2e6)
    two_level = types.SimpleNamespace(wire_bytes=5e6, wire_ici_bytes=4e6,
                                      wire_dcn_bytes=1e6, pods=4, per_pod=2)
    for tele, nodes, pods in ((ring, 8, 1), (ring, 8, 2), (two_level, 8, 4)):
        assert pricing.price_reduce(tele, nodes=nodes, pods=pods) == \
            jcost.price_reduce(tele, nodes=nodes, pods=pods, pricing=h100)
    buckets, comm_s = [4e6, 1e6, 3e6], [2e-3, 5e-4, 1.5e-3]
    assert pricing.price_overlap(buckets, comm_s, bwd_s=3e-3) == \
        jcost.price_overlap(buckets, comm_s, bwd_s=3e-3)


def test_on_step_records_the_comm_row(runs, tmp_path):
    """The trainer's run directory holds one comm row a step with its wire
    and dense bytes; ``on_step`` writes the comm and bound rows the
    reference's writes for the same metrics."""
    _, streams = runlog.read_run(runs["rd"])
    wires = [r["comm_wire_mb"] * 1e6 for r in runs["out"]["history"]]
    assert [r["wire_bytes"] for r in streams["comm"]] == pytest.approx(wires)
    assert all(r["dense_bytes"] == DENSE for r in streams["comm"])
    m = {"loss": 2.5, "comm_wire_bytes": 1234.0, "comm_dense_bytes": 4096.0,
         "comm_error_bound": 0.125}
    rows = []
    for mod, kw in ((runlog, {"bus": MetricsBus()}), (jrunlog, {})):
        d = str(tmp_path / mod.__name__)
        obs = mod.run_obs(d, **kw)
        obs.on_step(3, m)
        obs.finish()
        s = mod.read_run(d)[1]
        rows.append({k: [{f: v for f, v in r.items() if f != "ts"}
                         for r in s[k] if r["tag"] in ("step", "reduce")]
                     for k in ("comm", "bound")})
    assert rows[0] == rows[1] and rows[0]["bound"]


# ---------------------------------------------------------------------------
# error-feedback residuals in checkpoints
# ---------------------------------------------------------------------------

EF = dict(default="topk_ef", topk_frac=0.1, min_leaf_size=1)


def _port_trainer(ckpt_dir, total, comm_policy):
    return trainer_mod.Trainer(
        get_smoke_model(ARCH), opt.OptConfig(lr=1e-3),
        trainer_mod.TrainerConfig(total_steps=total, log_every=0,
                                  ckpt_every=3, ckpt_dir=str(ckpt_dir)),
        device="cpu", comm_policy=comm_policy)


def _batches():
    return iter([token_batch(TokenStreamConfig(vocab=512, seq_len=16,
                                               batch=8), i, device="cpu")
                 for i in range(6)])


def test_trainer_ef_state_survives_checkpoint_resume(tmp_path):
    """topk_ef residuals ride the checkpoint as ``comm``: a restored
    trainer continues from them; a checkpoint without them restarts them
    at 0. A second ``fit(params=...)`` on the same trainer keeps the
    residuals it holds, as the reference's does."""
    t1 = _port_trainer(tmp_path / "ef", 3, comm.CommPolicy(**EF))
    t1.fit(_batches())
    saved = {k: v.residual.clone() for k, v in t1._comm_state.items()}
    assert "layers/attn/wq" in saved and saved["layers/attn/wq"].shape == (
        2 * 128 * 128,)
    assert any(float(r.abs().sum()) > 0 for r in saved.values())
    t2 = _port_trainer(tmp_path / "ef", 6, comm.CommPolicy(**EF))
    _, opt_state = t2.restore_or_init()
    assert opt_state["step"] == 3
    for name, r in saved.items():
        assert torch.equal(t2._comm_state[name].residual, r), name

    _port_trainer(tmp_path / "plain", 3, None).fit(_batches())
    t3 = _port_trainer(tmp_path / "plain", 6, comm.CommPolicy(**EF))
    _, opt_state = t3.restore_or_init()
    assert opt_state["step"] == 3 and set(t3._comm_state) == set(saved)
    assert all(float(v.residual.abs().sum()) == 0
               for v in t3._comm_state.values())

    t4 = _port_trainer(tmp_path / "direct", 3, comm.CommPolicy(**EF))
    t4.fit(_batches(), params=t4.init_params())
    held = {k: v.residual.clone() for k, v in t4._comm_state.items()}
    assert any(float(r.abs().sum()) > 0 for r in held.values())
    t4.fit(_batches(), params=t4.net, opt_state=t4.opt_state)
    for name, r in held.items():
        assert torch.equal(t4._comm_state[name].residual, r), name


def test_reference_checkpoint_comm_subtree_restores_in_the_port(tmp_path):
    """The reference trainer's topk_ef checkpoint: its ``comm`` subtree has
    the port's names and restores into the port's state with the
    reference's residuals."""
    jm = j_get_smoke(ARCH)
    jt = JTrainer(jm, JOpt(lr=1e-3), JTrainerConfig(
        total_steps=2, log_every=0, ckpt_every=2, ckpt_dir=str(tmp_path)),
        comm_policy=jcomp.CommPolicy(**EF))
    jt.fit(iter([j_token_batch(JTok(vocab=512, seq_len=16, batch=8), i)
                 for i in range(2)]))
    want = {k: np.asarray(v.residual) for k, v in jt._comm_state.items()}
    port = _port_trainer(tmp_path / "unused", 2, comm.CommPolicy(**EF))
    port.restore_or_init()
    assert set(port._comm_state) == set(want)
    got = CheckpointManager(str(tmp_path)).restore(
        {"comm": port._comm_state})["comm"]
    for name, r in want.items():
        np.testing.assert_array_equal(got[name].residual.numpy(), r)


# ---------------------------------------------------------------------------
# the launcher and the overlap row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("program,stats", [
    ("comm: default=nsd;s=2.0;stats=1", True), ("quant: wire=nsd", False)])
def test_launcher_sends_gradients_through_the_wire(program, stats):
    """The launcher's comm: section and quant: wire= each give the trainer
    the reference's CommPolicy; every history row carries comm_wire_mb
    below the dense f32 exchange; stats=1 records one row a step."""
    metrics.reset()
    tr = launch_train.main(["--arch", ARCH, "--preset", "smoke", "--batch",
                            "2", "--seq", "16", "--device", "cpu", "--steps",
                            "2", "--program", program])
    want = (j_parse(program.split(": ", 1)[1]) if stats
            else jcomp.CommPolicy(default="nsd"))
    assert dataclasses.asdict(tr.comm_policy) == dataclasses.asdict(want)
    assert [r["step"] for r in tr.history] == [1, 2]
    assert all(0 < r["comm_wire_mb"] < DENSE / 1e6 for r in tr.history)
    summ = comm.telemetry.summary()
    assert (summ["comm/"].n_records if stats else len(summ)) == (2 if stats
                                                                 else 0)


def test_overlap_row_meets_the_reference_gates():
    """``distributed_nodes``'s overlap row against the reference's
    committed row: bit for bit, three buckets, the efficiency gap in its
    band."""
    base = SuiteRun.from_dict(json.loads(
        (ROOT / "benchmarks/baselines/BENCH_distributed_nodes.json")
        .read_text()))
    row = distributed_nodes.overlap_result(
        distributed_nodes.compare_overlap(device="cpu"), 0.0)
    want = base.by_name()[row.name]
    assert set(row.derived) == set(want.derived) and row.gates == want.gates
    report = compare_runs(SuiteRun(suite=base.suite, quick=base.quick,
                                   results=[row]),
                          SuiteRun(suite=base.suite, quick=base.quick,
                                   results=[want]))
    assert report.ok, report.render()
    assert pricing.compression_speedup(0, 1) == float("inf")
