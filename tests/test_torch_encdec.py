"""Port parity for the audio family (whisper-small, the encoder-decoder):
configurations, the parameter tree, layer norm, cross-attention, the
rotary embedding at theta 0, logits, losses, paper-variant and
kernel-route gradients, remat, decoding (prefill, decode, greedy with
encoder frames), the serving refusals and the launcher, ``repro_torch``
against ``repro`` on the CPU.

The parity tests share one fixture: whisper-small's smoke configuration (2
encoder and 2 decoder blocks, d 64, 4 heads, d_ff 128, vocab 512, 16
frames, f32) from the reference's ``init_encdec`` draw (seed 0), converted
with ``repro_torch.convert.lm_params_from_jax``, on the reference's token
batch 0 at batch 2 x seq 16 with the launchers' frames of step 0
(normal(0, 1) from ``np.random.default_rng(0)``, (2, 16, 64)), and the
reference's jitted steps. Dithered steps take the reference's per-layer
draw (fed through ``DitherCtx.unit_noise``) and its Delta (``jnp.std``,
patched into ``nsd.compute_delta``), as tests/test_torch_lm.py does.

Bands (f32). Layer norm, cross-attention, logits and each decode step's
logits: rtol 1e-5, atol 1e-6 of the largest entry (the same math summed
in another order); losses rtol 1e-6; decode caches rtol 1e-5, atol 1e-6
of the largest. Gradients under plain backprop, the paper variant and the
kernel route: relative L2 <= 1e-5 per parameter (``test_torch_zoo.py``'s
band); on the kernel route every dense's k equals the reference's Pallas
kernel's (interpret mode) element for element, fed its cotangent, draw
and Delta. Exact: the parameter round trip, theta-0 rope (the identity),
the remat gradients against the non-remat ones, the greedy tokens, the
launcher's frames against the reference launcher's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
from repro.configs import get_model as j_get_model, get_smoke_model as j_get_smoke  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy, nsd as jnsd  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data.synthetic import TokenStreamConfig as JTok, token_batch as j_token_batch  # noqa: E402
from repro.launch import train as j_launch_train  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serve import greedy_generate as j_greedy  # noqa: E402
from repro_torch.configs import get_model, get_smoke_model  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.core import nsd, schedule  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import encdec_model  # noqa: E402
from repro_torch.serve import Engine, ServeConfig, greedy_generate  # noqa: E402

ARCH, B, S, SEED = "whisper-small", 2, 16, 0
_ST = {}


@pytest.fixture(scope="module")
def st():
    """The reference smoke model, its parameters and jitted plain step, the
    port's model loaded with them, and batch 0 on both sides."""
    if not _ST:
        jm, m = j_get_smoke(ARCH), get_smoke_model(ARCH)
        params, _ = jm.init(jax.random.PRNGKey(SEED))
        net = m.init(SEED, "cpu")
        net.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray,
                                                            params)))
        tb = launch_train.batch_fn_for(m, B, S, "cpu")(0)
        jb = j_token_batch(JTok(vocab=jm.cfg.vocab, seq_len=S, batch=B), 0)
        jb["frames"] = jnp.asarray(tb["frames"].numpy())

        def f(p):
            logits, _ = jm.forward(p, jb)
            return jm.loss(p, jb), logits
        (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            params)
        _ST.update(jm=jm, m=m, params=params, net=net, jb=jb, tb=tb,
                   loss=float(loss), logits=np.asarray(logits),
                   grads=jax.tree.map(np.asarray, grads))
    return _ST


def _close(got, want, rtol=1e-5, atol_frac=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _pd(tree):
    return torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(np.array(a)))
         for k, a in tree.items()})


def _grads(net):
    grads = lm_params_to_jax({n: p.grad for n, p in net.named_parameters()})
    net.zero_grad(set_to_none=True)
    return grads


def _hold(jgrads, grads, band=1e-5):
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(jax.tree.leaves(grads))
    for (path, want), got in zip(flat, jax.tree.leaves(grads)):
        assert np.isfinite(got).all()
        assert _rel_l2(got, want) <= band, (jax.tree_util.keystr(path),
                                            _rel_l2(got, want))


# ---------------------------------------------------------------------------
# configurations and the parameter tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_matches_reference(which):
    """Every field of the reference's config but the dry run's
    ``scan_unroll`` (ROADMAP.md section 1, item 9), the dtype and the
    parameter count (the reference's formula: it counts 2 d for the four
    final-norm vectors of d each, so the tree holds 2 d more)."""
    jm, m = ((j_get_model(ARCH), get_model(ARCH)) if which == "full"
             else (j_get_smoke(ARCH), get_smoke_model(ARCH)))
    assert (m.name, m.family) == (jm.name, jm.family) == (
        m.cfg.name, "audio")
    jd, d = dataclasses.asdict(jm.cfg), dataclasses.asdict(m.cfg)
    for f in ("dtype", "scan_unroll"):
        jd.pop(f)
    d.pop("dtype")
    assert d == jd
    assert str(m.cfg.dtype).split(".")[-1] == jnp.dtype(jm.cfg.dtype).name
    assert m.param_count == m.active_param_count == jm.param_count
    assert m.cfg.hd == jm.cfg.hd
    if which == "full":
        assert m.param_count == 238_450_944


def test_parameter_tree_and_conversion(st):
    """The port's parameters are the reference's tree (the ``enc`` and
    ``dec`` stacks one block a layer, ``dec.{i}.xattn.*``, the norms'
    scales and biases, ``embed.table``, ``head.dec_pos`` and the final
    norms); the conversion round-trips exactly."""
    tree = jax.tree.map(np.asarray, st["params"])
    fresh = dict(st["m"].init(SEED, "cpu").named_parameters())
    conv = lm_params_from_jax(tree)
    assert conv.keys() == fresh.keys()
    for n, p in fresh.items():
        assert tuple(conv[n].shape) == tuple(p.shape), n
        assert conv[n].dtype == p.dtype, n
    assert {"enc.1.attn.wq", "dec.0.xattn.wk", "dec.1.lnx_s", "embed.table",
            "head.dec_pos", "head.ln_enc_s", "head.ln_dec_b"} <= set(fresh)
    assert sum(p.numel() for p in fresh.values()) == (
        st["m"].param_count + 2 * st["m"].cfg.d_model)
    back = lm_params_to_jax(dict(st["net"].named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layer_norm_matches_reference():
    x, scale, bias = _np((3, 7, 64), 1, 3.0), _np((64,), 2), _np((64,), 3)
    got = L.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    _close(got, JL.layer_norm(*(jnp.asarray(a) for a in (x, scale, bias))))


def test_rope_at_theta_zero_is_the_identity():
    """theta <= 0 disables the rotary embedding, as in the reference: x
    comes back as it is, and the decode path's table is None."""
    x = _np((2, 5, 4, 16), 4)
    pos = torch.arange(5)[None].expand(2, 5)
    for theta in (0.0, -1.0):
        got = L.apply_rope(torch.from_numpy(x), pos, theta)
        np.testing.assert_array_equal(got.numpy(), x)
        np.testing.assert_array_equal(
            np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos.numpy()),
                                     theta)), x)
        assert L.rope_table(pos, 16, theta) is None


def test_cross_attention_matches_reference():
    """q of h, k and v of the encoder states (another length), no mask and
    no rope; the cached read over the same keys and values."""
    cfg = JL.AttnConfig(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
                        causal=False, rope_theta=0.0)
    jp, _ = JL.init_attention(jax.random.PRNGKey(4), cfg, jnp.float32)
    jp = {k: np.asarray(a) for k, a in jp.items()}
    h, enc = _np((2, 5, 32), 5), _np((2, 11, 32), 6)
    pos = jnp.broadcast_to(jnp.arange(5)[None], (2, 5))
    want, (jk, jv) = JL.attention(jp, jnp.asarray(h), pos, cfg,
                                  x_kv=jnp.asarray(enc))
    got = L.cross_attention(_pd(jp), torch.from_numpy(h),
                            torch.from_numpy(enc), 4, 4, 8)
    _close(got.detach(), want)
    cached = L.cross_attention_cached(
        _pd(jp), torch.from_numpy(h[:, :1]),
        (torch.from_numpy(np.asarray(jk)), torch.from_numpy(np.asarray(jv))),
        4, 8)
    _close(cached.detach(), JL.cross_attention_cached(
        jp, jnp.asarray(h[:, :1]), (jk, jv), cfg))


# ---------------------------------------------------------------------------
# the model: logits, losses, gradients
# ---------------------------------------------------------------------------

def test_logits_loss_and_plain_gradients_match_reference(st):
    net = st["net"]
    with torch.no_grad():
        got = st["m"].forward(net, st["tb"])
    assert tuple(got.shape) == (B, S, 512)
    _close(got, st["logits"])
    net.zero_grad(set_to_none=True)
    loss = st["m"].loss(net, st["tb"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), st["loss"], rtol=1e-6)
    _hold(st["grads"], _grads(net))


class FedCtx(DitherCtx):
    """Hands the port the reference's draw of each layer (its
    ``key_for(name)`` under the reference context ``jctx``)."""

    def __init__(self, policy, jctx, program):
        super().__init__(policy, program=program, device="cpu")
        self.jctx = jctx

    def unit_noise(self, name, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.jctx.key_for(name), tuple(shape), jnp.float32, -0.5, 0.5)))


def _jnp_delta(monkeypatch):
    monkeypatch.setattr(nsd, "compute_delta", lambda x, s: torch.from_numpy(
        np.array(jnsd.compute_delta(jnp.asarray(x.detach().float().numpy()), s))))


def _step_grads(st, variant, monkeypatch, record=None):
    """Step 0 of ``phase@0=<variant>`` (lm_head included) on both sides:
    (the reference's gradients, the port's), reference-shaped."""
    spec = f"phase@0={variant}"
    jprog = jsched.parse_program(spec, JPolicy(s=2.0))
    prog = schedule.parse_program(spec, DitherPolicy(s=2.0))
    base = jax.random.fold_in(jax.random.PRNGKey(SEED), 0xD17E)
    jctx = JCtx.for_step(base, 0, jprog.phase_policy_at(0), program=jprog)
    ctx = FedCtx(prog.phase_policy_at(0), jctx, prog)
    if record is not None:
        real = jops.quantize_and_mask

        def recording(g2d, key, s, **kw):
            q = real(g2d, key, s, **kw)
            jax.debug.callback(lambda *a: record.append(
                tuple(np.asarray(x) for x in a)), g2d,
                jax.random.key_data(key), q.k)
            return q
        monkeypatch.setattr(jops, "quantize_and_mask", recording)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: st["jm"].loss(p, st["jb"], ctx=jctx)))(st["params"])
    _jnp_delta(monkeypatch)
    net = st["net"]
    net.zero_grad(set_to_none=True)
    loss = st["m"].loss(net, st["tb"], ctx=ctx)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    return jax.tree.map(np.asarray, jgrads), _grads(net)


# the dithered denses of the smoke model: 2 encoder blocks x (q, k, v, o, up,
# down), 2 decoder blocks x (self q, k, v, o, cross q, k, v, o, up, down),
# the tied lm_head
N_DENSE = 2 * 6 + 2 * 10 + 1


def test_paper_step_gradients(st, monkeypatch):
    """The paper variant's first step with the reference's draws and
    Delta: every gradient (the encoder's, reached through the cross k and v
    alone) within relative L2 1e-5, the same loss; the names the port's
    layers resolve are the reference's scan names."""
    _hold(*_step_grads(st, "paper", monkeypatch))
    want = jsched.discover_layer_names(
        lambda p, b, ctx: st["jm"].loss(p, b, ctx=ctx), st["params"], st["jb"])
    seen = set()

    class Recording(DitherCtx):
        def resolve(self, name):
            seen.add(name)
            return super().resolve(name)

    st["m"].loss(st["net"], st["tb"],
                 ctx=Recording(DitherPolicy(variant="paper"), device="cpu"))
    assert sorted(seen) == want == sorted(
        [f"{t}.{p}" for t in ("enc.attn", "dec.attn", "dec.xattn")
         for p in "qkvo"]
        + [f"{t}.{p}" for t in ("enc.mlp", "dec.mlp") for p in ("up", "down")]
        + ["lm_head"])


def test_kernel_step_gradients_and_k_per_dense(st, monkeypatch):
    """The kernel route: the port's kernels' plain versions against the
    reference's Pallas kernels (interpret mode), lm_head on the kernel too.
    Every dense quantizes once; fed the reference's cotangent, draw and
    Delta, the port's k equals the reference kernel's, element for
    element; the gradients within relative L2 1e-5."""
    record = []
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    _hold(*_step_grads(st, "kernel", monkeypatch, record))
    assert not ops.KERNEL_FALLBACKS and not any(build.LAUNCHES.values())
    assert len(record) == N_DENSE
    for g2d, key, k_ref in record:
        T, N = g2d.shape
        u = jax.random.uniform(jax.random.wrap_key_data(key), (T, N),
                               jnp.float32, -0.5, 0.5)
        q = ops.quantize_and_mask(torch.from_numpy(g2d.copy()),
                                  torch.from_numpy(np.array(u)), 2.0)
        np.testing.assert_array_equal(q.k[:T, :N].numpy(), k_ref[:T, :N])


def test_remat_gradients_equal_the_plain_blocks(st):
    """A ``remat=True`` copy of the smoke config (each block under
    ``torch.utils.checkpoint``, the rerun marked ``recompute``) on the same
    parameters: the paper step's loss and every gradient equal the
    non-remat model's bit for bit (the draws come from the layers' keys)."""
    m = encdec_model(dataclasses.replace(st["m"].cfg, remat=True))
    net_r = m.init(SEED, "cpu")
    net_r.load_state_dict(st["net"].state_dict())
    out = []
    for mm, net in ((st["m"], st["net"]), (m, net_r)):
        ctx = DitherCtx(DitherPolicy(variant="paper", s=2.0), device="cpu")
        net.zero_grad(set_to_none=True)
        loss = mm.loss(net, st["tb"], ctx=ctx)
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.clone()
                                  for n, p in net.named_parameters()}))
        net.zero_grad(set_to_none=True)
    (l0, g0), (l1, g1) = out
    assert l0 == l1 and g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


# ---------------------------------------------------------------------------
# decoding and serving
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_reference(st):
    """prefill (the encoder once, the cross K/V once, the prompt token by
    token) on a 5-token prompt, then 6 greedy decode steps, against the
    reference's: logits, t, the self and cross caches, the tokens."""
    jcfg, max_len = st["jm"].cfg, 32
    prompt = np.asarray(st["jb"]["tokens"])[:, :5]
    jl, jcache, jt = jed.prefill(st["params"], jcfg, jnp.asarray(prompt),
                                 max_len, st["jb"]["frames"])
    logits, cache, t = ed.prefill(st["net"], torch.from_numpy(
        prompt.astype(np.int64)), max_len, st["tb"]["frames"])
    _close(logits, jl)
    assert t == int(jt) == 4

    def same_cache(cache, jcache):
        assert len(cache) == len(jcache)
        for c, jc in zip(cache, jcache):
            for part in ("self", "cross"):
                for a, ja in zip(c[part], jc[part]):
                    assert a.shape == ja.shape
                    _close(a, ja)
    same_cache(cache, jcache)
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1))
    j_step = jax.jit(lambda p, c, tk, tt: jed.decode_step(p, jcfg, c, tk, tt))
    for _ in range(6):
        t += 1
        jl, jcache = j_step(st["params"], jcache, jnp.asarray(tok),
                            jnp.asarray(t, jnp.int32))
        logits, cache = ed.decode_step(st["net"], cache,
                                       torch.from_numpy(tok.astype(np.int64)), t)
        _close(logits, jl)
        got_tok = torch.argmax(logits[:, -1:], -1).numpy()
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1))
        np.testing.assert_array_equal(got_tok, tok)
    same_cache(cache, jcache)


def test_greedy_generate_with_frames_matches_reference(st):
    """``greedy_generate(model, net, prompt, n, frames=...)``: one request's
    frames (an array, as the reference takes them) through the prefill,
    then greedy decode; the tokens equal the reference's."""
    frames = np.asarray(st["jb"]["frames"])[:1]
    prompt = np.array([1, 7, 3], np.int32)
    got = greedy_generate(st["m"], st["net"], prompt, 8, max_len=32,
                          frames=frames)
    want = j_greedy(st["jm"], st["params"], prompt, 8, max_len=32,
                    frames=frames)
    assert got == want and len(got) == 8


def test_engine_and_serve_launcher_refuse_the_audio_family(st):
    """The slot engine refuses the family with the reference's words (each
    request needs its own encoder features), and so does the serve
    launcher's worker; ``parse_serve_spec`` accepts the arch, as the
    reference's does."""
    with pytest.raises(ValueError, match=r"greedy_generate\(model, \.\.\., "
                                         r"frames=\.\.\.\)"):
        Engine(st["m"], st["net"], ServeConfig(max_batch=2, max_len=32))
    assert launch_serve.parse_serve_spec("worker whisper-small: batch=2") == [
        ("whisper-small", {"batch": "2"})]
    with pytest.raises(ValueError, match="greedy_generate"):
        launch_serve.main(["--arch", ARCH, "--device", "cpu"])


def test_launcher_runs_the_smoke_preset_with_the_reference_frames():
    """Two steps of ``repro_torch.launch.train --preset smoke`` on the
    kernel program, lm_head included (its K, the vocab of 512, is inside
    the int8 product's exact range): finite losses, no fallback; each
    step's frames equal the reference launcher's bit for bit."""
    jm, m = j_get_smoke(ARCH), get_smoke_model(ARCH)
    for step in (0, 1):
        got = launch_train.batch_fn_for(m, B, S, "cpu")(step)
        want = j_launch_train.batch_fn_for(jm, B, S)(step)
        assert got["frames"].dtype == torch.float32
        np.testing.assert_array_equal(got["frames"].numpy(),
                                      np.asarray(want["frames"]))
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
    ops.KERNEL_FALLBACKS.clear()
    trainer = launch_train.main(
        ["--arch", ARCH, "--preset", "smoke", "--steps", "2", "--batch",
         str(B), "--seq", str(S), "--device", "cpu", "--program",
         "dither: phase@0=off;phase@1=kernel"])
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert not ops.KERNEL_FALLBACKS
