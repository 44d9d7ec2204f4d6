"""Port parity for the rest of the LM zoo's dense, MoE and VLM families
(gemma3-4b, qwen2.5-32b, minitron-8b, moonshot-v1-16b-a3b, dbrx-132b,
internvl2-2b): configurations, parameter trees, logits, losses,
paper-variant gradients, sliding windows, decoding, and the launchers,
``repro_torch`` against ``repro`` on the CPU.

Every arch runs its smoke configuration from the reference's ``init_lm``
draw (seed 0), converted with ``repro_torch.convert.lm_params_from_jax``,
on the reference's token batch 0 at batch 2 x seq 16 (twice gemma3's smoke
window of 8, so the window binds). internvl2-2b's batch also carries 8
patch embeddings of 64 (normal(0, 1) from ``np.random.default_rng(0)``, as
the launchers' ``batch_fn_for`` draws them): its projector's output is a
visual prefix of 8 positions, and its loss counts the 16 text positions. Gradients take the reference's
per-layer draw (fed through ``DitherCtx.unit_noise``) and its Delta
(``jnp.std``, patched into ``nsd.compute_delta``), as
tests/test_torch_lm.py does.

Bands (f32). Logits and losses: rtol 1e-5 (atol 1e-6 of the largest
logit); the MoE aux loss 1e-6; the routing inside is exact (the MoE tests
in tests/test_torch_moe.py). Paper-variant gradients: relative L2 <= 1e-5
per parameter. Decoding: each step's logits rtol 1e-5, the greedy tokens
equal. The conversion round-trips exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_model as j_get_model, get_smoke_model as j_get_smoke  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy, nsd as jnsd  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data.synthetic import TokenStreamConfig as JTok, token_batch as j_token_batch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import Engine as JEngine, Request as JRequest, ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_model, get_smoke_model  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.core import nsd, schedule  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.data.synthetic import TokenStreamConfig, token_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig, greedy_generate  # noqa: E402

ZOO = ("gemma3-4b", "qwen2.5-32b", "minitron-8b", "moonshot-v1-16b-a3b",
       "dbrx-132b", "internvl2-2b")
VLM = "internvl2-2b"
MOE = ("moonshot-v1-16b-a3b", "dbrx-132b")
B, S, SEED = 2, 16, 0
_CACHE = {}


def _setup(arch):
    """The reference smoke model and its parameters, the port's loaded with
    them, and batch 0 on both sides."""
    if arch not in _CACHE:
        jm, m = j_get_smoke(arch), get_smoke_model(arch)
        params, _ = jm.init(jax.random.PRNGKey(SEED))
        net = m.init(SEED, "cpu")
        net.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray,
                                                            params)))
        tcfg = dict(vocab=jm.cfg.vocab, seq_len=S, batch=B)
        jb = j_token_batch(JTok(**tcfg), 0)
        tb = token_batch(TokenStreamConfig(**tcfg), 0, device="cpu")
        if jm.cfg.vlm_patches:
            pe = launch_train.batch_fn_for(m, B, S, "cpu")(0)["patch_embeds"]
            jb["patch_embeds"], tb["patch_embeds"] = jnp.asarray(pe.numpy()), pe
        _CACHE[arch] = dict(jm=jm, m=m, params=params, net=net, jb=jb, tb=tb)
    return _CACHE[arch]


def _close(got, want, rtol=1e-5, atol_frac=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _pd(tree):
    return torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(a)) for k, a in tree.items()})


# ---------------------------------------------------------------------------
# configurations and the registry
# ---------------------------------------------------------------------------

CFG_FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "hd", "act", "qkv_bias", "tie_embeddings",
              "rope_theta", "window", "window_pattern", "embed_scale",
              "vlm_patches", "vit_dim", "remat")


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ("gemma-2b",) + ZOO)
def test_config_matches_reference(arch, which):
    """Widths letter for letter, the MoE and VLM settings, dtype and the
    parameter counts; the settings the port leaves out are the reference's
    defaults for these archs."""
    jm, m = ((j_get_model(arch), get_model(arch)) if which == "full"
             else (j_get_smoke(arch), get_smoke_model(arch)))
    assert (m.name, m.family) == (jm.name, jm.family)
    for f in CFG_FIELDS:
        assert getattr(m.cfg, f) == getattr(jm.cfg, f), f
    assert (jm.cfg.norm, jm.cfg.softcap, jm.cfg.rope_scaling) == (
        "rmsnorm", None, 1.0)
    if jm.cfg.moe is None:
        assert m.cfg.moe is None
    else:
        assert dataclasses.asdict(m.cfg.moe) == dataclasses.asdict(jm.cfg.moe)
    assert str(m.cfg.dtype).split(".")[-1] == jnp.dtype(jm.cfg.dtype).name
    assert m.param_count == m.cfg.param_count == jm.param_count
    assert m.active_param_count == jm.active_param_count
    assert [m.cfg.layer_is_local(i) for i in range(m.cfg.n_layers)] == [
        jm.cfg.layer_is_local(i) for i in range(jm.cfg.n_layers)]


def test_registry_holds_the_dense_and_moe_families():
    """The registry holds every arch of the reference, in its order: the
    dense, MoE and VLM families (here), the SSM and hybrid ones
    (tests/test_torch_ssm.py) and the audio family
    (tests/test_torch_encdec.py)."""
    assert ARCH_IDS == J_ARCH_IDS
    assert set(ARCH_IDS) == {"gemma-2b", "mamba2-370m", "hymba-1.5b",
                             "whisper-small"} | set(ZOO)
    assert get_model("whisper-small").param_count == 238_450_944
    assert get_model("gemma3-4b").param_count == 3_879_907_840  # ~3.88 B
    assert get_model(VLM).param_count == 1_895_438_336  # the projector's in
    gemma3 = get_model("gemma3-4b").cfg
    assert [i for i in range(34) if not gemma3.layer_is_local(i)] == [
        5, 11, 17, 23, 29]


@pytest.mark.parametrize("arch", ZOO)
def test_parameter_tree_and_conversion(arch):
    """The port's parameters are the reference's tree (q/k/v biases, the
    untied head, relu2 without a gate, the MoE router, experts and shared
    experts, the VLM projector ``head.vit_proj1`` and ``.vit_proj2``), one
    block per layer; the conversion round-trips exactly."""
    st = _setup(arch)
    tree = jax.tree.map(np.asarray, st["params"])
    fresh = dict(st["m"].init(SEED, "cpu").named_parameters())
    conv = lm_params_from_jax(tree)
    assert conv.keys() == fresh.keys()
    for n, p in fresh.items():
        assert tuple(conv[n].shape) == tuple(p.shape), n
        assert conv[n].dtype == p.dtype, n
    back = lm_params_to_jax(dict(st["net"].named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gelu", "silu", "relu", "relu2", "tanh"])
def test_act_fn_matches_reference(name):
    x = _np((4, 33), 1, 3.0)
    _close(L.act_fn(name)(torch.from_numpy(x)), JL.act_fn(name)(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2"])
def test_mlp_kinds_match_reference(kind):
    jp, _ = JL.init_mlp(jax.random.PRNGKey(2), JL.MLPConfig(32, 64, kind),
                        jnp.float32)
    jp = {k: np.asarray(a) for k, a in jp.items()}
    net = L.init_mlp(L.Init(torch.Generator().manual_seed(0), "cpu",
                            torch.float32), 32, 64, kind)
    assert set(net) == set(jp)
    x = _np((2, 5, 32), 3)
    got = L.mlp(_pd(jp), torch.from_numpy(x), kind)
    _close(got.detach(), JL.mlp(jp, jnp.asarray(x), JL.MLPConfig(32, 64, kind)))


def test_attention_with_qkv_bias_matches_reference():
    cfg = JL.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                        qkv_bias=True)
    jp, _ = JL.init_attention(jax.random.PRNGKey(4), cfg, jnp.float32)
    jp = {k: np.asarray(a) for k, a in jp.items()}
    for i, b in enumerate(("bq", "bk", "bv")):  # the init's biases are zeros
        jp[b] = _np(jp[b].shape, 10 + i)
    x = _np((2, 7, 32), 5)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7)).copy()
    want, _ = JL.attention(jp, jnp.asarray(x), jnp.asarray(pos), cfg)
    tp = torch.from_numpy(pos)
    got, _ = L.attention(_pd(jp), torch.from_numpy(x), tp,
                         L.attention_mask(tp, tp), 4, 2, 8, 10_000.0)
    _close(got.detach(), want)


def test_windowed_mask_matches_reference():
    """gemma3's smoke window (8) at seq 2 x window: every layer's mask, a
    local layer's keeping the last 8 positions, layer 5's global."""
    cfg = get_smoke_model("gemma3-4b").cfg
    jcfg = j_get_smoke("gemma3-4b").cfg
    pos = torch.arange(2 * cfg.window)[None].expand(B, -1)
    masks = tf._masks(cfg, pos)
    for i in range(cfg.n_layers):
        want = JL.attention_mask(jnp.asarray(pos.numpy()),
                                 jnp.asarray(pos.numpy()),
                                 jcfg.attn_cfg(jcfg.window if
                                               jcfg.layer_is_local(i) else None))
        got = masks[cfg.layer_window(i)]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got[0, -1].sum()) == (8 if i != 5 else 16)


# ---------------------------------------------------------------------------
# the models: logits, losses and one dithered step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ZOO)
def test_logits_and_loss_match_reference(arch):
    st = _setup(arch)
    with torch.no_grad():
        got, aux = tf.forward_aux(st["net"], st["tb"]["tokens"],
                                  patch_embeds=st["tb"].get("patch_embeds"))
        loss = st["m"].loss(st["net"], st["tb"])
    want, jaux = st["jm"].forward(st["params"], st["jb"])
    prefix = st["m"].cfg.vlm_patches  # the visual prefix's positions
    assert tuple(got.shape) == (B, prefix + S, 512)
    _close(got, want)
    np.testing.assert_allclose(float(loss),
                               float(st["jm"].loss(st["params"], st["jb"])),
                               rtol=1e-5)
    if arch in MOE:
        assert abs(float(aux) - float(jaux)) <= 1e-6 and float(aux) > 0
    else:
        assert aux is None and float(jaux) == 0.0


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


@pytest.mark.parametrize("arch", ZOO)
def test_paper_step_gradients(arch, monkeypatch):
    """Step 0 of ``phase@0=paper`` (lm_head included) on both sides, the
    reference's draws and Delta fed: every parameter's gradient within
    relative L2 1e-5, and the same loss."""
    st = _setup(arch)
    spec = "phase@0=paper"
    jprog = jsched.parse_program(spec, JPolicy(s=2.0))
    prog = schedule.parse_program(spec, DitherPolicy(s=2.0))
    base = jax.random.fold_in(jax.random.PRNGKey(SEED), 0xD17E)
    jctx = JCtx.for_step(base, 0, jprog.phase_policy_at(0), program=jprog)
    ctx = FedCtx(prog.phase_policy_at(0), jctx, prog)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: st["jm"].loss(p, st["jb"], ctx=jctx)))(st["params"])
    _jnp_delta(monkeypatch)
    net = st["net"]
    net.zero_grad(set_to_none=True)
    loss = st["m"].loss(net, st["tb"], ctx=ctx)
    loss.backward()
    grads = lm_params_to_jax({n: p.grad for n, p in net.named_parameters()})
    net.zero_grad(set_to_none=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             jgrads))[0]
    for (path, want), got in zip(flat, jax.tree.leaves(grads)):
        assert np.isfinite(got).all()
        assert _rel_l2(got, want) <= 1e-5, (jax.tree_util.keystr(path),
                                            _rel_l2(got, want))


@pytest.mark.parametrize("arch", ZOO)
def test_dither_names_match_reference(arch):
    """The names the port's layers resolve equal the reference's
    (``discover_layer_names``): the router ``moe.router`` under every block,
    the experts ``L.moe.{gate,up,down}``, the shared ones
    ``L.moe.{sgate,sup,sdown}``, the VLM's projector ``vit_proj1`` and
    ``vit_proj2``."""
    st = _setup(arch)
    want = jsched.discover_layer_names(
        lambda p, b, ctx: st["jm"].loss(p, b, ctx=ctx), st["params"], st["jb"])
    seen = set()

    class Recording(DitherCtx):
        def resolve(self, name):
            seen.add(name)
            return super().resolve(name)

    st["m"].loss(st["net"], st["tb"],
                 ctx=Recording(DitherPolicy(variant="paper"), device="cpu"))
    assert sorted(seen) == want
    if arch in MOE:
        assert "moe.router" in seen and "L.moe.gate" in seen
    if arch == VLM:
        assert {"vit_proj1", "vit_proj2"} <= seen


# ---------------------------------------------------------------------------
# decoding: prefill, the windowed ring, MoE decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,prompt_len", [
    ("gemma3-4b", 5), ("gemma3-4b", 12), ("moonshot-v1-16b-a3b", 5),
    (VLM, 5)],
    ids=["gemma3-short", "gemma3-past_window", "moonshot", "internvl"])
def test_prefill_and_decode_match_reference(arch, prompt_len):
    """prefill on a prompt (shorter than gemma3's window of 8, or past it:
    the ring keeps the last 8 positions; internvl's behind its visual
    prefix of 8 projected patches), then 8 greedy decode steps (the ring
    wraps), against the reference's prefill and decode_step: each step's
    logits rtol 1e-5, the same greedy tokens, the same caches."""
    st = _setup(arch)
    jcfg, max_len = st["jm"].cfg, 32
    prompt = np.asarray(st["jb"]["tokens"])[:, :prompt_len]
    pe = st["tb"].get("patch_embeds")
    jl, jcache, jt = jtf.prefill(st["params"], jcfg, jnp.asarray(prompt),
                                 max_len, patch_embeds=st["jb"].get(
                                     "patch_embeds"))
    logits, cache, t = tf.prefill(st["net"], torch.from_numpy(prompt.astype(np.int64)),
                                  max_len, patch_embeds=pe)
    assert logits.shape[1] == prompt_len + jcfg.vlm_patches
    _close(logits, jl)
    assert t == int(jt)
    for (K, V), (jK, jV) in zip(cache, jcache):
        assert K.shape == jK.shape
        _close(K, jK)
        _close(V, jV)
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1))
    for _ in range(8):
        t += 1
        jl, jcache = jtf.decode_step(st["params"], jcfg, jcache,
                                     jnp.asarray(tok), jnp.asarray(t, jnp.int32))
        logits, cache = tf.decode_step(st["net"], cache,
                                       torch.from_numpy(tok.astype(np.int64)), t)
        _close(logits, jl)
        got_tok = torch.argmax(logits[:, -1:], -1).numpy()
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1))
        np.testing.assert_array_equal(got_tok, tok)
    assert t > jcfg.window if jcfg.window else True


@pytest.mark.parametrize("arch", ZOO)
def test_launcher_runs_the_smoke_preset(arch):
    """``repro_torch.launch.train --preset smoke --device cpu`` on the
    kernel program (the kernels' plain versions on the CPU): finite
    losses and no fallback."""
    ops.KERNEL_FALLBACKS.clear()
    trainer = launch_train.main(
        ["--arch", arch, "--preset", "smoke", "--steps", "2", "--batch", "2",
         "--seq", "16", "--device", "cpu", "--program",
         "dither: phase@0=off;phase@1=kernel;rule lm_head:off"])
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert not ops.KERNEL_FALLBACKS


@pytest.mark.parametrize("arch", ZOO)
def test_serve_launcher_serves(arch):
    sup = launch_serve.main(["--arch", arch, "--device", "cpu", "--requests",
                             "3", "--new-tokens", "4", "--max-len", "32"])
    h = sup.health()
    assert sum(w.finished for w in h) == 3


def test_windowed_engine_matches_greedy_generate_and_refuses_pages():
    """gemma3's smoke model in the engine on dense buffers, prompts longer
    than the window (the ring wraps during prefill chunks and decode):
    every request's tokens equal ``greedy_generate``'s; paged KV is
    refused with the reference's words."""
    st = _setup("gemma3-4b")
    m, net = st["m"], st["net"]
    with pytest.raises(ValueError, match="sliding-window ring buffers"):
        Engine(m, net, ServeConfig(max_batch=2, max_len=32, kv_page=4))
    eng = Engine(m, net, ServeConfig(max_batch=2, max_len=32, chunk=4))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n) for n in (11, 3, 9)]
    for i, p in enumerate(prompts):
        assert eng.submit(Request(uid=i, prompt=p, max_new_tokens=10))
    done = eng.run(max_ticks=64)
    assert sorted(done) == [0, 1, 2]
    for i, p in enumerate(prompts):
        assert done[i] == greedy_generate(m, net, p, 10, max_len=32), i


def test_vlm_engine_on_pages_and_greedy_generate_with_patches():
    """internvl2-2b's smoke model serves text in the engine on fp32 pages
    of 8, its tokens equal to ``greedy_generate``'s (its nsd pages run the
    same paged path as gemma-2b's, tests/test_torch_serve.py);
    ``greedy_generate`` hands ``patch_embeds`` to the prefill, whose tokens
    equal the reference's."""
    from repro.serve import greedy_generate as j_greedy
    st = _setup(VLM)
    m, net = st["m"], st["net"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n) for n in (11, 3, 9)]
    eng = Engine(m, net, ServeConfig(max_batch=2, max_len=32, chunk=4,
                                     kv_page=8))
    for i, p in enumerate(prompts):
        assert eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    done = eng.run(max_ticks=64)
    assert sorted(done) == [0, 1, 2]
    for i, p in enumerate(prompts):
        assert done[i] == greedy_generate(m, net, p, 6, max_len=32)
    pe = st["tb"]["patch_embeds"][:1]
    got = greedy_generate(m, net, prompts[0], 6, max_len=32, patch_embeds=pe)
    want = j_greedy(st["jm"], st["params"], prompts[0].astype(np.int32), 6,
                    max_len=32, patch_embeds=st["jb"]["patch_embeds"][:1])
    assert got == want


@pytest.mark.parametrize("arch", MOE)
def test_moe_engine_matches_reference_engine(arch):
    """The MoE smoke models in both engines at batch 4, chunk 4, five
    prompts of different lengths (the fifth waits for a slot). Each
    micro-step routes every slot's token, inactive slots included, with
    C = max(1, int(1.25 B k / E)), so the tokens depend on the batch:
    every request's tokens equal the reference engine's."""
    st = _setup(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n) for n in (11, 3, 9, 6, 13)]
    jeng = JEngine(st["jm"], st["params"],
                   JServeConfig(max_batch=4, max_len=32, chunk=4))
    eng = Engine(st["m"], st["net"], ServeConfig(max_batch=4, max_len=32,
                                                 chunk=4))
    for i, p in enumerate(prompts):
        assert jeng.submit(JRequest(uid=i, prompt=p.astype(np.int32),
                                    max_new_tokens=6))
        assert eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    want = jeng.run(max_ticks=64)
    assert sorted(want) == list(range(len(prompts)))
    assert eng.run(max_ticks=64) == want
