"""Port parity for the dense LM (gemma-2b's family): the token stream, the
configurations, the layers, the model and one dithered training step's
gradients, ``repro_torch`` against ``repro`` on the CPU.

Both sides run gemma-2b's smoke configuration (2 layers, d 128, 4 heads
with one KV head, GeGLU d_ff 256, vocab 512, f32) from the same
parameters: the reference's ``init_lm`` draw, converted with
``repro_torch.convert.lm_params_from_jax`` (threefry draws cannot be
reproduced in torch). A dithered step takes the reference's per-layer draw
(``DitherCtx.key_for(name)``, fed through the port's ``unit_noise``) and
the reference's Delta (``jnp.std``, patched into ``nsd.compute_delta``),
as tests/test_torch_models.py does: ``torch.std`` rounds differently, and a
k that sits on a rounding boundary would flip.

Bands (f32). Layers and logits: rtol 1e-5 (atol 1e-6 of the largest
entry); the same math summed in another order. Step-1 gradients under the
paper and kernel variants: rel L2 <= 1e-5 per parameter (measured <= 6e-7;
with the draw and Delta fed, no k flips on these inputs, so only rounding
differs). The kernel variant's k is bit-exact per dense layer when the
reference's cotangent is fed. bf16 (the full configuration's dtype, at
smoke size): under plain backprop logits within rel L2 2e-2 and gradients
within 3e-2 (measured 0.9% and <= 1.4%: bf16 rounds at other places in the
two frameworks, 2^-8 relative a rounding); one dithered dense's kernel
backward in bf16 equal to the reference's on the same cotangent.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_model as j_get_model, get_smoke_model as j_get_smoke  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy, dense as j_dense, nsd as jnsd  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data.synthetic import TokenStreamConfig as JTok, token_batch as j_token_batch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import lm_model as j_lm_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_model, get_smoke_model  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.core import dithered, nsd, schedule  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.data.synthetic import TokenStreamConfig, token_batch  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import lm_model  # noqa: E402

ARCH, B, S, SEED = "gemma-2b", 2, 16, 0
_CACHE = {}


def _setup(dtype="f32"):
    """The reference smoke model and its parameters, the port's model loaded
    with them, and batch 0 on both sides."""
    if dtype not in _CACHE:
        jm, m = j_get_smoke(ARCH), get_smoke_model(ARCH)
        if dtype == "bf16":
            jm = j_lm_model(dataclasses.replace(jm.cfg, dtype=jnp.bfloat16),
                            "dense")
            m = lm_model(dataclasses.replace(m.cfg, dtype=torch.bfloat16),
                         "dense")
        params, _ = jm.init(jax.random.PRNGKey(SEED))
        net = m.init(SEED, "cpu")
        net.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray,
                                                            params)))
        tcfg = dict(vocab=jm.cfg.vocab, seq_len=S, batch=B)
        _CACHE[dtype] = dict(jm=jm, m=m, params=params, net=net,
                             jb=j_token_batch(JTok(**tcfg), 0),
                             tb=token_batch(TokenStreamConfig(**tcfg), 0,
                                            device="cpu"))
    return _CACHE[dtype]


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


# ---------------------------------------------------------------------------
# data and configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,step", [
    (dict(vocab=512, seq_len=16, batch=2), 0),
    (dict(vocab=512, seq_len=16, batch=2), 7),
    (dict(vocab=256000, seq_len=128, batch=8), 3),
    (dict(vocab=1000, seq_len=33, batch=3, seed=5, zipf_a=1.5), 2)])
def test_token_batch_matches_reference(cfg, step):
    want = j_token_batch(JTok(**cfg), step)
    got = token_batch(TokenStreamConfig(**cfg), step, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_gemma_config_matches_reference(which):
    jm, m = ((j_get_model(ARCH), get_model(ARCH)) if which == "full"
             else (j_get_smoke(ARCH), get_smoke_model(ARCH)))
    assert (m.name, m.family) == (jm.name, jm.family)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "hd", "rope_theta", "embed_scale", "remat"):
        assert getattr(m.cfg, f) == getattr(jm.cfg, f), f
    # the settings the port's block builds in (GeGLU, tied, no window, no
    # soft-cap, dense, text only) are the reference's for gemma-2b
    assert (jm.cfg.act, jm.cfg.tie_embeddings, jm.cfg.window, jm.cfg.softcap,
            jm.cfg.moe, jm.cfg.vlm_patches) == ("geglu", True, None, None,
                                                None, 0)
    assert str(m.cfg.dtype).split(".")[-1] == jnp.dtype(jm.cfg.dtype).name
    assert m.param_count == m.cfg.param_count == jm.param_count
    if which == "full":
        assert m.param_count == 2_506_172_416  # about 2.51 B
    assert set(ARCH_IDS) <= set(J_ARCH_IDS)


def test_parameter_tree_and_conversion():
    """The port's parameters are the reference's tree, one block per layer;
    the conversion round-trips it exactly."""
    st = _setup()
    tree = jax.tree.map(np.asarray, st["params"])
    fresh = dict(get_smoke_model(ARCH).init(SEED, "cpu").named_parameters())
    conv = lm_params_from_jax(tree)
    assert conv.keys() == fresh.keys()
    for n, p in fresh.items():
        assert tuple(conv[n].shape) == tuple(p.shape) and conv[n].dtype == p.dtype
    back = lm_params_to_jax(dict(st["net"].named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_init_draws_the_reference_distribution():
    """Weights normal(0, 1/sqrt(fan_in)), the table normal(0, 0.02), norm
    scales ones: each parameter's std within 10% of the reference's draw's
    (different generators, same distribution)."""
    ref = lm_params_from_jax(jax.tree.map(np.asarray, _setup()["params"]))
    net = get_smoke_model(ARCH).init(1, "cpu")
    for n, p in net.named_parameters():
        want = ref[n]
        if n.endswith(("ln1", "ln2", "ln_f")):
            assert torch.equal(p, want), n
            continue
        assert abs(float(p.detach().std()) / float(want.std()) - 1) < 0.1, n
        assert abs(float(p.detach().mean())) < 4 * float(want.std()) / p.numel() ** 0.5, n
    a = get_smoke_model(ARCH).init(7, "cpu").state_dict()
    b = get_smoke_model(ARCH).init(7, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# layers (f32)
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    x, s = _np((2, 5, 64), 1, 3.0), _np((64,), 2)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("shape", [(2, 16, 4, 32), (1, 9, 1, 256)])
def test_apply_rope_matches_reference(shape):
    x = _np(shape, 3)
    pos = np.broadcast_to(np.arange(shape[1])[None], shape[:2])
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy())),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos)))


def test_attention_mask_is_causal():
    pos = torch.arange(6)[None].expand(2, 6)
    got = L.attention_mask(pos, pos)
    cfg = JL.AttnConfig(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4)
    want = JL.attention_mask(jnp.asarray(pos.numpy()), jnp.asarray(pos.numpy()),
                             cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("heads,kv", [(4, 1), (8, 1), (4, 2), (4, 4)],
                         ids=["mqa4", "mqa8", "gqa", "mha"])
def test_sdpa_matches_reference(heads, kv):
    q, k, v = _np((2, 7, heads, 16), 4), _np((2, 7, kv, 16), 5), _np((2, 7, kv, 16), 6)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7))
    mask = np.asarray(pos[:, None, :] <= pos[:, :, None])
    got = L._sdpa(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    want = JL._sdpa(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    _close(got, want)


def test_geglu_mlp_matches_reference():
    p = {"w_gate": _np((32, 64), 7, 0.2), "w_up": _np((32, 64), 8, 0.2),
         "w_down": _np((64, 32), 9, 0.1)}
    x = _np((2, 5, 32), 10)
    got = L.mlp(torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(a)) for k, a in p.items()}),
        torch.from_numpy(x), "geglu")
    want = JL.mlp({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                  JL.MLPConfig(32, 64, "geglu"))
    _close(got.detach(), want)


def test_embed_and_tied_unembed_match_reference():
    table, x = _np((50, 16), 11, 0.02), _np((2, 3, 16), 12)
    tok = np.array([[0, 7, 49], [3, 3, 1]])
    np.testing.assert_array_equal(
        L.embed(torch.from_numpy(table), torch.from_numpy(tok)).numpy(),
        np.asarray(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(tok))))
    _close(L.unembed(torch.from_numpy(table), torch.from_numpy(x)),
           JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the model and one dithered step
# ---------------------------------------------------------------------------

def test_logits_and_loss_match_reference():
    st = _setup()
    with torch.no_grad():
        got = st["m"].forward(st["net"], st["tb"])
        loss = st["m"].loss(st["net"], st["tb"])
    want, _ = st["jm"].forward(st["params"], st["jb"])
    assert tuple(got.shape) == (B, S, 512)
    _close(got, want)
    np.testing.assert_allclose(float(loss),
                               float(st["jm"].loss(st["params"], st["jb"])),
                               rtol=1e-6)


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


def _step_contexts(spec):
    """Step 0's micro-batch-0 contexts of the program ``spec`` over a paper
    base, as the two trainers build them."""
    jprog = jsched.parse_program(spec, JPolicy(s=2.0))
    prog = schedule.parse_program(spec, DitherPolicy(s=2.0))
    base = jax.random.fold_in(jax.random.PRNGKey(SEED), 0xD17E)
    jctx = JCtx.for_step(base, 0, jprog.phase_policy_at(0), program=jprog)
    jctx = jctx.with_key(jax.random.fold_in(jctx.key, 0))
    return jctx, FedCtx(prog.phase_policy_at(0), jctx, prog)


def _step_grads(variant, monkeypatch, record=None):
    """Step 1 of the program ``phase@0=<variant>`` on both sides: the
    reference's gradients and the port's, as reference-shaped trees."""
    st = _setup()
    jctx, ctx = _step_contexts(f"phase@0={variant}")
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
    grads = lm_params_to_jax({n: p.grad for n, p in net.named_parameters()})
    net.zero_grad(set_to_none=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    return jax.tree.map(np.asarray, jgrads), grads


def _hold(jgrads, grads, band=1e-5):
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, want), got in zip(flat, jax.tree.leaves(grads)):
        assert np.isfinite(got).all()
        assert _rel_l2(got, want) <= band, jax.tree_util.keystr(path)


def test_paper_step_gradients(monkeypatch):
    _hold(*_step_grads("paper", monkeypatch))


def test_kernel_step_gradients_and_k_per_dense(monkeypatch):
    """The kernel variant: the port's kernels' plain versions against the
    reference's Pallas kernels (interpret mode). Every dense (2 blocks x 7
    and lm_head) quantizes once; fed the reference's cotangent, draw and
    Delta, the port's k equals the reference's kernel's, element for
    element."""
    record = []
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    jgrads, grads = _step_grads("kernel", monkeypatch, record)
    _hold(jgrads, grads)
    assert not ops.KERNEL_FALLBACKS and not any(build.LAUNCHES.values())
    assert len(record) == 2 * 7 + 1
    for g2d, key, k_ref in record:
        T, N = g2d.shape
        u = jax.random.uniform(jax.random.wrap_key_data(key), (T, N),
                               jnp.float32, -0.5, 0.5)
        q = ops.quantize_and_mask(torch.from_numpy(g2d.copy()),
                                  torch.from_numpy(np.array(u)), 2.0)
        np.testing.assert_array_equal(q.k[:T, :N].numpy(), k_ref[:T, :N])


def test_dither_names_match_reference():
    """The names the port's layers resolve equal the reference's (its
    ``discover_layer_names``): every block's layers under the scan tag L."""
    st = _setup()
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
        [f"L.attn.{p}" for p in "qkvo"]
        + [f"L.mlp.{p}" for p in ("gate", "up", "down")] + ["lm_head"])


def test_bf16_logits_and_gradients_within_band():
    st = _setup("bf16")
    net = st["net"]
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    jloss, jgrads = jax.value_and_grad(
        lambda p: st["jm"].loss(p, st["jb"]))(st["params"])
    want, _ = st["jm"].forward(st["params"], st["jb"])
    with torch.no_grad():
        got = st["m"].forward(net, st["tb"])
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got.float().numpy(), np.asarray(want, np.float32)) <= 2e-2
    net.zero_grad(set_to_none=True)
    loss = st["m"].loss(net, st["tb"])
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jloss)) <= 1e-3
    grads = lm_params_to_jax({n: p.grad for n, p in net.named_parameters()})
    net.zero_grad(set_to_none=True)
    _hold(jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads), grads,
          band=3e-2)


def test_bf16_kernel_dense_backward_matches_reference(monkeypatch):
    """One dithered dense of bf16 x (T, K) and w (K, N) under the kernel
    variant, fed the same cotangent, draw and Delta: dx and dW in bf16 as
    the reference's (int8 products exact, the f32 rescale and the bf16
    cast the same)."""
    x, w = _np((64, 96), 13), _np((96, 160), 14, 0.1)
    g = _np((64, 160), 15, 1e-2)
    key = jax.random.PRNGKey(3)
    jctx = JCtx(key=key, policy=JPolicy(variant="kernel"))
    xb, wb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))
    _, vjp = jax.vjp(lambda a, b: j_dense(a, b, ctx=jctx, name="fc"), xb, wb)
    jdx, jdw = vjp(gb)
    _jnp_delta(monkeypatch)
    ctx = FedCtx(DitherPolicy(variant="kernel"), jctx, None)
    xt, wt = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (x, w))
    dithered.dense(xt, wt, ctx=ctx, name="fc").backward(
        torch.from_numpy(np.asarray(gb, np.float32)).to(torch.bfloat16))
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(jdx, np.float32))
    np.testing.assert_array_equal(wt.grad.float().numpy(),
                                  np.asarray(jdw, np.float32))
