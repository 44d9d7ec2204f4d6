"""Port parity for the SSM and hybrid families (mamba2-370m, hymba-1.5b):
configurations, parameter trees, the chunked SSD scan, logits, losses,
paper-variant gradients, dither names, decoding (prefill, decode, the meta
bootstrap), the serving engine and the launchers, ``repro_torch`` against
``repro`` on the CPU.

The parity tests run mamba2-370m's smoke configuration and a test-local
hybrid from the reference's init draw (seed 0), converted with
``repro_torch.convert.lm_params_from_jax``, on the reference's token batch
0 at batch 2 x seq 16. hymba's smoke model has three layers, all global
(``global_layers()`` is (0, 1, 2)), so the hybrid held to the reference
is a ``HybridConfig`` at hymba's smoke widths with four layers (window 8,
4 meta tokens: layer 1 is local, 0, 2 and 3 global), built on both sides:
it runs every path of the 3-layer model and the windowed, prefix-pinned
one, with prompts that run past the window so that its ring wraps behind
the pinned meta slots. hymba's own smoke configuration is held to the
reference's field by field and runs the engine and the launchers.
Gradients take the reference's per-layer draw (fed through
``DitherCtx.unit_noise``) and its Delta (``jnp.std``, patched into
``nsd.compute_delta``), as tests/test_torch_zoo.py does.

Bands (f32). The numbers differ from the reference's without being wrong in
three places, each summed or rounded in another order: the f32 ``cumsum``
of the log-decays (up to 2e-6 absolute on sums of ~18: an ulp or two),
``F.softplus`` (its linear branch above 20, and ``log1p(exp(x))`` against
XLA's ``logaddexp``: an ulp) and the depthwise conv (ATen's or cuDNN's
order against XLA's over 4 taps). The scan's outputs stay within rtol
1e-5, atol 1e-6 of the largest, and its gradients within relative L2
1e-5 (one mixer: 8e-7 of the largest output). Through the models:
logits, losses and decode steps rtol 1e-5, atol 2e-6 of the largest
logit for mamba; the hybrid, whose two branches are each rescaled by an
RMS norm, rtol 2e-5, atol 1e-5 of the largest (measured up to 6e-6).
Decode caches (the SSM state, the conv window, K and V): rtol 1e-5, atol
1e-5 of the largest entry. Gradients, plain and first paper step:
relative L2 <= 1e-5 per parameter; the reference's f32 gradients are also
held within 1e-4 of the port's float64 ones, which ties the port's math
to the reference's apart from f32 rounding (hymba's 3-layer smoke model,
not held here, is ill-conditioned in f32: the reference's own gradients
are up to 1.9e-5 from a float64 evaluation, the port's up to 6.8e-5).
The scan's roundings move a cotangent by ~3e-6 relative, so a
dither index k that sits within 1e-3 of its rounding boundary may flip,
and one flip cascades into every layer below: the paper step checks that
each layer's cotangent is within relative L2 1e-5 of the reference's and
that every k that differs sat within 1e-3 of its boundary, then carries on
with the reference's quantized cotangent. The greedy tokens are equal.
The conversion round-trips exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_model as j_get_model, get_smoke_model as j_get_smoke  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy, nsd as jnsd  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data.synthetic import TokenStreamConfig as JTok, token_batch as j_token_batch  # noqa: E402
from repro.models import hybrid as jhy  # noqa: E402
from repro.models import mamba as jmb  # noqa: E402
from repro.models.api import hybrid_model as j_hybrid_model  # noqa: E402
from repro_torch.configs import get_model, get_smoke_model  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.core import nsd, schedule  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.data.synthetic import TokenStreamConfig, token_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import hybrid as hy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as mb  # noqa: E402
from repro_torch.models.api import hybrid_model  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig, greedy_generate  # noqa: E402

ARCHS = ("mamba2-370m", "hymba-1.5b")
LOCAL4 = "hymba-local4"  # the test-local 4-layer hybrid (layer 1 local)
PARITY = ("mamba2-370m", LOCAL4)  # the models held to the reference
B, S, SEED = 2, 16, 0
_CACHE = {}


def _local4(hcls, dtype):
    return hcls(name=LOCAL4, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=512, head_dim=16, d_state=8, expand=2,
                window=8, n_meta_tokens=4, dtype=dtype, remat=False)


def _setup(arch):
    """The reference model and its parameters, the port's loaded with them,
    and batch 0 on both sides."""
    if arch not in _CACHE:
        if arch == LOCAL4:
            jm = j_hybrid_model(_local4(jhy.HybridConfig, jnp.float32))
            m = hybrid_model(_local4(hy.HybridConfig, torch.float32))
        else:
            jm, m = j_get_smoke(arch), get_smoke_model(arch)
        params, _ = jm.init(jax.random.PRNGKey(SEED))
        net = m.init(SEED, "cpu")
        net.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray,
                                                            params)))
        tcfg = dict(vocab=jm.cfg.vocab, seq_len=S, batch=B)
        _CACHE[arch] = dict(jm=jm, m=m, params=params, net=net,
                            jb=j_token_batch(JTok(**tcfg), 0),
                            tb=token_batch(TokenStreamConfig(**tcfg), 0,
                                           device="cpu"))
    return _CACHE[arch]


def _ref_plain(arch):
    """The reference's logits, loss and plain gradients on batch 0, from
    one jitted evaluation shared by the tests."""
    st = _setup(arch)
    if "plain" not in st:
        def f(p):
            logits, _ = st["jm"].forward(p, st["jb"])
            return st["jm"].loss(p, st["jb"]), logits
        (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            st["params"])
        st["plain"] = dict(loss=float(loss), logits=np.asarray(logits),
                           grads=jax.tree.map(np.asarray, grads))
    return st["plain"]


def _close(got, want, rtol=1e-5, atol_frac=1e-6):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


def _logit_band(arch):
    """(rtol, atol_frac) of logits: the hybrid's two branches add their
    roundings."""
    return (1e-5, 2e-6) if arch == "mamba2-370m" else (2e-5, 1e-5)


CACHE_BAND = (1e-5, 1e-5)  # (rtol, atol_frac) of decode caches


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# configurations, the registry, the parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, which):
    """The config's fields letter for letter (the SSM's too), dtype and the
    parameter count; hymba's global layers (first, middle, last)."""
    jm, m = ((j_get_model(arch), get_model(arch)) if which == "full"
             else (j_get_smoke(arch), get_smoke_model(arch)))
    assert (m.name, m.family) == (jm.name, jm.family)
    jd, d = dataclasses.asdict(jm.cfg), dataclasses.asdict(m.cfg)
    for f in ("dtype", "scan_unroll"):
        jd.pop(f)
    d.pop("dtype")
    assert d == jd
    assert str(m.cfg.dtype).split(".")[-1] == jnp.dtype(jm.cfg.dtype).name
    assert m.param_count == m.cfg.param_count == jm.param_count
    assert m.active_param_count == jm.active_param_count
    if arch == "hymba-1.5b":
        assert dataclasses.asdict(m.cfg.ssm) == dataclasses.asdict(jm.cfg.ssm)
        assert m.cfg.global_layers() == jm.cfg.global_layers()
        n = m.cfg.n_layers
        assert [m.cfg.layer_is_local(i) for i in range(n)] == [
            jm.cfg.layer_is_local(i) for i in range(n)]
    if which == "full":
        assert m.param_count == {"mamba2-370m": 368_325_120,
                                 "hymba-1.5b": 1_589_976_896}[arch]


@pytest.mark.parametrize("arch", PARITY)
def test_parameter_tree_and_conversion(arch):
    """The port's parameters are the reference's tree (the nested ``mixer``,
    ``attn`` and ``mlp`` subtrees of the stacked layers, ``head.ln_f`` and
    ``head.meta_tokens``), one block per layer; the conversion round-trips
    exactly."""
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


def test_mixer_init_follows_the_reference_recipe():
    """The port's own draw: A_log = log(linspace(1, 16, H)), softplus(dt
    bias) within [dt_min, dt_max], conv bias and D zero, the norm one."""
    cfg = get_model("mamba2-370m").cfg.ssm
    p = mb.init_mamba_mixer(L.Init(torch.Generator().manual_seed(0), "cpu",
                                   torch.float32), cfg)
    np.testing.assert_allclose(p["A_log"].detach().numpy(), np.asarray(
        jnp.log(jnp.linspace(1.0, 16.0, cfg.n_heads))), rtol=1e-6)
    dt = torch.nn.functional.softplus(p["dt_bias"].detach())
    assert float(dt.min()) >= cfg.dt_min * (1 - 1e-5)
    assert float(dt.max()) <= cfg.dt_max * (1 + 1e-5)
    assert not p["conv_b"].any() and not p["D"].any()
    assert bool((p["norm"] == 1).all())


# ---------------------------------------------------------------------------
# the chunked SSD scan: tails (trap 3) and the masked exponent (trap 1)
# ---------------------------------------------------------------------------

def _ssd_inputs(S_len, H, G, P, N, seed, dt_scale):
    """x, dt (positive), A (-1 .. -16 over the heads), B, C as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S_len, H, P)).astype(np.float32)
    dt = (rng.random((2, S_len, H)) * dt_scale + dt_scale / 10
          ).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((2, S_len, G, N)).astype(np.float32)
    Cm = rng.standard_normal((2, S_len, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _ssd_grads_torch(inputs, cfg, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y, h = mb._ssd_chunked(ts[0], ts[1], ts[2], ts[3], ts[4], cfg)
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach().numpy(), h.detach().numpy(), [t.grad.numpy() for t in ts]


def _ssd_grads_jax(fn, inputs, cfg, cot):
    def f(*a):
        y, h = fn(*a, cfg)
        return jnp.sum(y * cot), (y, h)
    grads, (y, h) = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4),
                                     has_aux=True))(*map(jnp.asarray, inputs))
    return np.asarray(y), np.asarray(h), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("S_len", [5, 8, 19], ids=["below_Q", "equal_Q",
                                                   "past_Q_ragged"])
def test_ssd_chunked_tails_match_reference(S_len):
    """chunk Q = 8 at S below Q (one padded chunk: Q becomes S), equal to
    Q, and a non-multiple above Q (nc = 3, the tail padded, the cross-chunk
    recurrence run): outputs, the final state and every input's gradient
    against the reference's; 4 heads in 2 groups (B and C never repeated)."""
    cfg = mb.SSMConfig(d_model=32, d_inner=64, head_dim=16, d_state=8,
                       n_groups=2, chunk=8)
    jcfg = jmb.SSMConfig(d_model=32, d_inner=64, head_dim=16, d_state=8,
                         n_groups=2, chunk=8)
    inputs = _ssd_inputs(S_len, 4, 2, 16, 8, S_len, 0.05)
    cot = _np((2, S_len, 4, 16), 99)
    y, h, grads = _ssd_grads_torch(inputs, cfg, cot)
    jy, jh, jgrads = _ssd_grads_jax(jmb._ssd_chunked, inputs, jcfg, cot)
    assert y.shape == jy.shape == (2, S_len, 4, 16)
    _close(y, jy)
    _close(h, jh)
    for name, g, jg in zip(("x", "dt", "A", "B", "C"), grads, jgrads):
        assert np.isfinite(jg).all()
        assert _rel_l2(g, jg) <= 1e-5, (name, _rel_l2(g, jg))


def _ssd_masked_exp(x, dt, A, Bm, Cm, cfg):
    """The reference's ``_ssd_chunked`` (f32 operands, no initial state)
    with the within-chunk decay's exponent masked before the exp: the
    port's form, written here in JAX."""
    Bsz, S_len, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.chunk, S_len)
    assert S_len % Q == 0
    nc, rep = S_len // Q, H // G
    xc = x.reshape(Bsz, nc, Q, G, rep, Pd)
    dtc = dt.reshape(Bsz, nc, Q, G, rep)
    Bg = Bm.reshape(Bsz, nc, Q, G, N)
    Cg = Cm.reshape(Bsz, nc, Q, G, N)
    dA = dtc * A.reshape(G, rep)
    cum = jnp.cumsum(dA, axis=2)
    diff = cum[:, :, :, None] - cum[:, :, None, :, :, :]
    tri = jnp.tril(jnp.ones((Q, Q), bool))
    Lmat = jnp.exp(jnp.where(tri[None, None, :, :, None, None], diff,
                             -jnp.inf))
    scores = jnp.einsum("bcign,bcjgn->bcijg", Cg, Bg,
                        preferred_element_type=jnp.float32)
    M = scores[..., None] * Lmat * dtc[:, :, None, :, :, :]
    y_intra = jnp.einsum("bcijgr,bcjgrp->bcigrp", M, xc,
                         preferred_element_type=jnp.float32)
    decay_to_end = jnp.exp(cum[:, :, -1:] - cum)
    states = jnp.einsum("bcjgr,bcjgn,bcjgrp->bcgrnp", decay_to_end * dtc,
                        Bg, xc)
    chunk_decay = jnp.exp(jnp.sum(dA, axis=2))

    def scan_fn(h, inp):
        st, dec = inp
        return h * dec[:, :, :, None, None] + st, h

    h0 = jnp.zeros((Bsz, G, rep, N, Pd), jnp.float32)
    h_final, h_prev = jax.lax.scan(
        scan_fn, h0, (jnp.moveaxis(states, 1, 0),
                      jnp.moveaxis(chunk_decay, 1, 0)))
    h_prev = jnp.moveaxis(h_prev, 0, 1)
    y_inter = jnp.einsum("bcign,bcgrnp->bcigrp", Cg, h_prev,
                         preferred_element_type=jnp.float32)
    y_inter = y_inter * jnp.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S_len, H, Pd)
    return y, h_final.reshape(Bsz, H, N, Pd)


@pytest.mark.parametrize("dt_scale", [0.01, 0.5], ids=["finite", "overflow"])
def test_ssd_masked_exp_gradients(dt_scale):
    """Trap 1. At chunk 32 with A down to -16: at small dt the reference's
    gradients are finite and the port's equal them (relative L2 1e-5); at
    dt ~0.5 a chunk's summed decay passes 88, the reference's masked
    exp(cum_i - cum_j) (i < j) overflows to inf and its d dt is NaN. The
    test's JAX copy with the exponent masked first gives the reference's
    forward bit for bit, finite gradients (where the reference's are
    finite, within relative L2 1e-6 of them: the two jitted programs fuse
    differently), and the port's gradients equal its (relative L2 1e-5)
    and are finite."""
    cfg = mb.SSMConfig(d_model=32, d_inner=64, head_dim=16, d_state=8,
                       chunk=32)
    jcfg = jmb.SSMConfig(d_model=32, d_inner=64, head_dim=16, d_state=8,
                         chunk=32)
    inputs = _ssd_inputs(64, 4, 1, 16, 8, 7, dt_scale)
    cot = _np((2, 64, 4, 16), 98)
    y, h, grads = _ssd_grads_torch(inputs, cfg, cot)
    jy, jh, jgrads = _ssd_grads_jax(jmb._ssd_chunked, inputs, jcfg, cot)
    my, mh, mgrads = _ssd_grads_jax(_ssd_masked_exp, inputs, jcfg, cot)
    np.testing.assert_array_equal(my, jy)  # the masked form's forward
    np.testing.assert_array_equal(mh, jh)
    _close(y, jy)
    _close(h, jh)
    ref_finite = all(np.isfinite(g).all() for g in jgrads)
    assert ref_finite == (dt_scale == 0.01)
    if not ref_finite:
        assert not np.isfinite(jgrads[1]).all()  # the reference's d dt
    for name, g, jg, mg in zip(("x", "dt", "A", "B", "C"), grads, jgrads,
                               mgrads):
        assert np.isfinite(g).all() and np.isfinite(mg).all(), name
        assert _rel_l2(g, mg) <= 1e-5, (name, _rel_l2(g, mg))
        if ref_finite:  # the two jitted programs fuse differently
            assert _rel_l2(mg, jg) <= 1e-6, (name, _rel_l2(mg, jg))
            assert _rel_l2(g, jg) <= 1e-5, (name, _rel_l2(g, jg))


def test_causal_conv_matches_reference():
    x, w, b = _np((2, 11, 24), 1), _np((4, 24), 2), _np((24,), 3)
    got = mb._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    _close(got, jmb._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b)))


# ---------------------------------------------------------------------------
# the models: logits, losses, one dithered step, dither names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PARITY)
def test_logits_and_loss_match_reference(arch):
    st, ref = _setup(arch), _ref_plain(arch)
    with torch.no_grad():
        got = st["m"].forward(st["net"], st["tb"])
        loss = st["m"].loss(st["net"], st["tb"])
    assert tuple(got.shape) == (B, S, 512)
    _close(got, ref["logits"], *_logit_band(arch))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)


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


GRAD_BAND = 1e-5  # relative L2 of gradients and cotangents


def _grads(net):
    grads = lm_params_to_jax({n: p.grad for n, p in net.named_parameters()})
    net.zero_grad(set_to_none=True)
    return grads


def _compare_grads(grads, jgrads, band):
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             jgrads))[0]
    for (path, want), got in zip(flat, jax.tree.leaves(grads)):
        assert np.isfinite(got).all(), jax.tree_util.keystr(path)
        assert _rel_l2(got, want) <= band, (jax.tree_util.keystr(path),
                                            _rel_l2(got, want))


def _float64_copy(st):
    """The port's model with its parameters and dtype in float64."""
    import copy
    net = copy.deepcopy(st["net"]).double()
    cfg = dataclasses.replace(net.cfg, dtype=torch.float64)
    for mod in net.modules():
        if hasattr(mod, "cfg"):
            mod.cfg = cfg
    return net


@pytest.mark.parametrize("arch", PARITY)
def test_plain_gradients_match_reference(arch):
    """Plain backprop (no dither): every parameter's gradient (the mixer's
    in_proj, dt_bias and A_log through the SSD scan, the meta tokens)
    finite and within relative L2 1e-5 of the reference's, and the
    reference's within 1e-4 of the port's float64 evaluation."""
    st = _setup(arch)
    jgrads = _ref_plain(arch)["grads"]
    net = st["net"]
    net.zero_grad(set_to_none=True)
    st["m"].loss(net, st["tb"]).backward()
    _compare_grads(_grads(net), jgrads, GRAD_BAND)
    net64 = _float64_copy(st)
    st["m"].loss(net64, st["tb"]).backward()
    _compare_grads(jgrads, _grads(net64), 1e-4)


@pytest.mark.parametrize("arch", PARITY)
def test_paper_step_gradients(arch, monkeypatch):
    """Step 0 of ``phase@0=paper`` (lm_head included) on both sides, the
    reference's draws and Delta fed. Every dithered layer's cotangent
    (matched by name and call order) within relative L2 1e-5 of the
    reference's; each dither index that differs sat within 1e-3 of its
    rounding boundary (at most 4 a layer), and the layer carries on with
    the reference's quantized cotangent; then every parameter's gradient
    finite and within the band, and the same loss."""
    import repro.core.dithered as jdith
    import repro_torch.core.dithered as tdith
    st = _setup(arch)
    spec = "phase@0=paper"
    jprog = jsched.parse_program(spec, JPolicy(s=2.0))
    prog = schedule.parse_program(spec, DitherPolicy(s=2.0))
    base = jax.random.fold_in(jax.random.PRNGKey(SEED), 0xD17E)
    jctx = JCtx.for_step(base, 0, jprog.phase_policy_at(0), program=jprog)
    ctx = FedCtx(prog.phase_policy_at(0), jctx, prog)
    ref = {}  # name -> [(g, g~)] in backward order
    j_quantize = jdith.quantize_cotangent

    def recording(g, key, knobs, spec, name):
        out = j_quantize(g, key, knobs, spec, name)
        jax.debug.callback(lambda a, b: ref.setdefault(name, []).append(
            (np.asarray(a), np.asarray(b))), g, out)
        return out

    monkeypatch.setattr(jdith, "quantize_cotangent", recording)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: st["jm"].loss(p, st["jb"], ctx=jctx)))(st["params"])
    jax.effects_barrier()
    _jnp_delta(monkeypatch)
    t_quantize = tdith.quantize_cotangent
    flips = []

    def forced(g2d, u, pol, name):
        own = t_quantize(g2d, u, pol, name)
        jg, jgq = ref[name].pop(0)
        g = g2d.detach().numpy()
        assert _rel_l2(g, jg) <= GRAD_BAND, (name, _rel_l2(g, jg))
        delta = np.float64(nsd.compute_delta(g2d, pol.s))
        jdelta = np.float64(jnsd.compute_delta(jnp.asarray(jg), pol.s))
        r = (jg.astype(np.float64) + u.numpy() * jdelta) / jdelta + 0.5
        differ = (np.rint(own.detach().numpy() / delta)
                  != np.rint(jgq / jdelta))
        dist = np.abs(r - np.round(r))[differ]
        assert (dist < 1e-3).all() and differ.sum() <= 4, (name, dist)
        flips.append(int(differ.sum()))
        return torch.from_numpy(np.array(jgq))

    monkeypatch.setattr(tdith, "quantize_cotangent", forced)
    net = st["net"]
    net.zero_grad(set_to_none=True)
    loss = st["m"].loss(net, st["tb"], ctx=ctx)
    loss.backward()
    assert not any(ref.values())  # every reference call consumed
    assert len(flips) == (2 if arch == "mamba2-370m" else 9) * len(
        net.layers) + 1  # every dithered product, lm_head included
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _compare_grads(_grads(net), jgrads, GRAD_BAND)


@pytest.mark.parametrize("arch", PARITY)
def test_dither_names_match_reference(arch):
    """Trap 5: the names the port's layers resolve equal the reference's
    (``discover_layer_names``): ``L.ssm.in`` / ``L.ssm.out`` under the one
    block tag (and the hybrid's ``L.attn.*``, ``L.mlp.*``), ``lm_head``."""
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
    assert {"L.ssm.in", "L.ssm.out", "lm_head"} <= seen


# ---------------------------------------------------------------------------
# decoding: prefill, decode, the meta bootstrap, the windowed prefix
# ---------------------------------------------------------------------------

def _close_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == np.asarray(w).shape
        _close(g, w, *CACHE_BAND)


def _as_jax_tree(cache):
    """The port's cache as the reference's pytree layout (lists, dicts,
    (K, V) tuples) of numpy arrays."""
    return jax.tree.map(lambda t: t.numpy(), cache)


def test_bootstrap_cache_matches_reference():
    """The meta tokens replayed through the decode step: every layer's K,
    V (the local layer's pinned prefix slots included) and SSM state, on
    the 4-layer hybrid (hymba's smoke widths, its three global layers'
    paths and a local one)."""
    st = _setup(LOCAL4)
    want = jhy.bootstrap_cache(st["params"], st["jm"].cfg, B, 24)
    got = hy.bootstrap_cache(st["net"], B, 24)
    assert [c["kv"][0].shape[1] for c in got] == [
        c["kv"][0].shape[1] for c in want]
    _close_tree(_as_jax_tree(got), want)


@pytest.mark.parametrize("arch,prompt_len", [
    ("mamba2-370m", 6), (LOCAL4, 11)],
    ids=["mamba", "hymba_local4_past_window"])
def test_prefill_and_decode_match_reference(arch, prompt_len):
    """prefill on a prompt, then 8 greedy decode steps, against the
    reference's prefill and decode_step: logits rtol 1e-5 each step, the
    same greedy tokens, the same caches and t. The 4-layer hybrid's prompt
    of 11 + 8 tokens runs past its window of 8: its local layer's ring
    wraps behind the 4 pinned meta slots."""
    st = _setup(arch)
    jm, max_len = st["jm"], 32
    prompt = np.asarray(st["jb"]["tokens"])[:, :prompt_len]
    jl, jcache, jt = jm.prefill(st["params"], jnp.asarray(prompt), max_len)
    logits, cache, t = st["m"].prefill(
        st["net"], torch.from_numpy(prompt.astype(np.int64)), max_len)
    band = _logit_band(arch)
    _close(logits, jl, *band)
    assert t == int(jt)
    _close_tree(_as_jax_tree(cache), jcache)
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1))
    j_decode = jax.jit(jm.decode_step)
    for _ in range(8):
        t += 1
        jl, jcache = j_decode(st["params"], jcache, jnp.asarray(tok),
                              jnp.asarray(t, jnp.int32))
        logits, cache = st["m"].decode_step(
            st["net"], cache, torch.from_numpy(tok.astype(np.int64)), t)
        _close(logits, jl, *band)
        got_tok = torch.argmax(logits[:, -1:], -1).numpy()
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1))
        np.testing.assert_array_equal(got_tok, tok)
    _close_tree(_as_jax_tree(cache), jcache)
    if arch == LOCAL4:
        cfg = st["m"].cfg
        assert t - cfg.n_meta_tokens > cfg.window
        assert cache[1]["kv"][0].shape[1] == cfg.window + cfg.n_meta_tokens


@pytest.mark.parametrize("t", [-1, 0, 3, 4, 9, 12, 13, 30])
def test_prefix_ring_helpers_match_reference(t):
    """The ring with a pinned prefix (12 slots: 4 pinned, a ring of 8) and
    the windowed mask with ``prefix_len``."""
    from repro.models import layers as JL
    tt = torch.tensor(t)
    assert int(L.ring_write_slot(tt, 12, 4)) == int(
        JL.ring_write_slot(jnp.asarray(t), 12, 4))
    pos, valid = L.ring_slot_positions(tt, 12, 4)
    jpos, jvalid = JL.ring_slot_positions(jnp.asarray(t), 12, 4)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    q = np.arange(20)[None]
    cfg = JL.AttnConfig(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
                        window=8, prefix_len=4)
    np.testing.assert_array_equal(
        L.attention_mask(torch.from_numpy(q), torch.from_numpy(q), window=8,
                         prefix_len=4).numpy(),
        np.asarray(JL.attention_mask(jnp.asarray(q), jnp.asarray(q), cfg)))


# ---------------------------------------------------------------------------
# the engine and the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + (LOCAL4,))
def test_engine_matches_greedy_generate(arch):
    """The engine on dense state (batch 2, chunk 4, three prompts, the
    third waiting for a slot, so that a slot is reset to its template),
    the port's own seed-0 draw: every request's tokens equal
    ``greedy_generate``'s. The 4-layer hybrid's prompts and outputs run
    past its window. Paged KV is refused with the reference's words."""
    m = (hybrid_model(_local4(hy.HybridConfig, torch.float32))
         if arch == LOCAL4 else get_smoke_model(arch))
    net = m.init(SEED, "cpu")
    with pytest.raises(ValueError, match=r"paged KV needs per-layer \(K, V\)"):
        Engine(m, net, ServeConfig(max_batch=2, max_len=32, kv_page=4))
    eng = Engine(m, net, ServeConfig(max_batch=2, max_len=32, chunk=4))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n) for n in (11, 3, 9)]
    for i, p in enumerate(prompts):
        assert eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
    done = eng.run(max_ticks=64)
    assert sorted(done) == [0, 1, 2]
    for i, p in enumerate(prompts):
        assert done[i] == greedy_generate(m, net, p, 8, max_len=32), i


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_serves(arch):
    sup = launch_serve.main(["--arch", arch, "--device", "cpu", "--requests",
                             "3", "--new-tokens", "4", "--max-len", "32"])
    assert sum(w.finished for w in sup.health()) == 3
