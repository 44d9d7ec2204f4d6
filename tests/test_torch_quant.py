"""Port parity for the rest of the quant engine and its callers against
``repro.quant``, ``repro.optim``, ``repro.core`` and ``repro.launch`` on the
CPU: the int8_absmax, int4, m8 and u8 codecs, the ``quant:`` program, AdamW
and SGD with encoded moments, the cotangent codec (``grad_codec``) in the
dithered ops and through a program, the launcher's ``quant:`` section, and
the quant bench's registry race.

Tolerances. The codecs run the reference's f32 operations in its order
(true divisions, round half to even): codes, scales, decodes, byte counts
and error bounds are equal bit for bit. The optimizer's update is the
reference's f32 arithmetic, but XLA may contract b * m + (1 - b) * g into
one rounding where torch rounds twice (tests/test_torch_trainer.py holds the
f32 moments at rtol 1e-6), so a moment that lands within an ulp of a code
boundary may take the neighbouring code: per moment at most one code in
1,000 may differ, by one, and the parameters stay within rtol 1e-5 (atol
1e-7) over 3 steps. The grad-codec ops keep tests/test_torch_variants.py's
bands for f32 products (rtol 1e-4, atol 1e-5 of the largest entry); the
cotangent codes and telemetry rows are equal. The launcher run keeps
tests/test_torch_trainer.py's bands for plain backprop (int4 draws no
noise): loss within 1e-4 and final parameters within rel L2 1e-4
(measured 1e-6 and 2.2e-5), with the reference's quantized cotangents fed
after its codes are checked (the test's docstring says how).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.configs import get_smoke_model as j_get_smoke  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy  # noqa: E402
from repro.core import conv2d as jconv2d, dense as jdense  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data.synthetic import TokenStreamConfig as JTok, token_batch as j_token_batch  # noqa: E402
from repro.memory import parse_memory_program as j_parse_memory  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.optim import OptConfig as JOpt, apply_updates as j_apply, init_opt_state as j_init  # noqa: E402
from repro.train import Trainer as JTrainer, TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.bench import SuiteRun  # noqa: E402
from repro_torch.bench.compare import compare_result  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.core import dithered, schedule  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.kernels import nsd_quant, ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.memory.policy import parse_memory_program  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.train import quant_bench  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NEW_CODECS = ("int8_absmax", "int4", "int4@g64", "m8", "u8")


def _np(shape, seed, scale=1.0):
    return np.asarray(np.random.default_rng(seed).standard_normal(shape)
                      * scale, np.float32)


def _draw(key, shape):
    return np.array(jax.random.uniform(key, tuple(shape), jnp.float32,
                                       -0.5, 0.5))


def _fields(enc):
    """An encoding's tensors by field name, as numpy."""
    names = (enc._fields if isinstance(enc, tuple)
             else [f.name for f in dataclasses.fields(enc)])
    return {n: np.array(getattr(enc, n)) for n in names
            if not isinstance(getattr(enc, n), (tuple, str))}


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------

SHAPES = {"wide": (64, 256), "1d": (37,), "0d": (), "zeros": (4, 6),
          "3d": (3, 4, 10)}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("mode", NEW_CODECS)
def test_codec_matches_reference(mode, shape):
    """Codes, scales, decode, stored bytes and the error bound, equal bit
    for bit (int8_absmax here rounds to nearest: no noise)."""
    x = np.asarray(_np(SHAPES[shape], 3, 3.0) * (shape != "zeros"), np.float32)
    if mode == "u8":
        x = np.asarray(np.square(x))
    enc_t = quant.encode(mode, torch.from_numpy(x))
    # eager: under jit XLA may turn x / scale into x * (1 / scale)
    enc_j = jquant.encode(mode, jnp.asarray(x))
    dec_j, bound_j = jquant.decode(mode, enc_j), jquant.error_bound(mode, enc_j)
    ft, fj = _fields(enc_t), _fields(enc_j)
    assert ft.keys() == fj.keys()
    if "packed" in ft:
        # an all-zero group: the reference divides 0 by its flushed scale 0
        # and casts the NaN to code 0 (q = -8, times 0); the port stores
        # code 8 (q = 0) for both nibbles. Both decode to zeros.
        flushed = fj["scale"][:, 0] == 0
        assert np.all(ft["packed"][flushed] == 0x88)
        fj["packed"][flushed] = 0x88
    for n in ft:
        assert ft[n].dtype == fj[n].dtype and ft[n].shape == fj[n].shape, n
        np.testing.assert_array_equal(_ftz(ft[n]), fj[n], err_msg=n)
    np.testing.assert_array_equal(quant.decode(mode, enc_t).numpy(),
                                  np.asarray(dec_j))
    np.testing.assert_array_equal(_ftz(quant.error_bound(mode, enc_t).numpy()),
                                  np.asarray(bound_j))
    assert (quant.stored_nbytes(mode, x.shape, torch.float32)
            == quant.capacity_bytes(mode, enc_t)
            == jquant.stored_nbytes(mode, x.shape, jnp.float32)
            == jquant.capacity_bytes(mode, enc_j))
    assert quant.parse_spec(mode) == _spec(jquant.parse_spec(mode))


def _ftz(a):
    """``a`` with subnormals flushed to zero, as XLA's CPU code flushes
    them. An all-zero row's scale is tiny / 127 (/ 255, / 7), a subnormal
    that the reference stores as 0 and torch keeps; its codes and decoded
    values are 0 on both sides."""
    a = np.array(a)
    if a.dtype == np.float32:
        a[np.abs(a) < np.finfo(np.float32).tiny] = 0.0
    return a


def _spec(jspec):
    return quant.QuantSpec(**dataclasses.asdict(jspec))


@pytest.mark.parametrize("shape", [(40, 24), (3, 5, 7)], ids=str)
def test_int8_absmax_stochastic_rounding_with_fed_noise(shape):
    """The reference's uniform fed as the unit draw: the same codes; the
    codec front door hands the draw through; the bound holds."""
    x = _np(shape, 4)
    key = jax.random.PRNGKey(7)
    u = torch.from_numpy(_draw(key, shape))
    want = jquant.absmax_int8(jnp.asarray(x), key)
    got = quant.absmax_int8(torch.from_numpy(x), u)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert float(got.scale) == float(want.scale)
    enc = quant.encode("int8_absmax", torch.from_numpy(x), u)
    np.testing.assert_array_equal(enc.q.numpy(), np.asarray(want.q))
    dec = quant.decode("int8_absmax", enc).numpy()
    assert np.all(np.abs(dec - x) <= quant.error_bound("int8_absmax", enc).numpy())
    # a stream key draws on the codec's side: the same numbers as its tensor
    by_key = quant.absmax_int8(torch.from_numpy(x), 12345)
    fed = quant.absmax_int8(torch.from_numpy(x), nsd_quant.philox_uniform(
        12345, shape, device="cpu"))
    assert torch.equal(by_key.q, fed.q)


def test_registry_matches_reference():
    assert quant.codec_names() == jquant.codec_names()
    for spec in ("int4@g32", "int4@g8", "m8", "nsd@0.5", "int8_absmax"):
        assert quant.validate_spec(spec) == jquant.validate_spec(spec) == spec
        assert (quant.get_codec(quant.parse_spec(spec).codec).needs_noise
                == jquant.get_codec(jquant.parse_spec(spec).codec).needs_key)
    for bad in ("int4@g3", "int4@g0", "m8@1", "u8@x", "int5", "int8_absmax@2"):
        with pytest.raises(ValueError) as ej:
            jquant.validate_spec(bad)
        with pytest.raises(ValueError) as et:
            quant.validate_spec(bad)
        assert str(et.value) == str(ej.value)
    assert quant.takes_noise("int8_absmax") and not quant.needs_noise("int8_absmax")
    assert not quant.takes_noise("m8") and quant.takes_noise("nsd")
    with pytest.raises(NotImplementedError, match="'int4'"):
        quant.get_codec("int4").compute_on_packed(quant.parse_spec("int4"), None)


def test_nsd_error_bound_and_fakequant_match_reference():
    """nsd's bound (Delta per element), and the registry's decode equal to
    the NSD fake-quant with the same draw (the bench's zero-width row)."""
    x = _np((9, 70), 5)
    key = jquant.resid_key(jax.random.PRNGKey(2))
    u = torch.from_numpy(_draw(key, x.shape))
    enc_t = quant.encode("nsd@0.5", torch.from_numpy(x), u)
    enc_j = jquant.encode("nsd@0.5", jnp.asarray(x), key)
    bound = quant.error_bound("nsd@0.5", enc_t)
    assert torch.equal(bound, enc_t.deltas[0].expand(x.shape))
    # Delta is torch.std's, within 1e-5 of jnp.std's (test_torch_memory.py)
    np.testing.assert_allclose(bound.numpy(), np.asarray(
        jquant.error_bound("nsd@0.5", enc_j)), rtol=1e-5)
    np.testing.assert_array_equal(
        quant.decode("nsd@0.5", enc_t).numpy(),
        quant.nsd_fakequant(torch.from_numpy(x), u, 0.5).numpy())
    assert quant.error_bound("fp32", torch.from_numpy(x)) is None


# ---------------------------------------------------------------------------
# the quant: program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "", "grad=int4@g32;mu=m8;nu=u8", " resid = int8 ; wire=nsd@1 ",
    "nu=int4@g64;grad=int8_absmax;resid=nsd"])
def test_parse_quant_program_matches_reference(spec):
    got, want = quant.parse_quant_program(spec), jquant.parse_quant_program(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert bool(got) == bool(want)
    text = quant.format_quant_program(got)
    assert text == jquant.format_quant_program(want)
    assert quant.parse_quant_program(text) == got


@pytest.mark.parametrize("spec", [
    "bogus=m8", "mu", "mu=", "mu=m8;mu=u8", "grad=nope", "mu=nsd",
    "nu=nsd@0.5", "grad=int4@g3"])
def test_quant_program_errors_match_reference(spec):
    with pytest.raises(ValueError) as ej:
        jquant.parse_quant_program(spec)
    with pytest.raises(ValueError) as et:
        quant.parse_quant_program(spec)
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the optimizer with encoded moments
# ---------------------------------------------------------------------------

OPT_SHAPES = {"w": (6, 40), "b": (40,), "emb": (11, 8), "s": ()}


def _moment_close(got_enc, want_enc, mode, what):
    """Codes equal but for at most one in 1,000 (and no fewer than one),
    by one (see the module docstring); scales and decodes to match."""
    ft, fj = _fields(got_enc), _fields(want_enc)
    codes = "packed" if "packed" in ft else "q"
    a, b = ft[codes].astype(np.int32), fj[codes].astype(np.int32)
    if codes == "packed":
        a = np.stack([a & 15, a >> 4], -1)
        b = np.stack([b & 15, b >> 4], -1)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and diff.sum() <= max(1, a.size // 1000), what
    np.testing.assert_allclose(ft["scale"], fj["scale"], rtol=1e-6, err_msg=what)
    dec_t = quant.decode(mode, got_enc).numpy()
    dec_j = np.asarray(jquant.decode(mode, want_enc))
    np.testing.assert_allclose(dec_t, dec_j, rtol=1e-5,
                               atol=float(ft["scale"].max()) * 1.01, err_msg=what)


M8U8 = dict(name="adamw", lr=1e-2, mu_codec="m8", nu_codec="u8", grad_clip=0.5,
            weight_decay=0.1)


@pytest.mark.parametrize("kw,chunk", [
    (M8U8, None), (M8U8, 16),
    (dict(name="adamw", lr=1e-2, mu_codec="int4@g8", nu_codec=None), None),
    (dict(name="sgd", lr=0.05, weight_decay=5e-4, grad_clip=None,
          mu_codec="m8", nu_codec="u8"), 16)],
    ids=["adamw-m8u8", "adamw-m8u8-row-slices", "adamw-int4", "sgd-m8-row-slices"])
def test_apply_updates_encoded_matches_reference(kw, chunk, monkeypatch):
    """Three steps from the same gradients, one parameter bf16 with its f32
    master: parameters, masters and the stored moments against the
    reference's. ``row-slices`` cuts each row-scaled parameter into slices
    of 16 elements (the path that bounds gemma-2b's temporaries): the same
    bits as whole."""
    if chunk is not None:
        monkeypatch.setattr(opt, "CHUNK_ELEMS", chunk)
    params = {n: _np(s, i) for i, (n, s) in enumerate(OPT_SHAPES.items())}
    grads = [{n: _np(s, 10 + 4 * k + i, 2.0)
              for i, (n, s) in enumerate(OPT_SHAPES.items())} for k in range(3)]
    jcfg, cfg = JOpt(**kw), opt.OptConfig(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    bf16 = {"emb"}
    jp = {n: jnp.asarray(a, jnp.bfloat16 if n in bf16 else jnp.float32)
          for n, a in params.items()}
    tp = {n: torch.nn.Parameter(torch.tensor(a).to(
        torch.bfloat16 if n in bf16 else torch.float32)) for n, a in params.items()}
    js, ts = j_init(jp, jcfg), opt.init_opt_state(tp, cfg)
    for g in grads:
        jp, js, _ = j_apply(jp, {n: jnp.asarray(a, jp[n].dtype)
                                 for n, a in g.items()}, js, jcfg)
        for n in tp:  # copies: the clip scales the gradients in place
            tp[n].grad = torch.tensor(g[n]).to(tp[n].dtype)
        opt.apply_updates(tp, ts, cfg)
    moments = {"mu": cfg.mu_codec}
    if cfg.name == "adamw":
        moments["nu"] = cfg.nu_codec
    for n in tp:
        np.testing.assert_allclose(tp[n].detach().float().numpy(),
                                   np.asarray(jp[n], np.float32), rtol=1e-5,
                                   atol=1e-7, err_msg=n)
        if n in bf16:
            np.testing.assert_allclose(ts["master"][n].numpy(),
                                       np.asarray(js["master"][n]), rtol=1e-5,
                                       atol=1e-7)
        for k, mode in moments.items():
            if mode is None:
                np.testing.assert_allclose(ts[k][n].numpy(), np.asarray(js[k][n]),
                                           rtol=1e-5, atol=1e-9)
            else:
                _moment_close(ts[k][n], js[k][n], mode, f"{k}[{n}]")
    if chunk is not None:  # the slices write the bits of the whole
        whole_p = {n: torch.nn.Parameter(torch.tensor(a).to(tp[n].dtype))
                   for n, a in params.items()}
        monkeypatch.setattr(opt, "CHUNK_ELEMS", 1 << 26)
        ws = opt.init_opt_state(whole_p, cfg)
        for g in grads:
            for n in whole_p:
                whole_p[n].grad = torch.tensor(g[n]).to(whole_p[n].dtype)
            opt.apply_updates(whole_p, ws, cfg)
        for n in tp:
            assert torch.equal(tp[n], whole_p[n]), n
            for k, mode in moments.items():
                for f, v in _fields(ts[k][n]).items() if mode else ():
                    np.testing.assert_array_equal(v, _fields(ws[k][n])[f])


def test_opt_config_refuses_dithered_moment_codecs():
    for field in ("mu_codec", "nu_codec"):
        with pytest.raises(ValueError) as ej:
            JOpt(**{field: "nsd"})
        with pytest.raises(ValueError) as et:
            opt.OptConfig(**{field: "nsd"})
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="unknown codec"):
        opt.OptConfig(mu_codec="m9")
    state = opt.init_opt_state({"w": torch.zeros(3, 4)},
                               opt.OptConfig(mu_codec="m8", nu_codec="u8"))
    assert isinstance(state["mu"]["w"], quant.RowQuant8)
    assert isinstance(state["nu"]["w"], quant.SqrtRowQuant8)


# ---------------------------------------------------------------------------
# the cotangent codec in the dithered ops
# ---------------------------------------------------------------------------

class FedCtx(DitherCtx):
    """Hands the port the reference's cotangent draw of each layer."""

    def __init__(self, policy, jctx):
        super().__init__(policy, device="cpu")
        self.jctx = jctx

    def unit_noise(self, name, shape):
        return torch.from_numpy(_draw(self.jctx.key_for(name), shape))


def _jit_vjp(f, primals, cotangent):
    def run(primals, ct):
        y, vjp = jax.vjp(f, *primals)
        return y, vjp(ct)
    return jax.jit(run)(tuple(map(jnp.asarray, primals)), jnp.asarray(cotangent))


def _close(actual, desired, rtol, atol_frac=0.0):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=rtol,
                               atol=atol_frac * float(np.abs(desired).max()))


@pytest.mark.parametrize("layer", ["dense", "conv"])
@pytest.mark.parametrize("codec,variant", [("int4@g32", "kernel"),
                                           ("int8_absmax", "int8"),
                                           ("int4@g32", "paper")])
def test_grad_codec_ops_match_reference(codec, variant, layer, monkeypatch):
    """The codec replaces the variant's quantizer: the kernel and int8
    routes are skipped (no NSD, no int8 product, no fallback noted), the
    products run as the paper variant's; int8_absmax rounds with the
    reference's draw, fed. dx, dW and the telemetry row (the zero share and
    the codec's bits) against the reference's."""
    calls = []
    monkeypatch.setattr(ops, "quantize_and_mask",
                        lambda *a, **k: calls.append("nsd"))
    jc = JCtx.for_step(jax.random.PRNGKey(3), 0, JPolicy(
        variant=variant, s=2.0, grad_codec=codec, collect_stats=True))
    pol = DitherPolicy(variant=variant, s=2.0, grad_codec=codec,
                       collect_stats=True)
    if layer == "dense":
        x, w, g = _np((40, 24), 8), _np((24, 16), 9, 0.2), _np((40, 16), 10, 0.1)
        f = lambda x, w: jdense(x, w, ctx=jc, name="fc")  # noqa: E731
        xt, wt, gt = map(torch.from_numpy, (x, w, g))
        run = lambda xt, wt, ctx: dithered.dense(xt, wt, ctx=ctx, name="fc")  # noqa: E731
    else:
        x, w = _np((2, 8, 8, 4), 8), _np((3, 3, 4, 6), 9, 0.2)
        f = lambda x, w: jconv2d(x, w, strides=(2, 2), padding="SAME",  # noqa: E731
                                 ctx=jc, name="fc")
        g = _np(jax.eval_shape(f, x, w).shape, 10, 0.1)
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
        run = lambda xt, wt, ctx: dithered.conv2d(xt, wt, stride=2,  # noqa: E731
                                                  padding="SAME", ctx=ctx, name="fc")
        gt = torch.from_numpy(g.transpose(0, 3, 1, 2).copy())
    jmetrics.reset()
    _, (dx_j, dw_j) = _jit_vjp(f, (x, w), g)
    jax.effects_barrier()
    metrics.reset()
    ops.KERNEL_FALLBACKS.clear()
    xt, wt = xt.requires_grad_(), wt.requires_grad_()
    run(xt, wt, FedCtx(pol, jc)).backward(gt)
    dx_t, dw_t = xt.grad, wt.grad
    if layer == "conv":
        dx_t, dw_t = dx_t.permute(0, 2, 3, 1), dw_t.permute(2, 3, 1, 0)
    _close(dx_t, dx_j, 1e-4, 1e-5)
    _close(dw_t, dw_j, 1e-4, 1e-5)
    assert not calls and not ops.KERNEL_FALLBACKS
    row_t, row_j = metrics.rows("fc")[0], jmetrics.rows("fc")[0]
    assert np.rint(row_t[0] * g.size) == np.rint(row_j[0] * g.size)
    assert row_t[1] == row_j[1] == quant.parse_spec(codec).bits
    assert row_t[2] == row_j[2] == 0.0


def test_program_base_carries_grad_codec():
    """A program over a base with grad_codec hands it to a phase@N=kernel
    layer and to a rule's variant, as the reference's resolve_layer."""
    spec = "phase@0=off;phase@2=kernel;rule fc2:variant=paper"
    base = DitherPolicy(variant="off", grad_codec="int4@g32")
    prog = schedule.parse_program(spec, base)
    jprog = jsched.parse_program(spec, JPolicy(variant="off", grad_codec="int4@g32"))
    for step in (0, 2):
        ctx = DitherCtx(prog.phase_policy_at(step), step=step, device="cpu",
                        program=prog)
        jctx = JCtx.for_step(jax.random.PRNGKey(0), step,
                             jprog.phase_policy_at(step), program=jprog)
        for name in ("fc0", "fc2"):
            pol, r = ctx.resolve(name), jprog.resolve_layer(jctx, name)
            assert (pol is None) == (r is None) == (step == 0 and name == "fc0")
            if pol is not None:
                assert pol.grad_codec == r.spec.grad_codec == "int4@g32"
                assert pol.variant == r.spec.variant
    with pytest.raises(ValueError, match="unknown codec"):
        DitherPolicy(grad_codec="int9")


# ---------------------------------------------------------------------------
# the launcher's quant: section
# ---------------------------------------------------------------------------

CPU_ARGS = ["--arch", "gemma-2b", "--preset", "smoke", "--batch", "4", "--seq",
            "16", "--lr", "3e-3", "--device", "cpu"]


def test_launcher_resid_is_the_memory_default():
    args = launch_train.parse_args(CPU_ARGS + ["--program", "quant: resid=nsd"])
    tr = launch_train.build(args)[0]
    assert tr.memory_policy == parse_memory_program("default=nsd")
    assert (tr.memory_policy.default
            == j_parse_memory("default=nsd").default == "nsd")
    with pytest.raises(ValueError, match="conflicts with the 'memory:'"):
        launch_train.build(launch_train.parse_args(CPU_ARGS + [
            "--program", "memory: default=int8 quant: resid=nsd"]))


def test_launcher_quant_section_matches_reference_trainer(monkeypatch):
    """``main`` with ``quant: grad=int4@g32;mu=m8;nu=u8`` on a paper base,
    2 steps, against the reference trainer on the same recipe, both from
    the reference's parameters: int4 is deterministic, so no draw is fed.

    Each cotangent's codes are held to the reference's, which are recorded
    under its jitted step (``jax.debug.callback`` around its codec), and
    the port carries on with the reference's quantized cotangent. Every
    cotangent within relative L2 1e-5 of the reference's (measured 5.0e-6).
    A code that differs must sit within 1e-3 of its rounding boundary in
    the reference's g / scale (measured 1.4e-5, at most 4 a layer), unless
    its group is rounding residue on both sides: no entry above one ulp
    (2^-23) of the cotangent's largest. Those groups must be exactly the
    rows of the queries whose visible keys all carry one token, in the
    query projections: their gradient is 0, and each side holds at most
    4.3e-11 of noise there (5.7e-8 of the largest entry; the smallest
    other group's largest entry is 9.2e-4 of it), which int4's per-group
    absmax spreads over all codes. 72 groups: 20 a layer at step 1 (the
    first token of each sequence, and the second of one that opens with a
    repeat), 16 at step 2. The scales differ by
    an ulp in most groups: XLA compiles the reference's ``/ 7`` as ``* (1
    / 7)``; its eager codec, which the port equals bit for bit
    (``test_codec_matches_reference``), does not. Unfed, a step-2 flip
    at 6e-6 from its boundary cascades through the layers below it and
    moved the parameters by up to 3e-3."""
    import repro.core.dithered as jdith
    import repro_torch.core.dithered as tdith
    steps, group = 2, 32
    ref = {}  # name -> [(g, g~, scale)] in backward order
    j_quantize = jdith.quantize_cotangent

    def recording(g, key, knobs, spec, name):
        out = j_quantize(g, key, knobs, spec, name)
        enc = jquant.encode(spec.grad_codec, g)
        jax.debug.callback(lambda *a: ref.setdefault(name, []).append(
            tuple(np.asarray(v) for v in a)), g, out, enc.scale)
        return out

    monkeypatch.setattr(jdith, "quantize_cotangent", recording)
    jm = j_get_smoke("gemma-2b")
    jt = JTrainer(jm, JOpt(name="adamw", lr=3e-3, schedule="cosine",
                           warmup_steps=1, total_steps=steps, mu_codec="m8",
                           nu_codec="u8"),
                  JTrainerConfig(total_steps=steps, log_every=1),
                  policy=JPolicy(variant="paper", s=2.0, grad_codec="int4@g32"))
    tcfg = JTok(vocab=512, seq_len=16, batch=4)
    batches = [j_token_batch(tcfg, i) for i in range(steps)]
    jout = jt.fit(iter(batches))
    jax.effects_barrier()
    params0, _ = jm.init(jax.random.PRNGKey(0))

    def ref_init(self):
        net = self.model.init(0, self.device)
        net.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params0)))
        return net

    def groups(a):
        flat = np.asarray(a, np.float32).reshape(-1)
        return np.pad(flat, (0, (-flat.size) % group)).reshape(-1, group)

    t_quantize = tdith.quantize_cotangent
    calls = 7 * 2 + 1  # a step: 7 projections x 2 blocks + lm_head
    flips, residues = [], []

    def forced(g2d, u, pol, name):
        own = t_quantize(g2d, u, pol, name)
        jg, jgq, jscale = ref[name].pop(0)
        g = g2d.detach().numpy()
        rel = np.linalg.norm(g - jg.reshape(g.shape)) / np.linalg.norm(jg)
        assert rel <= 1e-5, (name, rel)
        scale = quant.encode(pol.grad_codec, g2d.detach()).scale.numpy()
        residue = (np.maximum(np.abs(groups(g)).max(1), np.abs(groups(jg)).max(1))
                   <= 2.0 ** -23 * np.abs(jg).max())
        toks = np.asarray(batches[len(flips) // calls]["tokens"])
        alike = np.cumprod(toks == toks[:, :1], axis=1).astype(bool)
        zero_rows = np.repeat(alike.reshape(-1), g.shape[-1] // group)
        want = zero_rows & name.endswith("attn.q")
        np.testing.assert_array_equal(residue, want, err_msg=name)
        residues.append(int(residue.sum()))
        residue = residue[:, None]
        with np.errstate(invalid="ignore"):  # residue groups: scale 0
            q = np.rint(groups(own.detach().numpy()) / scale)
            jq = np.rint(groups(jgq) / jscale)
            r = groups(jg).astype(np.float64) / jscale
        differ = (q != jq) & ~residue
        dist = np.abs(np.abs(r - np.trunc(r)) - 0.5)[differ]
        assert (dist < 1e-3).all() and differ.sum() <= 4, (name, dist)
        flips.append(int(differ.sum()))
        return torch.from_numpy(np.array(jgq).reshape(own.shape))

    monkeypatch.setattr(trainer_mod.Trainer, "init_params", ref_init)
    monkeypatch.setattr(tdith, "quantize_cotangent", forced)
    tr = launch_train.main(CPU_ARGS + ["--steps", str(steps), "--program",
                                       "quant: grad=int4@g32;mu=m8;nu=u8"])
    assert not any(ref.values())  # every reference call consumed
    assert len(flips) == steps * calls
    assert sum(residues) == 72, residues
    assert tr.program.base.grad_codec == "int4@g32"
    assert (tr.opt_cfg.mu_codec, tr.opt_cfg.nu_codec) == ("m8", "u8")
    assert isinstance(tr.opt_state["nu"]["embed.table"], quant.SqrtRowQuant8)
    np.testing.assert_allclose([r["loss"] for r in tr.history],
                               [r["loss"] for r in jout["history"]], atol=1e-4)
    got = lm_params_to_jax(dict(tr.net.named_parameters()))
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jout["params"]))[0]
    for (path, want), g in zip(flat, jax.tree.leaves(got)):
        g = np.asarray(g, np.float32)
        rel = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert rel <= 1e-4, jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# the quant bench's race and packed products on the CPU
# ---------------------------------------------------------------------------

def test_registry_race_and_packed_products_meet_reference_gates():
    """The port's race and packed products, gated against the reference's
    committed results with the bench's own bands; a registered codec that
    is not raced fails the race."""
    out = {"race": quant_bench.registry_race(device="cpu"),
           "packed": quant_bench.packed_compute_metrics(device="cpu"),
           "timing": {"nsd_roundtrip_us": 0.0},
           "arms": {a: {"acc": 100.0, "us_per_step": 0.0, "final_loss": 0.0}
                    for a in ("paper", "grad_int4", "sgd_m8", "adamw_fp32",
                              "adamw_m8u8")}}
    assert out["race"]["nsd_max_abs_diff"] == out["race"]["nsd_0.5_max_abs_diff"] == 0.0
    baseline = SuiteRun.from_dict(json.loads(
        (ROOT / "benchmarks/baselines/BENCH_quant_bench.json").read_text())).by_name()
    for r in quant_bench.results(out)[:2]:
        findings = compare_result(r, baseline[r.name])
        assert not [f for f in findings if f.failing], findings
        assert set(r.derived) == set(baseline[r.name].derived)
    fake = type("Extra", (quant.Codec,), {"name": "extra_codec"})
    quant.register(fake())
    try:
        with pytest.raises(AssertionError, match="extra_codec"):
            quant_bench.registry_race(device="cpu")
    finally:
        quant.registry._REGISTRY.pop("extra_codec")
