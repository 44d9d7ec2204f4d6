"""Port parity for the residual store: the memory program
(``repro_torch.memory.policy``), the residual codecs (``repro_torch.quant``),
the dithered ops' encode in the forward and decode in the backward, and one
VGG11-CIFAR training step with ``memory="default=nsd"``, against
``repro.memory``, ``repro.quant`` and ``repro.core``.

The reference's noise is fed to the port: each layer's cotangent draw
through ``DitherCtx.unit_noise`` (``key_for(name)``) and its residual draw
through ``DitherCtx.resid_noise`` (``resid_key(key_for(name))``, the
RESID_SALT stream), each over the shape the reference draws it.

Tolerances. Codec round trips of bf16 and int8 are exact (the same f32
operations in the same order). Byte accounting is exact. A weight gradient
from a decoded residual is a sum of products whose order differs between
the port and a hand-written product: held with rtol 1e-6 plus an atol of
1e-6 of the largest entry, because entries that cancel to near zero carry
the absolute rounding of the large terms they sum, not a relative one
(rtol alone fails there on f32 summation order). The whole step keeps the
bands of ``tests/test_torch_slice.py``: loss rtol 1e-5, BatchNorm and
dense-bias gradients rel 1e-3 in the L2 norm (k may flip only where a value
lies within rounding of a step boundary); its residual byte counts must
agree exactly, save at most one k flip per 10,000 residual elements of a
layer (seed 0 flips none).

The step feeds the port one more reference value per layer: the residual's
Delta, as the reference computed it (jnp.std of its own activation), handed
to the port's ``wire.pack_nsd(..., delta=)``. The kernel variant's dW
multiplies k_g with absmax_int8 of the decoded residual k_x * Delta_x, and
that operand is decided by the last bits of Delta_x: when max|k_x| is even,
every element with |k_x| = max|k_x| / 2 quantizes to exactly 127 / 2, a
round-half-even tie. torch.std and jnp.std differ by up to 7e-6 relative, so
with its own Delta the port may round those ties the other way; with the
reference's Delta both sides build the same operand, and each layer's dW is
held to the slice band, rel 1e-3 in the L2 norm. The residual changes dW by
far more than that band: each layer's nsd dW lies more than 30 times the
band away from the fp32-residual dW.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.configs.paper_models import vgg11_cifar as j_vgg11  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy  # noqa: E402
from repro.core import conv2d as jconv2d, dense as jdense  # noqa: E402
from repro.core import dithered as jdithered  # noqa: E402
from repro.data.synthetic import ClassifConfig as JData, classification_batch as j_batch  # noqa: E402
from repro.memory import MemoryPolicy as JMemory, parse_memory_program as j_parse  # noqa: E402
from repro.models.cnn import loss_fn as j_loss  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.configs.paper_models import vgg11_cifar  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import dithered  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.data.synthetic import ClassifConfig, classification_batch  # noqa: E402
from repro_torch.memory.policy import MemoryPolicy, as_memory_policy, parse_memory_program  # noqa: E402
from repro_torch.models.cnn import CNN, loss_fn  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.quant import wire  # noqa: E402

LAYERS = [f"c{i}" for i in range(8)] + ["fc0", "fc1", "fc2"]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _draw(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(
        key, tuple(shape), jnp.float32, -0.5, 0.5)))


class FedCtx(DitherCtx):
    """Hands the port the reference's draws instead of its own, and keeps
    the name of the layer whose residual is being encoded (``resid_name``)."""

    def __init__(self, policy, jctx, memory=None):
        super().__init__(policy, device="cpu", memory=memory)
        self.jctx = jctx
        self.resid_name = None

    def unit_noise(self, name, shape):
        return _draw(self.jctx.key_for(name), shape)

    def resid_noise(self, name, shape):
        self.resid_name = name
        return _draw(jquant.resid_key(self.jctx.key_for(name)), shape)


# ---------------------------------------------------------------------------
# the memory program
# ---------------------------------------------------------------------------

VALID = ["", "default=nsd", "default=nsd@0.5;rule fc0:int8;rule c*:remat;rule fc2:fp32",
         " ; rule c1:bf16 ; ", "default=int8;rule c?:nsd;rule fc:fp32"]
INVALID = ["default=nope", "rule fc0", "bogus", "default=nsd@-1", "rule :fp32",
           "rule fc0:int8@3", "default=fp32@1"]


@pytest.mark.parametrize("spec", VALID)
def test_parse_memory_program_matches_reference(spec):
    pj, pt = j_parse(spec), parse_memory_program(spec)
    assert pt.default == pj.default
    assert [(r.pattern, r.mode) for r in pt.rules] == \
        [(r.pattern, r.mode) for r in pj.rules]
    assert [pt.mode_for(n) for n in LAYERS] == [pj.mode_for(n) for n in LAYERS]
    assert (as_memory_policy(spec) is None) == (spec == "")


def _head(err) -> str:
    """An error message up to its grammar text, with the package name of
    the port's codec list read as the reference's."""
    return str(err).split("grammar:")[0].replace("repro_torch.", "repro.")


@pytest.mark.parametrize("spec", INVALID)
def test_parse_errors_match_reference(spec):
    with pytest.raises(ValueError) as ej:
        j_parse(spec)
    with pytest.raises(ValueError) as et:
        parse_memory_program(spec)
    assert _head(et.value) == _head(ej.value)


@pytest.mark.parametrize("mode", ["int4@g32", "m8", "u8", "int8_absmax"])
def test_codecs_not_ported_yet_are_refused(mode):
    """The four codecs the residual store lacked until the quant engine's
    last slice: a memory program and a policy now take them as the
    reference does, and a dense layer's dW from such a residual (paper
    variant, the reference's cotangent and residual draws fed: int8_absmax
    rounds stochastically with the residual's draw) matches the reference's
    in the paper-variant band of test_nsd_residual_dw_matches_reference."""
    mem = f"default={mode}"
    assert parse_memory_program(mem).default == j_parse(mem).default == mode
    assert DitherPolicy(residual=mode).residual == mode
    jctx = JCtx.for_step(jax.random.PRNGKey(0), 3, JPolicy(variant="paper", s=2.0),
                         memory=j_parse(mem))
    x, w = np.maximum(_np((16, 48), 8), 0), _np((48, 8), 9, 0.1)
    dw_j = jax.grad(lambda w: jnp.sum(jdense(jnp.asarray(x), w, ctx=jctx,
                                             name="fc") ** 2))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    ctx = FedCtx(DitherPolicy(variant="paper", s=2.0), jctx,
                 parse_memory_program(mem))
    (dithered.dense(torch.from_numpy(x), wt, ctx=ctx, name="fc") ** 2
     ).sum().backward()
    assert ctx.resid_name == ("fc" if mode == "int8_absmax" else None)
    want = np.asarray(dw_j)
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def test_as_memory_policy_passes_policies_and_refuses_other_types():
    pol = MemoryPolicy(default="nsd")
    assert as_memory_policy(pol) is pol and as_memory_policy(None) is None
    with pytest.raises(TypeError):
        as_memory_policy(3)


def test_ctx_stamps_the_layer_mode():
    ctx = DitherCtx(DitherPolicy(variant="paper"), device="cpu",
                    memory=parse_memory_program("default=nsd;rule fc2:fp32"))
    assert ctx.resolve("fc1").residual == "nsd"
    assert ctx.resolve("fc2").residual == "fp32"
    assert DitherCtx(DitherPolicy(variant="off"), device="cpu",
                     memory=MemoryPolicy(default="nsd")).resolve("fc1") is None


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------

def test_bf16_round_trip_matches_reference():
    x = _np((16, 48), 1)
    dj = jquant.decode("bf16", jquant.encode("bf16", jnp.asarray(x)))
    enc = quant.encode("bf16", torch.from_numpy(x))
    assert enc.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(quant.decode("bf16", enc).numpy(), np.asarray(dj))
    assert quant.capacity_bytes("bf16", enc) == jquant.stored_nbytes(
        "bf16", x.shape, jnp.float32) == x.size * 2


# (16, 48) a dense layer's input; (2, 8, 8, 16) a conv input in the
# reference's NHWC order, whose rows run over the channels
@pytest.mark.parametrize("shape", [(16, 48), (2, 8, 8, 16)], ids=str)
def test_int8_round_trip_matches_reference(shape):
    x = _np(shape, 2, 3.0)
    ej = jquant.encode("int8", jnp.asarray(x))
    et = quant.encode("int8", torch.from_numpy(x))
    for name in ("q", "scale", "lo"):
        np.testing.assert_array_equal(getattr(et, name).numpy(),
                                      np.asarray(getattr(ej, name)), name)
    assert et.q.shape == (int(np.prod(shape[:-1])), shape[-1])
    np.testing.assert_array_equal(quant.decode("int8", et).numpy(),
                                  np.asarray(jquant.decode("int8", ej)))
    assert quant.capacity_bytes("int8", et) == jquant.capacity_bytes("int8", ej)


@pytest.mark.parametrize("mode", ["nsd", "nsd@0.5"])
@pytest.mark.parametrize("shape", [(16, 48), (3, 5, 5, 7)], ids=str)
def test_nsd_codec_dispatch_and_accounting(mode, shape):
    """The facade runs the wire container of ``tests/test_torch_wire.py``
    (held byte for byte against the reference there) at the spec's s, and
    accounts its bytes by the reference's formulas."""
    x = torch.from_numpy(_np(shape, 3))
    u = _draw(jax.random.PRNGKey(4), shape)
    s = quant.parse_spec(mode).param
    enc = quant.encode(mode, x, u)
    want = quant.wire.pack_nsd(x, u, s)
    for name in ("levels", "bitmap", "deltas", "nnz"):
        assert torch.equal(getattr(enc, name), getattr(want, name)), name
    assert torch.equal(quant.decode(mode, enc), quant.wire.unpack_nsd(want))
    assert quant.capacity_bytes(mode, enc) == quant.stored_nbytes(
        mode, shape, torch.float32) == jquant.stored_nbytes(mode, shape, jnp.float32)
    assert int(quant.measured_bytes(mode, enc)) == int(enc.wire_bytes())
    with pytest.raises(ValueError, match="noise"):
        quant.encode(mode, x)


@pytest.mark.parametrize("mode", ["fp32", "remat"])
def test_identity_modes(mode):
    x = torch.from_numpy(_np((4, 6), 5))
    assert quant.encode(mode, x) is x and quant.decode(mode, x) is x
    assert quant.capacity_bytes(mode, x) == quant.measured_bytes(mode, x) == 96
    assert not quant.needs_noise(mode) and quant.needs_noise("nsd@2")


# ---------------------------------------------------------------------------
# the residual store in the dithered ops
# ---------------------------------------------------------------------------

def _grads(layer, variant, mode, seed=0, collect=False):
    """(dx, dW) of sum(y^2) for one dithered layer under a residual mode
    (None = no memory policy), with the port's own noise."""
    if layer == "dense":
        x, w = _np((40, 48), seed), _np((48, 24), seed + 1, 0.1)
        x = np.maximum(x, 0)  # a relu activation, as the layers save
    else:
        x, w = _np((2, 6, 8, 8), seed), _np((12, 6, 3, 3), seed + 1, 0.1)
    x = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(w).requires_grad_()
    ctx = DitherCtx(DitherPolicy(variant=variant, s=2.0, collect_stats=collect),
                    seed=0, step=3, device="cpu",
                    memory=None if mode is None else MemoryPolicy(default=mode))
    if layer == "dense":
        y = dithered.dense(x, w, ctx=ctx, name="fc")
    else:
        y = dithered.conv2d(x, w, padding=1, ctx=ctx, name="c1")
    (y ** 2).sum().backward()
    return x.grad, w.grad


CASES = [(layer, variant) for layer in ("dense", "conv")
         for variant in ("paper", "kernel")]


@pytest.mark.parametrize("layer,variant", CASES)
def test_fp32_mode_identical_to_no_policy(layer, variant):
    for a, b in zip(_grads(layer, variant, None), _grads(layer, variant, "fp32")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layer,variant", CASES)
def test_remat_identical_to_store(layer, variant):
    """The backward reruns the forward: same inputs, same noise streams,
    the same gradients to the bit."""
    for a, b in zip(_grads(layer, variant, None), _grads(layer, variant, "remat")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["nsd", "int8", "bf16"])
@pytest.mark.parametrize("layer,variant", CASES)
def test_codec_residual_touches_only_dw(layer, variant, mode):
    """dx = g~ . W^T never reads x: identical across residual modes; dW
    sees the decoded activations."""
    dx0, dw0 = _grads(layer, variant, None)
    dxm, dwm = _grads(layer, variant, mode)
    assert torch.equal(dx0, dxm)
    assert torch.isfinite(dwm).all() and not torch.equal(dw0, dwm)


def test_nsd_residual_dw_matches_manual_product():
    """dW under the nsd residual == decode(encode(x))^T . g~ by hand from
    the same noise streams: pins the codec wiring and the stream split."""
    x = np.maximum(_np((16, 48), 6), 0)
    w = _np((48, 8), 7, 0.1)
    pol = DitherPolicy(variant="paper", s=2.0)
    ctx = DitherCtx(pol, seed=0, step=3, device="cpu",
                    memory=MemoryPolicy(default="nsd"))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).requires_grad_()
    (dithered.dense(xt, wt, ctx=ctx, name="fc") ** 2).sum().backward()
    g = 2.0 * (xt @ wt.detach())
    gq = dithered.quantize_cotangent(g, ctx.unit_noise("fc", g.shape), pol, "fc")
    x_hat = quant.quantize("nsd", xt, ctx.resid_noise("fc", xt.shape))
    manual = x_hat.t() @ gq
    np.testing.assert_allclose(wt.grad.numpy(), manual.numpy(), rtol=1e-6,
                               atol=1e-6 * float(manual.abs().max()))
    # the residual noise is not the cotangent's
    assert not torch.equal(ctx.resid_noise("fc", (4, 4)), ctx.unit_noise("fc", (4, 4)))


@pytest.mark.parametrize("layer", ["dense", "conv"])
def test_nsd_residual_dw_matches_reference(layer):
    """The port's dW with an nsd residual against the reference's, both
    paper variant, the reference's draws fed to the port. A conv residual
    is encoded in NHWC on both sides. The products differ in summation
    order only (XLA's against torch's): rtol 1e-4 plus atol 1e-5 of the
    largest entry, the paper-variant band of tests/test_torch_ops.py."""
    pol_j = JPolicy(variant="paper", s=2.0)
    mem = "default=nsd"
    jctx = JCtx.for_step(jax.random.PRNGKey(0), 3, pol_j, memory=j_parse(mem))
    if layer == "dense":
        x, w = np.maximum(_np((16, 48), 8), 0), _np((48, 8), 9, 0.1)
        dw_j = jax.grad(lambda w: jnp.sum(jdense(jnp.asarray(x), w, ctx=jctx,
                                                 name="fc") ** 2))(jnp.asarray(w))
        xt, wt = torch.from_numpy(x), torch.from_numpy(w).requires_grad_()
        ctx = FedCtx(DitherPolicy(variant="paper", s=2.0), jctx,
                     parse_memory_program(mem))
        (dithered.dense(xt, wt, ctx=ctx, name="fc") ** 2).sum().backward()
        got = wt.grad.numpy()
    else:
        x, w = _np((2, 8, 8, 6), 10), _np((3, 3, 6, 12), 11, 0.1)  # NHWC, HWIO
        dw_j = jax.grad(lambda w: jnp.sum(jconv2d(jnp.asarray(x), w, ctx=jctx,
                                                  name="c1") ** 2))(jnp.asarray(w))
        xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))
                              ).requires_grad_()
        ctx = FedCtx(DitherPolicy(variant="paper", s=2.0), jctx,
                     parse_memory_program(mem))
        (dithered.conv2d(xt, wt, padding=1, ctx=ctx, name="c1") ** 2).sum().backward()
        got = wt.grad.numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
    want = np.asarray(dw_j)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def test_remat_records_memory_row_and_no_dither_row():
    metrics.reset()
    _grads("dense", "paper", "remat", collect=True)
    rows = metrics.memory_rows("fc")
    assert rows.shape == (1, 3)
    assert rows[0, 0] == rows[0, 1] == rows[0, 2] == 40 * 48 * 4
    assert metrics.rows("fc").shape == (0, 3)


@pytest.mark.parametrize("mode", ["nsd", "int8", "bf16", "fp32"])
def test_memory_rows_account_the_encoding(mode):
    metrics.reset()
    _grads("dense", "kernel", mode, collect=True)
    (measured, cap, dense), = metrics.memory_rows("fc")
    assert dense == 40 * 48 * 4
    assert cap == quant.stored_nbytes(mode, (40, 48), torch.float32)
    assert (measured < cap) if mode == "nsd" else (measured == cap)
    assert metrics.rows("fc").shape == (1, 3)
    assert metrics.memory_summary()["fc"]["dense_bytes"] == dense
    assert metrics.overall_residual_compression() == pytest.approx(
        float(dense) / float(measured))


@pytest.mark.parametrize("mode", ["nsd", "remat"])
def test_no_memory_rows_without_differentiation(mode):
    """A residual is saved, and counted, only when a backward will read it."""
    metrics.reset()
    ctx = DitherCtx(DitherPolicy(variant="paper", collect_stats=True),
                    device="cpu", memory=MemoryPolicy(default=mode))
    x, w = torch.ones(4, 8), torch.ones(8, 2, requires_grad=True)
    with torch.no_grad():
        dithered.dense(x, w, ctx=ctx, name="fc")
    dithered.dense(x, w.detach(), ctx=ctx, name="fc")
    assert metrics.memory_tags() == []


# ---------------------------------------------------------------------------
# one VGG11-CIFAR step, variant=kernel, memory="default=nsd", batch 2
# ---------------------------------------------------------------------------

B, S, SEED = 2, 2.0, 0


@pytest.fixture(scope="module")
def vgg_step():
    model = j_vgg11()
    rng = np.random.default_rng(SEED)
    params = {}
    for n, sd in sorted(jax.eval_shape(model.init,
                                       jax.random.PRNGKey(SEED))[0].items()):
        if n.endswith("_w"):
            fan_in = int(np.prod(sd.shape[:-1]))
            params[n] = (rng.standard_normal(sd.shape) / np.sqrt(fan_in)
                         ).astype(np.float32)
        else:
            params[n] = (np.ones if n.endswith("_g") else np.zeros)(
                sd.shape, np.float32)
    dcfg = dict(n_classes=10, img_size=32, channels=3, noise=0.5, seed=SEED)
    jb = j_batch(JData(**dcfg), 0, B)
    jctx = JCtx.for_step(jax.random.PRNGKey(SEED), 0,
                         JPolicy(variant="kernel", s=S, collect_stats=True),
                         memory=JMemory(default="nsd"))
    jmetrics.reset()
    deltas = {}  # layer -> the reference's residual Delta

    def recording_encode(x, key, spec, name):
        enc = real_encode(x, key, spec, name)
        jax.debug.callback(lambda d: deltas.__setitem__(name, np.float32(d)),
                           enc.deltas[0])
        return enc

    real_encode = jdithered.encode_residual
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdithered, "encode_residual", recording_encode)
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda p: j_loss(p, model.cfg, jb, ctx=jctx)))(params)
        jax.effects_barrier()
    assert sorted(deltas) == sorted(LAYERS)
    ref = dict(loss=float(loss_j), grads=grads_j,
               rows={n: jmetrics.rows(n) for n in LAYERS},
               mem={n: jmetrics.memory_rows(n) for n in LAYERS},
               comp=jmetrics.overall_residual_compression())

    tb = classification_batch(ClassifConfig(**dcfg), 0, B, device="cpu")

    def port(memory):
        net = CNN(vgg11_cifar(), device="cpu")
        net.load_state_dict(params_from_jax(params))
        metrics.reset()
        ctx = FedCtx(DitherPolicy(variant="kernel", s=S, collect_stats=True),
                     jctx, memory)
        real_pack = wire.pack_nsd

        def fed_pack(x, u, s, **kw):
            return real_pack(x, u, s, delta=torch.tensor(deltas[ctx.resid_name]),
                             **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(wire, "pack_nsd", fed_pack)
            loss = loss_fn(net, tb, ctx=ctx)
            loss.backward()
        return dict(loss=float(loss.detach()),
                    grads={n: p.grad for n, p in net.named_parameters()},
                    rows={n: metrics.rows(n) for n in LAYERS},
                    mem={n: metrics.memory_rows(n) for n in LAYERS},
                    comp=metrics.overall_residual_compression())

    return dict(j=ref, nsd=port(parse_memory_program("default=nsd")),
                fp32=port(None))


def test_nsd_step_loss(vgg_step):
    assert vgg_step["nsd"]["loss"] == pytest.approx(vgg_step["j"]["loss"], rel=1e-5)


@pytest.mark.parametrize("name", LAYERS)
def test_nsd_step_weight_gradients(vgg_step, name):
    """The slice band, given the reference's Delta (module docstring)."""
    w_j = np.asarray(vgg_step["j"]["grads"][f"{name}_w"])
    w_t = vgg_step["nsd"]["grads"][f"{name}_w"].numpy()
    if w_t.ndim == 4:
        w_t = w_t.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    assert np.linalg.norm(w_t - w_j) <= 1e-3 * np.linalg.norm(w_j), name


def test_nsd_step_batchnorm_and_dense_bias_gradients(vgg_step):
    for n, g in vgg_step["nsd"]["grads"].items():
        if n.endswith("_w") or n.startswith("c"):
            continue  # conv biases: rounding noise around 0 (test_torch_slice)
        j = np.asarray(vgg_step["j"]["grads"][n])
        assert np.linalg.norm(g.numpy() - j) <= 1e-3 * np.linalg.norm(j), n


def test_nsd_moves_only_weight_gradients(vgg_step):
    """Against the port's own fp32-residual step with the same draws: every
    BatchNorm and bias gradient and every dither telemetry row is identical;
    every weight gradient moves, by more than 30 times the band that
    ``test_nsd_step_weight_gradients`` holds it to."""
    nsd, fp32 = vgg_step["nsd"], vgg_step["fp32"]
    for n, g in nsd["grads"].items():
        if n.endswith("_w"):
            moved = float((g - fp32["grads"][n]).norm())
            assert moved > 30 * 1e-3 * float(g.norm()), n
        else:
            assert torch.equal(g, fp32["grads"][n]), n
    for n in LAYERS:
        np.testing.assert_array_equal(nsd["rows"][n], fp32["rows"][n], n)


def test_nsd_step_telemetry_matches_reference(vgg_step):
    for n in LAYERS:
        r_t, r_j = vgg_step["nsd"]["rows"][n], vgg_step["j"]["rows"][n]
        assert r_t.shape == r_j.shape == (1, 3)
        # sparsity to one f32 ulp (test_torch_ops), bits exactly
        np.testing.assert_array_max_ulp(r_t[:, 0], r_j[:, 0], maxulp=1)
        np.testing.assert_array_equal(r_t[:, 1], r_j[:, 1], n)
        np.testing.assert_allclose(r_t[:, 2], r_j[:, 2], rtol=1e-4, err_msg=n)


def test_nsd_step_residual_bytes_match_reference(vgg_step):
    for n in LAYERS:
        m_t, m_j = vgg_step["nsd"]["mem"][n], vgg_step["j"]["mem"][n]
        assert m_t.shape == m_j.shape == (1, 3)
        np.testing.assert_array_equal(m_t[:, 1:], m_j[:, 1:], n)  # capacity, dense
        elements = m_j[0, 2] / 4
        assert abs(m_t[0, 0] - m_j[0, 0]) <= elements // 10_000, n
    fp32 = vgg_step["fp32"]["mem"]
    assert all(fp32[n][0, 0] == fp32[n][0, 1] == fp32[n][0, 2] for n in LAYERS)


def test_nsd_step_residual_compression_equal(vgg_step):
    comp_t, comp_j = vgg_step["nsd"]["comp"], vgg_step["j"]["comp"]
    assert 3.0 < comp_t < 32.0
    total = sum(vgg_step["j"]["mem"][n][0, 0] for n in LAYERS)
    # one flipped k moves the measured total by one byte
    flips = sum(vgg_step["j"]["mem"][n][0, 2] / 4 // 10_000 for n in LAYERS)
    assert comp_t == pytest.approx(comp_j, rel=flips / total + 1e-7)
    assert vgg_step["fp32"]["comp"] == 1.0


def test_cli_memory_program(capsys, monkeypatch):
    """``--memory-program`` on the trainer's CLI: CPU on request, the
    compression in the result; without a GPU and without ``--device cpu``
    it raises instead of running on the CPU."""
    import json

    from repro_torch.train import classifier

    classifier.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                     "--memory-program", "default=nsd;rule fc2:fp32"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["memory_program"] == "default=nsd;rule fc2:fp32"
    assert 1.0 < out["residual_compression"] < 32.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classifier.main(["--memory-program", "default=nsd", "--steps", "1",
                         "--batch", "2"])
