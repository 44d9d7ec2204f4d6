"""Port parity for the mixture-of-experts layer and the dithered einsum:
``repro_torch.models.moe`` and ``repro_torch.core.dithered.dithered_einsum``
against ``repro.models.moe`` and ``repro.core.dithered_einsum`` on the CPU.

The routing is held exactly: the top-k choices (ties to the lower expert
index, as ``jax.lax.top_k``), each choice's position in its expert
(the token-major cumsum), ``keep`` and the capacity. The layer's output
within rtol 1e-5 (the combine sums k f32 terms), the aux loss within 1e-6.

The einsum's backward, fed the reference's draw and Delta (``jnp.std``
over the shape the reference reduces): under the kernel variant the NSD
indices k bit for bit, each expert slice's bitmap, tile nnz and mask
equal to the reference's ``quantized_from_indices`` (its Pallas pack in
interpret mode), dx and dW within relative L2 1e-5; the paper variant's
dx and dW within 1e-5; an unsupported form is a counted fallback on both
sides. The kernels' plain versions run here; the card holds the kernels
to them (tests/test_torch_cuda.py, chip_smoke.py phase 12).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
from repro.configs import get_model as j_get_model, get_smoke_model as j_get_smoke  # noqa: E402
from repro.core import DitherCtx as JCtx, DitherPolicy as JPolicy, dithered_einsum as j_einsum  # noqa: E402
from repro.core import dithered as jdithered, nsd as jnsd  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_model  # noqa: E402
from repro_torch.core import dithered, nsd  # noqa: E402
from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.data.synthetic import TokenStreamConfig, token_batch  # noqa: E402
from repro_torch.kernels import bsp_matmul, nsd_quant, ops, pack  # noqa: E402
from repro_torch.models import moe  # noqa: E402


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _moe_params(cfg_j, d, seed=0):
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(seed), d, cfg_j, jnp.float32)
    jp = {k: np.asarray(a) for k, a in jp.items()}
    tp = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(a.copy()))
                                 for k, a in jp.items()})
    return jp, tp


def _cfgs(arch):
    jcfg, cfg = j_get_smoke(arch).cfg, get_smoke_model(arch).cfg
    return jcfg.moe, cfg.moe, cfg.d_model


# ---------------------------------------------------------------------------
# routing and the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,T,want", [
    ("moonshot-v1-16b-a3b", 1024, 120), ("dbrx-132b", 1024, 320),
    ("moonshot-v1-16b-a3b", 8, 1), ("dbrx-132b", 8, 2)])
def test_capacity_matches_reference(arch, T, want):
    """C = max(1, int(1.25 T k / E)) at the full configs: 120 slots an
    expert for moonshot at 8 x 128 tokens, 1 at a decode batch of 8."""
    jcfg = j_get_model(arch).cfg.moe
    got = moe.capacity(moe.MoEConfig(**dataclasses.asdict(jcfg)), T)
    assert got == want == max(1, int(jcfg.capacity_factor * T * jcfg.top_k
                                      / jcfg.n_experts))


def test_positions_in_expert_match_reference():
    choices = np.random.default_rng(0).integers(0, 64, size=6 * 1024)
    got = moe._positions_in_expert(torch.from_numpy(choices), 64)
    want = jmoe._positions_in_expert(jnp.asarray(choices), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("router", ["drawn", "zero"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dbrx-132b"])
def test_routing_matches_reference(arch, router):
    """Choices, positions and keep exact; the aux loss within 1e-6. A zero
    router ties every expert: both pick experts 0..k-1.

    The renormalised probabilities are held to a band derived from a
    float64 evaluation of the same routing (the same x, router and
    choices). Each side's f32 router product (the port's ``torch.matmul``,
    the reference's ``_plain_matmul``) sits D from the f64 product; a
    logit error D moves a renormalised top-k probability by at most
    exp(2D) - 1 relative. Each side's probabilities must lie within that
    of the float64 ones, plus 8 ulps of 2^-24 for its f32 softmax, and the
    two sides within the sum of their bands. Measured on an AVX-512 host,
    moonshot drawn: D 1.4e-6 for the port (5.9 ulps of its largest logit,
    MKL's summation order) and 4.6e-7 for the reference; the port's
    probabilities 9.9e-7 from the float64 ones (band 3.3e-6), the
    reference's 2.9e-7 (1.4e-6), the two 1.0e-6 apart (band 4.7e-6). A zero
    router has D = 0: both sides within 4.8e-7 of each other."""
    jcfg, cfg, d = _cfgs(arch)
    jp, tp = _moe_params(jcfg, d)
    if router == "zero":
        jp["router"] = np.zeros_like(jp["router"])
        with torch.no_grad():
            tp["router"].zero_()
    x = _np((64, d), 1)
    ji, jpr, jaux = jmoe._routing(jp, jnp.asarray(x), jcfg, None)
    ti, tpr, taux = moe._routing(tp, torch.from_numpy(x), cfg, None)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    logits = x.astype(np.float64) @ jp["router"].astype(np.float64)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    top = np.take_along_axis(e / e.sum(-1, keepdims=True), np.asarray(ji), -1)
    top /= top.sum(-1, keepdims=True)
    port_logits = torch.matmul(torch.from_numpy(x), tp["router"].detach())
    ref_logits = jdithered._plain_matmul(jnp.asarray(x),
                                         jnp.asarray(jp["router"]))
    band = {}
    for side, lg, pr in (("port", port_logits.numpy(), tpr.detach().numpy()),
                         ("ref", np.asarray(ref_logits), np.asarray(jpr))):
        drift = np.abs(lg.astype(np.float64) - logits).max()
        band[side] = np.expm1(2 * drift) + 8 * 2.0 ** -24
        dist = np.max(np.abs(pr.astype(np.float64) - top) / top)
        assert dist <= band[side], (side, dist, drift)
    np.testing.assert_allclose(tpr.detach().numpy(), np.asarray(jpr),
                               rtol=band["port"] + band["ref"])
    assert abs(float(taux) - float(jaux)) <= 1e-6
    if router == "zero":
        assert (ti.numpy() == np.arange(cfg.top_k)).all()
    cap = moe.capacity(cfg, 64)
    _, _, keep = moe.dispatch_masks(ti, tpr, cap, cfg.n_experts,
                                    torch.float32)
    jpos = np.asarray(jmoe._positions_in_expert(ji.reshape(-1),
                                                jcfg.n_experts))
    np.testing.assert_array_equal(keep.numpy(), jpos < cap)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["c1.25", "c0.5"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dbrx-132b"])
def test_moe_layer_matches_reference(arch, capacity_factor):
    """The einsum dispatch at the smoke widths (and at half capacity, where
    choices drop): output rtol 1e-5, aux 1e-6."""
    jcfg, cfg, d = _cfgs(arch)
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jp, tp = _moe_params(jcfg, d, seed=3)
    x = _np((2, 16, d), 4)
    want, jaux = jmoe.moe_layer(jp, jnp.asarray(x), jcfg, None)
    with torch.no_grad():
        got, aux = moe.moe_layer(tp, torch.from_numpy(x), cfg, None)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("int8_wire", [False, True])
def test_a2a_dispatch_raises(int8_wire):
    _, cfg, d = _cfgs("dbrx-132b")
    cfg = dataclasses.replace(cfg, dispatch="a2a", a2a_int8=int8_wire)
    _, tp = _moe_params(_cfgs("dbrx-132b")[0], d)
    with pytest.raises(NotImplementedError, match="section 1, item 7.2"):
        moe.moe_layer(tp, torch.zeros(1, 4, d), cfg, None)
    assert moe.resolve_dispatch(dataclasses.replace(cfg, dispatch="auto")) \
        == "einsum"


# ---------------------------------------------------------------------------
# the dithered einsum
# ---------------------------------------------------------------------------

SPECS = ["ecd,edf->ecf", "ecf,efd->ecd", "btk,kn->btn", "tk,kn->tn",
         "ecd,efd->ecf", "ab,cb->ac", "ij->ji", "...k,kn->...n",
         "aab,bc->aac", "becd,bdf->becf", "ecd,edf->cef"]


def test_einsum_form_matches_reference():
    for spec in SPECS:
        assert dithered._einsum_form(spec) == jdithered._einsum_form(spec), spec


class FedCtx(DitherCtx):
    """The reference's draw for every layer: ``key_for(name)`` of ``jctx``."""

    def __init__(self, policy, jctx):
        super().__init__(policy, device="cpu")
        self.jctx = jctx

    def unit_noise(self, name, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.jctx.key_for(name), tuple(shape), jnp.float32, -0.5, 0.5)))


def _jnp_delta(monkeypatch):
    monkeypatch.setattr(nsd, "compute_delta", lambda x, s: torch.from_numpy(
        np.array(jnsd.compute_delta(jnp.asarray(x.detach().float().numpy()), s))))


EINSUM_CASES = {  # spec: (x shape, w shape), C and N off the 128 tile
    "ecd,edf->ecf": ((4, 20, 96), (4, 96, 160)),
    "ecf,efd->ecd": ((3, 120, 64), (3, 64, 200)),
    "btk,kn->btn": ((2, 40, 96), (96, 160)),
}


def _einsum_both(spec, variant, monkeypatch, record=None):
    """The reference's and the port's (dx, dW) of ``spec`` for fixed x, w
    and cotangent, the reference's draw and Delta fed."""
    xs, ws = EINSUM_CASES[spec]
    x, w = _np(xs, 5), _np(ws, 6, 0.1)
    y_shape = np.einsum(spec, x, w).shape
    g = _np(y_shape, 7, 1e-2)
    jctx = JCtx(key=jax.random.PRNGKey(11), policy=JPolicy(variant=variant))
    if record is not None:
        real = jops.quantize_and_mask

        def recording(g2d, key, s, **kw):
            q = real(g2d, key, s, **kw)
            jax.debug.callback(lambda k: record.append(np.asarray(k)), q.k)
            return q
        monkeypatch.setattr(jops, "quantize_and_mask", recording)
    _, vjp = jax.vjp(lambda a, b: j_einsum(spec, a, b, ctx=jctx, name="fc"),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    _jnp_delta(monkeypatch)
    ctx = FedCtx(DitherPolicy(variant=variant), jctx)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    dithered.dithered_einsum(spec, xt, wt, ctx=ctx, name="fc").backward(
        torch.from_numpy(g))
    return (np.asarray(jdx), np.asarray(jdw)), (xt.grad.numpy(),
                                                wt.grad.numpy())


@pytest.mark.parametrize("spec", list(EINSUM_CASES))
def test_kernel_einsum_backward_matches_reference(spec, monkeypatch):
    """One NSD over the whole cotangent (k bit for bit against the
    reference's kernel), then, for the batched form, one pack and two int8
    products per slice: each slice's bitmap, nnz and mask equal to the
    reference's ``quantized_from_indices``; dx and dW within 1e-5."""
    record, qs, packs, int8s = [], [], [], []
    real_q, real_pack = ops.quantize_and_mask, pack.bitmap_pack_blocked
    real_i8 = bsp_matmul.bsp_matmul_int8

    def q_rec(g2d, noise, s):
        q = real_q(g2d, noise, s)
        qs.append(q)
        return q

    def pack_rec(k, **kw):
        packs.append(k.clone())
        return real_pack(k, **kw)

    def i8_rec(*a, **kw):
        int8s.append(None)
        return real_i8(*a, **kw)
    monkeypatch.setattr(ops, "quantize_and_mask", q_rec)
    monkeypatch.setattr(pack, "bitmap_pack_blocked", pack_rec)
    monkeypatch.setattr(bsp_matmul, "bsp_matmul_int8", i8_rec)
    ops.KERNEL_FALLBACKS.clear()
    jfallbacks = dict(jops.KERNEL_FALLBACKS)
    (jdx, jdw), (dx, dw) = _einsum_both(spec, "kernel", monkeypatch, record)
    assert not ops.KERNEL_FALLBACKS and jops.KERNEL_FALLBACKS == jfallbacks
    assert len(qs) == len(record) == 1
    T, N = qs[0].shape
    np.testing.assert_array_equal(qs[0].k.numpy(), record[0])
    n_b = EINSUM_CASES[spec][0][0] if dithered._einsum_form(spec) == "batched" else 0
    assert len(packs) == n_b and len(int8s) == 2 * max(n_b, 1)
    for e, kp in enumerate(list(packs)):
        rows = T // n_b
        want = jops.quantized_from_indices(
            jnp.asarray(record[0][e * rows:(e + 1) * rows, :N]), jnp.float32(1))
        np.testing.assert_array_equal(kp.numpy(), np.asarray(want.k))
        got = ops.quantized_from_indices(kp[:rows, :N], torch.tensor(1.0))
        for f in ("bitmap", "nnz", "mask"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
    assert _rel_l2(dx, jdx) <= 1e-5 and _rel_l2(dw, jdw) <= 1e-5


@pytest.mark.parametrize("spec", list(EINSUM_CASES))
def test_paper_einsum_backward_matches_reference(spec, monkeypatch):
    (jdx, jdw), (dx, dw) = _einsum_both(spec, "paper", monkeypatch)
    assert _rel_l2(dx, jdx) <= 1e-5 and _rel_l2(dw, jdw) <= 1e-5


def test_unsupported_einsum_form_is_a_counted_fallback(monkeypatch):
    """``ecd,efd->ecf`` (w stored (E, N, K)) has no kernel form: both sides
    count the fallback and take the generic quantized path."""
    spec = "ecd,efd->ecf"
    x, w, g = _np((2, 8, 16), 1), _np((2, 24, 16), 2, 0.1), _np((2, 8, 24), 3)
    jctx = JCtx(key=jax.random.PRNGKey(2), policy=JPolicy(variant="kernel"))
    jops.KERNEL_FALLBACKS.clear()
    _, vjp = jax.vjp(lambda a, b: j_einsum(spec, a, b, ctx=jctx, name="fc"),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    _jnp_delta(monkeypatch)
    ops.KERNEL_FALLBACKS.clear()
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    dithered.dithered_einsum(spec, xt, wt, ctx=FedCtx(
        DitherPolicy(variant="kernel"), jctx), name="fc").backward(
        torch.from_numpy(g))
    assert ops.KERNEL_FALLBACKS == jops.KERNEL_FALLBACKS == {
        "einsum:unsupported-form:" + spec: 1}
    assert _rel_l2(xt.grad.numpy(), jdx) <= 1e-5
    assert _rel_l2(wt.grad.numpy(), jdw) <= 1e-5


def test_moe_kernel_step_calls_per_block(monkeypatch):
    """One kernel-variant step of moonshot's smoke model (lm_head off):
    per block one NSD a dense (attention 4, router 1, shared 3) and one an
    expert einsum (3); a pack per expert slice (3 x E); two int8 products a
    dense and two an expert slice; no fallback. chip_smoke.py phase 12c
    holds the card's launches to this count."""
    m = get_smoke_model("moonshot-v1-16b-a3b")
    E, n_l = m.cfg.moe.n_experts, m.cfg.n_layers
    calls = {"nsd": 0, "pack": 0, "int8": 0}

    def counting(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(nsd_quant, "nsd_quantize",
                        counting("nsd", nsd_quant.nsd_quantize))
    monkeypatch.setattr(pack, "bitmap_pack_blocked",
                        counting("pack", pack.bitmap_pack_blocked))
    monkeypatch.setattr(bsp_matmul, "bsp_matmul_int8",
                        counting("int8", bsp_matmul.bsp_matmul_int8))
    ops.KERNEL_FALLBACKS.clear()
    from repro_torch.core import schedule
    prog = schedule.parse_program("phase@0=kernel;rule lm_head:off",
                                  DitherPolicy(s=2.0))
    ctx = DitherCtx(prog.phase_policy_at(0), program=prog, device="cpu")
    net = m.init(0, "cpu")
    batch = token_batch(TokenStreamConfig(vocab=512, seq_len=16, batch=2), 0,
                        device="cpu")
    loss = m.loss(net, batch, ctx=ctx)
    loss.backward()
    assert torch.isfinite(loss) and not ops.KERNEL_FALLBACKS
    assert calls == {"nsd": n_l * (4 + 1 + 3 + 3), "pack": n_l * 3 * E,
                     "int8": n_l * (2 * 8 + 2 * 3 * E)}
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in net.parameters())


@pytest.mark.parametrize("variant", ["paper", "kernel"])
def test_einsum_residual_modes(variant):
    """The expert einsum under the memory policy's residual modes, as a
    dense layer: ``remat`` reruns the forward in the backward and gives
    the fp32 residual's dx and dW; ``nsd`` stores x NSD-encoded, so dx
    (which never reads x) is unchanged and only dW moves."""
    from repro_torch.memory.policy import parse_memory_program

    spec = "ecd,edf->ecf"
    x, w, g = _np((4, 20, 96), 5), _np((4, 96, 160), 6, 0.1), _np((4, 20, 160), 7)
    out = {}
    for mode in ("fp32", "remat", "nsd"):
        ctx = DitherCtx(DitherPolicy(variant=variant), seed=3, device="cpu",
                        memory=parse_memory_program(f"default={mode}"))
        xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        y = dithered.dithered_einsum(spec, xt, wt, ctx=ctx, name="L.moe.up")
        torch.testing.assert_close(y, torch.einsum(spec, xt, wt), rtol=0, atol=0)
        y.backward(torch.from_numpy(g))
        out[mode] = (xt.grad, wt.grad)
    for a, b in zip(out["remat"], out["fp32"]):
        assert torch.equal(a, b)
    assert torch.equal(out["nsd"][0], out["fp32"][0])
    assert not torch.equal(out["nsd"][1], out["fp32"][1])
    assert _rel_l2(out["nsd"][1], out["fp32"][1]) < 0.5
