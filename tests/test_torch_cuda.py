"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and nvcc;
without one they skip (marker ``cuda``). On a machine with the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
need not have.)
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.policy import DitherCtx, DitherPolicy  # noqa: E402
from repro_torch.core import dithered  # noqa: E402
from repro_torch.kernels import build, bsp_matmul, nsd_quant, pack  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, device=cuda, generator=g)


@pytest.mark.parametrize("shape", [(128, 128), (384, 256)])
@pytest.mark.parametrize("s", [2.0, 0.0])
def test_nsd_kernel_matches_plain(cuda, shape, s):
    x = _rand(shape, cuda, 1)
    delta = (s * x.std(correction=0)).reshape(())
    nu = (torch.rand(shape, device=cuda) - 0.5) * delta
    before = build.LAUNCHES["nsd_quant"]
    got = nsd_quant.nsd_quantize_blocked(x, nu, delta)
    assert build.LAUNCHES["nsd_quant"] == before + 1
    want = nsd_quant.nsd_quantize_blocked_plain(x, nu, delta)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pack_kernel_matches_plain(cuda):
    k = (_rand((256, 384), cuda, 2) * 2).round().clamp(-127, 127).to(torch.int8)
    k[:128, 128:256] = 0
    got = pack.bitmap_pack_blocked(k)
    want = pack.bitmap_pack_blocked_plain(k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[2][0, 1]) == 0


@pytest.mark.parametrize("trans_a,trans_b", [(False, True), (True, False),
                                             (False, False), (True, True)])
def test_bsp_kernel_matches_plain(cuda, trans_a, trans_b):
    a = (_rand((256, 384), cuda, 3) * 40).clamp(-127, 127).to(torch.int8)
    b = (_rand((384, 128), cuda, 4) * 40).clamp(-127, 127).to(torch.int8)
    mask = torch.tensor([[1, 0, 1], [0, 0, 1]], dtype=torch.int32, device=cuda)
    if trans_a:
        a, mask = a.t().contiguous(), mask.t().contiguous()
    if trans_b:
        b = b.t().contiguous()
    scale = torch.tensor(3e-3, device=cuda)
    got = bsp_matmul.bsp_matmul_int8(a, b, scale, mask, trans_a=trans_a,
                                     trans_b=trans_b)
    want = bsp_matmul.bsp_matmul_int8_plain(a, b, scale, mask, trans_a=trans_a,
                                            trans_b=trans_b)
    assert torch.equal(got, want)


def test_wrapper_rejects_unaligned_cuda_operands(cuda):
    x = torch.zeros(128 * 128 + 1, device=cuda)[1:].reshape(128, 128)
    with pytest.raises(ValueError, match="aligned"):
        nsd_quant.nsd_quantize_blocked(x, x, torch.zeros((), device=cuda))


def test_dense_kernel_backward_launches_each_kernel(cuda):
    x = _rand((100, 200), cuda, 5).requires_grad_()
    w = (_rand((200, 72), cuda, 6) * 0.1).requires_grad_()
    ctx = DitherCtx(DitherPolicy(variant="kernel"), device=cuda)
    build.reset_launches()
    dithered.dense(x, w, ctx=ctx, name="fc").sum().backward()
    torch.cuda.synchronize()
    assert build.LAUNCHES == {"nsd_quant": 1, "bitmap_pack": 1,
                              "bsp_matmul_int8": 2}
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()
