#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. hold the fused NSD kernel bit-exact against its plain PyTorch version
     on both routes (the dither drawn inside from a stream key, and fed) at
     the unpadded cotangents of VGG11 layers c0 (131,072 x 64), c1, c5 and
     fc2 (128 x 10) at batch 128 and at delta = 0, its bitmap, counts and
     mask against the pack's plain version on its k; the draw-only Philox
     kernel against its plain version; the pack kernel at c0's padded k and
     with an empty tile; the int8 matmul at c1 and c5 with full and empty
     masks;
  3b. hold the levels compact and expand kernels (chunk-local, and the
     one-launch wire kernels that lay out a whole chunk stream: levels,
     bitmap and nnz; its decode) and the bitmap-unpack kernel bit for bit
     against their plain versions at c1's residual size at batch 128
     (2,097,152 elements, 8,192 chunks) and at the edges (an all-zero and
     an all-non-zero chunk, an all-zero and an all-non-zero tensor, one
     chunk, 2^18 chunks for the wire kernels, n = 1000 through the wire
     container), and the dequant product
     within its band (relative L2 <= 8 sqrt(K) 2^-24 for a K-long
     contraction) at the c1 and c5 dx and dW shapes with full, empty and
     partial masks;
  4. train VGG11-CIFAR at full width, batch 128, 5 steps, variant=kernel,
     through ``repro_torch.train.classifier.train_classifier``; check the
     loss is finite, the launch counts (per step: NSD 11, bsp 21, c0's dx
     being skipped because the images need no gradient; pack and the draw
     kernel 0: the NSD kernel draws the dither and writes the bitmap and
     tile mask itself), that no
     structural fallback happened, that dither sparsity is within 8 points
     of the same steps run on the plain versions, and that step 1's
     gradients agree with the plain versions' (relative L2 <= 1e-5 per
     parameter; the kernels are bit-exact, so 0 is expected);
  4b. the same training with ``memory="default=nsd"``: every dithered
     layer's input is NSD-encoded into the wire container in the forward
     and decoded in the backward. Check the loss is finite, the launch
     counts (per step: NSD 22, wire compact 11, wire expand 11, bsp 21;
     pack, unpack and the draw kernel 0), no fallback,
     ``residual_compression`` equal to the plain
     versions' run (relative 1e-6), sparsity within 8 points of phase 4's
     run, step-1 gradients against the plain versions (relative L2 <=
     1e-5), and step-1 BatchNorm and bias gradients and dither telemetry
     identical to the fp32-residual step's (only weight gradients move);
  4c. the f32-operand backward: ``ops.dithered_backward_matmuls(...,
     int8_operands=False)`` on every layer's captured (g, x, w, u) of one
     step, held to its plain versions and to the paper variant's f32
     products within the dequant band, with its launches counted (NSD 11,
     dequant 22);
  4d. the paper variant (NSD in f32 ops, f32 products) for 5 steps: its
     only kernel is the draw-only Philox kernel, 11 launches a step; loss
     finite, step time printed;
  5. capture every kernel input of one step (for the NSD kernel its
     cotangent calls of the fp32 step and, apart, its calls in the nsd
     step's residual encode; for compact and expand the wire calls of the
     nsd step; for pack and unpack, which no path launches now, the fp32
     step's k and the bitmaps of the nsd step's decodes; for the draw
     kernel the fp32 step's cotangent shapes), hold each call against its
     plain version again (the
     dequant product and the wire kernels also against a second launch of
     themselves, the wire kernels also against a CUDA-graph replay, bit for
     bit), log each matmul call's split-K count, and time kernel, plain
     version and the library yardstick with CUDA events (every kernel also
     by CUDA-graph replay, but unpack; the chunk-local compact
     and expand on the same chunks on lines of their own), beside the
     least time the card could take (bytes over 3.35 TB/s, or operations
     over the peak rate of the units that do them); then break one step's
     device time (and the host's self CPU time by op) down with
     torch.profiler, for fp32 and for nsd residuals and for the
     f32-operand backward, and print one step's peak device memory for the
     first two;
  5a. (before the timing) the split-K edges of both matmuls, with A read
     transposed as dW reads it: c0's dW shape at batch 128 (128 x 131,072
     x 128, which must run split), a K-tile count the split count does not
     divide, a split whose K-tiles are all masked, only the last K-tile
     occupied, and an all-masked mask (zeros); the int8 product bit-exact,
     the dequant product within its band and equal over two launches;
  5d. time the fp32-residual and the nsd forward+backward step in turns
     (host clock around synchronised steps, median of 15 each) and print
     the nsd step's excess;
  6. print one JSON line naming the seven kernels (the NSD row carries its
     residual-encode figures under ``nsd_residual_encode``, the draw-only
     kernel of its source under ``philox_uniform``; phase 5's log gives
     the NSD row's bound by the padded definition too, 9 bytes a padded
     element);
  7. print the JSON result line last.

It imports nothing of JAX or of the reference package, and needs the
checkout's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12  # f32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # dense TF32 tensor-core peak
BATCH, STEPS, SEED = 128, 5, 0
STEP_PAIRS = 15  # phase 5d: fp32 and nsd steps, taken in turns
# the kernel variant: one NSD launch a layer (the dither drawn inside, the
# bitmap and tile mask written with k), two products but for c0's dx
PER_STEP = {"nsd_quant": 11, "bitmap_pack": 0, "bsp_matmul_int8": 21,
            "philox_uniform": 0}
# memory="default=nsd": each of the 11 layers encodes its input (NSD, wire
# compact) in the forward and decodes it (wire expand) in the backward
NSD_PER_STEP = {"nsd_quant": 22, "bitmap_pack": 0, "bsp_matmul_int8": 21,
                "levels_compact": 11, "bitmap_unpack": 0, "levels_expand": 11,
                "bsp_matmul_dequant": 0, "philox_uniform": 0}
# the f32-operand backward of the 11 layers: one NSD each, both products on
# the dequant kernel
F32_OPERAND_LAUNCHES = {"nsd_quant": 11, "bsp_matmul_dequant": 22}
# the paper variant: the unit draw of each layer, nothing else
PAPER_PER_STEP = {"philox_uniform": 11}
# the unpadded cotangents (T, N) of the fp32 step at batch 128, held on
# both NSD routes in phase 3
COTANGENTS = {"c0": (131072, 64), "c1": (32768, 128), "c5": (2048, 512),
              "fc2": (128, 10)}
MEMORY = "default=nsd"
SPARSITY_BAND = 8.0  # percentage points (Table 1's own band)
GRAD_BAND = 1e-5  # relative L2, kernels vs plain versions
COMPRESSION_BAND = 1e-6  # relative, kernels vs plain versions

KERNELS = {
    "nsd_quant": ("src/repro_torch/kernels/csrc/nsd_quant.cu",
                  "src/repro/kernels/nsd_quant/nsd_quant.py:27"),
    "bitmap_pack": ("src/repro_torch/kernels/csrc/pack.cu",
                    "src/repro/kernels/pack/pack.py:52"),
    "bsp_matmul_int8": ("src/repro_torch/kernels/csrc/bsp_matmul_int8.cu",
                        "src/repro/kernels/bsp_matmul/bsp_matmul.py:63"),
    "bitmap_unpack": ("src/repro_torch/kernels/csrc/pack.cu",
                      "src/repro/kernels/pack/pack.py:67"),
    "levels_compact": ("src/repro_torch/kernels/csrc/levels.cu",
                       "src/repro/kernels/levels/levels.py:112"),
    "levels_expand": ("src/repro_torch/kernels/csrc/levels.cu",
                      "src/repro/kernels/levels/levels.py:123"),
    "bsp_matmul_dequant": ("src/repro_torch/kernels/csrc/bsp_matmul_dequant.cu",
                           "src/repro/kernels/bsp_matmul/bsp_matmul.py:44"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def f32_band(K: int) -> float:
    """Relative L2 band of two f32 evaluations of a K-long contraction in
    different orders: the rounding of a sum of K random-sign terms grows as
    sqrt(K) u relative to the result (u = 2^-24); 8x that."""
    return 8 * math.sqrt(K) * 2.0 ** -24


def profile_step(torch, step_fn, card, label, steps=3):
    """Print the device time per step of the top kernels, of the port's
    kernels, and the device's busy share of the wall time, from
    torch.profiler over ``steps`` forward+backward passes. Informational:
    where the profiler records no device time it says so and moves on."""
    from torch.profiler import ProfilerActivity, profile

    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op also reports, as its own device
        # time, the kernels it launched, and would be counted twice
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count // steps, e.key))
    if not rows:
        log(f"phase 5b ({label}): torch.profiler recorded no device time: not measured")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"phase 5b ({label}): forward+backward of one batch-{BATCH} step: wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{sum(r[1] for r in rows)} device kernels launched ({card})")
    # a matmul's name also matches its split-K reduce kernel, listed after it;
    # "Memset" counts the wire kernels' workspace clears among others
    for name in ("nsd_quant_kernel", "philox_uniform_kernel", "bitmap_pack_kernel",
                 "bsp_int8_kernel",
                 "bsp_int8_kernel_reduce", "levels_compact_kernel",
                 "levels_compact_wire_kernel", "bitmap_unpack_kernel",
                 "levels_expand_kernel", "levels_expand_wire_kernel",
                 "bsp_dequant_kernel", "bsp_dequant_kernel_reduce", "Memset"):
        ms = sum(r[0] for r in rows if name in r[2])
        n = sum(r[1] for r in rows if name in r[2])
        log(f"  port kernel {name}: {ms:.4f} ms device time per step over {n} launches")
    for ms, n, key in rows[:15]:
        log(f"  {ms:9.4f} ms  x{n:<4d} {key[:100]}")
    # the host side: self CPU time of the recorded (aten) ops; the rest of
    # the wall is Python, ctypes launches and the profiler's own cost
    host = sorted(((e.self_cpu_time_total / 1e3 / steps, e.count // steps, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU
                   and e.self_cpu_time_total > 0), reverse=True)
    log(f"  host: {sum(h[0] for h in host):.3f} ms per step of self CPU time in "
        f"{sum(h[1] for h in host)} recorded ops, under the profiler")
    for ms, n, key in host[:8]:
        log(f"  host {ms:9.4f} ms  x{n:<4d} {key[:80]}")


def main() -> int:
    import torch

    # -- phase 1 ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.int8 import absmax_int8
    from repro_torch.kernels import build, bsp_matmul, levels, nsd_quant, ops, pack
    from repro_torch.quant import wire

    # every wrapper, its module and its plain version
    modules = {"nsd_quant": (nsd_quant, "nsd_quantize"),
               "bitmap_pack": (pack, "bitmap_pack_blocked"),
               "bsp_matmul_int8": (bsp_matmul, "bsp_matmul_int8"),
               "bitmap_unpack": (pack, "bitmap_unpack"),
               "levels_compact": (levels, "levels_compact_wire"),
               "levels_expand": (levels, "levels_expand_wire"),
               "bsp_matmul_dequant": (bsp_matmul, "bsp_matmul"),
               "philox_uniform": (nsd_quant, "philox_uniform")}
    kernel = {k: getattr(m, a) for k, (m, a) in modules.items()}
    plain = {k: getattr(m, a + "_plain") for k, (m, a) in modules.items()}

    @contextlib.contextmanager
    def swapped(fns):
        """Route the named wrappers through other functions for a while."""
        saved = {k: getattr(*modules[k]) for k in fns}
        for k, fn in fns.items():
            setattr(*modules[k], fn)
        try:
            yield
        finally:
            for k, fn in saved.items():
                setattr(*modules[k], fn)

    def plain_kernels():
        """Route the ops through the kernels' plain versions (on the card)."""
        return swapped(plain)

    # -- phase 2 ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"phase 2: built the kernels in {time.perf_counter() - t0:.1f} s")

    max_err = {k: 0.0 for k in modules}

    def same(kname, got, want, what):
        for g, w in zip(got, want):
            if g is None or w is None:  # an output not asked for (the bitmap)
                check(g is None and w is None, f"{kname} {what}: one output missing")
                continue
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{kname} {what}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            err = float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
            max_err[kname] = max(max_err[kname], err)
            check(torch.equal(g, w), f"{kname} {what}: differs from the plain "
                                     f"version (max abs err {err})")

    def banded(kname, got, want, K, what):
        """got within the f32 band of want (a K-long contraction); exact
        zeros where want is all zero (an empty mask)."""
        check(got.shape == want.shape, f"{kname} {what}: {got.shape} vs {want.shape}")
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        max_err[kname] = max(max_err[kname], err)
        ref = float(want.double().norm())
        if ref == 0.0:
            check(not got.any(), f"{kname} {what}: non-zero output, want zeros")
            return 0.0
        rel = float((got.double() - want.double()).norm()) / ref
        check(rel <= f32_band(K), f"{kname} {what}: relative L2 {rel} > "
                                  f"{f32_band(K)} (K = {K})")
        return rel

    # -- phase 3 ----------------------------------------------------------
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    key = 0x9E3779B97F4A7C15
    for name, (T, N) in COTANGENTS.items():
        g = torch.randn(T, N, device=dev, generator=gen) * 1e-3
        for s in (2.0, 0.0):
            delta = (s * torch.std(g, correction=0)).reshape(())
            nu = nsd_quant.philox_uniform_plain(key, (T, N), device=dev) * delta
            what = f"{name} delta={'0' if s == 0 else 's*std'}"
            got = nsd_quant.nsd_quantize(g, delta, key=key)
            same("nsd_quant", got, nsd_quant.nsd_quantize_plain(g, delta, key=key),
                 f"{what} key route")
            fed = nsd_quant.nsd_quantize(g, delta, noise=nu)
            same("nsd_quant", fed, nsd_quant.nsd_quantize_plain(g, delta, noise=nu),
                 f"{what} fed route")
            same("nsd_quant", fed, got, f"{what}: fed draw against the key")
            same("nsd_quant", got[1:], pack.bitmap_pack_blocked_plain(got.k),
                 f"{what}: bitmap, nnz, mask against the pack's")
            check(not got.k[T:].any() and not got.k[:, N:].any(),
                  f"nsd_quant {what}: non-zero padding")
        same("philox_uniform", (nsd_quant.philox_uniform(key, (T, N), device=dev),),
             (nsd_quant.philox_uniform_plain(key, (T, N), device=dev),), name)
    # c0's padded k (the largest pack the path would run), and c1 and c5
    # with an empty tile; the int8 matmul on c1's and c5's k
    kc0 = nsd_quant.nsd_quantize(torch.randn(131072, 64, device=dev, generator=gen),
                                 torch.tensor(2.0, device=dev), key=key).k
    same("bitmap_pack", pack.bitmap_pack_blocked(kc0), pack.bitmap_pack_blocked_plain(kc0),
         "c0")
    del kc0
    # (T, K_in, N_out) padded to 128: c1 (16x16x64 -> 128), c5 (4x4x512 -> 512)
    for name, (T, K, N) in {"c1": (32768, 640, 128), "c5": (2048, 4608, 512)}.items():
        g = torch.randn(T, N, device=dev, generator=gen) * 1e-3
        x = torch.randn(T, K, device=dev, generator=gen)
        w = torch.randn(K, N, device=dev, generator=gen)
        delta = 2.0 * torch.std(g, correction=0)
        k = nsd_quant.nsd_quantize(g, delta, key=key).k
        k[:128, :128] = 0  # an empty tile
        same("bitmap_pack", pack.bitmap_pack_blocked(k),
             pack.bitmap_pack_blocked_plain(k), name)
        _, _, mask = pack.bitmap_pack_blocked(k)
        check(int(mask[0, 0]) == 0, "empty tile not masked")
        xq = absmax_int8(x).q
        wq = absmax_int8(w).q
        scale = delta * 1e-2
        for mname, m in (("bitmap", mask), ("full", torch.ones_like(mask)),
                         ("empty", torch.zeros_like(mask))):
            for ta, b in ((False, wq), (True, xq)):
                args = (k, b, scale, m)
                kw = dict(trans_a=ta, trans_b=not ta)
                same("bsp_matmul_int8", (bsp_matmul.bsp_matmul_int8(*args, **kw),),
                     (bsp_matmul.bsp_matmul_int8_plain(*args, **kw),),
                     f"{name} {'dW' if ta else 'dx'} mask={mname}")
    torch.cuda.synchronize()
    log(f"phase 3: kernels bit-exact against their plain versions "
        f"(max abs err {max(max_err.values())}); NSD on both routes at "
        f"{', '.join(f'{n} {t}x{c}' for n, (t, c) in COTANGENTS.items())}")

    # -- phase 3b ---------------------------------------------------------
    def sparse_levels(C, density):
        vals = torch.randint(1, 128, (C, 256), device=dev, generator=gen)
        sign = torch.randint(0, 2, (C, 256), device=dev, generator=gen) * 2 - 1
        keep = torch.rand((C, 256), device=dev, generator=gen) < density
        return torch.where(keep, vals * sign, 0).to(torch.int8)

    # c1's residual at batch 128 (128 x 16 x 16 x 64 = 8,192 chunks) at the
    # non-zero share NSD gives at s = 1, an all-zero and an all-non-zero chunk
    k = sparse_levels(8192, 0.6)
    k[0] = 0
    k[1] = sparse_levels(1, 1.0)[0]
    for what, kk in (("c1 residual", k), ("one chunk", sparse_levels(1, 0.4))):
        got = levels.levels_compact(kk)
        same("levels_compact", got, levels.levels_compact_plain(kk), what)
        mask = (kk != 0).to(torch.int8)
        out = levels.levels_expand(got[0], mask)
        same("levels_expand", (out,), (levels.levels_expand_plain(got[0], mask),), what)
        check(torch.equal(out, kk), f"levels_expand {what}: not the inverse of compact")
        bitmap = pack.bitmap_pack_blocked(torch.nn.functional.pad(
            kk, (0, 0, 0, (-kk.shape[0]) % 128)))[0][:kk.shape[0]]
        unpacked = pack.bitmap_unpack(bitmap)
        same("bitmap_unpack", (unpacked,), (pack.bitmap_unpack_plain(bitmap),), what)
        check(torch.equal(unpacked, mask), f"bitmap_unpack {what}: not the mask")
    counts = levels.levels_compact(k)[1]
    check(int(counts[0]) == 0 and int(counts[1]) == 256, "edge chunk counts")
    # the wire kernels: the whole chunk stream in one launch each way
    # (2^18 chunks: 8,192 blocks, more than the card holds at once)
    for what, kk in (("c1 residual", k), ("all-zero c1 residual", torch.zeros_like(k)),
                     ("all-non-zero c1 residual", sparse_levels(8192, 1.0)),
                     ("one chunk", sparse_levels(1, 0.4)),
                     ("2^18 chunks", sparse_levels(1 << 18, 0.6))):
        got = levels.levels_compact_wire(kk)
        same("levels_compact", got, levels.levels_compact_wire_plain(kk), f"wire {what}")
        check(int(got[2]) == int((kk != 0).sum()), f"levels_compact wire {what}: nnz")
        out = levels.levels_expand_wire(got[0], got[1])
        same("levels_expand", (out,), (levels.levels_expand_wire_plain(got[0], got[1]),),
             f"wire {what}")
        check(torch.equal(out, kk), f"levels_expand wire {what}: not the inverse of compact")
    del got, out, kk
    for n in (1000, 2_097_152):  # not a chunk multiple; c1's residual size
        xr = torch.relu(torch.randn(n, device=dev, generator=gen))
        ur = torch.rand(n, device=dev, generator=gen) - 0.5
        for noise in (ur, 12345):  # fed, and the stream key's draw
            pk = wire.pack_nsd(xr, noise, 1.0)
            pp = wire.pack_nsd(xr, noise, 1.0, backend="plain")
            for f in ("levels", "bitmap", "deltas", "nnz"):
                check(torch.equal(getattr(pk, f), getattr(pp, f)),
                      f"wire container n={n}: {f} differs from the plain route")
            check(torch.equal(wire.unpack_nsd(pk), wire.unpack_nsd(pp, backend="plain")),
                  f"wire decode n={n} differs from the plain route")

    # the dequant product at the c1 and c5 dx and dW shapes: (T, N, K_in)
    rels = []
    for name, (T, N, K) in {"c1": (32768, 128, 640), "c5": (2048, 512, 4608)}.items():
        kq = torch.where(torch.rand(T, N, device=dev, generator=gen) < 0.2,
                         torch.randint(-6, 7, (T, N), device=dev, generator=gen),
                         0).to(torch.int8)
        _, _, mask = pack.bitmap_pack_blocked(kq)
        w_t = torch.randn(N, K, device=dev, generator=gen)  # w^T, (N, K)
        x = torch.relu(torch.randn(T, K, device=dev, generator=gen))
        d = torch.tensor(3e-3, device=dev)
        partial = (torch.rand(mask.shape, device=dev, generator=gen) < 0.5).to(torch.int32)
        for mname, m in (("full", torch.ones_like(mask)), ("partial", partial),
                         ("empty", torch.zeros_like(mask))):
            for ta, b, contraction in ((False, w_t, N), (True, x, T)):
                got = bsp_matmul.bsp_matmul(kq, d, b, m, trans_a=ta)
                want = bsp_matmul.bsp_matmul_plain(kq, d, b, m, trans_a=ta)
                rels.append(banded("bsp_matmul_dequant", got, want, contraction,
                                   f"{name} {'dW' if ta else 'dx'} mask={mname}"))
    torch.cuda.synchronize()
    log(f"phase 3b: compact, expand (chunk-local and wire) and unpack bit-exact "
        f"against their plain versions (max abs err "
        f"{max(max_err[k] for k in ('levels_compact', 'levels_expand', 'bitmap_unpack'))}), "
        f"wire container n=1000 and n=2097152 identical on both routes (fed and "
        f"key draws); dequant "
        f"within its band (worst relative L2 {max(rels):.3e}, max abs err "
        f"{max_err['bsp_matmul_dequant']:.3e})")

    # -- phase 4 ----------------------------------------------------------
    from repro_torch.configs.paper_models import vgg11_cifar
    from repro_torch.core import dithered
    from repro_torch.core.policy import DitherCtx, DitherPolicy
    from repro_torch.data.synthetic import ClassifConfig, classification_batch
    from repro_torch.memory.policy import as_memory_policy
    from repro_torch.models.cnn import CNN, loss_fn
    from repro_torch.obs import metrics
    from repro_torch.train.classifier import train_classifier

    cfg = vgg11_cifar()
    policy = DitherPolicy(variant="kernel", s=2.0, collect_stats=True)
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    res = train_classifier(cfg, policy, steps=STEPS, batch=BATCH, seed=SEED)
    launches = dict(build.LAUNCHES)
    log(f"phase 4: kernel path {json.dumps(res)}")
    log(f"phase 4: launches over {STEPS} steps {launches}")
    check(math.isfinite(res["final_loss"]), f"loss {res['final_loss']}")
    for kname, n in PER_STEP.items():
        check(launches[kname] == n * STEPS,
              f"{kname}: {launches[kname]} launches, want {n} x {STEPS}")
    check(not ops.KERNEL_FALLBACKS, f"fallbacks {ops.KERNEL_FALLBACKS}")

    with plain_kernels():
        build.reset_launches()
        res_plain = train_classifier(cfg, policy, steps=STEPS, batch=BATCH,
                                     seed=SEED)
        check(not any(build.LAUNCHES.values()), "plain run launched a kernel")
    log(f"phase 4: plain versions {json.dumps(res_plain)}")
    check(abs(res["sparsity"] - res_plain["sparsity"]) <= SPARSITY_BAND,
          f"sparsity {res['sparsity']} vs plain {res_plain['sparsity']}")

    dcfg = ClassifConfig(n_classes=cfg.n_classes, img_size=cfg.img_size,
                         channels=cfg.in_channels, noise=0.5, seed=SEED)
    batch0 = classification_batch(dcfg, 0, BATCH)

    def step1(memory=None, collect=False):
        """Step 1's loss, gradients and dither telemetry rows."""
        net = CNN(cfg, seed=SEED)
        ctx = DitherCtx(policy.replace(collect_stats=collect), seed=SEED,
                        step=0, memory=as_memory_policy(memory))
        metrics.reset()
        loss = loss_fn(net, batch0, ctx=ctx)
        loss.backward()
        rows = {t: metrics.rows(t) for t in metrics.tags()}
        return (float(loss.detach()),
                {n: p.grad for n, p in net.named_parameters()}, rows)

    def worst_rel(grads, ref_grads, what):
        worst = 0.0
        for n, gk in grads.items():
            check(bool(torch.isfinite(gk).all()), f"{what}: non-finite gradient {n}")
            ref = float(ref_grads[n].norm())
            rel = float((gk - ref_grads[n]).norm()) / ref if ref else float(gk.norm())
            worst = max(worst, rel)
            check(rel <= GRAD_BAND, f"{what}: step-1 gradient {n}: rel L2 {rel}")
        return worst

    loss_k, grads_k, _ = step1()
    with plain_kernels():
        loss_p, grads_p, _ = step1()
    worst = worst_rel(grads_k, grads_p, "fp32 residuals")
    log(f"phase 4: step-1 loss {loss_k} (plain {loss_p}); worst relative L2 "
        f"gradient difference kernel vs plain {worst}")

    # -- phase 4b: the same training with NSD-encoded residuals ------------
    ops.KERNEL_FALLBACKS.clear()
    build.reset_launches()
    res_nsd = train_classifier(cfg, policy, steps=STEPS, batch=BATCH, seed=SEED,
                               memory=MEMORY)
    launches_nsd = dict(build.LAUNCHES)
    log(f"phase 4b: memory={MEMORY!r} kernel path {json.dumps(res_nsd)}")
    log(f"phase 4b: launches over {STEPS} steps {launches_nsd}")
    check(math.isfinite(res_nsd["final_loss"]), f"loss {res_nsd['final_loss']}")
    for kname, n in NSD_PER_STEP.items():
        check(launches_nsd[kname] == n * STEPS,
              f"{kname}: {launches_nsd[kname]} launches, want {n} x {STEPS}")
    check(not ops.KERNEL_FALLBACKS, f"fallbacks {ops.KERNEL_FALLBACKS}")
    check("residual_compression" in res_nsd, "no residual_compression in the result")
    with plain_kernels():
        build.reset_launches()
        res_nsd_plain = train_classifier(cfg, policy, steps=STEPS, batch=BATCH,
                                         seed=SEED, memory=MEMORY)
        check(not any(build.LAUNCHES.values()), "plain run launched a kernel")
    log(f"phase 4b: plain versions {json.dumps(res_nsd_plain)}")
    comp, comp_plain = res_nsd["residual_compression"], res_nsd_plain["residual_compression"]
    check(abs(comp - comp_plain) <= COMPRESSION_BAND * comp_plain,
          f"residual_compression {comp} vs plain {comp_plain}")
    check(abs(res_nsd["sparsity"] - res["sparsity"]) <= SPARSITY_BAND,
          f"sparsity {res_nsd['sparsity']} vs fp32 residuals {res['sparsity']}")

    loss_n, grads_n, _ = step1(MEMORY)
    with plain_kernels():
        _, grads_np, _ = step1(MEMORY)
    worst_n = worst_rel(grads_n, grads_np, "nsd residuals")
    _, grads_fc, rows_fc = step1(None, collect=True)
    _, grads_nc, rows_nc = step1(MEMORY, collect=True)
    moved = 0
    for n, g in grads_nc.items():
        if n.endswith("_w"):
            moved += not torch.equal(g, grads_fc[n])
        else:
            check(torch.equal(g, grads_fc[n]),
                  f"nsd residuals moved the BatchNorm/bias gradient {n}")
    check(rows_nc.keys() == rows_fc.keys() and all(
        (rows_nc[t] == rows_fc[t]).all() for t in rows_fc),
        "nsd residuals changed the dither telemetry")
    log(f"phase 4b: residual_compression {comp} (plain versions {comp_plain}); "
        f"step-1 loss {loss_n}; worst relative L2 gradient difference kernel vs "
        f"plain {worst_n}; BatchNorm/bias gradients and {len(rows_fc)} telemetry "
        f"rows identical to the fp32-residual step, {moved} of 11 weight "
        f"gradients moved; step time {res_nsd['ms_per_step']:.2f} ms vs "
        f"{res['ms_per_step']:.2f} ms with fp32 residuals ({card})")

    # -- phase 4c: the f32-operand backward (int8_operands=False) ----------
    captured = {}
    real_products = dithered._kernel_products

    def capturing(g2d, x2d, w, noise, pol, name, need_dx):
        # noise: the layer's stream key (an int)
        captured[name] = (g2d.detach().clone(), x2d.detach().clone(),
                          w.detach().clone(), noise, pol.s)
        return real_products(g2d, x2d, w, noise, pol, name, need_dx)

    dithered._kernel_products = capturing
    try:
        step1()
    finally:
        dithered._kernel_products = real_products
    check(len(captured) == 11, f"captured {len(captured)} layers")
    calls = {k: [] for k in KERNELS}

    def recorder(kname, fn, store=calls):
        def rec(*args, **kw):
            store[kname].append(([a.clone() if torch.is_tensor(a) else a
                                  for a in args], dict(kw)))
            return fn(*args, **kw)
        return rec

    build.reset_launches()
    with swapped({"bsp_matmul_dequant": recorder("bsp_matmul_dequant",
                                                 kernel["bsp_matmul_dequant"])}):
        outs = {n: ops.dithered_backward_matmuls(g, x, w, u, s, int8_operands=False)
                for n, (g, x, w, u, s) in captured.items()}
        torch.cuda.synchronize()
    launches_f32 = dict(build.LAUNCHES)
    for kname in build.LAUNCHES:
        want = F32_OPERAND_LAUNCHES.get(kname, 0)
        check(launches_f32[kname] == want,
              f"f32-operand backward: {kname} {launches_f32[kname]} launches, want {want}")
    worst_plain = worst_paper = 0.0
    for n, (g, x, w, u, s) in captured.items():
        with plain_kernels():
            dx_p, dw_p = ops.dithered_backward_matmuls(g, x, w, u, s,
                                                       int8_operands=False)
        q = ops.quantize_and_mask(g, u, s)
        gq = q.k[:g.shape[0], :g.shape[1]].to(torch.float32) * q.delta
        dx, dw = outs[n]
        T, N = g.shape
        for got, plain_v, paper_v, K, what in (
                (dx, dx_p, gq @ w.t(), N, "dx"), (dw, dw_p, x.t() @ gq, T, "dW")):
            worst_plain = max(worst_plain, banded(
                "bsp_matmul_dequant", got, plain_v, K, f"{n} {what} vs plain"))
            rel = float((got - paper_v).norm() / paper_v.norm())
            check(rel <= f32_band(K), f"{n} {what}: rel L2 {rel} against the paper "
                                      f"variant's f32 product")
            worst_paper = max(worst_paper, rel)
    log(f"phase 4c: f32-operand backward of the 11 layers: launches "
        f"{ {k: v for k, v in launches_f32.items() if v} }; worst relative L2 "
        f"against the plain versions {worst_plain:.3e}, against the paper "
        f"variant's f32 products {worst_paper:.3e}")
    del outs

    # -- phase 4d: the paper variant (its unit draws on the Philox kernel) --
    build.reset_launches()
    res_paper = train_classifier(cfg, policy.replace(variant="paper"), steps=STEPS,
                                 batch=BATCH, seed=SEED)
    launches_paper = dict(build.LAUNCHES)
    check(math.isfinite(res_paper["final_loss"]), f"loss {res_paper['final_loss']}")
    for kname in build.LAUNCHES:
        want = PAPER_PER_STEP.get(kname, 0) * STEPS
        check(launches_paper[kname] == want,
              f"paper variant: {kname} {launches_paper[kname]} launches, want {want}")
    log(f"phase 4d: paper variant {json.dumps(res_paper)}; launches over {STEPS} "
        f"steps { {k: v for k, v in launches_paper.items() if v} } ({card})")

    # -- phase 5 ----------------------------------------------------------
    old = ("nsd_quant", "bsp_matmul_int8")
    resid = ("levels_compact", "levels_expand")
    # the NSD calls of the nsd step's residual encode, on the (n_chunks,
    # 256) views: the cotangents' calls are those of ``old``
    encode_calls = {"nsd_quant": []}
    real_pack_nsd = wire.pack_nsd

    def recording_pack_nsd(*a, **kw):
        with swapped({k: recorder(k, kernel[k], encode_calls) for k in encode_calls}):
            return real_pack_nsd(*a, **kw)

    with swapped({k: recorder(k, kernel[k]) for k in old}):
        step1()
    wire.pack_nsd = recording_pack_nsd
    try:
        with swapped({k: recorder(k, kernel[k]) for k in resid}):
            step1(MEMORY)
    finally:
        wire.pack_nsd = real_pack_nsd
    # no path launches the pack and unpack kernels: they are held and timed
    # on the fp32 step's k and on the bitmaps of the nsd step's decodes; the
    # draw kernel on the fp32 step's keys and cotangent shapes
    calls["bitmap_unpack"] = [([bm], {}) for (_, bm), _ in calls["levels_expand"]]
    calls["bitmap_pack"] = [([kernel["nsd_quant"](*a, **kw).k], {})
                            for a, kw in calls["nsd_quant"]]
    calls["philox_uniform"] = [([kw["key"], tuple(a[0].shape)], {"device": dev})
                               for a, kw in calls["nsd_quant"]]
    n_cot = PER_STEP["nsd_quant"]
    for kname, n in {"nsd_quant": n_cot, "bsp_matmul_int8": PER_STEP["bsp_matmul_int8"],
                     "bitmap_pack": n_cot, "philox_uniform": n_cot,
                     **{k: NSD_PER_STEP[k] for k in resid},
                     "bitmap_unpack": NSD_PER_STEP["levels_expand"],
                     "bsp_matmul_dequant": F32_OPERAND_LAUNCHES["bsp_matmul_dequant"]}.items():
        check(len(calls[kname]) == n, f"captured {len(calls[kname])} {kname} calls")
    for kname, got in encode_calls.items():
        want = NSD_PER_STEP[kname] - PER_STEP[kname]
        check(len(got) == want, f"captured {len(got)} {kname} residual-encode "
                                f"calls, want {want}")

    def time_ms(fn, launches=10, groups=5):
        """Median over groups of (CUDA-event time of back-to-back launches)
        / launches: device time where the device is the bottleneck, host
        dispatch time where a kernel is shorter than its launch."""
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(groups):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(launches):
                fn()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / launches)
        return statistics.median(per)

    def capture(fn, launches):
        """A CUDA graph of ``launches`` calls of fn (after one warm-up call
        on a side stream), replayed once, and the last call's outputs."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                out = fn()
        graph.replay()
        torch.cuda.synchronize()
        return graph, out

    def graph_ms(fn, launches=10, groups=5):
        """Device time per launch without the host's dispatch: ``launches``
        calls captured in one CUDA graph, whose replays are timed with CUDA
        events (median over groups)."""
        graph, _ = capture(fn, launches)
        per = []
        for _ in range(groups):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / launches)
        return statistics.median(per)

    def graph_outputs(fn):
        """fn's outputs from a CUDA graph of one call, after two replays."""
        graph, out = capture(fn, 1)
        graph.replay()
        torch.cuda.synchronize()
        return out if isinstance(out, tuple) else (out,)

    def int_mm_fn(a, b):
        """torch._int_mm on the dense operands, in the layout it accepts."""
        for bb in (b, b.t().contiguous().t()):
            try:
                torch._int_mm(a, bb)
                return lambda: torch._int_mm(a, bb)
            except RuntimeError as e:
                err = e
        log(f"  library yardstick unavailable: {err}")
        return None

    def check_call(kname, args, kw, i):
        got, want = kernel[kname](*args, **kw), plain[kname](*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if kname == "bsp_matmul_dequant":
            k_st = args[0]
            K = k_st.shape[0] if kw.get("trans_a") else k_st.shape[1]
            banded(kname, got[0], want[0], K, f"path call {i}")
            check(torch.equal(got[0], kernel[kname](*args, **kw)),
                  f"{kname} path call {i}: two launches differ")
        else:
            same(kname, got, want, f"path call {i}")
        if kname in resid:
            again = kernel[kname](*args, **kw)
            again = again if isinstance(again, tuple) else (again,)
            replayed = graph_outputs(lambda: kernel[kname](*args, **kw))
            for g, a, r in zip(got, again, replayed):
                check(torch.equal(g, a), f"{kname} path call {i}: two launches differ")
                check(torch.equal(g, r), f"{kname} path call {i}: graph replay differs")

    libraries = {
        "bsp_matmul_int8": "torch._int_mm on the dense int8 operands",
        "levels_compact": "torch.masked_select(k, k != 0): the wire levels",
        "levels_expand": "masked_scatter of the wire levels into zeros",
        "bsp_matmul_dequant": "torch.matmul on the dense dequantized f32 operands, TF32 off",
    }

    def measure(kname, call_list, label=""):
        """Check each recorded call against the plain version and sum the
        kernel, plain, library and bound times over the calls."""
        tot = dict(ms=0.0, plain_ms=0.0, t_bytes=0.0, t_ops=0.0, library_ms=0.0,
                   local_ms=0.0, graph_ms=0.0, old_bound_ms=0.0)
        have_library = kname in libraries
        for i, (args, kw) in enumerate(call_list):
            check_call(kname, args, kw, i)
            ms = time_ms(lambda: kernel[kname](*args, **kw))
            pms = time_ms(lambda: plain[kname](*args, **kw), launches=2, groups=3)
            lib = local = None
            # every kernel but unpack: its device time per call, from graph
            # replays
            gms = (graph_ms(lambda: kernel[kname](*args, **kw))
                   if kname != "bitmap_unpack" else None)
            if gms is not None:
                tot["graph_ms"] += gms
            if kname == "nsd_quant":
                # read x (and a fed nu) once over its live elements; write k,
                # the bitmap (when asked) and the tile counts and mask over
                # the 128-padded view
                x_in = args[0]
                fed = kw.get("noise") is not None
                cols = kw.get("cols") or x_in.shape[-1]
                n = x_in.numel()
                rows = -(-n // cols)
                Tp, Np = -(-rows // 128) * 128, -(-cols // 128) * 128
                tiles = (Tp // 128) * (Np // 128)
                nbytes = (n * 4 * (2 if fed else 1) + Tp * Np
                          + (Tp * Np // 8 if kw.get("bitmap", True) else 0)
                          + tiles * 8 + 4)
                # the padded definition, for the kernel that took padded
                # copies: x and nu read, k written over the padded shape,
                # the counts
                tot["old_bound_ms"] += (Tp * Np * 9 + tiles * 4 + 4) / HBM_BYTES_PER_S * 1e3
                nops, rate = 5 * n, FP32_OPS_PER_S
                shape = f"{rows}x{cols} ({'fed' if fed else 'key'})"
            elif kname == "philox_uniform":
                rows_u, cols_u = args[1]
                nbytes, nops, rate = rows_u * cols_u * 4, 0, INT8_OPS_PER_S
                shape = f"{rows_u}x{cols_u}"
            elif kname == "bitmap_pack":
                M, N = args[0].shape
                nbytes = M * N + M * N // 8 + 2 * (M // 128) * (N // 128) * 4
                nops, rate = 0, INT8_OPS_PER_S
                shape = f"{M}x{N}"
            elif kname == "bitmap_unpack":
                M, NB = args[0].shape
                nbytes = M * NB + M * NB * 8
                nops, rate = 0, INT8_OPS_PER_S
                shape = f"{M}x{NB * 8}"
            elif kname == "levels_compact":
                # the wire kernel: read k, write the levels, bitmap and nnz
                k_c = args[0]
                C = k_c.shape[0]
                nbytes, nops, rate = C * 256 * 2 + C * 32 + 4, 0, INT8_OPS_PER_S
                shape = f"{C} chunks"
                flat = k_c.reshape(-1)
                lib = time_ms(lambda: torch.masked_select(flat, flat != 0))
                local = time_ms(lambda: levels.levels_compact(k_c))
            elif kname == "levels_expand":
                # the wire kernel: read the bitmap and the live levels, write k
                lv, bm = args
                C = bm.shape[0]
                nnz = int(wire.popcount_u8(bm).sum())
                nbytes, nops, rate = C * 32 + nnz + C * 256, 0, INT8_OPS_PER_S
                shape = f"{C} chunks, {nnz} levels"
                occ = wire.unpack_bitmap(bm).reshape(-1)
                glob = lv[:nnz]
                lib = time_ms(lambda: torch.zeros(C * 256, dtype=torch.int8, device=dev
                                                  ).masked_scatter_(occ, glob))
                k_full = levels.levels_expand_wire(lv, bm)
                lv_local, _ = levels.levels_compact(k_full)
                m_local = (k_full != 0).to(torch.int8)
                local = time_ms(lambda: levels.levels_expand(lv_local, m_local))
            elif kname == "bsp_matmul_dequant":
                k_st, d, b_op, mask = args
                ta = kw.get("trans_a", False)
                a_op = k_st.t() if ta else k_st
                m_op = (mask.t() if ta else mask) != 0
                M, K = a_op.shape
                N = b_op.shape[1]
                occupied = int(m_op.sum())
                k_needed = int(m_op.any(0).sum())
                nbytes = (occupied * 128 * 128 + k_needed * 128 * N * 4 + M * N * 4
                          + mask.numel() * 4 + 4)
                # two TF32 products (B_hi, B_lo) per multiply-add
                nops, rate = 2 * 2 * occupied * 128 * 128 * N, TF32_OPS_PER_S
                shape = (f"{M}x{K}x{N} {'dW' if ta else 'dx'} "
                         f"{occupied}/{m_op.numel()} tiles, split "
                         f"{bsp_matmul.splits_for(M, N, K, dev)}")
                a_f = a_op.to(torch.float32) * d
                lib = time_ms(lambda: torch.matmul(a_f, b_op))
                del a_f
            else:
                a, b, scale, mask = args
                ta, tb = kw.get("trans_a", False), kw.get("trans_b", False)
                a_op = a.t() if ta else a
                m_op = (mask.t() if ta else mask) != 0
                b_op = b.t() if tb else b
                M, K = a_op.shape
                N = b_op.shape[1]
                occupied = int(m_op.sum())
                k_needed = int(m_op.any(0).sum())
                nbytes = (occupied * 128 * 128 + k_needed * 128 * N + M * N * 4
                          + mask.numel() * 4 + 4)
                nops, rate = 2 * occupied * 128 * 128 * N, INT8_OPS_PER_S
                shape = (f"{M}x{K}x{N} {'dW' if ta else 'dx'} "
                         f"{occupied}/{m_op.numel()} tiles, split "
                         f"{bsp_matmul.splits_for(M, N, K, dev)}")
                fn = int_mm_fn(a_op.contiguous(), b_op.contiguous())
                lib = time_ms(fn) if fn is not None else None
            if have_library:
                if lib is None:
                    have_library = False
                else:
                    tot["library_ms"] += lib
            if local is not None:
                tot["local_ms"] += local
            t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / rate * 1e3
            tot["ms"] += ms
            tot["plain_ms"] += pms
            tot["t_bytes"] += t_b
            tot["t_ops"] += t_o
            log(f"  {kname}{label} {shape}: {ms:.4f} ms "
                + (f"(device {gms:.4f} ms in graph replay), " if gms is not None else "")
                + f"(bound {max(t_b, t_o):.4f} ms, plain {pms:.4f} ms"
                + (f", library {lib:.4f} ms)" if lib is not None else ")"))
        tot["bound_ms"] = max(tot["t_bytes"], tot["t_ops"])
        tot["bound_by"] = "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations"
        tot["library_ms"] = tot["library_ms"] if have_library else None
        log(f"  {kname}{label}: {len(call_list)} calls, {tot['ms']:.4f} ms, "
            + (f"device {tot['graph_ms']:.4f} ms in graph replay, " if tot["graph_ms"] else "")
            + f"bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}"
            + (f"; {tot['old_bound_ms']:.4f} ms by the padded definition"
               if tot["old_bound_ms"] else "")
            + f"), plain "
            f"{tot['plain_ms']:.4f} ms"
            + (f", library {tot['library_ms']:.4f} ms ({libraries[kname]})"
               if have_library else ", library none"))
        if tot["local_ms"]:
            log(f"  {kname}{label}: the chunk-local kernel on the same chunks, "
                f"{len(call_list)} calls, {tot['local_ms']:.4f} ms")
        return tot

    # -- phase 5a: the split-K edges of both matmuls, A stored (K, M) as dW
    # reads it: c0's dW shape, a K-tile count the split does not divide, a
    # split with every K-tile masked, the last K-tile alone, and no K-tile
    for case, k_tiles in (("c0 dW", 1024), ("ragged", 37), ("masked split", 37),
                          ("last tile only", 37), ("all masked", 37)):
        M, N, K = 128, 128, 128 * k_tiles
        splits = bsp_matmul.splits_for(M, N, K, dev)
        check(splits > 1, f"{case}: not split")
        if case == "c0 dW":
            check(splits >= 100, f"c0 dW: split {splits}")
        else:
            check(k_tiles % splits, f"{case}: {splits} divides {k_tiles}")
        mask = torch.ones(k_tiles, 1, dtype=torch.int32, device=dev)
        if case == "masked split":
            lo, hi = bsp_matmul.split_bounds(k_tiles, splits)[1]
            mask[lo:hi] = 0
        elif case == "last tile only":
            mask.zero_()
            mask[-1] = 1
        elif case == "all masked":
            mask.zero_()
        a8 = torch.randint(-127, 128, (K, M), device=dev, generator=gen,
                           dtype=torch.int8)
        b8 = torch.randint(-127, 128, (K, N), device=dev, generator=gen,
                           dtype=torch.int8)
        scale = torch.tensor(3e-3, device=dev)
        same("bsp_matmul_int8",
             (bsp_matmul.bsp_matmul_int8(a8, b8, scale, mask, trans_a=True),),
             (bsp_matmul.bsp_matmul_int8_plain(a8, b8, scale, mask, trans_a=True),),
             f"split edge {case}")
        kq = torch.randint(-6, 7, (K, M), device=dev, generator=gen, dtype=torch.int8)
        bf = torch.randn(K, N, device=dev, generator=gen)
        got = bsp_matmul.bsp_matmul(kq, scale, bf, mask, trans_a=True)
        rel = banded("bsp_matmul_dequant", got, bsp_matmul.bsp_matmul_plain(
            kq, scale, bf, mask, trans_a=True), K, f"split edge {case}")
        check(torch.equal(got, bsp_matmul.bsp_matmul(kq, scale, bf, mask, trans_a=True)),
              f"bsp_matmul_dequant split edge {case}: two launches differ")
        log(f"phase 5a: {case} ({M}x{K}x{N}, {int(mask.sum())}/{k_tiles} K-tiles, "
            f"split {splits}): int8 bit-exact, dequant relative L2 {rel:.3e} and "
            f"equal over two launches")

    rows = []
    for kname in KERNELS:
        tot = measure(kname, calls[kname])
        path_launches = (launches if kname in PER_STEP else launches_f32
                         if kname == "bsp_matmul_dequant" else launches_nsd)[kname]
        row = {"name": kname, "route": "cuda", "source": KERNELS[kname][0],
               "replaces": KERNELS[kname][1], "launches": path_launches,
               "max_abs_err": max_err[kname],
               **{k: tot[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}
        if tot["graph_ms"]:
            row["graph_ms"] = tot["graph_ms"]  # device time, no host dispatch
        if kname == "bitmap_unpack":
            row["note"] = ("no path launches it: the wire expand reads the bitmap "
                           "itself; held and timed on the nsd step's decode bitmaps")
        if kname == "bitmap_pack":
            row["note"] = ("no path launches it: the NSD kernel writes the bitmap, "
                           "nnz and mask itself; held and timed on the fp32 step's k")
        if kname in encode_calls:
            # the same kernel's calls in the nsd step's residual encode, with
            # their launches over phase 4b's run
            enc = measure(kname, encode_calls[kname], " (nsd residual encode)")
            row["nsd_residual_encode"] = {
                "launches": launches_nsd[kname] - launches[kname],
                **{k: enc[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "graph_ms")}}
        if kname == "nsd_quant":
            # the draw-only entry of the same source, on the fp32 step's
            # cotangent shapes, with its launches over phase 4d's paper run
            drw = measure("philox_uniform", calls["philox_uniform"])
            row["philox_uniform"] = {
                "launches": launches_paper["philox_uniform"],
                "max_abs_err": max_err["philox_uniform"],
                **{k: drw[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "graph_ms")}}
        rows.append(row)
    torch.cuda.synchronize()
    log(f"phase 5: per-kernel times are sums over the launches of one "
        f"batch-{BATCH} step (the f32-operand backward's 22 products for the "
        f"dequant kernel; the NSD row's cotangent calls of the fp32 step, its "
        f"residual-encode calls of the nsd step apart; the pack row the fp32 "
        f"step's k; the compact and expand rows the nsd step's wire calls); "
        f"paper variant {res_paper['ms_per_step']:.2f} ms; step time kernel "
        f"path {res['ms_per_step']:.2f} ms, "
        f"plain versions {res_plain['ms_per_step']:.2f} ms; with nsd residuals "
        f"{res_nsd['ms_per_step']:.2f} ms, plain versions "
        f"{res_nsd_plain['ms_per_step']:.2f} ms ({card})")

    # -- phase 5b: where one step's device time goes (torch.profiler) -----
    # -- phase 5c: one step's peak device memory ---------------------------
    def make_step(memory):
        net = CNN(cfg, seed=SEED)
        ctx = DitherCtx(policy.replace(collect_stats=False), seed=SEED, step=0,
                        memory=as_memory_policy(memory))

        def fwd_bwd():
            for p in net.parameters():
                p.grad = None
            loss_fn(net, batch0, ctx=ctx).backward()
        return fwd_bwd

    configs = (("fp32 residuals", None), (f"memory={MEMORY!r}", MEMORY))
    for label, memory in configs:
        fwd_bwd = make_step(memory)
        profile_step(torch, fwd_bwd, card, label)
        fwd_bwd()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 5c ({label}): peak device memory of one batch-{BATCH} step "
            f"{peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} MiB above the "
            f"{base / 2**20:.1f} MiB held between steps ({card})")

    # -- phase 5d: the nsd step's cost over fp32 residuals, on the host
    # clock, the two steps taken in turns so that both see the same host
    steps = {label: make_step(memory) for label, memory in configs}
    wall = {label: [] for label in steps}
    for _ in range(STEP_PAIRS):
        for label, fwd_bwd in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd_bwd()
            torch.cuda.synchronize()
            wall[label].append((time.perf_counter() - t0) * 1e3)
    med = {label: statistics.median(w) for label, w in wall.items()}
    fp32_ms, nsd_ms = med.values()
    log(f"phase 5d: forward+backward of one batch-{BATCH} step, median of "
        f"{STEP_PAIRS} taken in turns: fp32 residuals {fp32_ms:.3f} ms, "
        f"memory={MEMORY!r} {nsd_ms:.3f} ms, excess {nsd_ms - fp32_ms:+.3f} ms ({card})")

    # the f32-operand backward of phase 4c: the dequant row's device time
    def f32_operand_backward():
        for g, x, w, u, s in captured.values():
            ops.dithered_backward_matmuls(g, x, w, u, s, int8_operands=False)

    profile_step(torch, f32_operand_backward, card,
                 "f32-operand backward of the 11 layers")

    # -- phases 6 and 7 ----------------------------------------------------
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
