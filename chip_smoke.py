#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. hold each kernel bit-exact against its plain PyTorch version at the
     padded shapes of VGG11 layers c1 and c5 at batch 128, plus edge cases
     (delta = 0, empty tiles, full and empty masks);
  4. train VGG11-CIFAR at full width, batch 128, 5 steps, variant=kernel,
     through ``repro_torch.train.classifier.train_classifier``; check the
     loss is finite, the launch counts (per step: NSD 11, pack 11, bsp 21,
     c0's dx being skipped because the images need no gradient), that no
     structural fallback happened, that dither sparsity is within 8 points
     of the same steps run on the plain versions, and that step 1's
     gradients agree with the plain versions' (relative L2 <= 1e-5 per
     parameter; the kernels are bit-exact, so 0 is expected);
  5. capture every kernel input of one step, hold each call bit-exact
     against its plain version again, and time kernel, plain version and
     the library yardstick (``torch._int_mm`` on the dense int8 operands,
     for the matmul) with CUDA events, beside the least time the card could
     take (bytes over 3.35 TB/s, or operations over the peak rate); then
     break one step's device time down with torch.profiler;
  6. print one JSON line naming the three kernels;
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
BATCH, STEPS, SEED = 128, 5, 0
PER_STEP = {"nsd_quant": 11, "bitmap_pack": 11, "bsp_matmul_int8": 21}
SPARSITY_BAND = 8.0  # percentage points (Table 1's own band)
GRAD_BAND = 1e-5  # relative L2, kernels vs plain versions

KERNELS = {
    "nsd_quant": ("src/repro_torch/kernels/csrc/nsd_quant.cu",
                  "src/repro/kernels/nsd_quant/nsd_quant.py:27"),
    "bitmap_pack": ("src/repro_torch/kernels/csrc/pack.cu",
                    "src/repro/kernels/pack/pack.py:52"),
    "bsp_matmul_int8": ("src/repro_torch/kernels/csrc/bsp_matmul_int8.cu",
                        "src/repro/kernels/bsp_matmul/bsp_matmul.py:63"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def profile_step(torch, step_fn, card, steps=3):
    """Print the device time per step of the top kernels, of the port's
    three kernels, and the device's busy share of the wall time, from
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
        log("phase 5b: torch.profiler recorded no device time: not measured")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"phase 5b: forward+backward of one batch-{BATCH} step: wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%) ({card})")
    for name in ("nsd_quant_kernel", "bitmap_pack_kernel", "bsp_int8_kernel"):
        ms = sum(r[0] for r in rows if name in r[2])
        n = sum(r[1] for r in rows if name in r[2])
        log(f"  port kernel {name}: {ms:.4f} ms device time per step over {n} launches")
    for ms, n, key in rows[:15]:
        log(f"  {ms:9.4f} ms  x{n:<4d} {key[:100]}")


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
    from repro_torch.kernels import build, bsp_matmul, nsd_quant, ops, pack

    # -- phase 2 ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    log(f"phase 2: built the kernels in {time.perf_counter() - t0:.1f} s")

    max_err = {k: 0.0 for k in KERNELS}

    def same(kernel, got, want, what):
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{kernel} {what}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            err = float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
            max_err[kernel] = max(max_err[kernel], err)
            check(torch.equal(g, w), f"{kernel} {what}: differs from the plain "
                                     f"version (max abs err {err})")

    # -- phase 3 ----------------------------------------------------------
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # (T, K_in, N_out) padded to 128: c1 (16x16x64 -> 128), c5 (4x4x512 -> 512)
    for name, (T, K, N) in {"c1": (32768, 640, 128), "c5": (2048, 4608, 512)}.items():
        g = torch.randn(T, N, device=dev, generator=gen) * 1e-3
        u = torch.rand(T, N, device=dev, generator=gen) - 0.5
        x = torch.randn(T, K, device=dev, generator=gen)
        w = torch.randn(K, N, device=dev, generator=gen)
        for s in (2.0, 0.0):
            delta = (s * torch.std(g, correction=0)).reshape(())
            nu = u * delta
            same("nsd_quant", nsd_quant.nsd_quantize_blocked(g, nu, delta),
                 nsd_quant.nsd_quantize_blocked_plain(g, nu, delta),
                 f"{name} delta={'0' if s == 0 else 's*std'}")
        delta = 2.0 * torch.std(g, correction=0)
        k, _ = nsd_quant.nsd_quantize_blocked(g, u * delta, delta)
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
        f"(max abs err {max(max_err.values())})")

    # -- phase 4 ----------------------------------------------------------
    from repro_torch.configs.paper_models import vgg11_cifar
    from repro_torch.core.policy import DitherCtx, DitherPolicy
    from repro_torch.data.synthetic import ClassifConfig, classification_batch
    from repro_torch.models.cnn import CNN, loss_fn
    from repro_torch.train.classifier import train_classifier

    @contextlib.contextmanager
    def plain_kernels():
        """Route the ops through the kernels' plain versions (on the card)."""
        saved = (nsd_quant.nsd_quantize_blocked, pack.bitmap_pack_blocked,
                 bsp_matmul.bsp_matmul_int8)
        nsd_quant.nsd_quantize_blocked = nsd_quant.nsd_quantize_blocked_plain
        pack.bitmap_pack_blocked = pack.bitmap_pack_blocked_plain
        bsp_matmul.bsp_matmul_int8 = bsp_matmul.bsp_matmul_int8_plain
        try:
            yield
        finally:
            (nsd_quant.nsd_quantize_blocked, pack.bitmap_pack_blocked,
             bsp_matmul.bsp_matmul_int8) = saved

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

    def step1_grads():
        net = CNN(cfg, seed=SEED)
        ctx = DitherCtx(policy.replace(collect_stats=False), seed=SEED, step=0)
        loss = loss_fn(net, batch0, ctx=ctx)
        loss.backward()
        return float(loss.detach()), {n: p.grad for n, p in net.named_parameters()}

    loss_k, grads_k = step1_grads()
    with plain_kernels():
        loss_p, grads_p = step1_grads()
    worst = 0.0
    for n, gk in grads_k.items():
        check(bool(torch.isfinite(gk).all()), f"non-finite gradient {n}")
        ref = float(grads_p[n].norm())
        rel = float((gk - grads_p[n]).norm()) / ref if ref else float(gk.norm())
        worst = max(worst, rel)
        check(rel <= GRAD_BAND, f"step-1 gradient {n}: rel L2 {rel}")
    log(f"phase 4: step-1 loss {loss_k} (plain {loss_p}); worst relative L2 "
        f"gradient difference kernel vs plain {worst}")

    # -- phase 5 ----------------------------------------------------------
    calls = {k: [] for k in KERNELS}

    def recorder(kname, fn):
        def rec(*args, **kw):
            calls[kname].append(([a.clone() if torch.is_tensor(a) else a
                                  for a in args], dict(kw)))
            return fn(*args, **kw)
        return rec

    saved = (nsd_quant.nsd_quantize_blocked, pack.bitmap_pack_blocked,
             bsp_matmul.bsp_matmul_int8)
    nsd_quant.nsd_quantize_blocked = recorder("nsd_quant", saved[0])
    pack.bitmap_pack_blocked = recorder("bitmap_pack", saved[1])
    bsp_matmul.bsp_matmul_int8 = recorder("bsp_matmul_int8", saved[2])
    try:
        step1_grads()
    finally:
        (nsd_quant.nsd_quantize_blocked, pack.bitmap_pack_blocked,
         bsp_matmul.bsp_matmul_int8) = saved
    for kname, n in PER_STEP.items():
        check(len(calls[kname]) == n, f"captured {len(calls[kname])} {kname} calls")

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

    plain = {"nsd_quant": nsd_quant.nsd_quantize_blocked_plain,
             "bitmap_pack": pack.bitmap_pack_blocked_plain,
             "bsp_matmul_int8": bsp_matmul.bsp_matmul_int8_plain}
    kernel = {"nsd_quant": nsd_quant.nsd_quantize_blocked,
              "bitmap_pack": pack.bitmap_pack_blocked,
              "bsp_matmul_int8": bsp_matmul.bsp_matmul_int8}
    rows = []
    for kname in KERNELS:
        tot = dict(ms=0.0, plain_ms=0.0, t_bytes=0.0, t_ops=0.0, library_ms=0.0)
        have_library = kname == "bsp_matmul_int8"
        for i, (args, kw) in enumerate(calls[kname]):
            got, want = kernel[kname](*args, **kw), plain[kname](*args, **kw)
            same(kname, got if isinstance(got, tuple) else (got,),
                 want if isinstance(want, tuple) else (want,), f"path call {i}")
            ms = time_ms(lambda: kernel[kname](*args, **kw))
            pms = time_ms(lambda: plain[kname](*args, **kw), launches=2, groups=3)
            if kname == "nsd_quant":
                M, N = args[0].shape
                nbytes = M * N * (4 + 4 + 1) + (M // 128) * (N // 128) * 4 + 4
                nops, rate = 5 * M * N, FP32_OPS_PER_S
                shape = f"{M}x{N}"
                lib = None
            elif kname == "bitmap_pack":
                M, N = args[0].shape
                nbytes = M * N + M * N // 8 + 2 * (M // 128) * (N // 128) * 4
                nops, rate = 0, INT8_OPS_PER_S
                shape = f"{M}x{N}"
                lib = None
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
                         f"{occupied}/{m_op.numel()} tiles")
                fn = int_mm_fn(a_op.contiguous(), b_op.contiguous())
                lib = time_ms(fn) if fn is not None else None
                if lib is None:
                    have_library = False
                else:
                    tot["library_ms"] += lib
            t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / rate * 1e3
            tot["ms"] += ms
            tot["plain_ms"] += pms
            tot["t_bytes"] += t_b
            tot["t_ops"] += t_o
            log(f"  {kname} {shape}: {ms:.4f} ms (bound {max(t_b, t_o):.4f} ms, "
                f"plain {pms:.4f} ms" + (f", library {lib:.4f} ms)" if lib is not None
                                          else ")"))
        rows.append({
            "name": kname, "route": "cuda", "source": KERNELS[kname][0],
            "replaces": KERNELS[kname][1], "launches": launches[kname],
            "max_abs_err": max_err[kname], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": max(tot["t_bytes"], tot["t_ops"]),
            "bound_by": "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations",
            "library_ms": tot["library_ms"] if have_library else None,
        })
    torch.cuda.synchronize()
    log(f"phase 5: per-kernel times are sums over the {sum(PER_STEP.values())} "
        f"launches of one batch-{BATCH} step; step time kernel path "
        f"{res['ms_per_step']:.2f} ms, plain versions {res_plain['ms_per_step']:.2f} ms "
        f"({card})")

    # -- phase 5b: where one step's device time goes (torch.profiler) -----
    net = CNN(cfg, seed=SEED)
    ctx = DitherCtx(policy.replace(collect_stats=False), seed=SEED, step=0)

    def fwd_bwd():
        for p in net.parameters():
            p.grad = None
        loss_fn(net, batch0, ctx=ctx).backward()

    profile_step(torch, fwd_bwd, card)

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
