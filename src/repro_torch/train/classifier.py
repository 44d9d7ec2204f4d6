"""Paper-recipe training of a classifier on the synthetic image set.

Counterpart of ``benchmarks/harness.py::train_classifier``: SGD with
momentum 0.9, weight decay 5e-4 and a step schedule (x0.1 at half the
steps); one untimed warm-up step (step 0), then steps 1..steps-1 timed on
the host clock around work that ends in a device synchronise. And of its
``measure_baseline_sparsity``: Table 1's baseline sparsity, through the
tap probe (``repro_torch.core.probe``).

    python -m repro_torch.train.classifier --model vgg11-cifar \\
        --variant kernel --steps 5 --batch 128 --memory-program default=nsd

runs on CUDA (``--device cpu`` for the CPU) and prints one JSON line.
``--memory-program`` (the grammar of ``repro_torch.memory.policy``) picks
each dithered layer's residual codec or remat, as ``launch/train.py``'s flag
of that name does in the reference.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.paper_models import MODELS
from repro_torch.core import probe
from repro_torch.core.policy import VARIANTS, DitherCtx, DitherPolicy
from repro_torch.data.synthetic import ClassifConfig, classification_batch
from repro_torch.device import resolve_device
from repro_torch.memory.policy import MemoryPolicy, as_memory_policy
from repro_torch.models.cnn import CNN, CNNConfig, accuracy, loss_fn, tap_shapes
from repro_torch.obs import metrics
from repro_torch.optim.optimizers import OptConfig, apply_updates, init_opt_state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_classifier(model: CNNConfig, policy: Optional[DitherPolicy], *,
                     steps: int = 60, batch: int = 64, lr: float = 0.05,
                     seed: int = 0, noise: float = 0.5,
                     memory: Union[None, str, MemoryPolicy] = None,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, float]:
    """Train ``model`` (a config from ``repro_torch.configs``) under
    ``policy`` (None = plain backprop) and return acc (%), final_loss,
    ms_per_step and, when the policy collects stats, sparsity (%) and
    max_bits over every dithered layer and step. ``memory`` (a
    ``MemoryPolicy`` or its spec string) selects each dithered layer's
    residual codec or remat; with stats on, the result then also carries
    ``residual_compression``, dense over measured residual bytes."""
    dev = resolve_device(device)
    memory = as_memory_policy(memory)
    # full f32 on the card: cuDNN would run f32 convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    collect = policy is not None and policy.collect_stats
    if collect:
        metrics.reset()
    net = CNN(model, seed=seed, device=dev)
    params = dict(net.named_parameters())
    opt_cfg = OptConfig(name="sgd", lr=lr, momentum=0.9, weight_decay=5e-4,
                        grad_clip=None, schedule="step",
                        step_decay_every=max(steps // 2, 1),
                        step_decay_rate=0.1)
    state = init_opt_state(params, opt_cfg)
    dcfg = ClassifConfig(n_classes=model.n_classes, img_size=model.img_size,
                         channels=model.in_channels, noise=noise, seed=seed)

    def step(i: int) -> torch.Tensor:
        b = classification_batch(dcfg, i, batch, device=dev)
        ctx = (DitherCtx(policy, seed=seed, step=state["step"], device=dev,
                         memory=memory)
               if policy is not None and policy.enabled else None)
        for p in params.values():
            p.grad = None
        loss = loss_fn(net, b, ctx=ctx)
        loss.backward()
        apply_updates(params, state, opt_cfg)
        return loss.detach()

    step(0)  # warm-up: first-use kernel build and allocator growth
    timed_s, losses = 0.0, []
    for i in range(1, steps):
        _sync(dev)
        t0 = time.perf_counter()
        loss = step(i)
        _sync(dev)
        timed_s += time.perf_counter() - t0
        losses.append(float(loss))
    test = classification_batch(dcfg, 10**6, 512, device=dev)
    out = {"acc": float(accuracy(net, test)) * 100,
           "final_loss": losses[-1] if losses else math.nan,
           "ms_per_step": timed_s / max(steps - 1, 1) * 1e3}
    if collect:
        out["sparsity"] = metrics.overall_sparsity() * 100
        out["max_bits"] = metrics.overall_max_bits()
        if memory is not None and metrics.memory_tags():
            out["residual_compression"] = metrics.overall_residual_compression()
    return out


def measure_baseline_sparsity(model: CNNConfig, *, steps: int = 5,
                              batch: int = 64, noise: float = 0.5,
                              seed: int = 0,
                              device: Optional[torch.device] = None) -> float:
    """Sparsity (%) of the raw pre-activation gradients under plain
    backprop, the mean over every tapped layer and step: Table 1's
    baseline sparsity column."""
    dev = resolve_device(device)
    net = CNN(model, seed=seed, device=dev)
    dcfg = ClassifConfig(n_classes=model.n_classes, img_size=model.img_size,
                         channels=model.in_channels, noise=noise, seed=seed)
    shapes = tap_shapes(model, batch)
    sps = []
    for i in range(steps):
        b = classification_batch(dcfg, i, batch, device=dev)
        grads = probe.grad_wrt_taps(
            lambda taps: loss_fn(net, b, taps=taps),
            probe.make_taps(shapes, device=dev))
        sps.extend(float(probe.baseline_sparsity(g)) for g in grads.values())
    return float(np.mean(sps)) * 100


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vgg11-cifar", choices=sorted(MODELS))
    ap.add_argument("--variant", default="kernel", choices=VARIANTS)
    ap.add_argument("--s", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise", type=float, default=0.5)
    ap.add_argument("--memory-program", default="",
                    help="per-layer residual modes, e.g. 'default=nsd;rule "
                         "fc2:fp32' (default: dense fp32 residuals)")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is none)")
    args = ap.parse_args(argv)
    policy = DitherPolicy(variant=args.variant, s=args.s, collect_stats=True)
    res = train_classifier(MODELS[args.model](), policy, steps=args.steps,
                           batch=args.batch, lr=args.lr, seed=args.seed,
                           noise=args.noise, memory=args.memory_program,
                           device=args.device)
    dev = resolve_device(args.device)
    res["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    print(json.dumps({"model": args.model, "variant": args.variant,
                      "memory_program": args.memory_program, **res}))


if __name__ == "__main__":
    main()
