"""The paper's VGG11-CIFAR in PyTorch (counterpart of ``repro.models.cnn``).

VGG11 (CIFAR-reduced: FC 512) carries BatchNorm, which is what destroys the
natural sparsity of the pre-activation gradients and makes dithered
backprop matter (the reference module's docstring and the paper's Table 1).
Every conv and dense layer goes through ``repro_torch.core.dithered``.

Parameters keep the reference's names (``c{i}_w``, ``c{i}_b``,
``bn{i}_g``, ``bn{i}_b``, ``fc{i}_w``, ``fc{i}_b``); conv weights are OIHW
and dense weights (in, out), as ``dense`` computes x @ w. The public
functions take NHWC images like the reference; NCHW is used inside. All
eight convolutions are 3x3, stride 1, padding 1 (JAX's SAME), and the
classifier's input is 512 x 1 x 1, so the NHWC and NCHW flattens agree.
The other paper models are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dithered import conv2d, dense
from repro_torch.core.policy import DitherCtx
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    arch: str  # only "vgg11" is ported
    n_classes: int = 10
    in_channels: int = 3
    img_size: int = 32


_VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def batchnorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Training-mode BatchNorm over (N, H, W) of an NCHW tensor: batch
    statistics, biased variance, no running statistics."""
    xf = x.to(torch.float32)
    mean = xf.mean((0, 2, 3), keepdim=True)
    var = xf.var((0, 2, 3), keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * g.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)).to(x.dtype)


def _vgg11_shapes(cfg: CNNConfig) -> Dict[str, tuple]:
    shapes, cin, ci = {}, cfg.in_channels, 0
    for v in _VGG11:
        if v == "M":
            continue
        shapes[f"c{ci}_w"] = (v, cin, 3, 3)
        shapes[f"c{ci}_b"] = (v,)
        shapes[f"bn{ci}_g"] = (v,)
        shapes[f"bn{ci}_b"] = (v,)
        cin, ci = v, ci + 1
    for i, (din, dout) in enumerate([(512, 512), (512, 512),
                                     (512, cfg.n_classes)]):
        shapes[f"fc{i}_w"] = (din, dout)
        shapes[f"fc{i}_b"] = (dout,)
    return shapes


class CNN(nn.Module):
    """VGG11-CIFAR with the reference's initialisation: weights N(0, 1/fan_in)
    drawn on the CPU from ``seed`` (so one seed gives one model on every
    device), biases 0, BatchNorm scale 1 and shift 0."""

    def __init__(self, cfg: CNNConfig, *, seed: int = 0,
                 device: Optional[torch.device] = None):
        super().__init__()
        if cfg.arch != "vgg11":
            raise NotImplementedError(f"arch {cfg.arch!r} is not ported yet")
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        for name, shape in _vgg11_shapes(cfg).items():
            if name.endswith("_w"):
                fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
                t = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
            elif name.startswith("bn") and name.endswith("_g"):
                t = torch.ones(shape)
            else:
                t = torch.zeros(shape)
            self.register_parameter(name, nn.Parameter(t.to(dev)))

    def forward(self, images: torch.Tensor, *,
                ctx: Optional[DitherCtx] = None) -> torch.Tensor:
        """images: (B, H, W, C) NHWC -> logits (B, n_classes)."""
        p = dict(self.named_parameters())
        h = images.permute(0, 3, 1, 2).contiguous()
        ci = 0
        for v in _VGG11:
            if v == "M":
                h = F.max_pool2d(h, 2)
                continue
            z = conv2d(h, p[f"c{ci}_w"], p[f"c{ci}_b"], padding=1, ctx=ctx,
                       name=f"c{ci}")
            h = F.relu(batchnorm(z, p[f"bn{ci}_g"], p[f"bn{ci}_b"]))
            ci += 1
        h = h.reshape(h.shape[0], -1)
        for i in range(3):
            z = dense(h, p[f"fc{i}_w"], p[f"fc{i}_b"], ctx=ctx, name=f"fc{i}")
            h = F.relu(z) if i < 2 else z
        return h


def loss_fn(model: CNN, batch: Dict[str, torch.Tensor], *,
            ctx: Optional[DitherCtx] = None) -> torch.Tensor:
    """Mean cross-entropy of the logits, in f32."""
    logits = model(batch["images"], ctx=ctx)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(1, batch["labels"].to(torch.int64)[:, None])[:, 0]
    return nll.mean()


@torch.no_grad()
def accuracy(model: CNN, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = model(batch["images"])
    return (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()
