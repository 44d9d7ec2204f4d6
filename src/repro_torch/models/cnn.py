"""The paper's Table-1 models in PyTorch (counterpart of ``repro.models.cnn``):
MLP-(500, 500), LeNet-300-100, LeNet5, AlexNet-CIFAR (FC 2048), VGG11-CIFAR
(FC 512) and ResNet18 (CIFAR stem).

BatchNorm matters here: it destroys the natural ReLU-derivative sparsity of
the pre-activation gradients, which is what dithered backprop restores
(the reference module's docstring and the paper's Table 1). So VGG11,
ResNet18 and LeNet5 carry BatchNorm, AlexNet and the MLPs do not. Every
conv and dense layer goes through ``repro_torch.core.dithered``, and every
pre-activation takes an optional probe tap (``repro_torch.core.probe``) at
the reference's sites, under the reference's names.

Parameters keep the reference's names and shapes (``c{i}_w``, ``bn{i}_g``,
``fc{i}_w``, ResNet18's ``stem_w``, ``b{i}_w1``, ``b{i}_bnd_g``, ...); conv
weights are OIHW (``repro_torch.convert`` maps the reference's HWIO) and
dense weights (in, out), as ``dense`` computes x @ w. The public functions
take NHWC images like the reference; NCHW is used inside, and every
flatten before a dense layer runs in the reference's NHWC order.
Convolutions pad as the reference's ``"SAME"``, so a stride-2 convolution
of an even size pads only the bottom and right.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dithered import conv2d, dense
from repro_torch.core.policy import DitherCtx
from repro_torch.core.probe import tap
from repro_torch.device import resolve_device

ARCHS = ("mlp", "lenet300100", "lenet5", "alexnet", "vgg11", "resnet18")


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    arch: str  # one of ARCHS
    n_classes: int = 10
    in_channels: int = 3
    img_size: int = 32
    hidden: Tuple[int, ...] = (500, 500)  # the MLPs' hidden widths


_VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]
# (out channels, kernel, stride); max-pools after c0, c1 and c4
_ALEX_CONVS = [(64, 3, 2), (192, 3, 1), (384, 3, 1), (256, 3, 1), (256, 3, 1)]
_ALEX_POOLS = (0, 1, 4)
# (out channels, blocks, first block's stride) of ResNet18's four stages
_RESNET18 = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]


def batchnorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Training-mode BatchNorm over (N, H, W) of an NCHW tensor: batch
    statistics, biased variance, no running statistics."""
    xf = x.to(torch.float32)
    mean = xf.mean((0, 2, 3), keepdim=True)
    var = xf.var((0, 2, 3), keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * g.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)).to(x.dtype)


# ---------------------------------------------------------------------------
# parameter trees: name -> (shape, init), init a fan-in (N(0, 1/fan_in)),
# "ones" or "zeros", in the reference's order
# ---------------------------------------------------------------------------

def _conv(tree, name, k, cin, cout, bias=True):
    tree[f"{name}_w"] = ((cout, cin, k, k), k * k * cin)
    if bias:
        tree[f"{name}_b"] = ((cout,), "zeros")


def _bn(tree, name, c):
    tree[f"{name}_g"] = ((c,), "ones")
    tree[f"{name}_b"] = ((c,), "zeros")


def _fc(tree, name, din, dout):
    tree[f"{name}_w"] = ((din, dout), din)
    tree[f"{name}_b"] = ((dout,), "zeros")


def _mlp_dims(cfg: CNNConfig) -> Tuple[int, ...]:
    return ((cfg.img_size * cfg.img_size * cfg.in_channels,)
            + tuple(cfg.hidden) + (cfg.n_classes,))


def param_tree(cfg: CNNConfig) -> Dict[str, tuple]:
    """The reference's init tree of ``cfg.arch``: name -> (shape, init)."""
    tree: Dict[str, tuple] = {}
    if cfg.arch in ("mlp", "lenet300100"):
        dims = _mlp_dims(cfg)
        for i in range(len(dims) - 1):
            _fc(tree, f"fc{i}", dims[i], dims[i + 1])
    elif cfg.arch == "lenet5":
        _conv(tree, "c1", 5, cfg.in_channels, 6)
        _bn(tree, "bn1", 6)
        _conv(tree, "c2", 5, 6, 16)
        _bn(tree, "bn2", 16)
        _fc(tree, "fc1", (cfg.img_size // 4) ** 2 * 16, 120)
        _fc(tree, "fc2", 120, 84)
        _fc(tree, "fc3", 84, cfg.n_classes)
    elif cfg.arch == "alexnet":
        cin = cfg.in_channels
        for i, (cout, k, _) in enumerate(_ALEX_CONVS):
            _conv(tree, f"c{i}", k, cin, cout)
            cin = cout
        for i, (din, dout) in enumerate([(256 * 2 * 2, 2048), (2048, 2048),
                                         (2048, cfg.n_classes)]):
            _fc(tree, f"fc{i}", din, dout)
    elif cfg.arch == "vgg11":
        cin, ci = cfg.in_channels, 0
        for v in _VGG11:
            if v == "M":
                continue
            _conv(tree, f"c{ci}", 3, cin, v)
            _bn(tree, f"bn{ci}", v)
            cin, ci = v, ci + 1
        for i, (din, dout) in enumerate([(512, 512), (512, 512),
                                         (512, cfg.n_classes)]):
            _fc(tree, f"fc{i}", din, dout)
    elif cfg.arch == "resnet18":
        _conv(tree, "stem", 3, cfg.in_channels, 64, bias=False)
        _bn(tree, "stem_bn", 64)
        cin, bi = 64, 0
        for cout, blocks, stride in _RESNET18:
            for b in range(blocks):
                s = stride if b == 0 else 1
                tree[f"b{bi}_w1"] = ((cout, cin, 3, 3), 9 * cin)
                _bn(tree, f"b{bi}_bn1", cout)
                tree[f"b{bi}_w2"] = ((cout, cout, 3, 3), 9 * cout)
                _bn(tree, f"b{bi}_bn2", cout)
                if s != 1 or cin != cout:
                    tree[f"b{bi}_wd"] = ((cout, cin, 1, 1), cin)
                    _bn(tree, f"b{bi}_bnd", cout)
                cin, bi = cout, bi + 1
        tree["fc_w"] = ((512, cfg.n_classes), 512)
        tree["fc_b"] = ((cfg.n_classes,), "zeros")
    else:
        raise ValueError(f"unknown arch {cfg.arch!r}; one of {ARCHS}")
    return tree


# ---------------------------------------------------------------------------
# forwards: p the parameters, h NCHW (NHWC images for the MLPs)
# ---------------------------------------------------------------------------

def _flatten_nhwc(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _classifier(h, p, names, ctx, taps):
    """Dense layers with ReLU between them; the last gives the logits."""
    for i, nm in enumerate(names):
        z = tap(dense(h, p[f"{nm}_w"], p[f"{nm}_b"], ctx=ctx, name=nm),
                taps, nm)
        h = F.relu(z) if i < len(names) - 1 else z
    return h


def _mlp_forward(p, cfg, images, ctx, taps):
    h = images.reshape(images.shape[0], -1)  # NHWC flatten
    return _classifier(h, p, [f"fc{i}" for i in range(len(cfg.hidden) + 1)],
                       ctx, taps)


def _lenet5_forward(p, cfg, h, ctx, taps):
    for i in (1, 2):
        z = tap(conv2d(h, p[f"c{i}_w"], p[f"c{i}_b"], padding="SAME", ctx=ctx,
                       name=f"c{i}"), taps, f"c{i}")
        h = F.max_pool2d(F.relu(batchnorm(z, p[f"bn{i}_g"], p[f"bn{i}_b"])), 2)
    return _classifier(_flatten_nhwc(h), p, ["fc1", "fc2", "fc3"], ctx, taps)


def _alexnet_forward(p, cfg, h, ctx, taps):
    for i, (_, _, stride) in enumerate(_ALEX_CONVS):
        z = tap(conv2d(h, p[f"c{i}_w"], p[f"c{i}_b"], stride=stride,
                       padding="SAME", ctx=ctx, name=f"c{i}"), taps, f"c{i}")
        h = F.relu(z)
        if i in _ALEX_POOLS:
            h = F.max_pool2d(h, 2)
    return _classifier(_flatten_nhwc(h), p, ["fc0", "fc1", "fc2"], ctx, taps)


def _vgg11_forward(p, cfg, h, ctx, taps):
    ci = 0
    for v in _VGG11:
        if v == "M":
            h = F.max_pool2d(h, 2)
            continue
        z = tap(conv2d(h, p[f"c{ci}_w"], p[f"c{ci}_b"], padding="SAME",
                       ctx=ctx, name=f"c{ci}"), taps, f"c{ci}")
        h = F.relu(batchnorm(z, p[f"bn{ci}_g"], p[f"bn{ci}_b"]))
        ci += 1
    return _classifier(_flatten_nhwc(h), p, ["fc0", "fc1", "fc2"], ctx, taps)


def _resnet18_forward(p, cfg, h, ctx, taps):
    z = tap(conv2d(h, p["stem_w"], padding="SAME", ctx=ctx, name="stem"),
            taps, "stem")
    h = F.relu(batchnorm(z, p["stem_bn_g"], p["stem_bn_b"]))
    bi = 0
    for _, blocks, stride in _RESNET18:
        for b in range(blocks):
            s = stride if b == 0 else 1
            idn = h
            z = tap(conv2d(h, p[f"b{bi}_w1"], stride=s, padding="SAME",
                           ctx=ctx, name=f"b{bi}_c1"), taps, f"b{bi}_c1")
            h2 = F.relu(batchnorm(z, p[f"b{bi}_bn1_g"], p[f"b{bi}_bn1_b"]))
            z = tap(conv2d(h2, p[f"b{bi}_w2"], padding="SAME", ctx=ctx,
                           name=f"b{bi}_c2"), taps, f"b{bi}_c2")
            h2 = batchnorm(z, p[f"b{bi}_bn2_g"], p[f"b{bi}_bn2_b"])
            if f"b{bi}_wd" in p:
                idn = conv2d(idn, p[f"b{bi}_wd"], stride=s, padding="SAME",
                             ctx=ctx, name=f"b{bi}_cd")
                idn = batchnorm(idn, p[f"b{bi}_bnd_g"], p[f"b{bi}_bnd_b"])
            h = F.relu(h2 + idn)
            bi += 1
    h = h.mean((2, 3))
    return dense(h, p["fc_w"], p["fc_b"], ctx=ctx, name="fc")


_FORWARDS = {"mlp": _mlp_forward, "lenet300100": _mlp_forward,
             "lenet5": _lenet5_forward, "alexnet": _alexnet_forward,
             "vgg11": _vgg11_forward, "resnet18": _resnet18_forward}


class CNN(nn.Module):
    """One of the paper's models with the reference's initialisation:
    weights N(0, 1/fan_in) drawn on the CPU from ``seed`` (so one seed
    gives one model on every device), biases 0, BatchNorm scale 1 and
    shift 0."""

    def __init__(self, cfg: CNNConfig, *, seed: int = 0,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        for name, (shape, init) in param_tree(cfg).items():
            if init == "ones":
                t = torch.ones(shape)
            elif init == "zeros":
                t = torch.zeros(shape)
            else:
                t = torch.randn(shape, generator=gen) / math.sqrt(init)
            self.register_parameter(name, nn.Parameter(t.to(dev)))

    def forward(self, images: torch.Tensor, *, ctx: Optional[DitherCtx] = None,
                taps: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """images: (B, H, W, C) NHWC -> logits (B, n_classes)."""
        p = dict(self.named_parameters())
        h = (images if self.cfg.arch in ("mlp", "lenet300100")
             else images.permute(0, 3, 1, 2).contiguous())
        return _FORWARDS[self.cfg.arch](p, self.cfg, h, ctx, taps)


def loss_fn(model: CNN, batch: Dict[str, torch.Tensor], *,
            ctx: Optional[DitherCtx] = None,
            taps: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Mean cross-entropy of the logits, in f32."""
    logits = model(batch["images"], ctx=ctx, taps=taps)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(1, batch["labels"].to(torch.int64)[:, None])[:, 0]
    return nll.mean()


@torch.no_grad()
def accuracy(model: CNN, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = model(batch["images"])
    return (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()


def tap_shapes(cfg: CNNConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    """The probe's tap shapes: each pre-activation's, NHWC for a
    convolution, as the reference's ``tap_shapes``."""
    img = cfg.img_size
    if cfg.arch in ("mlp", "lenet300100"):
        dims = tuple(cfg.hidden) + (cfg.n_classes,)
        return {f"fc{i}": (batch, d) for i, d in enumerate(dims)}
    if cfg.arch == "lenet5":
        s2 = img // 2
        return {"c1": (batch, img, img, 6), "c2": (batch, s2, s2, 16),
                "fc1": (batch, 120), "fc2": (batch, 84),
                "fc3": (batch, cfg.n_classes)}
    if cfg.arch == "alexnet":
        shapes, s = {}, img
        for i, (cout, _, stride) in enumerate(_ALEX_CONVS):
            s = -(-s // stride)
            shapes[f"c{i}"] = (batch, s, s, cout)
            if i in _ALEX_POOLS:
                s //= 2
        shapes.update({"fc0": (batch, 2048), "fc1": (batch, 2048),
                       "fc2": (batch, cfg.n_classes)})
        return shapes
    if cfg.arch == "vgg11":
        shapes, s, ci = {}, img, 0
        for v in _VGG11:
            if v == "M":
                s //= 2
                continue
            shapes[f"c{ci}"] = (batch, s, s, v)
            ci += 1
        shapes.update({"fc0": (batch, 512), "fc1": (batch, 512),
                       "fc2": (batch, cfg.n_classes)})
        return shapes
    if cfg.arch == "resnet18":
        shapes, s, bi = {"stem": (batch, img, img, 64)}, img, 0
        for cout, blocks, stride in _RESNET18:
            for b in range(blocks):
                if b == 0:
                    s = -(-s // stride)
                shapes[f"b{bi}_c1"] = (batch, s, s, cout)
                shapes[f"b{bi}_c2"] = (batch, s, s, cout)
                bi += 1
        return shapes
    raise ValueError(f"unknown arch {cfg.arch!r}; one of {ARCHS}")
