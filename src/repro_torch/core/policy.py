"""Dither policy and the per-step context threaded through a model.

Counterpart of ``repro.core.policy`` for the variants this port has so far:

* ``off``    plain backprop (the paper's baseline column);
* ``paper``  NSD on the pre-activation gradient, products in f32;
* ``kernel`` NSD + tile-skipping int8 products on the CUDA kernels.

Noise seeding. ``jax.random``'s ``fold_in`` chain cannot be reproduced in
torch, so each (seed, step, worker, layer) gets its own 63-bit seed from a
splitmix64 chain over ``seed``, ``step``, ``worker`` and the layer's
``name_salt`` (a crc32 of its name, as in the reference), and one
``torch.Generator`` seeded with it draws the layer's unit noise. Draws are
therefore independent across layers, steps and data-parallel workers (the
condition of the paper's averaging argument) and reproducible on one device
type. ``DitherCtx.unit_noise`` is the seam through which tests feed the
reference's own draw instead.

Residual memory. ``DitherCtx.memory`` (a ``repro_torch.memory``
``MemoryPolicy``) picks each dithered layer's residual mode, which
:meth:`DitherCtx.resolve` stamps onto the layer's resolved policy
(``DitherPolicy.residual``), as the reference's ``resolve`` stamps it onto
its static spec. The ``nsd`` residual encode draws its own noise,
``DitherCtx.resid_noise``: a second stream per layer, the layer's seed
mixed once more with ``RESID_SALT``, independent of the cotangent's.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.quant.codecs import MODE_FP32, RESID_SALT, validate_mode

VARIANT_OFF = "off"
VARIANT_PAPER = "paper"
VARIANT_KERNEL = "kernel"
VARIANTS = (VARIANT_OFF, VARIANT_PAPER, VARIANT_KERNEL)


@dataclasses.dataclass(frozen=True)
class DitherPolicy:
    """Per-run configuration of dithered backprop."""

    variant: str = VARIANT_PAPER
    s: float = 2.0  # Delta = s * std(grad): the paper's one knob
    exclude: Tuple[str, ...] = ()  # layer-name substrings left undithered
    collect_stats: bool = False  # record per-layer sparsity/bits/delta
    # the layer's residual mode (a codec spec of repro_torch.quant), stamped
    # by DitherCtx.resolve from its MemoryPolicy
    residual: str = MODE_FP32

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}; one of "
                             f"{VARIANTS}")
        if not self.s > 0:
            raise ValueError(f"DitherPolicy: s must be > 0, got {self.s!r}")
        validate_mode(self.residual)

    @property
    def enabled(self) -> bool:
        return self.variant != VARIANT_OFF

    def applies_to(self, name: str) -> bool:
        return self.enabled and not any(p in name for p in self.exclude)

    def replace(self, **kw) -> "DitherPolicy":
        return dataclasses.replace(self, **kw)



def name_salt(name: str) -> int:
    """Stable 31-bit salt of a layer name (the reference's crc32)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def layer_seed(seed: int, step: int, worker: int, name: str) -> int:
    """The 63-bit generator seed of one (seed, step, worker, layer)."""
    h = _splitmix64(seed & _MASK64)
    for v in (step, worker, name_salt(name)):
        h = _splitmix64(h ^ (v & _MASK64))
    return h >> 1


@dataclasses.dataclass
class DitherCtx:
    """Per-step dither state: the policy plus what seeds the noise."""

    policy: DitherPolicy
    seed: int = 0
    step: int = 0
    worker: int = 0
    device: Optional[torch.device] = None
    # repro_torch.memory.MemoryPolicy selecting each layer's residual mode;
    # None = dense fp32 residuals
    memory: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def resolve(self, name: str) -> Optional[DitherPolicy]:
        """The policy for layer ``name`` with its residual mode, or None for
        plain backprop."""
        if not self.policy.applies_to(name):
            return None
        if self.memory is not None:
            mode = self.memory.mode_for(name)
            if mode != self.policy.residual:
                return self.policy.replace(residual=mode)
        return self.policy

    def _uniform(self, seed: int, shape) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return torch.rand(tuple(shape), generator=gen, device=self.device,
                          dtype=torch.float32) - 0.5

    def unit_noise(self, name: str, shape) -> torch.Tensor:
        """u ~ U(-1/2, 1/2), f32, of ``shape`` for layer ``name``.

        The shape is that of the layer's 2-D cotangent (T, N), rows in the
        reference's NHWC order for a convolution.
        """
        return self._uniform(layer_seed(self.seed, self.step, self.worker,
                                        name), shape)

    def resid_noise(self, name: str, shape) -> torch.Tensor:
        """u ~ U(-1/2, 1/2), f32, of ``shape`` for layer ``name``'s residual
        encode: the stream salted with ``RESID_SALT``.

        The shape is that of the residual in the reference's layout (NHWC
        for a convolution's input).
        """
        seed = layer_seed(self.seed, self.step, self.worker, name)
        return self._uniform(_splitmix64(seed ^ RESID_SALT) >> 1, shape)
