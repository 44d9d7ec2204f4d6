"""Dither policy and the per-step context threaded through a model.

Counterpart of ``repro.core.policy`` for the variants this port has so far:

* ``off``    plain backprop (the paper's baseline column);
* ``paper``  NSD on the pre-activation gradient, products in f32;
* ``kernel`` NSD + tile-skipping int8 products on the CUDA kernels.

Noise. ``jax.random``'s ``fold_in`` chain cannot be reproduced in torch,
so each (seed, step, worker, layer) gets its own 63-bit stream key from a
splitmix64 chain over ``seed``, ``step``, ``worker`` and the layer's
``name_salt`` (a crc32 of its name, as in the reference), and the unit draw
is Philox4x32-10 under that key (see :class:`DitherCtx`). Draws are
independent across layers, steps and data-parallel workers (the condition of
the paper's averaging argument) and identical on the CPU and the card.

Fed noise. Tests hand the port the reference's own draw by overriding
``unit_noise`` (and ``resid_noise``) in a subclass. That override is the
one switch: :meth:`DitherCtx.cotangent_dither` and
:meth:`DitherCtx.resid_dither`, which the ops call, return the stream key
when the class keeps the base method and the overriding method's tensor
otherwise, and a tensor takes the NSD kernel's fed-noise route.

Residual memory. ``DitherCtx.memory`` (a ``repro_torch.memory``
``MemoryPolicy``) picks each dithered layer's residual mode, which
:meth:`DitherCtx.resolve` stamps onto the layer's resolved policy
(``DitherPolicy.residual``), as the reference's ``resolve`` stamps it onto
its static spec. The ``nsd`` residual encode draws from a second stream per
layer, :meth:`DitherCtx.resid_key`: the layer's key mixed once more with
``RESID_SALT``, independent of the cotangent's; its unit draw,
:meth:`DitherCtx.resid_noise`, is the wire's own
(``repro_torch.quant.wire.unit_draw``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import nsd_quant
from repro_torch.quant import wire
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
    """The 63-bit stream key of one (seed, step, worker, layer)."""
    h = _splitmix64(seed & _MASK64)
    for v in (step, worker, name_salt(name)):
        h = _splitmix64(h ^ (v & _MASK64))
    return h >> 1


@dataclasses.dataclass
class DitherCtx:
    """Per-step dither state: the policy plus what seeds the noise.

    The draw: layer ``name``'s stream key is :meth:`cotangent_key` (its
    residual encode's, :meth:`resid_key`), and the unit draw u in
    [-1/2, 1/2) is Philox4x32-10 under that key, counter (c // 4, r, 0, 0)
    for element (r, c) of a 2-D view (the mapping in full:
    ``repro_torch.kernels.nsd_quant``). The context hands out keys; the
    kernel variant never materialises u: its NSD launch gets the key and
    draws inside. :meth:`unit_noise` and :meth:`resid_noise` return the
    same numbers as a tensor, element for element what the launch draws
    from that key.
    """

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

    def cotangent_key(self, name: str) -> int:
        """Layer ``name``'s stream key for its cotangent's dither."""
        return layer_seed(self.seed, self.step, self.worker, name)

    def resid_key(self, name: str) -> int:
        """Layer ``name``'s stream key for its residual encode: the
        cotangent key mixed with ``RESID_SALT``."""
        return _splitmix64(self.cotangent_key(name) ^ RESID_SALT) >> 1

    def unit_noise(self, name: str, shape) -> torch.Tensor:
        """u ~ U(-1/2, 1/2), f32, of ``shape`` for layer ``name``: the
        Philox draw of :meth:`cotangent_key` over the (rows, shape[-1])
        view, the one the NSD kernel takes from that key.

        The shape is that of the layer's 2-D cotangent (T, N), rows in the
        reference's NHWC order for a convolution.
        """
        return nsd_quant.philox_uniform(self.cotangent_key(name), shape,
                                        device=self.device)

    def resid_noise(self, name: str, shape) -> torch.Tensor:
        """u ~ U(-1/2, 1/2), f32, of ``shape`` for layer ``name``'s residual
        encode: the wire's draw of :meth:`resid_key`
        (``repro_torch.quant.wire.unit_draw``), the one the encode's NSD
        launch takes from that key.

        The shape is that of the residual in the reference's layout (NHWC
        for a convolution's input).
        """
        return wire.unit_draw(self.resid_key(name), shape, device=self.device)

    def cotangent_dither(self, name: str, shape) -> Union[int, torch.Tensor]:
        """What the kernel variant's NSD launch of layer ``name`` dithers
        with: the stream key, or, when a subclass overrides
        :meth:`unit_noise` (fed noise), that method's tensor."""
        if type(self).unit_noise is DitherCtx.unit_noise:
            return self.cotangent_key(name)
        return self.unit_noise(name, shape)

    def resid_dither(self, name: str, shape) -> Union[int, torch.Tensor]:
        """What layer ``name``'s residual encode dithers with: the stream
        key, or an overriding :meth:`resid_noise`'s tensor."""
        if type(self).resid_noise is DitherCtx.resid_noise:
            return self.resid_key(name)
        return self.resid_noise(name, shape)
