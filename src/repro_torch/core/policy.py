"""Dither policy and the per-step context threaded through a model.

Counterpart of ``repro.core.policy``. The knobs ``s``, ``meprop_k_frac``
and ``row_alpha`` are host numbers: a policy program
(``repro_torch.core.schedule``) evaluates its schedules at the step on the
host and :meth:`DitherCtx.resolve` hands each layer a ``DitherPolicy`` with
its own variant and knobs. The variants:

* ``off``    plain backprop (the paper's baseline column);
* ``paper``  NSD on the pre-activation gradient, products in f32;
* ``int8``   NSD + int8 products (Table 1's 8-bit + dithered column): a
             dense layer's products on the int8 kernel, a convolution's on
             the generic path, as in the reference;
* ``row``    structured row dither (``repro_torch.core.rowdither``);
* ``meprop`` the top-k comparator (``repro_torch.core.meprop``);
* ``kernel`` NSD + tile-skipping int8 products on the CUDA kernels.

Noise. ``jax.random``'s threefry keys cannot be reproduced in torch, so
keys are 63-bit integers and :func:`fold_in` (a splitmix64 mix) stands in
for ``jax.random.fold_in``. A context is keyed as the reference's
``DitherCtx.for_step`` keys it: its base key folded with the step, then with
the worker; a micro-batch folds its index in (:meth:`DitherCtx.with_key`);
layer ``name``'s stream is ``fold_in(key, name_salt(name))`` (a crc32 of
the name, as in the reference). The unit draw is Philox4x32-10 under that
stream key (see :class:`DitherCtx`). Draws are independent across layers,
steps and data-parallel workers (the condition of the paper's averaging
argument) and identical on the CPU and the card.

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

from repro_torch.core.meprop import MEPROP_K_FRAC
from repro_torch.core.rowdither import ROW_ALPHA
from repro_torch.device import resolve_device
from repro_torch.kernels import nsd_quant
from repro_torch.quant import wire
from repro_torch.quant.codecs import MODE_FP32, RESID_SALT, validate_mode

VARIANT_OFF = "off"
VARIANT_PAPER = "paper"
VARIANT_INT8 = "int8"
VARIANT_ROW = "row"
VARIANT_MEPROP = "meprop"
VARIANT_KERNEL = "kernel"
VARIANTS = (VARIANT_OFF, VARIANT_PAPER, VARIANT_INT8, VARIANT_ROW,
            VARIANT_MEPROP, VARIANT_KERNEL)


def validate_knob_values(s, meprop_k_frac, row_alpha, owner: str) -> None:
    """Range checks shared by ``DitherPolicy`` and the program's rules and
    phases (``repro_torch.core.schedule``); ``None`` means "not set"."""
    if s is not None and not s > 0:
        raise ValueError(f"{owner}: s must be > 0, got {s!r}")
    if meprop_k_frac is not None and not 0 < meprop_k_frac <= 1:
        raise ValueError(
            f"{owner}: meprop_k_frac must be in (0, 1], got {meprop_k_frac!r}")
    if row_alpha is not None and not row_alpha > 0:
        raise ValueError(f"{owner}: row_alpha must be > 0, got {row_alpha!r}")


@dataclasses.dataclass(frozen=True)
class DitherPolicy:
    """Per-run configuration of dithered backprop (and, from
    :meth:`DitherCtx.resolve`, one layer's resolved policy)."""

    variant: str = VARIANT_PAPER
    s: float = 2.0  # Delta = s * std(grad): the paper's one knob
    exclude: Tuple[str, ...] = ()  # layer-name substrings left undithered
    collect_stats: bool = False  # record per-layer sparsity/bits/delta
    # the layer's residual mode (a codec spec of repro_torch.quant), stamped
    # by DitherCtx.resolve from its MemoryPolicy
    residual: str = MODE_FP32
    meprop_k_frac: float = MEPROP_K_FRAC  # the share of a row meProp keeps
    row_alpha: float = ROW_ALPHA  # row-dither aggressiveness

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}; one of "
                             f"{VARIANTS}")
        validate_knob_values(self.s, self.meprop_k_frac, self.row_alpha,
                             owner="DitherPolicy")
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


def fold_in(key: int, value: int) -> int:
    """A new 63-bit stream key from ``key`` and an integer: the int-key
    counterpart of ``jax.random.fold_in`` (a splitmix64 mix of the key,
    xor the value, mixed again)."""
    return _splitmix64(_splitmix64(key & _MASK64) ^ (value & _MASK64)) >> 1


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

    Keys. ``seed`` is the base key; unless ``key`` is given, the context's
    key is ``fold_in(fold_in(seed, step), worker)`` (the reference's
    ``for_step``), and a layer's stream is ``fold_in(key, name_salt(name))``
    (its ``key_for``).

    ``policy`` is the phase's base policy; with ``program`` set (a
    ``repro_torch.core.schedule.PolicyProgram``) :meth:`resolve` applies
    its rules and knob schedules at ``step`` per layer name.
    """

    policy: DitherPolicy
    seed: int = 0  # the base key
    step: int = 0
    worker: int = 0
    device: Optional[torch.device] = None
    # repro_torch.memory.MemoryPolicy selecting each layer's residual mode;
    # None = dense fp32 residuals
    memory: Any = None
    # the step's key; None = fold_in(fold_in(seed, step), worker)
    key: Optional[int] = None
    # repro_torch.core.schedule.PolicyProgram; None = the plain policy
    program: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.key is None:
            self.key = fold_in(fold_in(self.seed, self.step), self.worker)

    def with_key(self, key: int) -> "DitherCtx":
        """The same resolution state under another stream (a micro-batch:
        ``fold_in(ctx.key, i)``)."""
        return dataclasses.replace(self, key=key)

    def resolve(self, name: str) -> Optional[DitherPolicy]:
        """The policy for layer ``name`` (the program's rules and schedules
        applied) with its residual mode, or None for plain backprop."""
        if self.program is not None:
            pol = self.program.resolve_layer(self, name)
        elif self.policy.applies_to(name):
            pol = self.policy
        else:
            pol = None
        if pol is not None and self.memory is not None:
            mode = self.memory.mode_for(name)
            if mode != pol.residual:
                pol = pol.replace(residual=mode)
        return pol

    def cotangent_key(self, name: str) -> int:
        """Layer ``name``'s stream key for its cotangent's dither."""
        return fold_in(self.key, name_salt(name))

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
