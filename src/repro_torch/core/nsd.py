"""Non-subtractive dithered (NSD) quantization, the paper's core operator.

    x_tilde = Delta * floor((x + nu) / Delta + 1/2)
    nu ~ U(-Delta/2, Delta/2),   Delta = s * std(x)   (per tensor, per layer)

Counterpart of ``repro.core.nsd``. Here the dither noise enters as a unit
draw ``u ~ U(-1/2, 1/2)`` that the caller supplies: the paper variant's
``DitherCtx.unit_noise`` (a Philox draw from the layer's stream key), or the
reference's exact draw that a test feeds. The kernel variant never forms u:
its NSD launch (``repro_torch.kernels.nsd_quant``) draws the same numbers
from the key inside, and takes ``dither_noise``'s nu only on the fed route.
All arithmetic is f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# |k| is clipped so the non-zeros always fit in int8 (a numerical safety
# net: for s >= 1 a Gaussian almost never reaches 127 sigma).
INT8_CLIP = 127
_TINY = torch.finfo(torch.float32).tiny


class QuantStats(NamedTuple):
    """Telemetry matching the paper's Table-1 metrics (0-d f32 tensors)."""

    sparsity: torch.Tensor  # fraction of exact zeros after NSD
    max_bitwidth: torch.Tensor  # worst-case bits (sign included) of the ks
    delta: torch.Tensor  # the step size used


def compute_delta(x: torch.Tensor, s: float) -> torch.Tensor:
    """Delta = s * std(x) over the whole tensor, in f32. The population std
    (``correction=0``), as ``jnp.std`` computes it."""
    return s * torch.std(x.to(torch.float32), correction=0)


def dither_noise(u: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """nu = u * Delta for a unit draw u ~ U(-1/2, 1/2), f32."""
    return u.to(torch.float32) * delta


def nsd_indices(x: torch.Tensor, u: torch.Tensor, delta: torch.Tensor
                ) -> torch.Tensor:
    """Integer indices k = floor((x + nu) / Delta + 1/2), int32, clipped to
    +-127; zeros when Delta <= 0 (e.g. an all-zero gradient)."""
    nu = dither_noise(u, delta)
    safe = torch.clamp(delta, min=_TINY)
    k = torch.floor((x.to(torch.float32) + nu) / safe + 0.5)
    k = torch.clamp(k, -INT8_CLIP, INT8_CLIP).to(torch.int32)
    return torch.where(delta > 0.0, k, torch.zeros_like(k))


class QuantizedGrad(NamedTuple):
    """int8 form of an NSD-quantized tensor: value = k * delta."""

    k: torch.Tensor  # int8 indices
    delta: torch.Tensor  # 0-d f32 step

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.k.to(torch.float32) * self.delta).to(dtype)


def quant_stats(k: torch.Tensor, delta: torch.Tensor) -> QuantStats:
    """Sparsity and worst-case bit-width of an integer index tensor; stays
    on k's device (no host sync)."""
    kf = k.to(torch.int32)
    # mean as count * (1/n): the form XLA gives jnp.mean, so the f32 result
    # is the reference's to the bit
    inv_n = 1.0 / torch.tensor(float(kf.numel()), dtype=torch.float32,
                               device=kf.device)
    sparsity = 1.0 - (kf != 0).sum().to(torch.float32) * inv_n
    max_abs = kf.abs().max().to(torch.float32)
    # bits = ceil(log2(max|k| + 1)) + 1 sign bit; 0 bits when all-zero
    bits = torch.where(max_abs > 0, torch.ceil(torch.log2(max_abs + 1.0)) + 1.0,
                       torch.zeros_like(max_abs))
    return QuantStats(sparsity=sparsity, max_bitwidth=bits,
                      delta=delta.to(torch.float32))
