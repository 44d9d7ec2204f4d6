"""Per-tensor symmetric absmax int8 (counterpart of ``repro.core.int8`` and
the ``int8_absmax`` codec of ``repro.quant.codecs``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

_TINY = torch.finfo(torch.float32).tiny


class QuantTensor(NamedTuple):
    q: torch.Tensor  # int8
    scale: torch.Tensor  # 0-d f32: value ~= q * scale


def absmax_scale(x: torch.Tensor) -> torch.Tensor:
    amax = x.to(torch.float32).abs().max()
    return torch.clamp(amax, min=_TINY) / 127.0


def absmax_int8(x: torch.Tensor) -> QuantTensor:
    """q = clip(round(x / scale), -127, 127): a true division and round half
    to even, as ``jnp.round`` does."""
    scale = absmax_scale(x)
    v = x.to(torch.float32) / scale
    q = torch.clamp(torch.round(v), -127, 127).to(torch.int8)
    return QuantTensor(q=q, scale=scale)
