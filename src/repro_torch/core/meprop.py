"""meProp comparator baseline (Sun et al. 2017), per the paper's section 4.2.

Counterpart of ``repro.core.meprop``: keep only the top-k entries of each
row of the pre-activation gradient by magnitude, k = round(frac * n) (at
least 1), a deterministic and so biased operator, the property the paper
contrasts dithered backprop against. The threshold is the k-th largest
|g| of the row and the mask ``|g| >= threshold``, so ties with the
threshold are kept, on both sides alike.
"""
from __future__ import annotations

import torch

from repro_torch.core import nsd

# the default of ``DitherPolicy.meprop_k_frac``, the share of each row the
# meprop variant keeps (the reference policy's default)
MEPROP_K_FRAC = 0.1


def meprop_sparsify(g: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Keep the top-``k_frac`` fraction of each row of ``g`` (the last axis)
    by magnitude; zeros elsewhere."""
    if g.dim() < 1:
        return g
    n = g.shape[-1]
    k = max(1, int(round(k_frac * n)))
    if k >= n:
        return g
    flat = g.reshape(-1, n)
    mag = flat.to(torch.float32).abs()
    thresh = torch.topk(mag, k, dim=-1).values[:, -1:]
    out = torch.where(mag >= thresh, flat, torch.zeros_like(flat))
    return out.reshape(g.shape)


def meprop_sparsity(g: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Realised sparsity of the meProp mask (ties can keep a few extra)."""
    out = meprop_sparsify(g, k_frac)
    return 1.0 - nsd.mask_mean(out != 0)
