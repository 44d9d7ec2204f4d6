"""Structured row dither: the beyond-paper variant that makes sparsity come
in whole rows.

Counterpart of ``repro.core.rowdither``. Each row g_i of the 2-D
pre-activation gradient (one example or output position) is kept with
probability

    p_i = min(1, ||g_i||_2 / (alpha * m)),   m = the mean row norm,

and a kept row is scaled by 1 / p_i, so E[out] = g. The dropped rows shrink
the contraction of both backward products directly.

The draw is fed: ``u`` holds one uniform in [0, 1) per row (shape (T,) or
(T, 1)); the dithered ops take it from the layer's stream
(``DitherCtx.unit_noise(name, (T, 1)) + 1/2``) and tests feed the
reference's ``jax.random.uniform`` draw. ``row_then_nsd`` takes a second,
elementwise unit draw in [-1/2, 1/2) for its NSD pass.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import nsd

_TINY = torch.finfo(torch.float32).tiny
# the default of ``DitherPolicy.row_alpha``, the row variant's
# aggressiveness (the reference policy's default)
ROW_ALPHA = 1.0


def _row_probs(g2d: torch.Tensor, alpha: float) -> torch.Tensor:
    norms = torch.linalg.vector_norm(g2d.to(torch.float32), dim=-1)
    safe = torch.clamp(alpha * norms.mean(), min=_TINY)
    return torch.clamp(norms / safe, 0.0, 1.0)


def _keep_and_scale(g2d, u, alpha):
    p = _row_probs(g2d, alpha)
    keep = u.reshape(-1).to(torch.float32) < p
    scale = torch.where(keep, 1.0 / torch.clamp(p, min=_TINY),
                        torch.zeros_like(p))
    return p, keep, scale


def row_dither(g: torch.Tensor, u: torch.Tensor, alpha: float = 1.0
               ) -> torch.Tensor:
    """Unbiased Bernoulli row sampling with 1/p rescaling; g's shape."""
    shape = g.shape
    g2d = g.reshape(-1, shape[-1])
    _, _, scale = _keep_and_scale(g2d, u, alpha)
    out = g2d.to(torch.float32) * scale[:, None]
    return out.to(g.dtype).reshape(shape)


class CompactRows(NamedTuple):
    """Fixed-capacity compaction of the surviving rows."""

    rows: torch.Tensor  # (capacity, n) the scaled surviving rows, zero-padded
    index: torch.Tensor  # (capacity,) int32 source row of each slot
    valid: torch.Tensor  # (capacity,) bool, slot occupied
    n_rows: torch.Tensor  # 0-d int32, number of survivors (may exceed capacity)


def row_dither_compact(g: torch.Tensor, u: torch.Tensor, alpha: float,
                       capacity: int) -> CompactRows:
    """Row dither, then the survivors gathered into a dense (capacity, n)
    matrix, highest p first (a stable order, as ``jnp.argsort``). Survivors
    beyond ``capacity`` are dropped without rescaling the rest; ``n_rows >
    capacity`` reports it."""
    g2d = g.reshape(-1, g.shape[-1])
    p, keep, scale = _keep_and_scale(g2d, u, alpha)
    order_key = torch.where(keep, p, torch.full_like(p, -1.0))
    idx = torch.argsort(-order_key, stable=True)[:capacity]
    rows = (g2d.to(torch.float32) * scale[:, None])[idx]
    valid = keep[idx]
    rows = torch.where(valid[:, None], rows, torch.zeros_like(rows)).to(g.dtype)
    return CompactRows(rows=rows, index=idx.to(torch.int32), valid=valid,
                       n_rows=keep.to(torch.int32).sum().to(torch.int32))


def scatter_rows(compact: CompactRows, n_total_rows: int) -> torch.Tensor:
    """The inverse of the compaction: (n_total_rows, n), zeros elsewhere."""
    n = compact.rows.shape[-1]
    out = torch.zeros((n_total_rows, n), dtype=compact.rows.dtype,
                      device=compact.rows.device)
    idx = compact.index.to(torch.int64)[compact.valid]
    return out.index_add(0, idx, compact.rows[compact.valid])


def row_then_nsd(g: torch.Tensor, u_rows: torch.Tensor, u_nsd: torch.Tensor,
                 alpha: float, s: float) -> torch.Tensor:
    """Row dither (uniforms ``u_rows``), then elementwise NSD on the result
    (unit draw ``u_nsd``, g's shape): k * Delta."""
    rd = row_dither(g, u_rows, alpha)
    delta = nsd.compute_delta(rd, s)
    k = nsd.nsd_indices(rd, u_nsd, delta)
    return (k.to(torch.float32) * delta).to(rd.dtype)


def row_sparsity(g: torch.Tensor, u: torch.Tensor, alpha: float
                 ) -> torch.Tensor:
    """Fraction of rows dropped (the structured sparsity realised)."""
    g2d = g.reshape(-1, g.shape[-1])
    _, keep, _ = _keep_and_scale(g2d, u, alpha)
    return 1.0 - nsd.mask_mean(keep)
