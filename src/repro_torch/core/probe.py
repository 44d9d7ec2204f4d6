"""Pre-activation gradient probe (the "tap" trick) for Table 1's telemetry.

Counterpart of ``repro.core.probe``. A model takes an optional ``taps``
dict of zero tensors that are added to its pre-activations; the gradient of
the loss with respect to a tap is exactly that site's pre-activation
gradient delta_z. Taps are shaped as the reference's, NHWC for a
convolution (``repro_torch.models.cnn.tap_shapes``), so a tap's gradient is
laid out as the reference's.

    taps = make_taps(tap_shapes(cfg, B), device=dev)
    grads = grad_wrt_taps(lambda taps: loss_fn(net, batch, taps=taps), taps)
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import nsd


def make_taps(shapes: Dict[str, Tuple[int, ...]], dtype=torch.float32, *,
              device: Optional[torch.device] = None
              ) -> Dict[str, torch.Tensor]:
    """Zero taps of the given shapes that require a gradient."""
    return {k: torch.zeros(s, dtype=dtype, device=device, requires_grad=True)
            for k, s in shapes.items()}


def tap(x: torch.Tensor, taps: Optional[Dict[str, torch.Tensor]],
        name: str) -> torch.Tensor:
    """x plus the named tap, if there is one. A 4-D x is NCHW and its tap
    NHWC (the reference's layout)."""
    if taps is None or name not in taps:
        return x
    t = taps[name].to(x.dtype)
    if x.dim() == 4:
        B, C, H, W = x.shape
        return x + t.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return x + t.reshape(x.shape)


def grad_wrt_taps(loss_fn: Callable, taps: Dict[str, torch.Tensor], *args,
                  **kwargs) -> Dict[str, torch.Tensor]:
    """d(loss)/d(taps) for ``loss_fn(*args, taps=taps, **kwargs)``: the
    exact pre-activation gradients, one per tap."""
    loss = loss_fn(*args, taps=taps, **kwargs)
    names = list(taps)
    grads = torch.autograd.grad(loss, [taps[n] for n in names])
    return dict(zip(names, grads))


def layer_nsd_stats(delta_z: torch.Tensor, u: torch.Tensor, s: float
                    ) -> nsd.QuantStats:
    """The NSD stats that dithering this gradient (unit draw ``u``) would
    give."""
    delta = nsd.compute_delta(delta_z, s)
    k = nsd.nsd_indices(delta_z, u, delta)
    return nsd.quant_stats(k, delta)


def baseline_sparsity(delta_z: torch.Tensor) -> torch.Tensor:
    """Sparsity of the raw gradient: Table 1's "Baseline" column."""
    return 1.0 - nsd.mask_mean(delta_z != 0)
