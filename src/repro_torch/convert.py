"""Parameter conversion between the JAX reference and the port.

The reference keeps conv weights HWIO (NHWC convolutions); the port keeps
them OIHW. Every other parameter (biases, BatchNorm scale and shift, dense
weights (in, out)) has the same layout in both. Names are kept as they are
(``c{i}_w``, ``bn{i}_g``, ``fc{i}_w``, ...).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def params_from_jax(tree: Dict[str, np.ndarray], *,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """Reference parameters (as numpy) -> the port's tensors (4-D conv
    weights HWIO -> OIHW)."""
    out = {}
    for name, a in tree.items():
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax` (OIHW -> HWIO)."""
    out = {}
    for name, t in params.items():
        a = t.detach().cpu().numpy()
        out[name] = np.ascontiguousarray(a.transpose(2, 3, 1, 0)
                                         if a.ndim == 4 else a)
    return out
