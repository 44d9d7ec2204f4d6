"""Device selection for the port's entry points, and IEEE division by a
number on every device."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With ``device=None`` and no GPU this raises instead of quietly running
    on the CPU; callers that mean the CPU (the tests) pass ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. CUDA computes a tensor
    divided by a Python number as x * (1 / d) (PyTorch's
    ``div_true_kernel_cuda``), which may differ from x / d in the last bit;
    a divisor on x's device keeps the true division that the CPU and the
    reference compute."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)
