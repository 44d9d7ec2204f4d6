"""Model configurations: the paper's classifiers (``paper_models``) and the
LM architecture registry (``--arch <id>`` of ``repro_torch.launch.train``).

Counterpart of ``repro.configs``; the registry holds the archs the port has.
The reference's other nine (``NOT_PORTED``) raise ``NotImplementedError``
naming ROADMAP.md section 1, item 6."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.transformer import ZOO_TODO

_MODULES: Dict[str, str] = {
    "gemma-2b": "repro_torch.configs.gemma_2b",
}

ARCH_IDS = tuple(_MODULES)
NOT_PORTED = ("qwen2.5-32b", "gemma3-4b", "minitron-8b", "dbrx-132b",
              "moonshot-v1-16b-a3b", "hymba-1.5b", "mamba2-370m",
              "internvl2-2b", "whisper-small")


def _module(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: {ZOO_TODO}")
    return importlib.import_module(_MODULES[arch_id])


def get_model(arch_id: str):
    """The full-size configuration."""
    return _module(arch_id).config()


def get_smoke_model(arch_id: str):
    """The reduced same-family configuration for CPU runs."""
    return _module(arch_id).smoke()
