"""Model configurations: the paper's classifiers (``paper_models``) and the
LM architecture registry (``--arch <id>`` of ``repro_torch.launch.train``).

Counterpart of ``repro.configs``; the registry holds the archs the port has:
the dense (gemma-2b, gemma3-4b, qwen2.5-32b, minitron-8b), MoE
(moonshot-v1-16b-a3b, dbrx-132b), VLM (internvl2-2b), SSM (mamba2-370m)
and hybrid (hymba-1.5b) families. The reference's audio arch
(``NOT_PORTED``: whisper-small) raises ``NotImplementedError`` naming
ROADMAP.md section 1, item 6."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.transformer import ZOO_TODO

_MODULES: Dict[str, str] = {
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}

ARCH_IDS = tuple(_MODULES)
NOT_PORTED = ("whisper-small",)


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
