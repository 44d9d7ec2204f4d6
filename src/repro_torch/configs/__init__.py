"""Model configurations: the paper's classifiers (``paper_models``) and the
LM architecture registry (``--arch <id>`` of ``repro_torch.launch.train``).

Counterpart of ``repro.configs``; the registry holds every arch of the
reference, in its order: the dense (qwen2.5-32b, gemma-2b, gemma3-4b,
minitron-8b), MoE (dbrx-132b, moonshot-v1-16b-a3b), hybrid (hymba-1.5b),
SSM (mamba2-370m), VLM (internvl2-2b) and audio (whisper-small)
families."""
from __future__ import annotations

import importlib
from typing import Dict

_MODULES: Dict[str, str] = {
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "whisper-small": "repro_torch.configs.whisper_small",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    return importlib.import_module(_MODULES[arch_id])


def get_model(arch_id: str):
    """The full-size configuration."""
    return _module(arch_id).config()


def get_smoke_model(arch_id: str):
    """The reduced same-family configuration for CPU runs."""
    return _module(arch_id).smoke()
