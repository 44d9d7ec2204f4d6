"""minitron-8b [dense]: 32L d4096 32H (GQA kv=8) ff16384 V=256000 —
pruned Nemotron-4 (squared-ReLU MLP per lineage). [arXiv:2407.14679]

The reference's ``repro.configs.minitron_8b``: ``config()`` at full width
(bf16, remat per block, untied head, relu2 MLP without a gate), ``smoke()``
its 2-layer f32 model."""
import torch

from repro_torch.models.api import lm_model
from repro_torch.models.transformer import LMConfig

ARCH_ID = "minitron-8b"


def config():
    return lm_model(LMConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=16384, vocab=256000, head_dim=128, act="relu2",
        tie_embeddings=False, rope_theta=10_000.0, dtype=torch.bfloat16,
    ), family="dense")


def smoke():
    return lm_model(LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, act="relu2",
        tie_embeddings=False, dtype=torch.float32, remat=False,
    ), family="dense")
