"""gemma-2b [dense]: 18L d2048 8H (MQA kv=1) ff16384 V=256000, GeGLU,
head_dim=256, tied embeddings. [arXiv:2403.08295]

The reference's ``repro.configs.gemma_2b``: ``config()`` at full width (bf16,
remat per block), ``smoke()`` the 2-layer f32 model its CPU tests use."""
import torch

from repro_torch.models.api import lm_model
from repro_torch.models.transformer import LMConfig

ARCH_ID = "gemma-2b"


def config():
    return lm_model(LMConfig(
        name=ARCH_ID, n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_ff=16384, vocab=256000, head_dim=256, act="geglu",
        tie_embeddings=True, embed_scale=True, rope_theta=10_000.0,
        dtype=torch.bfloat16,
    ), family="dense")


def smoke():
    return lm_model(LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=1, d_ff=256, vocab=512, head_dim=32, act="geglu",
        tie_embeddings=True, embed_scale=True, dtype=torch.float32,
        remat=False,
    ), family="dense")
