"""internvl2-2b [vlm]: 24L d2048 16H (GQA kv=8) ff8192 V=92553 — InternLM2
backbone + InternViT frontend STUB (precomputed patch embeds -> MLP
projector -> 256 visual prefix tokens). [arXiv:2404.16821]

The reference's ``repro.configs.internvl2_2b``: ``config()`` at full width
(bf16, remat per block, untied head, 256 patches of vit_dim 1024),
``smoke()`` its 2-layer f32 model with 8 patches of 64."""
import torch

from repro_torch.models.api import lm_model
from repro_torch.models.transformer import LMConfig

ARCH_ID = "internvl2-2b"


def config():
    return lm_model(LMConfig(
        name=ARCH_ID, n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92553, head_dim=128, act="swiglu",
        tie_embeddings=False, rope_theta=1_000_000.0, dtype=torch.bfloat16,
        vlm_patches=256, vit_dim=1024,
    ), family="vlm")


def smoke():
    return lm_model(LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, act="swiglu",
        tie_embeddings=False, dtype=torch.float32, remat=False,
        vlm_patches=8, vit_dim=64,
    ), family="vlm")
