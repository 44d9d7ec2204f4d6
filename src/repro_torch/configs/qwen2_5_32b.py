"""qwen2.5-32b [dense]: 64L d5120 40H (GQA kv=8) ff27648 V=152064, QKV bias.
[hf:Qwen/Qwen2.5-32B; config lineage via Qwen2.5-0.5B per assignment]

The reference's ``repro.configs.qwen2_5_32b``: ``config()`` at full width
(bf16, remat per block, untied head), ``smoke()`` its 2-layer f32 model."""
import torch

from repro_torch.models.api import lm_model
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen2.5-32b"


def config():
    return lm_model(LMConfig(
        name=ARCH_ID, n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab=152064, head_dim=128, act="swiglu", qkv_bias=True,
        tie_embeddings=False, rope_theta=1_000_000.0, dtype=torch.bfloat16,
    ), family="dense")


def smoke():
    return lm_model(LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, act="swiglu",
        qkv_bias=True, tie_embeddings=False, dtype=torch.float32, remat=False,
    ), family="dense")
