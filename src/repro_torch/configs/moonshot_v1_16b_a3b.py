"""moonshot-v1-16b-a3b [moe]: 48L d2048 16H (MHA kv=16) ff1408/expert
V=163840, 64 experts top-6 + 2 shared (DeepSeek-style).
[hf:moonshotai/Moonlight-16B-A3B]

The reference's ``repro.configs.moonshot_v1_16b_a3b``: ``config()`` at full
width (bf16, remat per block; ``a2a_int8`` is the expert-parallel wire's,
which one card does not use: dispatch ``auto`` is ``einsum`` there),
``smoke()`` its 2-layer f32 model with 8 experts top-2 and one shared."""
import torch

from repro_torch.models.api import lm_model
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def config():
    return lm_model(LMConfig(
        name=ARCH_ID, n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=163840, head_dim=128, act="swiglu",
        tie_embeddings=False, rope_theta=50_000.0, dtype=torch.bfloat16,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                      a2a_int8=True),
    ), family="moe")


def smoke():
    return lm_model(LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=512, head_dim=32, act="swiglu",
        tie_embeddings=False, dtype=torch.float32, remat=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                      dispatch="einsum"),
    ), family="moe")
