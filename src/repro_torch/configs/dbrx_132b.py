"""dbrx-132b [moe]: 40L d6144 48H (GQA kv=8) ff10752/expert V=100352,
16 experts top-4 fine-grained. [hf:databricks/dbrx-base; unverified]

The reference's ``repro.configs.dbrx_132b``: ``config()`` at full width
(bf16, remat per block; ``a2a_int8`` is the expert-parallel wire's, which
one card does not use), ``smoke()`` its 2-layer f32 model with 4 experts
top-2."""
import torch

from repro_torch.models.api import lm_model
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "dbrx-132b"


def config():
    return lm_model(LMConfig(
        name=ARCH_ID, n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100352, head_dim=128, act="swiglu",
        tie_embeddings=False, rope_theta=500_000.0, dtype=torch.bfloat16,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752,
                      a2a_int8=True),
    ), family="moe")


def smoke():
    return lm_model(LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, head_dim=32, act="swiglu",
        tie_embeddings=False, dtype=torch.float32, remat=False,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      dispatch="einsum"),
    ), family="moe")
