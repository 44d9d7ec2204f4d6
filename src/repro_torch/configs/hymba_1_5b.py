"""hymba-1.5b [hybrid]: 32L d1600 25H (GQA kv=5) ff5504 V=32001,
parallel attn+mamba heads, ssm_state=16, meta tokens, SWA + 3 global.
[arXiv:2411.13676]

The reference's ``repro.configs.hymba_1_5b``: ``config()`` at full width
(bf16, remat per block, window 1024, 128 meta tokens), ``smoke()`` its
3-layer f32 model (window 8, 4 meta tokens; with 3 layers every layer is
global)."""
import torch

from repro_torch.models.api import hybrid_model
from repro_torch.models.hybrid import HybridConfig

ARCH_ID = "hymba-1.5b"


def config():
    return hybrid_model(HybridConfig(
        name=ARCH_ID, n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001, head_dim=64, d_state=16, expand=2,
        window=1024, n_meta_tokens=128, dtype=torch.bfloat16,
    ))


def smoke():
    return hybrid_model(HybridConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, head_dim=16, d_state=8,
        expand=2, window=8, n_meta_tokens=4, dtype=torch.float32, remat=False,
    ))
