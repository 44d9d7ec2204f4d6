"""gemma3-4b [dense]: 34L d2560 8H (GQA kv=4) ff10240 V=262144,
5:1 local:global sliding window (1024), 128k context, head_dim=256.
[hf:google/gemma-3-4b-pt lineage; unverified per assignment]

The reference's ``repro.configs.gemma3_4b``: ``config()`` at full width (bf16,
remat per block), ``smoke()`` its 6-layer f32 model with window 8 (layer 5
global)."""
import torch

from repro_torch.models.api import lm_model
from repro_torch.models.transformer import LMConfig

ARCH_ID = "gemma3-4b"


def config():
    return lm_model(LMConfig(
        name=ARCH_ID, n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
        d_ff=10240, vocab=262144, head_dim=256, act="geglu",
        tie_embeddings=True, embed_scale=True, rope_theta=1_000_000.0,
        window=1024, window_pattern=5, dtype=torch.bfloat16,
    ), family="dense")


def smoke():
    return lm_model(LMConfig(
        name=ARCH_ID + "-smoke", n_layers=6, d_model=64, n_heads=2,
        n_kv_heads=1, d_ff=128, vocab=512, head_dim=32, act="geglu",
        tie_embeddings=True, embed_scale=True, window=8, window_pattern=5,
        dtype=torch.float32, remat=False,
    ), family="dense")
