"""whisper-small [audio]: 12L enc + 12L dec, d768 12H (MHA kv=12) ff3072
V=51865, conv/mel frontend STUB (precomputed frame embeds, 1500 frames).
[arXiv:2212.04356]

The reference's ``repro.configs.whisper_small``: ``config()`` at full
width (bf16, remat per block, 448 decoder positions), ``smoke()`` its
2-layer f32 model over 16 frames, no remat."""
import torch

from repro_torch.models.api import encdec_model
from repro_torch.models.encdec import EncDecConfig

ARCH_ID = "whisper-small"


def config():
    return encdec_model(EncDecConfig(
        name=ARCH_ID, n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865, n_frames=1500, dtype=torch.bfloat16,
    ))


def smoke():
    return encdec_model(EncDecConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512, n_frames=16, dtype=torch.float32,
        remat=False,
    ))
