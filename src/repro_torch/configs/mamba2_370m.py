"""mamba2-370m [ssm]: 48L d1024 attn-free V=50280, SSD state=128,
headdim=64 (expand=2 -> d_inner=2048, 32 SSM heads). [arXiv:2405.21060]

The reference's ``repro.configs.mamba2_370m``: ``config()`` at full width
(bf16, chunk 256, no remat: the reference measured that its activations
fit without it), ``smoke()`` its 2-layer f32 model with chunk 8."""
import torch

from repro_torch.models.api import ssm_model
from repro_torch.models.mamba import SSMConfig, SSMLMConfig

ARCH_ID = "mamba2-370m"


def config():
    return ssm_model(SSMLMConfig(
        name=ARCH_ID, n_layers=48, vocab=50280,
        ssm=SSMConfig(d_model=1024, d_inner=2048, head_dim=64, d_state=128,
                      n_groups=1, d_conv=4, chunk=256),
        dtype=torch.bfloat16, remat=False,
    ))


def smoke():
    return ssm_model(SSMLMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, vocab=512,
        ssm=SSMConfig(d_model=64, d_inner=128, head_dim=32, d_state=16,
                      n_groups=1, d_conv=4, chunk=8),
        dtype=torch.float32, remat=False,
    ))
