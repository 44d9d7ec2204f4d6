"""repro_torch.distributed: data-parallel SSGD over simulated nodes
(counterpart of ``repro.distributed``)."""
from repro_torch.distributed.ssgd import (SSGDConfig, SSGDStep,
                                          make_ssgd_step, shard_batch)

__all__ = ["SSGDConfig", "SSGDStep", "make_ssgd_step", "shard_batch"]
