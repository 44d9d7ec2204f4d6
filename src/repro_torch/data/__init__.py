"""Deterministic synthetic data and the prefetching loader (counterpart of
``repro.data``; its ``classification_eval_set`` has no caller in the port:
the classifier trainers evaluate on a held-out ``classification_batch``)."""
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.data.synthetic import (ClassifConfig, TokenStreamConfig,
                                        classification_batch, token_batch)

__all__ = ["ClassifConfig", "TokenStreamConfig", "classification_batch",
           "token_batch", "ShardedLoader"]
