"""Deterministic synthetic image classification (the environment is
offline): class prototypes plus Gaussian noise.

A copy of the numpy core of ``repro.data.synthetic`` (``ClassifConfig``,
``_prototypes``, ``classification_batch``), so that both packages see the
identical arrays for one (seed, step, batch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ClassifConfig:
    n_classes: int = 10
    img_size: int = 28
    channels: int = 1
    noise: float = 0.35
    seed: int = 0


def _prototypes(cfg: ClassifConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    return rng.normal(
        0, 1, (cfg.n_classes, cfg.img_size, cfg.img_size, cfg.channels)
    ).astype(np.float32)


def _classification_arrays(cfg: ClassifConfig, step: int, batch: int):
    """(images (B, H, W, C) f32, labels (B,) int32) as numpy arrays."""
    rng = np.random.default_rng((cfg.seed, 7, step))
    labels = rng.integers(0, cfg.n_classes, size=(batch,))
    protos = _prototypes(cfg)
    x = protos[labels] + cfg.noise * rng.normal(
        0, 1, (batch, cfg.img_size, cfg.img_size, cfg.channels))
    return x.astype(np.float32), labels.astype(np.int32)


def classification_batch(cfg: ClassifConfig, step: int, batch: int, *,
                         device: Optional[torch.device] = None
                         ) -> Dict[str, torch.Tensor]:
    """Batch ``step``: NHWC f32 images and int64 labels on ``device``."""
    dev = resolve_device(device)
    x, labels = _classification_arrays(cfg, step, batch)
    return {"images": torch.from_numpy(x).to(dev),
            "labels": torch.from_numpy(labels.astype(np.int64)).to(dev)}
