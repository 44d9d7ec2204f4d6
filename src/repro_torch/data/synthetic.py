"""Deterministic synthetic data (the environment is offline).

A copy of the numpy core of ``repro.data.synthetic``, so that both packages
see the identical arrays for one (seed, step, batch):

* ``token_batch``: zipf-distributed token sequences with planted bigrams
  (an LM has something to learn), ``TokenStreamConfig``;
* ``classification_batch``: image classification from class prototypes
  plus Gaussian noise, ``ClassifConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _bigram_table(vocab: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(vocab)


def _token_arrays(cfg: TokenStreamConfig, step: int):
    """(tokens, labels), each (batch, seq_len) int32, as numpy arrays: half
    zipf noise, half planted bigrams (every odd position maps to
    ``table[previous]``)."""
    rng = np.random.default_rng((cfg.seed, step))
    ranks = rng.zipf(cfg.zipf_a, size=(cfg.batch, cfg.seq_len + 1))
    toks = np.minimum(ranks - 1, cfg.vocab - 1).astype(np.int32)
    table = _bigram_table(cfg.vocab, cfg.seed)
    nxt = table[toks[:, :-1]]
    mask = (np.arange(cfg.seq_len)[None, :] % 2) == 1
    seq = np.where(mask, nxt, toks[:, 1:])
    full = np.concatenate([toks[:, :1], seq], axis=1)
    return full[:, :-1], full[:, 1:]


def token_batch(cfg: TokenStreamConfig, step: int, *,
                device: Optional[torch.device] = None
                ) -> Dict[str, torch.Tensor]:
    """Batch ``step`` of the stream: int64 ``tokens`` and ``labels``
    (batch, seq_len) on ``device``."""
    dev = resolve_device(device)
    tokens, labels = _token_arrays(cfg, step)
    return {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev),
            "labels": torch.from_numpy(labels.astype(np.int64)).to(dev)}


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
