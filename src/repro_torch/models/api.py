"""The model interface the LM trainer, launchers and serving engine talk to.

Counterpart of ``repro.models.api``'s ``Model`` and ``lm_model`` for the
dense family. The port's parameters are an ``nn.Module``: ``init(seed,
device)`` builds one, ``loss(net, batch, ctx=None)`` and
``forward(net, batch, ctx=None)`` run it; for serving,
``init_cache(batch, max_len, device=None)``, ``decode_step(net, cache,
token, t, t_host=None)`` and ``prefill(net, tokens, max_len)`` (the
reference path of ``repro_torch.serve.greedy_generate``). The other
families come with their models (ROADMAP.md section 1, item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import transformer as tf_mod


@dataclasses.dataclass
class Model:
    name: str
    family: str  # dense
    cfg: Any
    init: Callable  # (seed, device) -> nn.Module
    loss: Callable  # (net, batch, ctx=None) -> 0-d f32 tensor
    forward: Callable  # (net, batch, ctx=None) -> logits
    init_cache: Callable  # (batch, max_len, device=None) -> cache
    decode_step: Callable  # (net, cache, token, t, t_host=None)
    prefill: Callable  # (net, tokens (B, S), max_len) -> (logits, cache, t)
    param_count: int = 0


def lm_model(cfg: tf_mod.LMConfig, family: str) -> Model:
    if family != "dense":
        raise NotImplementedError(
            f"lm_model: family {family!r} is not ported yet: "
            f"{tf_mod.ZOO_TODO}")

    def loss(net, batch, ctx=None):
        return tf_mod.loss_fn(net, batch, ctx=ctx)

    def forward(net, batch, ctx=None):
        return tf_mod.forward(net, batch["tokens"], ctx=ctx)

    return Model(name=cfg.name, family=family, cfg=cfg,
                 init=lambda seed, device: tf_mod.init_lm(cfg, seed=seed,
                                                          device=device),
                 loss=loss, forward=forward,
                 init_cache=lambda b, s, device=None: tf_mod.init_cache(
                     cfg, b, s, device=device),
                 decode_step=tf_mod.decode_step, prefill=tf_mod.prefill,
                 param_count=cfg.param_count)
