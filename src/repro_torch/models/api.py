"""The model interface the LM trainer, launchers and serving engine talk to.

Counterpart of ``repro.models.api``'s ``Model``, ``lm_model`` (the dense,
MoE and VLM families), ``ssm_model``, ``hybrid_model`` and
``encdec_model`` (the audio family). The port's
parameters are an ``nn.Module``: ``init(seed, device)`` builds one,
``loss(net, batch, ctx=None)`` and ``forward(net, batch, ctx=None)`` run it
(a VLM batch may carry ``patch_embeds``, an audio batch carries
``frames``); for serving,
``init_cache(batch, max_len, device=None)``, ``decode_step(net, cache,
token, t, t_host=None)`` and ``prefill(net, tokens, max_len, **extras)``
(the reference path of ``repro_torch.serve.greedy_generate``; extras:
``patch_embeds`` for the VLM, ``frames`` for the audio family).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import transformer as tf_mod


@dataclasses.dataclass
class Model:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio
    cfg: Any
    init: Callable  # (seed, device) -> nn.Module
    loss: Callable  # (net, batch, ctx=None) -> 0-d f32 tensor
    forward: Callable  # (net, batch, ctx=None) -> logits
    init_cache: Callable  # (batch, max_len, device=None) -> cache
    decode_step: Callable  # (net, cache, token, t, t_host=None)
    prefill: Callable  # (net, tokens (B, S), max_len, **extras)
    param_count: int = 0
    active_param_count: int = 0


def lm_model(cfg: tf_mod.LMConfig, family: str) -> Model:
    def loss(net, batch, ctx=None):
        return tf_mod.loss_fn(net, batch, ctx=ctx)

    def forward(net, batch, ctx=None):
        return tf_mod.forward(net, batch["tokens"], ctx=ctx,
                              patch_embeds=batch.get("patch_embeds"))

    return Model(name=cfg.name, family=family, cfg=cfg,
                 init=lambda seed, device: tf_mod.init_lm(cfg, seed=seed,
                                                          device=device),
                 loss=loss, forward=forward,
                 init_cache=lambda b, s, device=None: tf_mod.init_cache(
                     cfg, b, s, device=device),
                 decode_step=tf_mod.decode_step, prefill=tf_mod.prefill,
                 param_count=cfg.param_count,
                 active_param_count=cfg.active_param_count)


def _stateful_model(mod, cfg, family: str, init: Callable) -> Model:
    return Model(name=cfg.name, family=family, cfg=cfg,
                 init=lambda seed, device: init(cfg, seed=seed,
                                                device=device),
                 loss=lambda net, batch, ctx=None: mod.loss_fn(net, batch,
                                                               ctx=ctx),
                 forward=lambda net, batch, ctx=None: mod.forward(
                     net, batch["tokens"], ctx=ctx),
                 init_cache=lambda b, s, device=None: mod.init_cache(
                     cfg, b, s, device=device),
                 decode_step=mod.decode_step, prefill=mod.prefill,
                 param_count=cfg.param_count,
                 active_param_count=cfg.active_param_count)


def ssm_model(cfg: mamba_mod.SSMLMConfig) -> Model:
    return _stateful_model(mamba_mod, cfg, "ssm", mamba_mod.init_ssm_lm)


def hybrid_model(cfg: hybrid_mod.HybridConfig) -> Model:
    return _stateful_model(hybrid_mod, cfg, "hybrid",
                           hybrid_mod.init_hybrid_lm)


def encdec_model(cfg: encdec_mod.EncDecConfig) -> Model:
    return Model(name=cfg.name, family="audio", cfg=cfg,
                 init=lambda seed, device: encdec_mod.init_encdec(
                     cfg, seed=seed, device=device),
                 loss=lambda net, batch, ctx=None: encdec_mod.loss_fn(
                     net, batch, ctx=ctx),
                 forward=lambda net, batch, ctx=None: encdec_mod.forward(
                     net, batch, ctx=ctx),
                 init_cache=lambda b, s, device=None: encdec_mod.init_cache(
                     cfg, b, s, device=device),
                 decode_step=encdec_mod.decode_step,
                 prefill=encdec_mod.prefill,
                 param_count=cfg.param_count,
                 active_param_count=cfg.active_param_count)
