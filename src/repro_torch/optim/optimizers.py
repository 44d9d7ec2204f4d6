"""Optimizers: SGD with momentum (the paper's recipe) and AdamW (the LM
default). Counterpart of ``repro.optim.optimizers``.

    sgd:    mu <- momentum * mu + g + weight_decay * w;   w <- w - lr * mu
    adamw:  mu <- b1 mu + (1 - b1) g;   nu <- b2 nu + (1 - b2) g^2
            w  <- w - lr (mu / bc1 / (sqrt(nu / bc2) + eps) + weight_decay w)

with bc1 = 1 - b1^t and bc2 = 1 - b2^t at t = step + 1, an optional clip of
the gradients' global norm first, and the learning rate of
:func:`schedule_lr` (constant, cosine with linear warmup, or step decay).
bf16 and f16 parameters keep an f32 master copy in the state, updated in f32
and cast back; f32 parameters are updated directly. The arithmetic is the
reference's, in f32; the port updates parameters, masters and moments in
place (the reference returns new arrays), which keeps a 2.5 B-parameter
model's AdamW state at one copy.

Moments can live encoded through the quant engine: ``mu_codec`` /
``nu_codec`` name a deterministic registered codec spec
(``repro_torch.quant``: ``"m8"``, per-row absmax int8 momentum; ``"u8"``,
sqrt-domain uint8 second moment; or e.g. ``"int4@g32"``). The update
decodes a moment, runs the same f32 arithmetic on the fresh f32 moments,
and re-encodes it: only storage changes. It works one parameter at a time,
and a parameter whose moments scale per row (or stay f32) in slices of
rows of at most ``CHUNK_ELEMS`` elements, so the decoded f32 temporaries
stay one slice's worth; per-row scales make the slices' codes those of the
whole. Dithered codecs (``needs_noise``) are refused: moments re-encode
every step with no noise stream.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import quant
from repro_torch.device import div

_F32 = np.float32
# the most elements of one slice of rows on the encoded-moment path: 64 Mi,
# 256 MiB per f32 temporary (gemma-2b's tied embedding takes 8 slices)
CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | sgd
    lr: float = 1e-3
    momentum: float = 0.9  # sgd
    b1: float = 0.9  # adamw
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    schedule: str = "constant"  # constant | cosine | step
    warmup_steps: int = 0
    total_steps: int = 10_000
    step_decay_every: int = 100  # paper: lr-decay 0.1/100
    step_decay_rate: float = 0.1
    min_lr_ratio: float = 0.1
    # deterministic quant codec specs for stored moments (None = dense f32)
    mu_codec: Optional[str] = None
    nu_codec: Optional[str] = None  # adamw only

    def __post_init__(self):
        if self.name not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {self.name!r}")
        if self.schedule not in ("constant", "cosine", "step"):
            raise ValueError(f"unknown lr schedule {self.schedule!r}")
        for field, mode in (("mu_codec", self.mu_codec),
                            ("nu_codec", self.nu_codec)):
            if mode is not None and quant.needs_noise(mode):
                raise ValueError(
                    f"{field}={mode!r}: moment codecs must be deterministic "
                    f"(re-encoded every step without an RNG stream)")


def schedule_lr(cfg: OptConfig, step: int) -> float:
    """The learning rate of step ``step``, in the reference's f32
    arithmetic."""
    s = _F32(step)
    warm = (min(_F32(1.0), (s + _F32(1)) / _F32(max(cfg.warmup_steps, 1)))
            if cfg.warmup_steps > 0 else _F32(1.0))
    if cfg.schedule == "cosine":
        t = (s - _F32(cfg.warmup_steps)) / _F32(
            max(cfg.total_steps - cfg.warmup_steps, 1))
        t = min(max(t, _F32(0.0)), _F32(1.0))
        lo = _F32(cfg.min_lr_ratio)
        mult = lo + (_F32(1) - lo) * _F32(0.5) * (
            _F32(1) + np.cos(_F32(np.pi) * t))
    elif cfg.schedule == "step":
        mult = _F32(cfg.step_decay_rate) ** _F32(
            math.floor(step / cfg.step_decay_every))
    else:
        mult = _F32(1.0)
    return float(_F32(cfg.lr) * warm * mult)


def _needs_master(p: torch.Tensor) -> bool:
    return p.dtype in (torch.bfloat16, torch.float16)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm`` (the sum of squares in f32); returns them and the norm
    before scaling, a 0-d tensor (no host sync)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g in grads.values():
        g.copy_((g.to(torch.float32) * scale).to(g.dtype))
    return grads, gn


def _encode(mode: Optional[str], x: torch.Tensor):
    return x if mode is None else quant.encode(mode, x)


def init_opt_state(params: Dict[str, torch.Tensor], cfg: OptConfig) -> Dict:
    """``step``, f32 ``master`` copies of the bf16/f16 parameters, and the
    moments: ``mu`` (both), ``nu`` (adamw), f32 zeros, encoded under
    ``mu_codec`` / ``nu_codec`` when set."""
    def zeros(mode):
        return {n: _encode(mode, torch.zeros_like(p, dtype=torch.float32))
                for n, p in params.items()}

    state = {"step": 0,
             "master": {n: p.detach().to(torch.float32).clone()
                        for n, p in params.items() if _needs_master(p)},
             "mu": zeros(cfg.mu_codec)}
    if cfg.name == "adamw":
        state["nu"] = zeros(cfg.nu_codec)
    return state


def _update(w: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
            nu: Optional[torch.Tensor], cfg: OptConfig, lr: float,
            bc1: float, bc2: float) -> None:
    """One parameter's (or slice's) update in place: f32 master ``w``,
    gradient ``g``, moments ``mu`` and (adamw) ``nu``."""
    if cfg.name == "sgd":
        mu.mul_(cfg.momentum).add_(g).add_(w, alpha=cfg.weight_decay)
        w.sub_(lr * mu)
        return
    b1, b2 = cfg.b1, cfg.b2
    mu.mul_(b1).add_((1 - b1) * g)
    nu.mul_(b2).add_((1 - b2) * torch.square(g))
    upd = div(mu, bc1) / (torch.sqrt(div(nu, bc2)) + cfg.eps)
    if cfg.weight_decay:
        upd.add_(cfg.weight_decay * w)
    w.sub_(lr * upd)


def _row_slices(cfg: OptConfig, shape) -> Tuple[int, list]:
    """(cols, [(r0, r1), ...]) of a parameter on the encoded-moment path:
    slices of rows of at most CHUNK_ELEMS elements when every moment codec
    scales per row (or is f32), else one slice of all rows."""
    cols = int(shape[-1]) if len(shape) else 1
    rows = math.prod(int(d) for d in shape) // max(cols, 1)
    modes = (cfg.mu_codec, cfg.nu_codec if cfg.name == "adamw" else None)
    by_row = all(m is None or quant.parse_spec(m).granularity == "row"
                 for m in modes)
    step = max(CHUNK_ELEMS // max(cols, 1), 1) if by_row else rows
    return cols, [(r, min(r + step, rows))
                  for r in range(0, max(rows, 1), max(step, 1))]


def _decode_rows(mode: Optional[str], enc, r0: int, r1: int, whole: bool,
                 cols: int) -> torch.Tensor:
    """Rows r0:r1 of a moment as f32 (rows, cols): a view of an f32
    moment, or a decode (of the whole encoding, or of its row slice)."""
    if mode is None:
        return enc.reshape(-1, cols)[r0:r1]
    if not whole:
        enc = dataclasses.replace(
            enc, shape=(r1 - r0, cols),
            **{f.name: getattr(enc, f.name)[r0:r1]
               for f in dataclasses.fields(enc)
               if isinstance(getattr(enc, f.name), torch.Tensor)})
    return quant.decode(mode, enc).reshape(-1, cols)


def _store_rows(mode: Optional[str], moments: Dict, name: str,
                x: torch.Tensor, r0: int, r1: int, whole: bool,
                shape) -> None:
    """Re-encode the updated f32 rows ``x`` into ``moments[name]``: the
    whole encoding replaced, or the row slice of each of its tensors
    overwritten (an f32 moment was updated in place)."""
    if mode is None:
        return
    if whole:
        moments[name] = quant.encode(mode, x.reshape(shape))
        return
    enc, new = moments[name], quant.encode(mode, x)
    for f in dataclasses.fields(enc):
        t = getattr(enc, f.name)
        if isinstance(t, torch.Tensor):
            t[r0:r1].copy_(getattr(new, f.name))


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor], state: Dict,
                  cfg: OptConfig,
                  grads: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """One optimizer step, in place, from ``grads`` (by parameter name, of
    any float dtype: the trainer's f32 accumulation) or, when None, each
    parameter's ``.grad``. Returns the metrics: ``lr`` (a float) and, with a
    clip, ``grad_norm`` (0-d)."""
    step = state["step"]
    lr = schedule_lr(cfg, step)
    metrics = {"lr": lr}
    if grads is None:
        grads = {n: p.grad for n, p in params.items()}
    if cfg.grad_clip is not None:
        grads, metrics["grad_norm"] = clip_by_global_norm(grads, cfg.grad_clip)
    adamw = cfg.name == "adamw"
    bc1 = bc2 = None
    if adamw:
        t = _F32(step + 1)
        bc1 = float(_F32(1) - _F32(cfg.b1) ** t)
        bc2 = float(_F32(1) - _F32(cfg.b2) ** t)
    nu_codec = cfg.nu_codec if adamw else None
    encoded = cfg.mu_codec is not None or nu_codec is not None
    for name, p in params.items():
        w = state["master"].get(name, p)
        if not encoded:
            _update(w, grads[name].to(torch.float32), state["mu"][name],
                    state["nu"][name] if adamw else None, cfg, lr, bc1, bc2)
        else:
            cols, slices = _row_slices(cfg, p.shape)
            whole = len(slices) == 1
            w2, g2 = w.view(-1, cols), grads[name].reshape(-1, cols)
            for r0, r1 in slices:
                mu = _decode_rows(cfg.mu_codec, state["mu"][name], r0, r1,
                                  whole, cols)
                nu = (_decode_rows(nu_codec, state["nu"][name], r0, r1,
                                   whole, cols) if adamw else None)
                _update(w2[r0:r1], g2[r0:r1].to(torch.float32), mu, nu, cfg,
                        lr, bc1, bc2)
                _store_rows(cfg.mu_codec, state["mu"], name, mu, r0, r1,
                            whole, p.shape)
                if adamw:
                    _store_rows(nu_codec, state["nu"], name, nu, r0, r1,
                                whole, p.shape)
        if w is not p:
            p.copy_(w)
    state["step"] = step + 1
    return metrics
