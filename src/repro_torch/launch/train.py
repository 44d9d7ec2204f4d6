"""LM training launcher.

    python -m repro_torch.launch.train --arch gemma-2b --preset smoke \\
        --steps 3 --device cpu \\
        --program "dither: phase@0=off;phase@1=kernel;rule lm_head:off"

Counterpart of ``repro.launch.train``. Presets: ``smoke``, the arch's
reduced f32 configuration (CPU-sized); ``full``, its published widths (bf16,
remat per block; gemma-2b fits one 80 GB card with AdamW). The dither
comes from ``--dither``/``--s`` as the base policy, and the ``dither:``
section of ``--program`` (phases, knob schedules, per-layer rules; the
kernel variant is reached through a phase or rule ``kernel``); the
``memory:`` section picks each dithered layer's residual codec. Runs on
CUDA unless ``--device cpu``; logs the loss every ``max(steps // 10, 1)``
steps to stderr.

Not ported yet (ROADMAP.md section 1): the flags ``--ckpt-dir``,
``--ckpt-every`` (checkpoints, item 5), ``--run-dir``,
``--escalate-monitors`` (obs, item 4) and ``--distributed`` (item 7), and
the ``comm:`` and ``quant:`` program sections, which raise.
"""
from __future__ import annotations

import argparse
import logging
from typing import Iterator, Optional, Sequence

from repro_torch.configs import (ARCH_IDS, NOT_PORTED, get_model,
                                 get_smoke_model)
from repro_torch.core.policy import DitherPolicy
from repro_torch.data.synthetic import TokenStreamConfig, token_batch
from repro_torch.device import resolve_device
from repro_torch.launch.program import merge_legacy_flags
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

log = logging.getLogger("repro_torch.train")


def batch_fn_for(model, batch: int, seq: int, device):
    """Step -> the synthetic token batch of that step (dense family)."""
    if model.family != "dense":
        raise NotImplementedError(f"batch_fn_for: family {model.family!r}")
    tcfg = TokenStreamConfig(vocab=model.cfg.vocab, seq_len=seq, batch=batch)
    return lambda step: token_batch(tcfg, step, device=device)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the reference's archs the port lacks are accepted and refused by the
    # registry, naming the ROADMAP item
    ap.add_argument("--arch", choices=ARCH_IDS + NOT_PORTED, required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dither", choices=["off", "paper", "int8", "row",
                                         "meprop"], default="paper")
    ap.add_argument("--s", type=float, default=2.0)
    ap.add_argument("--program", default="",
                    help="run program with 'dither:' and 'memory:' sections, "
                    "e.g. \"dither: phase@0=off;phase@30=kernel;"
                    "rule lm_head:off memory: default=nsd\" (see "
                    "repro_torch.launch.program). The dither section builds "
                    "on --dither/--s as the base policy.")
    ap.add_argument("--policy-program", default="",
                    help="DEPRECATED: use --program \"dither: ...\"")
    ap.add_argument("--memory-program", default="",
                    help="DEPRECATED: use --program \"memory: ...\"")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is none)")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """The trainer and the batch iterator that ``main`` runs."""
    device = resolve_device(args.device)
    model = (get_smoke_model if args.preset == "smoke" else get_model)(
        args.arch)
    spec = merge_legacy_flags(args.program, args.policy_program,
                              args.memory_program)
    spec.comm_policy()  # not ported: a comm: section raises
    spec.quant_overrides()  # not ported: a quant: section raises
    policy = (None if args.dither == "off"
              else DitherPolicy(variant=args.dither, s=args.s))
    if spec.dither:
        # --dither off stays off as the base: only the program's phases and
        # rule variants turn dithering on
        base = (policy if policy is not None
                else DitherPolicy(variant="off", s=args.s))
        policy = spec.dither_program(base)
    trainer = Trainer(
        model,
        OptConfig(name="adamw", lr=args.lr, schedule="cosine",
                  warmup_steps=max(args.steps // 20, 1),
                  total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, grad_accum=args.grad_accum,
                      log_every=max(args.steps // 10, 1)),
        policy=policy, memory_policy=spec.memory_policy(), device=device)
    fn = batch_fn_for(model, args.batch, args.seq, device)

    def batches() -> Iterator:
        step = 0
        while True:
            yield fn(step)
            step += 1

    return trainer, batches()


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse, build and fit; returns the trainer (its ``history``, ``net``
    and ``opt_state``)."""
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname).1s %(name)s :: %(message)s")
    trainer, batches = build(parse_args(argv))
    trainer.fit(batches)
    h = trainer.history
    log.info("final loss: %.4f", h[-1]["loss"] if h else float("nan"))
    return trainer


if __name__ == "__main__":
    main()
