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
``memory:`` section picks each dithered layer's residual codec; the
``quant:`` section picks registered codecs per surface: ``grad=`` the
cotangent codec (on the base policy, so phases and rules inherit it),
``resid=`` the residual default (``memory: default=SPEC``), ``mu=`` and
``nu=`` AdamW's stored moments. A ``controller:`` clause in the dither
section holds each layer's sparsity at its target. ``--run-dir DIR``
records the run (the dither, memory, phase, train and monitor streams and a
manifest) into DIR, rendered by ``python -m repro_torch.obs.report DIR``;
``--escalate-monitors`` makes a critical health event (a non-finite loss)
raise. Runs on CUDA unless ``--device cpu``; logs the loss every
``max(steps // 10, 1)`` steps to stderr.

Not ported yet (ROADMAP.md section 1): the flags ``--ckpt-dir``,
``--ckpt-every`` (checkpoints, item 5) and ``--distributed`` (item 7), and
the ``comm:`` section and ``quant: wire=`` (item 7.5), which raise.
"""
from __future__ import annotations

import argparse
from typing import Iterator, Optional, Sequence

from repro_torch.configs import (ARCH_IDS, NOT_PORTED, get_model,
                                 get_smoke_model)
from repro_torch.core.policy import DitherPolicy
from repro_torch.data.synthetic import TokenStreamConfig, token_batch
from repro_torch.device import resolve_device
from repro_torch.launch.program import format_program, merge_legacy_flags
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils import get_logger

log = get_logger("repro_torch.train")


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
                    help="run program with 'dither:', 'memory:' and 'quant:' "
                    "sections, e.g. \"dither: phase@0=off;phase@30=kernel;"
                    "rule lm_head:off memory: default=nsd quant: mu=m8;"
                    "nu=u8\" (see repro_torch.launch.program). The dither "
                    "section builds on --dither/--s as the base policy; the "
                    "quant section picks registered codecs per surface "
                    "(grad/resid/mu/nu, see repro_torch.quant.program).")
    ap.add_argument("--policy-program", default="",
                    help="DEPRECATED: use --program \"dither: ...\"")
    ap.add_argument("--memory-program", default="",
                    help="DEPRECATED: use --program \"memory: ...\"")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--run-dir", default="",
                    help="observability run directory: drains the metrics "
                    "bus (dither/comm/memory/phase/train/monitor streams) "
                    "into JSONL + a provenance manifest; render with "
                    "'python -m repro_torch.obs.report <run-dir>'")
    ap.add_argument("--escalate-monitors", action="store_true",
                    help="with --run-dir: critical health events (NaN "
                    "loss) raise instead of warn")
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
    qo = spec.quant_overrides()  # wire= raises: not ported
    policy = (None if args.dither == "off"
              else DitherPolicy(variant=args.dither, s=args.s))
    if qo is not None and qo.grad is not None:
        # on the BASE policy, so the program's phases and rules inherit the
        # cotangent codec (they build on the base with replace)
        policy = ((policy or DitherPolicy(variant="off", s=args.s))
                  .replace(grad_codec=qo.grad))
    if spec.dither:
        # --dither off stays off as the base: only the program's phases and
        # rule variants turn dithering on
        base = (policy if policy is not None
                else DitherPolicy(variant="off", s=args.s))
        policy = spec.dither_program(base)
    memory_program = spec.memory
    if qo is not None and qo.resid is not None:
        if memory_program:
            raise ValueError(
                "quant: resid= conflicts with the 'memory:' section "
                "(its default= clause); specify one")
        memory_program = f"default={qo.resid}"
    obs = None
    if args.run_dir:
        from repro_torch.obs import run_obs

        ctrl = getattr(policy, "controller", None)
        obs = run_obs(
            args.run_dir,
            context={"tool": "train", "arch": args.arch,
                     "preset": args.preset, "steps": args.steps,
                     "dither": args.dither, "s": args.s,
                     "program": format_program(spec)},
            escalate=args.escalate_monitors,
            # the collapse detector arms at the controller's target
            sparsity_setpoint=ctrl.target if ctrl is not None else None)
    trainer = Trainer(
        model,
        OptConfig(name="adamw", lr=args.lr, schedule="cosine",
                  warmup_steps=max(args.steps // 20, 1),
                  total_steps=args.steps,
                  mu_codec=qo.mu if qo is not None else None,
                  nu_codec=qo.nu if qo is not None else None),
        TrainerConfig(total_steps=args.steps, grad_accum=args.grad_accum,
                      log_every=max(args.steps // 10, 1)),
        policy=policy, memory_policy=memory_program or None, device=device,
        obs=obs)
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
    args = parse_args(argv)
    trainer, batches = build(args)
    trainer.fit(batches)
    h = trainer.history
    log.info("final loss: %.4f", h[-1]["loss"] if h else float("nan"))
    if args.run_dir:
        log.info("run dir: %s (render: python -m repro_torch.obs.report %s)",
                 args.run_dir, args.run_dir)
    return trainer


if __name__ == "__main__":
    main()
