"""LM training launcher.

    python -m repro_torch.launch.train --arch gemma-2b --preset smoke \\
        --steps 3 --device cpu \\
        --program "dither: phase@0=off;phase@1=kernel;rule lm_head:off"

Counterpart of ``repro.launch.train``. Archs: gemma-2b, gemma3-4b,
qwen2.5-32b, minitron-8b (dense), moonshot-v1-16b-a3b and dbrx-132b (MoE),
internvl2-2b (VLM: each batch carries 256 patch embeddings ahead of its
``--seq`` tokens), mamba2-370m (SSM), hymba-1.5b (hybrid) and
whisper-small (audio: each batch carries the encoder's 1500 frame
embeddings beside its ``--seq`` decoder tokens, whose learned positions
end at 448).
Presets: ``smoke``, the arch's reduced f32 configuration (CPU-sized);
``full``, its published widths (bf16, remat per block where the config
asks; gemma-2b, gemma3-4b, internvl2-2b, mamba2-370m, hymba-1.5b and
whisper-small fit one 80 GB card with AdamW, the others' state does not: a
depth-cut run builds ``dataclasses.replace(cfg, n_layers=...)`` and drives
``repro_torch.train.Trainer``, as ``chip_smoke.py`` does). The dither
comes from ``--dither``/``--s`` as the base policy, and the ``dither:``
section of ``--program`` (phases, knob schedules, per-layer rules; the
kernel variant is reached through a phase or rule ``kernel``); the
``memory:`` section picks each dithered layer's residual codec; the
``quant:`` section picks registered codecs per surface: ``grad=`` the
cotangent codec (on the base policy, so phases and rules inherit it),
``resid=`` the residual default (``memory: default=SPEC``), ``mu=`` and
``nu=`` AdamW's stored moments, ``wire=`` the gradients' comm mode. The
``comm:`` section gives the trainer a ``repro_torch.comm.CommPolicy``
(``quant: wire=`` sets its ``default``, or makes one): each step's
gradients cross the flat single-participant wire before AdamW, and the
history rows carry ``comm_wire_mb``. A ``controller:`` clause in the dither
section holds each layer's sparsity at its target. ``--run-dir DIR``
records the run (the dither, memory, phase, train and monitor streams and a
manifest) into DIR, rendered by ``python -m repro_torch.obs.report DIR``;
``--escalate-monitors`` makes a critical health event (a non-finite loss)
raise. ``--ckpt-dir DIR --ckpt-every K`` checkpoints the run every K
steps into DIR (``repro_torch.train.CheckpointManager``) and resumes from
DIR's latest checkpoint when there is one. As in the reference, the batch
counter of a resumed run starts again at 0: a run resumed at step 2 trains
step 2 on batch 0, not on batch 2 (a step-indexed loader, such as
``repro_torch.data.ShardedLoader(start_step=...)`` driving a ``Trainer``,
resumes on the step's own batch). Runs on CUDA unless ``--device cpu``;
logs the loss every ``max(steps // 10, 1)`` steps to stderr.

``--distributed`` joins the process group that ``torchrun`` describes in
the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL on CUDA, each rank on ``cuda:LOCAL_RANK``; gloo with
``--device cpu``. As the reference's flag, it only initialises the runtime:
the trainer reduces nothing across processes (data-parallel training over
processes is ``repro_torch.distributed.make_ssgd_step(..., mesh=)``).
"""
from __future__ import annotations

import argparse
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm.compression import CommPolicy
from repro_torch.configs import ARCH_IDS, get_model, get_smoke_model
from repro_torch.core.policy import DitherPolicy
from repro_torch.data.synthetic import TokenStreamConfig, token_batch
from repro_torch.device import resolve_device
from repro_torch.launch.program import format_program, merge_legacy_flags
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils import get_logger

log = get_logger("repro_torch.train")


def batch_fn_for(model, batch: int, seq: int, device):
    """Step -> the synthetic token batch of that step: tokens and labels
    (batch, seq), and for the audio family ``frames`` (batch, n_frames,
    d_model), for the VLM ``patch_embeds`` (batch, vlm_patches, vit_dim),
    f32, normal(0, 1) from ``np.random.default_rng(step)``, as the
    reference's (the visual prefix comes on top of the ``seq`` text
    positions)."""
    if model.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        raise NotImplementedError(f"batch_fn_for: family {model.family!r}")
    cfg = model.cfg
    tcfg = TokenStreamConfig(vocab=cfg.vocab, seq_len=seq, batch=batch)
    key = shape = None
    if model.family == "audio":
        key, shape = "frames", (cfg.n_frames, cfg.d_model)
    elif model.family == "vlm" and cfg.vlm_patches:
        key, shape = "patch_embeds", (cfg.vlm_patches, cfg.vit_dim)

    def fn(step: int):
        b = token_batch(tcfg, step, device=device)
        if key is not None:
            a = np.random.default_rng(step).normal(
                0, 1, (batch,) + shape).astype(np.float32)
            b[key] = torch.from_numpy(a).to(resolve_device(device))
        return b
    return fn


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dither", choices=["off", "paper", "int8", "row",
                                         "meprop"], default="paper")
    ap.add_argument("--s", type=float, default=2.0)
    ap.add_argument("--program", default="",
                    help="run program with 'dither:', 'memory:', 'comm:' and "
                    "'quant:' sections, e.g. \"dither: phase@0=off;"
                    "phase@30=kernel;rule lm_head:off memory: default=nsd "
                    "comm: default=nsd;s=2.0 quant: mu=m8;nu=u8\" (see "
                    "repro_torch.launch.program). The dither section builds "
                    "on --dither/--s as the base policy; the comm section "
                    "attaches a gradient CommPolicy to the trainer; the "
                    "quant section picks registered codecs per surface "
                    "(grad/wire/resid/mu/nu, see repro_torch.quant.program).")
    ap.add_argument("--policy-program", default="",
                    help="DEPRECATED: use --program \"dither: ...\"")
    ap.add_argument("--memory-program", default="",
                    help="DEPRECATED: use --program \"memory: ...\"")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
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
    ap.add_argument("--distributed", action="store_true",
                    help="join torchrun's process group (NCCL on CUDA, gloo "
                    "with --device cpu) and run on cuda:LOCAL_RANK")
    return ap.parse_args(argv)


def init_distributed(device: Optional[str]) -> torch.device:
    """Join the process group that torchrun's environment describes; the
    device this rank runs on."""
    import torch.distributed as dist

    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
                             if device is None else device)
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on CUDA needs a GPU; pass "
                               "--device cpu for gloo")
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://")
    log.info("distributed: %s rank %d of %d on %s", dist.get_backend(),
             dist.get_rank(), dist.get_world_size(), dev)
    return dev


def build(args: argparse.Namespace, device: Optional[torch.device] = None):
    """The trainer and the batch iterator that ``main`` runs (on
    ``device``, by default ``--device``'s)."""
    device = device or resolve_device(args.device)
    model = (get_smoke_model if args.preset == "smoke" else get_model)(
        args.arch)
    spec = merge_legacy_flags(args.program, args.policy_program,
                              args.memory_program)
    qo = spec.quant_overrides()
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
    comm_policy = spec.comm_policy()
    if qo is not None and qo.wire is not None:
        comm_policy = (comm_policy.replace(default=qo.wire)
                       if comm_policy is not None
                       else CommPolicy(default=qo.wire))
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
                      log_every=max(args.steps // 10, 1),
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        policy=policy, memory_policy=memory_program or None,
        comm_policy=comm_policy, device=device, obs=obs)
    fn = batch_fn_for(model, args.batch, args.seq, device)

    def batches() -> Iterator:
        step = 0  # 0 on a resume too, as the reference's counter
        while True:
            yield fn(step)
            step += 1

    return trainer, batches()


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Parse, build and fit; returns the trainer (its ``history``, ``net``
    and ``opt_state``)."""
    args = parse_args(argv)
    device = init_distributed(args.device) if args.distributed else None
    try:
        trainer, batches = build(args, device)
        trainer.fit(batches)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    h = trainer.history
    log.info("final loss: %.4f", h[-1]["loss"] if h else float("nan"))
    if args.run_dir:
        log.info("run dir: %s (render: python -m repro_torch.obs.report %s)",
                 args.run_dir, args.run_dir)
    return trainer


if __name__ == "__main__":
    main()
