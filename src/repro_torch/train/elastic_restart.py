"""The fault-tolerance drill: train, lose chips, plan the restart, resume
from the checkpoint with gradient accumulation scaled, and go on.

Counterpart of ``examples/elastic_restart.py``, fed as
``examples/train_lm.py`` feeds its trainer: a ``ShardedLoader`` over the
step-indexed token stream.

    python -m repro_torch.train.elastic_restart [--preset smoke|full] \\
        [--steps 20] [--resume-steps 40] [--ckpt-every 10] [--batch 8] \\
        [--seq 32] [--ckpt-dir DIR] [--device cpu]

1. gemma-2b (``--preset smoke``, the reduced configuration, or ``full``,
   its published widths) trains to ``--steps`` under AdamW and the dither
   program, checkpointing every ``--ckpt-every`` steps;
2. a ``StaticHealthSource`` stands for 256 chips, 8 to a host, in
   model-parallel groups of 16. Each host reports the healthy run's mean
   step time (the host's clock), except the five hosts of one rack, which
   report twice that; a ``StragglerDetector`` flags them after its
   ``patience`` steps, and their 40 chips are failed. ``make_restart_plan``
   keeps the groups whole and rounds the data axis down to a power of two
   (16 -> 8): gradient accumulation doubles to hold the global batch;
3. a new trainer resumes from the plan's checkpoint with ``grad_accum``
   scaled by the plan and a loader that starts at the restored step, and
   trains to ``--resume-steps``.

The one card plays every data-parallel replica: the plan's mesh is
reported, and the resumed run's micro-batches split the same global batch.
Prints one JSON line (losses, the plan, the steps) and exits non-zero if
the loss after the resume is more than 0.1 above the loss before it, the
reference's check. Runs on CUDA unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

from repro_torch.configs import get_model, get_smoke_model
from repro_torch.core.policy import DitherPolicy
from repro_torch.data import ShardedLoader, TokenStreamConfig, token_batch
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import (StaticHealthSource,
                                               StragglerDetector,
                                               make_restart_plan)
from repro_torch.train.trainer import Trainer, TrainerConfig

# the drill's simulated cluster: 32 hosts of 8 chips; the last rack's five
# hosts slow down to SLOWDOWN x the healthy step time, then fail
CHIPS, CHIPS_PER_HOST, MODEL_PARALLEL = 256, 8, 16
RACK, SLOWDOWN = (27, 28, 29, 30, 31), 2.0


def drill(*, preset: str = "smoke", steps: int = 20, resume_steps: int = 40,
          ckpt_every: int = 10, batch: int = 8, seq: int = 32,
          ckpt_dir: Optional[str] = None, device=None) -> Dict:
    """Run the drill; returns its summary (the JSON line of ``main``)."""
    dev = resolve_device(device)
    model = (get_smoke_model if preset == "smoke" else get_model)("gemma-2b")
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="elastic_")
    tcfg = TokenStreamConfig(vocab=model.cfg.vocab, seq_len=seq, batch=batch)

    def run(total: int, grad_accum: int, start: int) -> Trainer:
        trainer = Trainer(
            model, OptConfig(lr=1e-3),
            TrainerConfig(total_steps=total, grad_accum=grad_accum,
                          log_every=max(ckpt_every // 2, 1),
                          ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
            policy=DitherPolicy(variant="paper", s=2.0), device=dev)
        # host batches, pinned and copied on a side stream by the loader
        loader = ShardedLoader(lambda s: token_batch(tcfg, s, device="cpu"),
                               start_step=start, device=dev)
        try:
            trainer.fit(loader)
        finally:
            loader.close()
        return trainer

    # 1. the healthy run on the full cluster
    t0 = time.perf_counter()
    first = run(steps, 1, 0)
    step_s = (time.perf_counter() - t0) / max(steps, 1)
    # 2. a hardware event: a rack slows down, is flagged, and goes
    health = StaticHealthSource(chips=CHIPS)
    n_hosts = CHIPS // CHIPS_PER_HOST
    detector = StragglerDetector(n_hosts)
    for _ in range(detector.cfg.patience):
        for h in range(n_hosts):
            health.set_step_time(h, step_s * (SLOWDOWN if h in RACK else 1.0))
        times = health.step_times()
        stragglers = detector.observe([times[h] for h in range(n_hosts)])
    health.fail(len(stragglers) * CHIPS_PER_HOST)
    latest = CheckpointManager(ckpt_dir).latest_step()
    plan = make_restart_plan(
        n_alive_chips=health.alive_chips(), model_parallel=MODEL_PARALLEL,
        original_data_parallel=CHIPS // MODEL_PARALLEL, latest_step=latest)
    if plan is None:
        raise RuntimeError("fewer than one model-parallel group survived")
    # 3. resume on the smaller mesh, accumulation scaled to hold the batch
    second = run(resume_steps, plan.grad_accum_scale, plan.restore_step or 0)
    return {"preset": preset, "device": str(dev), "ckpt_dir": ckpt_dir,
            "step_s": step_s, "stragglers": stragglers,
            "alive_chips": health.alive_chips(),
            "mesh_shape": list(plan.mesh_shape),
            "mesh_axes": list(plan.mesh_axes),
            "restore_step": plan.restore_step,
            "grad_accum_scale": plan.grad_accum_scale,
            "final_step": second.opt_state["step"],
            "loss_before": first.history[-1]["loss"],
            "loss_after": second.history[-1]["loss"]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--resume-steps", type=int, default=40)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises when there is none)")
    args = ap.parse_args(argv)
    out = drill(preset=args.preset, steps=args.steps,
                resume_steps=args.resume_steps, ckpt_every=args.ckpt_every,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                device=args.device)
    print(json.dumps(out), flush=True)
    ok = out["loss_after"] <= out["loss_before"] + 0.1
    print(f"elastic restart drill: {'OK' if ok else 'FAILED'} (loss "
          f"{out['loss_before']:.4f} -> {out['loss_after']:.4f})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
