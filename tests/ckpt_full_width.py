"""One async save and one restore of gemma-2b's full training state through
the LM launcher's checkpoint path, on one card.

    PYTHONPATH=src python tests/ckpt_full_width.py --dir _archive/ckpt_full

Builds the launcher's trainer at ``--preset full`` under phase 7a's program
(batch 8 x 128, bf16 parameters, f32 masters and AdamW moments), trains
``--steps`` steps with ``--ckpt-every`` equal to it, so the last step's
save is the loop's async checkpoint, and waits for the write. Then it frees
that trainer, builds a second one from the same arguments and times its
in-place restore of the checkpoint (``Trainer.restore_or_init``; every
leaf's crc checked). Before and after, each leaf's f64 sum on the card is
taken: they must agree exactly.

Free disk is checked first: the run refuses to start when the directory's
file system has less than 1.2 x the state's f32 bytes free (bf16 leaves are
stored widened to f32). The checkpoint is deleted at the end. The reads are
warm: the file was just written and the file cache is not dropped.

Prints JSON lines (the state's bytes, the save's blocking time: gather plus
drain, the writer's time by span, the wait, the restore's time, the file's
bytes) and the card's name and power limit. Needs one card and ~45 GB of
host memory for the gathered leaves.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import time

LM_PROGRAM = "dither: phase@0=off;phase@2=kernel;s=lin(2,6,4.0,2.0);rule lm_head:off"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True, help="checkpoint directory "
                    "(created, and removed at the end)")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--preset", choices=["smoke", "full"], default="full",
                    help="smoke: a rehearsal of the script at the reduced size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.launch import train as lm_train
    from repro_torch.obs.bus import get_bus
    from repro_torch.obs.streams import PHASE
    from repro_torch.utils.pytree import flatten_with_names

    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip()
            if args.device != "cpu" else "cpu")
    lm_argv = ["--arch", "gemma-2b", "--preset", args.preset, "--batch", "8",
               "--seq", "128", "--program", LM_PROGRAM, "--device", args.device,
               "--steps", str(args.steps), "--ckpt-every", str(args.steps),
               "--ckpt-dir", args.dir]

    def fingerprint(trainer):
        tree = {"params": trainer.params, "opt": trainer.opt_state}
        return {name: float(x.detach().double().sum()) if isinstance(x, torch.Tensor)
                else x for name, x in flatten_with_names(tree)}

    def sync():
        if args.device != "cpu":
            torch.cuda.synchronize()

    def span_ms(tag):
        rows = get_bus().rows(PHASE.name, tag)
        return float(rows[:, 1].sum()) * 1e3 if len(rows) else 0.0

    trainer, batches = lm_train.build(lm_train.parse_args(lm_argv))
    net, opt_state = trainer.restore_or_init()  # fresh: the directory is new
    leaves = [x for _, x in flatten_with_names(
        {"params": trainer.params, "opt": opt_state})
        if isinstance(x, torch.Tensor)]
    state_bytes = sum(x.numel() * x.element_size() for x in leaves)
    # as stored: bf16 leaves widened to f32
    stored = sum(x.numel() * (4 if x.dtype == torch.bfloat16
                              else x.element_size()) for x in leaves)
    n_params = sum(p.numel() for p in trainer.params.values())
    os.makedirs(args.dir, exist_ok=True)
    free = shutil.disk_usage(args.dir).free
    if free < 1.2 * stored:
        print(f"ckpt_full_width: {free} B free under {args.dir}, need "
              f"{int(1.2 * stored)}", file=sys.stderr)
        shutil.rmtree(args.dir, ignore_errors=True)
        return 2

    # fit: the last step's save is the async checkpoint; wait() ends fit
    real_wait = trainer.ckpt.wait
    waits = []

    def timed_wait():
        t0 = time.perf_counter()
        real_wait()
        waits.append(time.perf_counter() - t0)

    trainer.ckpt.wait = timed_wait
    t0 = time.perf_counter()
    trainer.fit(batches, params=net, opt_state=opt_state)
    sync()
    fit_s = time.perf_counter() - t0
    step_dir = os.path.join(args.dir, f"step_{args.steps:08d}")
    file_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
    save = {"card": card, "params": n_params, "state_bytes": state_bytes,
            "stored_f32_bytes": stored, "file_bytes": file_bytes,
            "disk_free_before": free, "fit_s": fit_s,
            "blocking_ms": span_ms("ckpt_gather") + span_ms("ckpt_drain"),
            "gather_ms": span_ms("ckpt_gather"),
            "drain_ms": span_ms("ckpt_drain"),
            "writer_ms": span_ms("ckpt_write"),
            "serialize_ms": span_ms("ckpt_write/serialize"),
            "commit_ms": span_ms("ckpt_write/commit"),
            "rotate_ms": span_ms("ckpt_write/rotate"),
            "wait_ms": waits[-1] * 1e3 if waits else None}
    print(json.dumps({"save": save}), flush=True)
    before = fingerprint(trainer)
    del trainer, batches, net, opt_state, leaves
    gc.collect()
    if args.device != "cpu":
        torch.cuda.empty_cache()

    # the restore: a second trainer from the same arguments, in place
    second, _ = lm_train.build(lm_train.parse_args(lm_argv))
    real_restore = second.ckpt.restore
    restores = []

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = real_restore(*a, **kw)
        sync()
        restores.append(time.perf_counter() - t0)
        return out

    second.ckpt.restore = timed_restore
    t0 = time.perf_counter()
    second.restore_or_init()
    sync()
    total_s = time.perf_counter() - t0
    after = fingerprint(second)
    same = after == before
    print(json.dumps({"restore": {
        "card": card, "restore_ms": restores[0] * 1e3,
        "init_and_restore_ms": total_s * 1e3, "leaves": len(after),
        "f64_sums_equal": same, "step": second.opt_state["step"],
        "peak_device_bytes": (torch.cuda.max_memory_allocated()
                              if args.device != "cpu" else None)}}),
          flush=True)
    shutil.rmtree(args.dir, ignore_errors=True)
    print(card, flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
