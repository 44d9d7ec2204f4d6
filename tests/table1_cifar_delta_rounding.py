"""A Table-1 CIFAR row's accuracy against the last bits of Delta.

``tests/table1_cifar_rows.py --system port-fedref`` trains the port from the
reference's initial parameters on the reference's own draws, so that only
f32 rounding differs from the reference's run; its Delta is
``torch.std``'s, which differs from ``jnp.std``'s in the last bits (up to
7e-6 relative). This script trains the same dithered row with Delta from
the reference's eager ``jnp.std`` in its place: two valid roundings of one
port, fed the same draws. Where the two disagree by as much as either
disagrees with the reference, a 50-step row's accuracy is a function of
rounding, not of the arithmetic's correctness.

    PYTHONPATH=src:.:tests JAX_PLATFORMS=cpu python \\
        tests/table1_cifar_delta_rounding.py --models vgg11-c10 --seeds 0 1

One JSON line a (model, seed): the dithered row's accuracy and sparsity.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> int:
    import jax.numpy as jnp
    import torch

    import table1_cifar_rows as rows
    from repro.core import nsd as jnsd
    from repro_torch.core import nsd
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.train import classifier, table1

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=["vgg11-c10"],
                    choices=rows.CIFAR_MODELS)
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    nsd.compute_delta = lambda x, s: torch.from_numpy(np.array(
        jnsd.compute_delta(jnp.asarray(x.detach().float().numpy()), s)))
    for name in args.models:
        for seed in args.seeds:
            rows._use_reference_init(name)
            rows._use_reference_draws()
            r = classifier.train_classifier(
                table1._model(name),
                DitherPolicy(variant="paper", s=2.0, collect_stats=True),
                steps=args.steps, seed=seed, device="cpu")
            print(json.dumps({"system": "port-fedref-jnp-std", "model": name,
                              "seed": seed, "steps": args.steps,
                              "dithered_acc": r["acc"],
                              "dithered_sparsity": r["sparsity"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
