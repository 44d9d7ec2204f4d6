"""Table 1's CIFAR rows at the reference's recipe, from the reference and
from the port on the CPU, at several seeds.

The reference's committed baseline (benchmarks/baselines/
BENCH_table1_sparsity.json) holds only the three MNIST rows. This script
makes the reference's CIFAR rows, which the port's card run of Table 1 is
held to (``--out``), and the seed-to-seed spread of a 50-step row, which
says how far one run's accuracy can be read.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/table1_cifar_rows.py \\
        --system reference --models vgg11-c10 --seeds 0 1 2

``--system``:

* ``reference``: ``benchmarks/table1_sparsity.py``'s row
  (``benchmarks/harness.py``), at ``seed`` (its ``run()`` uses seed 0);
* ``port``: ``repro_torch.train.table1``'s row at ``seed``, on the CPU or,
  with ``--device cuda``, on the card (that system needs no JAX);
* ``port-refinit``: the port, started from the reference's initial
  parameters of that seed (``convert.params_from_jax``), so that only the
  dither's draw stream and f32 rounding differ from the reference's run;
* ``port-fedref``: as ``port-refinit``, and fed the reference's own unit
  draw of every layer and step (``jax.random.uniform`` under the
  reference's layer key), so that only f32 rounding differs.

One JSON line a (system, model, seed). ``--out FILE`` (reference only)
merges the rows into a data file; ``--rows LINES...`` takes the rows from
earlier runs' output in place of training.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

CIFAR_MODELS = ("alexnet-c10", "vgg11-c10", "resnet18-c10")
METHODS = ("dithered", "int8+dith")


def _reference_row(name: str, seed: int, steps: int) -> dict:
    from repro.core import DitherPolicy

    from benchmarks.harness import measure_baseline_sparsity, train_classifier
    from benchmarks.table1_sparsity import _model

    model = _model(name)
    row = {"model": name,
           "baseline_sparsity": measure_baseline_sparsity(model, steps=3,
                                                          seed=seed)}
    base = train_classifier(model, None, steps=steps, seed=seed)
    row["baseline_acc"] = base["acc"]
    row["us_per_step_baseline"] = base["us_per_step"]
    for mname, variant in zip(METHODS, ("paper", "int8")):
        r = train_classifier(model, DitherPolicy(variant=variant, s=2.0,
                                                 collect_stats=True),
                             steps=steps, seed=seed)
        row[f"{mname}_acc"] = r["acc"]
        row[f"{mname}_sparsity"] = r["sparsity"]
        row[f"{mname}_bits"] = r["max_bits"]
        row[f"us_per_step_{mname}"] = r["us_per_step"]
    return row


def _use_reference_init(name: str) -> None:
    """Make the port's trainer start from the reference's parameters."""
    import jax

    from benchmarks.table1_sparsity import _model
    from repro_torch import convert
    from repro_torch.models import cnn
    from repro_torch.train import classifier

    class RefInitCNN(cnn.CNN):
        def __init__(self, cfg, *, seed=0, device=None):
            super().__init__(cfg, seed=seed, device=device)
            params, _ = _model(name).init(jax.random.PRNGKey(seed))
            ref = convert.params_from_jax(
                {k: np.asarray(v) for k, v in params.items()})
            import torch
            with torch.no_grad():
                for n, p in self.named_parameters():
                    p.copy_(ref[n])

    classifier.CNN = RefInitCNN


def _use_reference_draws() -> None:
    """Make the port's trainer draw each layer's dither as the reference
    does: the key of ``benchmarks/harness.py``'s step (the seed's key
    folded with the step and worker 0), folded with the layer's salt."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core.policy import name_salt
    from repro_torch.core.policy import DitherCtx
    from repro_torch.train import classifier

    class RefDrawCtx(DitherCtx):
        def unit_noise(self, name, shape):
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(self.seed), self.step), self.worker)
            u = jax.random.uniform(jax.random.fold_in(key, name_salt(name)),
                                   tuple(shape), jnp.float32, -0.5, 0.5)
            return torch.from_numpy(np.array(u)).to(self.device)

    classifier.DitherCtx = RefDrawCtx


def _port_row(name: str, seed: int, steps: int, device: str) -> dict:
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.train import classifier, table1

    model = table1._model(name)
    row = {"model": name,
           "baseline_sparsity": classifier.measure_baseline_sparsity(
               model, steps=3, seed=seed, device=device)}
    base = classifier.train_classifier(model, None, steps=steps, seed=seed,
                                       device=device)
    row["baseline_acc"] = base["acc"]
    row["us_per_step_baseline"] = base["ms_per_step"] * 1e3
    for mname, variant in zip(METHODS, ("paper", "int8")):
        r = classifier.train_classifier(
            model, DitherPolicy(variant=variant, s=2.0, collect_stats=True),
            steps=steps, seed=seed, device=device)
        row[f"{mname}_acc"] = r["acc"]
        row[f"{mname}_sparsity"] = r["sparsity"]
        row[f"{mname}_bits"] = r["max_bits"]
        row[f"us_per_step_{mname}"] = r["ms_per_step"] * 1e3
    return row


def _write_rows(rows, path: str) -> None:
    """Merge ``rows`` into the data file at ``path`` (one row a model and
    seed; a new row replaces an old one of the same model and seed)."""
    import jax

    try:
        with open(path) as f:
            old = json.load(f)["rows"]
    except FileNotFoundError:
        old = []
    keep = {(r["model"], r["seed"]): r for r in old}
    keep.update({(r["model"], r["seed"]): r for r in rows})
    data = {
        "what": "Table 1's CIFAR rows of the reference "
                "(benchmarks/table1_sparsity.py's recipe: s = 2, batch 64, "
                "50 steps) on the CPU, one a model and seed",
        "made_by": "PYTHONPATH=src:. JAX_PLATFORMS=cpu python "
                   "tests/table1_cifar_rows.py --system reference "
                   "--models M --seeds S... --out FILE",
        "jax_version": jax.__version__,
        "platform": "cpu",
        "rows": [keep[k] for k in sorted(keep)],
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--system", required=True,
                    choices=("reference", "port", "port-refinit",
                             "port-fedref"))
    ap.add_argument("--models", nargs="+", default=list(CIFAR_MODELS),
                    choices=CIFAR_MODELS)
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (cpu or cuda)")
    ap.add_argument("--out", default=None,
                    help="reference only: merge the rows into this file")
    ap.add_argument("--rows", nargs="+", default=None, metavar="LINES",
                    help="read the rows from this script's earlier output")
    args = ap.parse_args(argv)
    if args.out and args.system != "reference":
        ap.error("--out takes the reference's rows only")
    if args.rows:
        rows = []
        for path in args.rows:
            with open(path) as f:
                rows += [r for r in map(json.loads, f)
                         if r["system"] == args.system
                         and r["model"] in args.models
                         and r["seed"] in args.seeds
                         and r["steps"] == args.steps]
        if args.out:
            _write_rows(rows, args.out)
        return 0
    rows = []
    for name in args.models:
        for seed in args.seeds:
            if args.system == "reference":
                row = _reference_row(name, seed, args.steps)
            else:
                if args.system in ("port-refinit", "port-fedref"):
                    _use_reference_init(name)
                if args.system == "port-fedref":
                    _use_reference_draws()
                row = _port_row(name, seed, args.steps, args.device)
            row = {"system": args.system, "seed": seed,
                   "steps": args.steps, **row}
            if args.system != "reference":
                row["device"] = args.device
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        _write_rows(rows, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
