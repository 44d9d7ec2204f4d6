"""chip_smoke.py's phase 15 (data-parallel over processes) alone on one
card: phase 6b's simulated VGG11 ring steps first, as 15b's reference, then
``chip_smoke.phase15``.

It imports ``chip_smoke`` and ``repro_torch`` from the working directory,
so run it from the root of the checkout to measure:

    python3 tests/phase15_alone.py

To compare two checkouts on one card, run it from each in turns within
one call, e.g. the parent unpacked with ``git archive`` into the
git-ignored ``_archive/parent`` and the change at the root, B A A B:

    for d in _archive/parent . . _archive/parent; do
        (cd $d && python3 /path/to/checkout/tests/phase15_alone.py); done

Prints the card's name and power limit, each simulated step's host time,
phase 15's lines and the launches of its paths. Needs one card.
"""
import subprocess
import sys
import time

sys.path.insert(0, "src")
sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    from repro_torch.kernels import build
    build.library()
    from repro_torch.train.classifier import repeatable_f32
    repeatable_f32()
    dev = torch.device("cuda")
    from repro_torch import comm
    from repro_torch.configs import paper_models
    from repro_torch.core.policy import DitherPolicy
    from repro_torch.data.synthetic import ClassifConfig, classification_batch
    from repro_torch.distributed import SSGDConfig, make_ssgd_step, shard_batch
    from repro_torch.models.cnn import CNN
    from repro_torch.optim.optimizers import OptConfig, init_opt_state
    mname, n, topology, steps = cs.MESH_SSGD
    mcfg = paper_models.MODELS[mname]()
    net = CNN(mcfg, seed=cs.SEED)
    dcfg = SSGDConfig(n_nodes=n, s_schedule="sqrt", s_base=2.0)
    cpol = comm.CommPolicy(default="nsd", s=dcfg.s_for_n(), topology=topology)
    opt_cfg = OptConfig(name="sgd", lr=0.05, momentum=0.9, weight_decay=5e-4,
                        grad_clip=None)
    step, _ = make_ssgd_step(net, opt_cfg, dcfg, DitherPolicy(variant="kernel"),
                             cpol)
    data = ClassifConfig(n_classes=mcfg.n_classes, img_size=mcfg.img_size,
                         channels=mcfg.in_channels, noise=0.5, seed=cs.SEED)
    state = init_opt_state(dict(net.named_parameters()), opt_cfg)
    for i in range(steps):
        b = shard_batch(classification_batch(data, i, cs.SSGD_NODE_BATCH * n), n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, _ = step(state, b, cs.SEED)
        torch.cuda.synchronize()
        print(f"sim step {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms loss "
              f"{float(m['loss'])} wire {float(m['comm_wire_bytes'])}", flush=True)
        cs.SIM_SSGD_STEPS.append(cs.host_state(torch, net, state))
    del step, net, state
    t = time.time()
    out = cs.phase15(torch, card, dev)
    print({k: cs.nonzero(v) for k, v in out.items()})
    print("phase15", time.time() - t)
