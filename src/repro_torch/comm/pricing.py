"""The price of measured wire bytes on the two link classes of the H100
platform.

Counterpart of the link half of ``repro.launch.costmodel``
(``price_wire_bytes``, ``price_reduce``, ``price_step_comm``,
``price_overlap``, ``compression_speedup``) and of the two link constants
of ``repro.launch.roofline``. It sits under ``comm`` so that the comm
telemetry, the trainer and the distributed benchmark read it downward; the
cost model's memory pricing and ``corrected_costs`` come with the dry run
(ROADMAP.md section 1, item 9). The target is an HGX H100 node, and the
constants are platform specification values, not measurements:

* the fast axis (the reference's ICI, inside a pod) is NVLink 4 through
  NVSwitch: 450 GB/s in each direction a GPU (900 GB/s both ways);
* the slow axis (the reference's DCN, between pods) is one 400 Gb/s NDR
  InfiniBand NIC a GPU: 50 GB/s.
"""
from __future__ import annotations

from typing import Dict

ICI_BW = 450e9  # bytes/s a GPU a direction: NVLink 4 through NVSwitch
DCN_BW = 50e9  # bytes/s a GPU: one 400 Gb/s NDR InfiniBand NIC


def price_wire_bytes(wire_bytes: float) -> float:
    """Seconds measured wire bytes occupy one fast-axis link."""
    return float(wire_bytes) / ICI_BW


def price_reduce(tele, *, nodes: int, pods: int = 1) -> Dict[str, float]:
    """The fast- and slow-axis seconds of one measured compressed
    all-reduce (a ring's telemetry, or a hierarchy's or butterfly's, which
    carry ``wire_ici_bytes``). Only the parallelism is modelled:

    A flat ring over N nodes in G pods: every round all N links carry one
    segment at once, so a link carries wire / N; G of the links cross
    pods, and with G > 1 each round waits for one, so ``total_s`` is the
    slower of the two. A two-level reduce: the intra-pod phases run all
    G x P ring links at once (wire_ici / (G P) a link); the tree phases run
    the P segment owners' lines at once and serialize 2 ceil(log2 G) of
    the 2 (G - 1) packs a line, so the slow axis's critical path is
    wire_dcn / P scaled by that ratio; the phases serialize."""
    ici_s = dcn_s = 0.0
    if hasattr(tele, "wire_ici_bytes"):  # two-level: the measured split
        g, p = int(tele.pods), int(tele.per_pod)
        ici_s = float(tele.wire_ici_bytes) / max(g * p, 1) / ICI_BW
        if g > 1:
            critical = 2 * (g - 1).bit_length()  # up and down rounds
            total_packs = 2 * (g - 1)
            dcn_s = (float(tele.wire_dcn_bytes) / max(p, 1)
                     * critical / total_packs / DCN_BW)
        total_s = ici_s + dcn_s
    else:
        per_link = float(tele.wire_bytes) / max(nodes, 1)
        ici_s = per_link / ICI_BW
        dcn_s = per_link / DCN_BW if pods > 1 else 0.0
        total_s = max(ici_s, dcn_s)
    return {"ici_s": ici_s, "dcn_s": dcn_s, "total_s": total_s}


def price_step_comm(wire_bytes: float, *, pods: int = 1) -> Dict[str, float]:
    """Bracket the link seconds of one training step's gradient exchange:
    ``comm_ici_s`` with every byte on the fast axis, ``comm_dcn_s`` on the
    slow axis when the topology spans pods (0 otherwise)."""
    return {"comm_ici_s": float(wire_bytes) / ICI_BW,
            "comm_dcn_s": (float(wire_bytes) / DCN_BW
                           if pods > 1 else 0.0)}


def price_overlap(bucket_bytes, bucket_comm_s, *,
                  bwd_s: float) -> Dict[str, object]:
    """How much of an overlap schedule's comm time the backward hides.

    ``bucket_bytes`` are the buckets' gradient bytes in launch order and
    ``bucket_comm_s`` the seconds each bucket's reduce holds the link
    (priced, or measured: the same recurrence reads both). Bucket i is
    ready once its share of the backward is done, taken proportional to
    the cumulative bytes (``ready_i = bwd_s cum_i / total``). The link is
    serial::

        start_i = max(ready_i, end_{i-1});   end_i = start_i + comm_i

    ``exposed_s`` is the tail past the backward, ``hidden_s`` the rest,
    ``overlap_efficiency = hidden_s / total_comm_s`` (1.0 when there is no
    comm), ``step_s`` the schedule's wall clock against ``serial_s``."""
    bb = [float(b) for b in bucket_bytes]
    cc = [float(c) for c in bucket_comm_s]
    if len(bb) != len(cc):
        raise ValueError(f"bucket_bytes ({len(bb)}) and bucket_comm_s "
                         f"({len(cc)}) must align")
    total_bytes = sum(bb)
    cum, ready = 0.0, []
    for b in bb:
        cum += b
        ready.append(bwd_s * (cum / total_bytes if total_bytes else 1.0))
    launch, drain = [], []
    end = 0.0
    for r, c in zip(ready, cc):
        start = max(r, end)
        end = start + c
        launch.append(start)
        drain.append(end)
    total_comm = sum(cc)
    exposed = max(0.0, (drain[-1] if drain else 0.0) - float(bwd_s))
    hidden = total_comm - exposed
    return {"launch_s": launch, "drain_s": drain,
            "total_comm_s": total_comm, "exposed_s": exposed,
            "hidden_s": hidden,
            "overlap_efficiency": (hidden / total_comm if total_comm > 0
                                   else 1.0),
            "step_s": max(float(bwd_s), drain[-1] if drain else 0.0),
            "serial_s": float(bwd_s) + total_comm}


def compression_speedup(wire_bytes: float, dense_bytes: float) -> float:
    """How much link time the packed exchange saves against dense f32."""
    if wire_bytes <= 0:
        return float("inf")
    return float(dense_bytes) / float(wire_bytes)
