"""Interconnect class per mesh axis name.

The port's copy of what ``repro.launch.mesh.NodeTopology`` needs from
``repro.parallel.axes``: collectives over a ``"dcn"`` axis cross the slow
inter-pod network, every other axis rides the fast intra-pod links (ICI).
"""
from __future__ import annotations

LINK_KINDS = {"pod": "dcn", "pods": "dcn"}


def axis_link_kind(axis_name: str) -> str:
    """"ici" | "dcn" for a mesh axis name (default: ici)."""
    return LINK_KINDS.get(axis_name, "ici")
