"""The data-parallel node set over ``torch.distributed`` processes.

Counterpart of ``repro.launch.mesh``'s ``NodeTopology`` and
``make_node_mesh``. The reference lays the nodes out as a 2-D (pods,
nodes) device mesh and runs its reduces as shard_map programs over it; the
port runs one node per process, and :class:`NodeMesh` is one process's view
of that layout: the process group, the pod-major order of its ranks (node
``i`` is group rank ``i``, in pod ``i // nodes_per_pod``) and this rank's
(pod, node) coordinates. The compressed reduces (``repro_torch.comm``)
address their peers by (pod, node) through it and send point to point
within the group; their gathers run over the whole group. No reduce runs a
collective over one axis, so the mesh makes no sub-group per pod or per
node index: making one is a collective call of every rank, and torch names
a group made by its members alone after its ranks, so a second mesh over
the same ranks would meet the first one's rendezvous.

On NCCL the mesh runs one barrier over every rank of its group when it is
made: torch leaves a group's first ``batch_isend_irecv`` undefined unless
every rank joins it, and a two-level reduce's first hops may join only
some. NCCL meshes of more than one rank have not run: the card machine has
one GPU, and NCCL refuses two ranks on one device.

A ``torch.distributed.device_mesh.DeviceMesh`` would carry the same layout,
but it binds its ranks to devices of its own choosing; here several gloo
ranks may share one card.

``make_production_mesh`` and ``host_device_mesh`` (the TPU v5e 16 x 16
layout) wait for the dry run, ROADMAP.md section 1, item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.parallel.axes import axis_link_kind

__all__ = ["NodeMesh", "NodeTopology", "make_node_mesh"]


@dataclasses.dataclass(frozen=True)
class NodeTopology:
    """Physical layout of the data-parallel node set: pods x nodes-per-pod.

    Collectives over ``node_axis`` ride the fast intra-pod interconnect
    (ICI), collectives over ``pod_axis`` the slow inter-pod network (DCN).
    ``flat()`` describes a single-pod (pure-ring) layout.
    """

    pods: int = 1
    nodes_per_pod: int = 1
    pod_axis: str = "pods"
    node_axis: str = "nodes"

    def __post_init__(self):
        if self.pods < 1 or self.nodes_per_pod < 1:
            raise ValueError(f"degenerate topology {self}")

    @classmethod
    def flat(cls, n_nodes: int) -> "NodeTopology":
        return cls(pods=1, nodes_per_pod=n_nodes)

    @property
    def n_nodes(self) -> int:
        return self.pods * self.nodes_per_pod

    def link_kind(self, axis_name: str) -> str:
        """"dcn" for the pod axis, else the generic axis registry."""
        if axis_name == self.pod_axis:
            return "dcn"
        if axis_name == self.node_axis:
            return "ici"
        return axis_link_kind(axis_name)

    def mesh(self, group=None) -> "NodeMesh":
        """This process's :class:`NodeMesh` over ``group`` (the default
        process group when None)."""
        return NodeMesh(self, group)


def make_node_mesh(topo: NodeTopology, group=None) -> "NodeMesh":
    """The node mesh laid out per ``topo`` over ``group``."""
    return topo.mesh(group)


class NodeMesh:
    """One rank's view of a (pods, nodes) layout over a process group.

    ``shape`` maps axis names to extents as the reference's ``Mesh.shape``
    does: ``{pods: G, nodes: P}``, or ``{nodes: P}`` for one pod. Raises
    ``ValueError`` when the group's size is not ``pods x nodes_per_pod``.
    """

    def __init__(self, topo: NodeTopology, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("NodeMesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        self.topo, self.group = topo, group
        self.ranks: List[int] = (dist.get_process_group_ranks(group)
                                 if group is not None
                                 else list(range(dist.get_world_size())))
        if len(self.ranks) != topo.n_nodes:
            raise ValueError(
                f"the process group has {len(self.ranks)} ranks but the "
                f"topology has {topo.pods} pods x {topo.nodes_per_pod} nodes "
                f"= {topo.n_nodes}; a mismatched mesh would leave gradients "
                "out of the reduce")
        self.index = self.ranks.index(dist.get_rank())
        self.pod, self.node = divmod(self.index, topo.nodes_per_pod)
        self.shape: Dict[str, int] = (
            {topo.node_axis: topo.nodes_per_pod} if topo.pods == 1 else
            {topo.pod_axis: topo.pods, topo.node_axis: topo.nodes_per_pod})
        self.backend = dist.get_backend(group)
        if self.backend == "nccl":
            import torch

            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])

    @property
    def size(self) -> int:
        return len(self.ranks)

    def rank_of(self, pod: int, node: int) -> int:
        """The global rank of node ``node`` of pod ``pod``."""
        return self.ranks[pod * self.topo.nodes_per_pod + node]

    def __repr__(self) -> str:
        return (f"NodeMesh({self.shape}, rank {self.index} = pod {self.pod} "
                f"node {self.node}, backend {self.backend})")
