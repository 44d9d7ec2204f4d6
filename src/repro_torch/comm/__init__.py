"""repro_torch.comm: NSD gradients as a wire format between data-parallel
nodes (counterpart of ``repro.comm``: the parameter server, the flat ring,
the two-level hierarchy and butterfly, and overlap bucketing; each
simulated in one process, or run one node a process over a
``repro_torch.launch.mesh.NodeMesh``).

reduce_base.py  segmenting, hop keys, wire-byte (ICI/DCN) and error-bound
                accounting (the ledger both routes replay), ring shares
p2p.py          packs between processes: two point-to-point messages a
                pack, staged through the host for gloo on CUDA
ring.py         the compressed ring all-reduce (re-dithered partial sums)
hierarchy.py    intra-pod ring + inter-pod binomial tree
butterfly.py    intra-pod ring + inter-pod recursive halving/doubling
overlap.py      reverse-layer-order buckets around any reducer
compression.py  per-leaf CommPolicy (dense/int8/nsd/topk_ef or a quant
                codec spec), error feedback, the reduce topologies,
                ``compress_tree``
reducer.py      the front door: ``reducer(policy, n_nodes=N)``,
                ``reducer(policy, mesh)`` or the trainer's flat
                ``reducer(policy, stacked=False)``, with ``reduce(grads,
                key, step, state)`` and typed telemetry; the ``comm:``
                program section
telemetry.py    one bytes-on-wire row per reduce into the obs metrics store,
                its readers and its link price

Not ported yet (``ROADMAP.md`` section 1, item 7): the deprecated
``wireformat`` / ``allreduce_compressed`` / ``reduce_cfg`` shims.
"""
from repro_torch.comm import telemetry
from repro_torch.comm.compression import (
    DENSE,
    MODE_DENSE,
    MODE_INT8,
    MODE_NSD,
    MODE_TOPK_EF,
    MODES,
    TOPO_BUTTERFLY,
    TOPO_HIER,
    TOPO_PS,
    TOPO_RING,
    TOPOLOGIES,
    CommPolicy,
    ErrorFeedbackState,
    compress_leaf,
    compress_tree,
    init_comm_state,
    topk_error_feedback,
)
from repro_torch.comm.butterfly import (ButterflyConfig, ButterflyTelemetry,
                                        allreduce_butterfly,
                                        butterfly_allreduce_mesh,
                                        butterfly_allreduce_nsd,
                                        butterfly_rounds,
                                        make_butterfly_allreduce)
from repro_torch.comm.hierarchy import (HierConfig, HierTelemetry,
                                        allreduce_hier, hier_allreduce_mesh,
                                        hier_allreduce_nsd,
                                        make_hier_allreduce, tree_rounds)
from repro_torch.comm.overlap import BucketPlan, OverlapReducer, plan_buckets
from repro_torch.comm.reduce_base import (PackCounter, ReduceTelemetry,
                                          hop_key, seg_len, segment)
from repro_torch.comm.reducer import (Reducer, ReducerTelemetry,
                                      format_comm_program,
                                      parse_comm_program, reducer)
from repro_torch.comm.ring import (RingConfig, dense_reduce_bytes,
                                   make_ring_allreduce, ring_allreduce_mesh,
                                   ring_allreduce_nsd)

__all__ = [
    "DENSE", "MODE_DENSE", "MODE_INT8", "MODE_NSD", "MODE_TOPK_EF", "MODES",
    "TOPO_BUTTERFLY", "TOPO_HIER", "TOPO_PS", "TOPO_RING", "TOPOLOGIES",
    "CommPolicy", "ErrorFeedbackState", "compress_leaf", "compress_tree", "init_comm_state", "topk_error_feedback",
    "PackCounter", "ReduceTelemetry", "hop_key", "seg_len", "segment",
    "ButterflyConfig", "ButterflyTelemetry", "allreduce_butterfly",
    "butterfly_allreduce_mesh", "butterfly_allreduce_nsd", "butterfly_rounds",
    "make_butterfly_allreduce",
    "HierConfig", "HierTelemetry", "allreduce_hier", "hier_allreduce_mesh",
    "hier_allreduce_nsd", "make_hier_allreduce", "tree_rounds",
    "BucketPlan", "OverlapReducer", "plan_buckets",
    "Reducer", "ReducerTelemetry", "format_comm_program",
    "parse_comm_program", "reducer",
    "RingConfig", "dense_reduce_bytes", "make_ring_allreduce",
    "ring_allreduce_mesh", "ring_allreduce_nsd",
    "telemetry",
]
