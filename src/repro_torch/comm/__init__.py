"""repro_torch.comm: NSD gradients as a wire format between data-parallel
nodes (counterpart of ``repro.comm``, the parameter server and the flat
ring, simulated in one process).

reduce_base.py  segmenting, hop keys, wire-byte and error-bound accounting
ring.py         the compressed ring all-reduce (re-dithered partial sums)
compression.py  per-leaf CommPolicy (dense/int8/nsd/topk_ef), error
                feedback, the reduce topologies
reducer.py      the front door: ``reducer(policy, n_nodes=N)`` with
                ``reduce(grads, key, step, state)`` and typed telemetry
telemetry.py    one bytes-on-wire row per reduce into the obs metrics store

Not ported yet (``ROADMAP.md`` section 1, item 7): the hierarchy, the
butterfly, overlap bucketing, the shard_map ring on a mesh, the flat
reducer and ``compress_tree``, codec specs as comm modes, the telemetry
readers, and the deprecated ``wireformat`` / ``allreduce_compressed`` /
``reduce_cfg`` shims.
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
    init_comm_state,
    topk_error_feedback,
)
from repro_torch.comm.reduce_base import (PackCounter, ReduceTelemetry,
                                          hop_key, seg_len, segment)
from repro_torch.comm.reducer import Reducer, ReducerTelemetry, reducer
from repro_torch.comm.ring import (RingConfig, dense_reduce_bytes,
                                   ring_allreduce_nsd)

__all__ = [
    "DENSE", "MODE_DENSE", "MODE_INT8", "MODE_NSD", "MODE_TOPK_EF", "MODES",
    "TOPO_BUTTERFLY", "TOPO_HIER", "TOPO_PS", "TOPO_RING", "TOPOLOGIES",
    "CommPolicy", "ErrorFeedbackState", "compress_leaf", "init_comm_state", "topk_error_feedback",
    "PackCounter", "ReduceTelemetry", "hop_key", "seg_len", "segment",
    "Reducer", "ReducerTelemetry", "reducer",
    "RingConfig", "dense_reduce_bytes", "ring_allreduce_nsd",
    "telemetry",
]
