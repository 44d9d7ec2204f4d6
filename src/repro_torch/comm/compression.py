"""Gradient compression policy for the wire: per-leaf mode selection and
error feedback.

Counterpart of ``repro.comm.compression``. ``CommPolicy`` decides, per
gradient leaf, how that leaf crosses the wire in a data-parallel exchange:

    dense    f32 passthrough                       (4 bytes/elem)
    int8     NSD -> (int8 k, f32 Delta), dense k   (1 byte/elem + 4)
    nsd      NSD -> packed wire format             (bitmap + non-zero levels;
                                                    ``repro_torch.quant.wire``)
    topk_ef  top-k sparsification + error feedback (8 bytes/kept elem)

Any registered quant codec spec (``repro_torch.quant``, e.g.
``"int4@g32"``) is also a per-leaf mode: it rides the registry branch of
``compress_leaf`` (encode, then decode) with the codec's own measured
bytes. Small leaves (biases, norm scales) default to dense.
``compress_tree`` routes a whole gradient dict through the wire leaf by
leaf: the trainer's single-participant wire (``repro_torch.comm.reducer``'s
flat reducer).

Where the reference passes an RNG key, the port passes ``noise``: an int
stream key (the NSD launch draws u from it) or a unit draw u of the leaf's
shape (the seam through which tests feed the reference's draw). Wire bytes
are Python ints for the static formats and 0-d int32 device tensors for the
measured ones, so a reduce never syncs with the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.comm import telemetry as tele
from repro_torch.quant import codecs as qc
from repro_torch.quant import wire
from repro_torch.quant.registry import dense_nbytes, parse_spec

MODE_DENSE = "dense"
MODE_INT8 = "int8"
MODE_NSD = "nsd"
MODE_TOPK_EF = "topk_ef"
MODES = (MODE_DENSE, MODE_INT8, MODE_NSD, MODE_TOPK_EF)


def _valid_comm_mode(mode: str) -> bool:
    """One of :data:`MODES` or a registered quant codec spec."""
    if mode in MODES:
        return True
    try:
        parse_spec(mode)
        return True
    except ValueError:
        return False


# How the data-parallel reduce is organized (``repro_torch.comm.reducer``):
# "ps" compresses every node's gradient and averages at a server, "ring" runs
# the compressed ring all-reduce, "hier" the two-level reduce (intra-pod
# ring, inter-pod binomial tree; ``repro_torch.comm.hierarchy``) and
# "butterfly" its recursive-halving variant (``repro_torch.comm.butterfly``).
TOPO_PS = "ps"
TOPO_RING = "ring"
TOPO_HIER = "hier"
TOPO_BUTTERFLY = "butterfly"
TOPOLOGIES = (TOPO_PS, TOPO_RING, TOPO_HIER, TOPO_BUTTERFLY)

Noise = Union[int, torch.Tensor]


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: torch.Tensor  # f32 (size,): the mass top-k has not sent yet


def topk_error_feedback(g: torch.Tensor, state: Optional[ErrorFeedbackState],
                        k_frac: float = 0.01
                        ) -> Tuple[torch.Tensor, ErrorFeedbackState]:
    """Top-k sparsification with error feedback (memory of dropped mass).

    The threshold is the k-th largest |g|, and every element at or above it
    is sent, so ties are all kept and the order ``torch.topk`` returns them
    in does not matter.
    """
    flat = g.reshape(-1)
    if state is not None:
        flat = flat + state.residual
    k = max(1, int(k_frac * flat.numel()))
    mag = flat.abs()
    thresh = torch.topk(mag, k).values[-1]
    sent = torch.where(mag >= thresh, flat, torch.zeros_like(flat))
    return sent.reshape(g.shape), ErrorFeedbackState(residual=flat - sent)


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """Per-run configuration of the gradient wire path."""

    default: str = MODE_NSD
    s: float = 1.0  # NSD scale of the comm-side quantization
    chunk: int = wire.DEFAULT_CHUNK  # the port's wire has this one chunk
    topk_frac: float = 0.01
    min_leaf_size: int = 256  # leaves smaller than this stay dense
    overrides: tuple = ()  # ((name_substring, mode), ...), first match wins
    collect_stats: bool = False  # one comm telemetry row per reduce
    stats_tag: str = "comm/"  # the rows' tag
    topology: str = TOPO_PS
    pods: int = 1  # node grouping for TOPO_HIER/BUTTERFLY (N = pods*per_pod)
    # > 0 reduces the gradient leaves in ~bucket_bytes buckets in reverse
    # layer order (repro_torch.comm.overlap); 0 keeps the one blocking
    # reduce. Bit-exact either way (pack keys are per leaf). In the port
    # the buckets run one after another once the backward is done, so the
    # option overlaps nothing and buys no speed; it changes the accounting
    # (telemetry per bucket, peak_dcn_bytes the largest bucket's).
    bucket_bytes: int = 0

    def __post_init__(self):
        for m in (self.default,) + tuple(m for _, m in self.overrides):
            if not _valid_comm_mode(m):
                raise ValueError(
                    f"unknown comm mode {m!r}; one of {MODES} or a "
                    f"registered quant codec spec (repro_torch.quant)")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown comm topology {self.topology!r}; "
                             f"one of {TOPOLOGIES}")
        if self.pods < 1:
            raise ValueError(f"pods must be >= 1, got {self.pods}")
        if self.chunk != wire.DEFAULT_CHUNK:
            raise ValueError(f"chunk {self.chunk}: the port's wire has one "
                             f"chunk, {wire.DEFAULT_CHUNK}")
        if self.bucket_bytes < 0:
            raise ValueError(
                f"bucket_bytes must be >= 0, got {self.bucket_bytes}")

    def mode_for(self, name: str, size: int) -> str:
        for pat, mode in self.overrides:
            if pat in name:
                return mode
        if size < self.min_leaf_size:
            return MODE_DENSE
        return self.default

    def replace(self, **kw) -> "CommPolicy":
        return dataclasses.replace(self, **kw)


# A passthrough policy: every leaf dense, a telemetry baseline.
DENSE = CommPolicy(default=MODE_DENSE)


def compress_leaf(g: torch.Tensor, noise: Noise, mode: str,
                  policy: CommPolicy,
                  state: Optional[ErrorFeedbackState] = None):
    """One leaf through the wire: (g_hat, wire_bytes, new_state).

    ``g_hat`` is what the receiving end reconstructs; ``wire_bytes`` what
    crossed the link (an int, or a 0-d int32 tensor where it is measured).
    """
    if mode == MODE_DENSE:
        return g, dense_nbytes(g.shape, torch.float32), state
    if mode == MODE_INT8:
        q = qc.nsd_int8(g, noise, policy.s)
        return q.dequantize(g.dtype), g.numel() + 4 + wire.HEADER_BYTES, state
    if mode == MODE_NSD:
        p = wire.pack_nsd(g, noise, policy.s)
        return wire.unpack_nsd(p), p.wire_bytes(), state
    if mode == MODE_TOPK_EF:
        sent, new_state = topk_error_feedback(g, state, policy.topk_frac)
        k = max(1, int(policy.topk_frac * g.numel()))
        # int32 index + f32 value per kept element
        return sent, 8 * k + wire.HEADER_BYTES, new_state
    # a registered quant codec spec: its round trip, its measured bytes
    enc = qc.encode(mode, g, noise)
    return qc.decode(mode, enc).to(g.dtype), qc.measured_bytes(mode, enc), state


def _as_f32(nbytes) -> Union[float, torch.Tensor]:
    """Bytes as an f32 addend: a tensor cast, an int as a Python float (a
    scalar argument of the add, no host-to-device copy)."""
    return (nbytes.to(torch.float32) if isinstance(nbytes, torch.Tensor)
            else float(nbytes))


def init_comm_state(grads: Dict[str, torch.Tensor], policy: CommPolicy
                    ) -> Dict[str, ErrorFeedbackState]:
    """Zero EF residuals for the leaves the policy routes through topk_ef."""
    return {name: ErrorFeedbackState(residual=torch.zeros(
                g.numel(), dtype=torch.float32, device=g.device))
            for name, g in sorted(grads.items())
            if policy.mode_for(name, g.numel()) == MODE_TOPK_EF}


def compress_tree(grads: Dict[str, torch.Tensor],
                  noise: Callable[[str, Tuple[int, ...]], Noise],
                  policy: CommPolicy,
                  states: Optional[Dict[str, ErrorFeedbackState]] = None):
    """Route a gradient dict through the wire, leaf by leaf in sorted name
    order (the reference's flatten order, so the f32 byte totals add up in
    its order). ``noise(name, shape)`` is what leaf ``name`` dithers with,
    asked only for the modes that draw (the reference's leaf key
    ``fold_in(key, name_salt(name))``; the flat reducer hands its
    ``pack_noise``). Returns (grads_hat, new_states, telemetry) with
    telemetry ``wire_bytes`` / ``dense_bytes``, 0-d f32 tensors; under
    ``policy.collect_stats`` it also records one comm row under
    ``policy.stats_tag``."""
    states = dict(states or {})
    first = next(iter(grads.values()))
    wire_total = torch.zeros((), dtype=torch.float32, device=first.device)
    dense_total = torch.zeros_like(wire_total)
    out = {}
    for name, g in sorted(grads.items()):
        mode = policy.mode_for(name, g.numel())
        leaf_noise = (None if mode in (MODE_DENSE, MODE_TOPK_EF)
                      else noise(name, tuple(g.shape)))
        out[name], nbytes, new_state = compress_leaf(
            g, leaf_noise, mode, policy, states.get(name))
        if new_state is not None:
            states[name] = new_state
        wire_total = wire_total + _as_f32(nbytes)
        dense_total = dense_total + float(dense_nbytes(g.shape, torch.float32))
    if policy.collect_stats:
        tele.emit(policy.stats_tag, wire_total, dense_total)
    return out, states, {"wire_bytes": wire_total, "dense_bytes": dense_total}
