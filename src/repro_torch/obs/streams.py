"""Declared metric streams: the bus's typed schema.

Counterpart of ``repro.obs.streams``. A :class:`MetricStream` declares once
what a family of telemetry rows means: a stable stream name, ordered column
names and a one-line description, so that the run log
(``repro_torch.obs.runlog``) and the offline report
(``repro_torch.obs.report``) name columns instead of guessing at positional
tuples. The nine built-in streams are the reference's, with the same names,
columns and order (a run manifest embeds them); ``overlap`` has no
emitter in the port yet.

Registration is idempotent by value: registering an identical stream again
is a no-op, registering a different schema under an existing name raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MetricStream:
    """Schema of one telemetry stream on the bus.

    ``name``     stable stream id (also the JSONL file stem in a run dir)
    ``columns``  ordered column names; every row is an f32 vector of this
                 arity
    ``description``  what a row means, for humans and manifests
    """

    name: str
    columns: Tuple[str, ...]
    description: str = ""

    def __post_init__(self):
        if not self.name or "/" in self.name:
            raise ValueError(f"stream name must be non-empty, no '/': "
                             f"{self.name!r}")
        if not self.columns:
            raise ValueError(f"stream {self.name!r}: needs >= 1 column")

    @property
    def ncols(self) -> int:
        return len(self.columns)


# ---------------------------------------------------------------------------
# the built-in streams
# ---------------------------------------------------------------------------

# tag = layer name; one row per (layer, backward pass)
DITHER = MetricStream(
    "dither", ("sparsity", "bits", "delta"),
    "per-layer dither telemetry from inside the backward pass: induced "
    "sparsity fraction, worst-case bit-width, quantization step Delta "
    "(paper Table 1 / Fig. 6b)")

# one row per gradient exchange
COMM = MetricStream(
    "comm", ("wire_bytes", "dense_bytes"),
    "bytes-on-wire of compressed gradient exchange vs the dense f32 "
    "counterfactual (repro.comm)")

# one row per (layer, forward pass under differentiation)
MEMORY = MetricStream(
    "memory", ("measured_bytes", "capacity_bytes", "dense_bytes"),
    "residual-store bytes per layer: occupancy-aware wire-equivalent, "
    "HBM-resident capacity, dense fp32 counterfactual (repro.memory)")

# tag = span path ("dispatch", "data", "controller/tick", ...)
PHASE = MetricStream(
    "phase", ("step", "duration_s"),
    "host-side step-phase spans (repro.obs.trace): wall-clock seconds "
    "attributed to one phase of one step")

# one row per optimizer step when a RunObs is attached
TRAIN = MetricStream(
    "train", ("step", "loss"),
    "per-step training headline metrics (host-synced; recorded only when "
    "a run observer is attached)")

# eq.-6-style pointwise error bounds from compressed reduces
BOUND = MetricStream(
    "bound", ("step", "error_bound"),
    "per-step compressed-reduce pointwise error bound vs the dense mean")

# one row per serving-engine tick; tag = engine/worker name
SERVE = MetricStream(
    "serve", ("tick", "active_slots", "queue_depth", "fed_tokens",
              "gen_tokens", "kv_bytes", "kv_dense_bytes"),
    "serving engine occupancy + throughput per decode tick "
    "(repro.serve.engine): prompt/decode tokens fed into the step, tokens "
    "emitted, and KV-cache capacity bytes vs the dense fp32 counterfactual "
    "(paged mode prices sealed pages through repro.quant)")

# one row per priced step of an overlap-scheduled reduce; tag = stats tag
OVERLAP = MetricStream(
    "overlap", ("step", "n_buckets", "hidden_s", "exposed_s", "efficiency"),
    "modeled overlap accounting of a bucketed gradient reduce "
    "(repro.launch.costmodel.price_overlap): comm seconds hidden under "
    "backward vs exposed past it, and their ratio")

# tag = "kernels/" + fallback reason; one row per snapshot
FALLBACK = MetricStream(
    "fallback", ("count",),
    "cumulative trace-time kernel-path fallback counts "
    "(repro.kernels.ops.KERNEL_FALLBACKS), snapshotted at run end")

BUILTIN_STREAMS = (DITHER, COMM, MEMORY, PHASE, TRAIN, BOUND, SERVE,
                   OVERLAP, FALLBACK)


class StreamRegistry:
    """Name -> MetricStream map with conflict detection."""

    def __init__(self):
        self._streams: Dict[str, MetricStream] = {}
        for s in BUILTIN_STREAMS:
            self._streams[s.name] = s

    def register(self, stream: MetricStream) -> MetricStream:
        cur = self._streams.get(stream.name)
        if cur is not None and cur != stream:
            raise ValueError(
                f"stream {stream.name!r} already registered with a "
                f"different schema: {cur.columns} != {stream.columns}")
        self._streams[stream.name] = stream
        return stream

    def get(self, name: str) -> MetricStream:
        try:
            return self._streams[name]
        except KeyError:
            raise KeyError(
                f"unknown stream {name!r}; registered: "
                f"{sorted(self._streams)}") from None

    def names(self):
        return sorted(self._streams)

    def schema(self) -> Dict[str, Tuple[str, ...]]:
        """{stream: columns}: what a run manifest embeds."""
        return {n: s.columns for n, s in sorted(self._streams.items())}
