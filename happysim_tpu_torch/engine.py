"""Ensemble engine: thousands of Monte-Carlo replicas of a service graph,
stepped together (counterpart of ``happysim_tpu/tpu/engine.py``).

Per-replica state is a ``dict[str, Tensor]`` whose leaves carry the names,
dtypes and shapes of the JAX engine's ``_Compiled.init_state``, with the
replica axis written out as the leading axis (JAX's ``vmap`` axis). The
next event of a replica is the argmin over a fixed candidate vector (the
source's next arrival, each server's earliest completion, then each
server's earliest transit arrival when edges carry latency), exactly as
in the JAX engine, and one step processes one event per replica.

A job leaving a node is delivered by a walk over the static topology:
through a limiter (admit or drop), through routers (one choice per hop),
to a sink, a server, or a server's transit slots when the edge carries
latency. The walk is written out per static target with the replica
lanes that chose it, which is what JAX's per-lane selects compute. The
chaos branches follow the same rule: where JAX computes both sides of a
retry or a packet loss and selects per lane, the step updates each
side's lanes in place (a deadline expiry is retried or discarded, a
fault-window rejection parked for its retry or dropped, a lost crossing
vanishes before it reaches its node).

A model with a :class:`~happysim_tpu_torch.telemetry.TelemetrySpec` adds
per-replica ``(n_windows, ...)`` buffers that the step adds into at the
same accounting sites, each event booked in the window of the time that
JAX's step books it at; they come back as ``EnsembleResult.timeseries``.

The hot loop runs in macro-blocks of ``macro`` event steps: block ``c``'s
uniforms are JAX's stream, ``uniform(fold_in(key, c))``, and
:func:`~happysim_tpu_torch.kernels.event_step.block_steps` runs every
replica's blocks of the event budget, each replica until it halts (JAX's
``replica_chunks``): one launch of the hand-written CUDA kernel on the
card, which draws the uniforms itself, or for CPU tensors its plain
torch-op version (the step below, applied ``macro`` times to each block
drawn by :mod:`~happysim_tpu_torch.rng`, until every replica has
halted). A call with no event budget first tries the closed form of
:mod:`~happysim_tpu_torch.chain`, as the JAX engine does. A checkpointed
or resumed call runs the same blocks in segments, one ``block_steps``
call each, and snapshots the state between them in the JAX package's
checkpoint format (:class:`EnsembleCheckpoint`). A model with a traced
source (:meth:`~happysim_tpu_torch.model.EnsembleModel.trace_arrivals`)
streams its trace to the device in pages, two resident at a time, and
runs one stall-gated launch (:func:`~happysim_tpu_torch.kernels.event_step.trace_steps`)
a stream step (:func:`_run_ensemble_traced`).

Reductions over replicas go through :mod:`~happysim_tpu_torch.reduce`, so
the reported totals are order-free and exact.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import os
import time as _wall
from dataclasses import dataclass
from dataclasses import field as dataclasses_field
from typing import Optional

import numpy as np
import torch

from happysim_tpu_torch import convert, rng
from happysim_tpu_torch import mesh as mesh_lib
from happysim_tpu_torch.faults import FaultTable, PartitionTable
from happysim_tpu_torch.kernels import event_step, support
from happysim_tpu_torch.numerics import erfinv, fma_f32, interp
from happysim_tpu_torch.model import (
    LIMITER,
    ROUTER,
    SERVER,
    SINK,
    EdgeLatency,
    EnsembleModel,
    NodeRef,
)
from happysim_tpu_torch.reduce import (
    MAX_EXACT_REPLICAS,
    host_f64,
    host_i64,
    reduce_over_processes,
    shard_sum_f32_fixed,
    shard_sum_i64_limbs,
    sum_i64_limbs,
)
from happysim_tpu_torch.summary import EntitySummary, SimulationSummary
from happysim_tpu_torch.telemetry import EnsembleTimeseries, build_timeseries, window_edges
from happysim_tpu_torch.temporal import Instant

logger = logging.getLogger("happysim_tpu_torch.engine")

INF = float("inf")

# Latency histogram: 10 bins/decade over [1e-5 s, 1e3 s] -> 80 bins.
HIST_BINS = 80
HIST_LO_LOG10 = -5.0
HIST_DECADES = 8.0

# Grid points of a rate profile's cumulative-rate lookup tables.
PROFILE_GRID_POINTS = 512

# Elements of the (replicas, nW, nV, W) overlap tensor the fault
# occupancy integral forms at once (256 MB of float32).
_FAULT_INTEGRAL_CHUNK = 1 << 26

# Default macro-block length: event steps per kernel launch and per RNG
# chunk. The RNG stream is keyed by (absolute block, row within block), so
# the length is part of the stream layout.
RNG_CHUNK = 32

# The torch.profiler ranges (``torch.profiler.record_function``) around
# the scan's stages, named as the JAX engine names its ``jax.named_scope``
# annotations: a budget call of the event step a shard (``hs.macro_block``:
# the one-call scan, each segment, each stream step), the kernel's launch
# inside it (``hs.kernel``, event_step.block_steps / trace_steps; the CPU's
# plain step runs outside it) and the reduce over replicas (``hs.reduce``,
# :func:`reduce_final`). They show in a torch.profiler trace, and under
# ``torch.autograd.profiler.emit_nvtx()`` as NVTX ranges.
PROFILER_SCOPES = ("hs.macro_block", "hs.kernel", "hs.reduce")

# Reduce-key encodings (see reduce.py): limb-encoded int counters and
# fixed-point float sums. reduce_final encodes by these, _build_result
# decodes by them (JAX's registry, for the keys the port has).
_I64_COUNTER_KEYS = frozenset({
    "events",
    "sink_count", "sink_hist",
    "srv_completed", "srv_dropped", "srv_outage_dropped", "srv_started",
    "srv_timed_out", "srv_retried", "srv_wait_n",
    "srv_fault_dropped", "srv_fault_retried", "srv_hedged", "srv_hedge_wins",
    "lim_admitted", "lim_dropped",
    "tr_dropped", "net_lost",
    "srv_breaker_dropped", "brk_tripped",
    "srv_shed_dropped", "srv_budget_dropped",
    "net_partitioned", "qrm_dropped", "ldr_changes",
    "trc_arrivals",
    "blocks_total",
})
# Telemetry reduce keys that are float integrals, sums or percentiles;
# every other tel_ key is an int counter and limb-encodes.
_TEL_FLOAT_KEYS = frozenset({
    "tel_sink_sum", "tel_srv_depth_int", "tel_srv_busy_int",
    "tel_fault_int", "tel_brk_open_int",
    "tel_qrm_dark_int", "tel_ldr_uptime_int",
    "tel_spread_p10", "tel_spread_p90",
})
# Fixed-point sums (the spread percentiles are plain floats, not sums).
_F64_SUM_KEYS = frozenset({
    "sink_sum", "sink_sq",
    "srv_busy_int", "srv_depth_int", "srv_wait_sum",
    "brk_open_time",
    "qrm_dark_time", "ldr_noleader_time",
    "tel_sink_sum", "tel_srv_depth_int", "tel_srv_busy_int", "tel_fault_int",
    "tel_brk_open_int",
    "tel_qrm_dark_int", "tel_ldr_uptime_int",
})


def _is_i64_key(key: str) -> bool:
    """Whether a reduce-output key is limb-encoded."""
    if key in _I64_COUNTER_KEYS:
        return True
    return key.startswith("tel_") and key not in _TEL_FLOAT_KEYS


def macro_block_len(model: Optional[EnsembleModel] = None) -> int:
    """Macro-block length: ``EnsembleModel.macro_block`` or :data:`RNG_CHUNK`."""
    if model is not None and model.macro_block:
        return max(1, int(model.macro_block))
    return RNG_CHUNK


def _f32(value, device) -> torch.Tensor:
    """A 0-d float32 tensor, so every op below runs in float32 as in JAX."""
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def _fused(base: torch.Tensor, terms: tuple) -> torch.Tensor:
    """``base + x * y`` for ``terms = (x, y)``, rounded once, where XLA's
    CPU backend contracts the product into one multiply-add in the
    compiled JAX step: a service's end, a hedge's race, an exponential
    edge's arrival, a limiter's refill, the sink's sum of squares and the
    depth integrals (ROADMAP C)."""
    x, y = terms
    return fma_f32(x, y.expand_as(x), base)


def _hist_bin(latency: torch.Tensor) -> torch.Tensor:
    dev = latency.device
    logv = torch.log10(torch.maximum(latency, _f32(1e-12, dev)))
    frac = (logv - _f32(HIST_LO_LOG10, dev)) / _f32(HIST_DECADES, dev)
    # .to(int32) truncates toward zero, as XLA's convert does.
    return torch.clamp((frac * _f32(HIST_BINS, dev)).to(torch.int32), 0, HIST_BINS - 1)


def hist_percentile(hist: np.ndarray, q: float) -> float:
    """Host-side percentile estimate from the log-spaced histogram (the
    bin centre in log space; 0.0 for an empty histogram)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"percentile q must be in [0, 1], got {q!r}")
    total = int(hist.sum())
    if total == 0:
        return 0.0
    target = min(max(total * q, 1.0), float(total))
    cumulative = np.cumsum(hist)
    bin_index = int(np.searchsorted(cumulative, target))
    bin_index = min(bin_index, HIST_BINS - 1)
    frac = (bin_index + 0.5) / HIST_BINS
    return float(10 ** (HIST_LO_LOG10 + frac * HIST_DECADES))


# ---------------------------------------------------------------------------
# Checkpoints: the JAX package's on-disk format and fingerprints, so that a
# file written by either package resumes in the other
# ---------------------------------------------------------------------------


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' to a path without it; normalise so that
    save(p) followed by load(p) round-trips."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint_npz(path: str, meta: dict, state: dict) -> None:
    """One npz: the meta dict as a JSON blob under ``__meta__`` and each
    state leaf under ``state__<name>``."""
    np.savez(
        _npz_path(path),
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{f"state__{k}": v for k, v in state.items()},
    )


def load_checkpoint_npz(path: str) -> tuple[dict, dict]:
    """The ``(meta, state)`` that :func:`save_checkpoint_npz` wrote."""
    with np.load(_npz_path(path)) as archive:
        meta = json.loads(archive["__meta__"].tobytes().decode())
        state = {
            k[len("state__"):]: archive[k] for k in archive.files if k.startswith("state__")
        }
    return meta, state


def model_fingerprint(model: EnsembleModel) -> str:
    """Digest of everything the step bakes in (topology, horizons, service
    families, chaos, telemetry and resilience specs): the SHA-256 of the
    repr the JAX package hashes, so both packages give the same digest for
    the same model. The spec dataclasses of :mod:`~happysim_tpu_torch.model`
    keep the JAX package's field order and ``repr=False`` flags for it; a
    trace enters through its :meth:`~happysim_tpu_torch.traces.TraceSpec.signature`,
    a remote egress node through :class:`~happysim_tpu_torch.model.RemoteSpec`'s
    repr, JAX's."""
    items = (
        model.horizon_s,
        model.warmup_s,
        model.transit_capacity,
        model.sources,
        model.servers,
        model.routers,
        model.limiters,
        len(model.sinks),
        model.remotes,
        model.correlated_faults,
    )
    # Appended only when present, as in the JAX package (which keeps
    # older fingerprints stable that way).
    if model.telemetry_spec is not None:
        items = items + (model.telemetry_spec,)
    weights = tuple(r.weights for r in model.routers if r.weights)
    if weights:
        items = items + (("router_weights",) + weights,)
    resilience = tuple(
        spec
        for spec in (model.circuit_breaker_spec, model.load_shed_spec, model.retry_budget_spec)
        if spec is not None
    )
    if resilience:
        items = items + (("resilience",) + resilience,)
    consensus = tuple(model.network_partitions) + tuple(
        spec for spec in (model.quorum_spec, model.leader_election_spec) if spec is not None
    )
    if consensus:
        items = items + (("consensus",) + consensus,)
    traces = tuple(
        (i, s.trace.signature()) for i, s in enumerate(model.sources) if s.trace is not None
    )
    if traces:
        items = items + (("trace",) + traces,)
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def params_fingerprint(params: dict) -> str:
    """Digest of the resolved per-replica parameter arrays (numpy, as
    :func:`_resolve_params` returns them): a resume under other sweep
    values would mix two parameterisations."""
    digest = hashlib.sha256()
    for name in sorted(params):
        digest.update(name.encode())
        digest.update(np.ascontiguousarray(np.asarray(params[name])).tobytes())
    return digest.hexdigest()[:16]


@dataclass
class EnsembleCheckpoint:
    """A resumable snapshot of a scan run: its state leaves as numpy
    arrays with the replica axis leading, after ``chunk_index`` of its
    ``n_chunks`` macro-blocks. Resuming with the same model, replicas,
    seed and budget reproduces the uninterrupted run bit for bit: each
    block's draws are keyed by its absolute index. The JAX package's
    ``EnsembleCheckpoint``, field for field; ``mesh_devices`` is
    provenance, the shard count that wrote it (a snapshot resumes on any
    shard count)."""

    chunk_index: int
    n_chunks: int
    n_replicas: int
    seed: int
    max_events: int
    state: dict
    model_fingerprint: str = ""
    params_fingerprint: str = ""
    # 0: unknown (resume skips the check).
    macro_block: int = 0
    # TelemetrySpec.signature(), "" for a model without telemetry.
    telemetry: str = ""
    mesh_devices: int = 0

    def save(self, path: str) -> None:
        meta = {
            "chunk_index": self.chunk_index,
            "n_chunks": self.n_chunks,
            "n_replicas": self.n_replicas,
            "seed": self.seed,
            "max_events": self.max_events,
            "model_fingerprint": self.model_fingerprint,
            "params_fingerprint": self.params_fingerprint,
            "macro_block": self.macro_block,
            "telemetry": self.telemetry,
            "mesh_devices": self.mesh_devices,
        }
        save_checkpoint_npz(path, meta, self.state)

    @classmethod
    def load(cls, path: str) -> "EnsembleCheckpoint":
        meta, state = load_checkpoint_npz(path)
        return cls(state=state, **meta)


@dataclass
class EnsembleResult:
    """Aggregated ensemble statistics (cross-replica sums and means)."""

    n_replicas: int
    horizon_s: float
    simulated_events: int
    wall_seconds: float
    events_per_second: float
    # per sink (lists indexed by sink id)
    sink_count: list[int]
    sink_mean_latency_s: list[float]
    sink_p50_s: list[float]
    sink_p99_s: list[float]
    sink_hist: np.ndarray  # (nK, HIST_BINS) aggregated
    # per server
    server_completed: list[int]
    server_dropped: list[int]
    server_outage_dropped: list[int]
    server_utilization: list[float]
    server_mean_wait_s: list[float]
    server_mean_queue_len: list[float]
    server_timed_out: list[int]
    server_retried: list[int]
    transit_dropped: list[int]
    limiter_admitted: list[int]
    limiter_dropped: list[int]
    # replicas whose event budget ran out before the horizon (bias warning)
    truncated_replicas: int = 0
    # chaos accounting, per server (zeros unless the model declares the
    # feature): terminal losses to fault windows, retries launched after
    # fault-window rejections, hedged second attempts launched and won
    server_fault_dropped: list[int] = dataclasses_field(default_factory=list)
    server_fault_retried: list[int] = dataclasses_field(default_factory=list)
    server_hedged: list[int] = dataclasses_field(default_factory=list)
    server_hedge_wins: list[int] = dataclasses_field(default_factory=list)
    # crossings lost on lossy edges (whole model)
    network_lost: int = 0
    # resilience accounting, per server (zeros unless the model installs
    # the spec): arrivals rejected by an open (or probe-exhausted
    # half-open) breaker, breaker trips, the fraction of replicas x
    # horizon each breaker spent open (not masked by the warmup),
    # arrivals shed, and retry or hedge launches the budget suppressed
    server_breaker_dropped: list[int] = dataclasses_field(default_factory=list)
    breaker_tripped: list[int] = dataclasses_field(default_factory=list)
    breaker_open_fraction: list[float] = dataclasses_field(default_factory=list)
    server_shed_dropped: list[int] = dataclasses_field(default_factory=list)
    server_budget_dropped: list[int] = dataclasses_field(default_factory=list)
    # the defenses the model declared (EnsembleModel.resilience_features)
    resilience_features: tuple = ()
    # consensus accounting (zeros unless the model declares the feature):
    # deliveries dropped at a drop-mode cut (whole model); arrivals a
    # write quorum out of reach rejected, per server (retried ones
    # included); the fraction of replicas x horizon the quorum group
    # spent below its write quorum; elections completed over all replicas
    # (the first included); the fraction of replicas x horizon the
    # election group had no live leader
    network_partitioned: int = 0
    server_quorum_dropped: list[int] = dataclasses_field(default_factory=list)
    quorum_dark_fraction: float = 0.0
    leader_changes: int = 0
    time_without_leader_fraction: float = 0.0
    # the consensus features the model declared
    # (EnsembleModel.consensus_features)
    consensus_features: tuple = ()
    # seconds spent building and loading the kernel library in this call,
    # kept out of wall_seconds
    compile_seconds: float = 0.0
    # "scan+cuda" when the CUDA event-step kernel ran, "scan" for the
    # plain torch-op step on the CPU
    engine_path: str = "scan"
    # why the CUDA kernel did not run: "" when it ran (or the run took
    # the chain form, which reaches no kernel dispatch), else the reason
    kernel_decline: str = ""
    # "mm1" / "chain" / "router" / "graph" on the kernel path, "" off it
    kernel_shape: str = ""
    # the chaos features (EnsembleModel.chaos_features) the kernel ran
    kernel_chaos: tuple = ()
    # macro-block length, per-run block budget, blocks retired summed over
    # replicas, and the occupancy histogram {blocks_run: n_replicas}
    macro_block: int = 0
    max_blocks: int = 0
    blocks_total: int = 0
    block_occupancy: dict = dataclasses_field(default_factory=dict)
    padded_replicas: int = 0
    # Mesh provenance (engine_report()["mesh"], JAX's fields): the shards
    # the replica axis was cut into, the mesh's axes and shape, the
    # replicas a shard, the reduce path ("device-limb-sum": exact limb
    # sums on the device, added across shards; "+all-reduce" across
    # processes), and on a resumed run the seconds spent cutting the
    # snapshot's state into this mesh's shards.
    mesh_devices: int = 1
    mesh_axes: tuple = ()
    mesh_shape: tuple = ()
    per_shard_replicas: int = 0
    reduce_path: str = "device-limb-sum"
    redistribution_seconds: float = 0.0
    # the device the run used (torch.cuda.get_device_name or "cpu")
    device_name: str = ""
    # the per-window series of a model with a telemetry spec, else None
    timeseries: Optional[EnsembleTimeseries] = None
    # trace-driven arrivals (a model with a traced source): the pages
    # uploaded, their length and count, the most the scan could address
    # at once, the seconds a launch waited on a page's upload, the
    # stream steps (launches), and the arrivals per tenant over all
    # replicas
    trace: bool = False
    trace_chunks_streamed: int = 0
    trace_chunk_len: int = 0
    trace_n_chunks: int = 0
    trace_max_resident_chunks: int = 0
    trace_buffer_stall_seconds: float = 0.0
    trace_stream_steps: int = 0
    trace_tenant_arrivals: list = dataclasses_field(default_factory=list)

    def summary(self) -> SimulationSummary:
        """The run as a :class:`~happysim_tpu_torch.summary.SimulationSummary`,
        entity for entity the JAX engine's: each sink, server and limiter
        with its conditional extras, the model-level ``Chaos`` entity when
        chaos fired, the ``Resilience`` and ``Consensus`` entities when the
        model declares those features, and the ``Engine`` entity. Two
        fields are the port's own: ``backend`` names the device ("cpu" for
        a run on the CPU, else "cuda"), and the ``Engine`` entity carries
        ``engine_path``, ``macro_blocks_run`` and ``kernel_decline`` as
        this result reports them, with no escape hatches (the port has no
        XLA or Pallas switch). A view of the result's fields: nothing runs
        on the device."""
        entities = []
        for index, count in enumerate(self.sink_count):
            entities.append(
                EntitySummary(
                    name=f"sink[{index}]",
                    kind="Sink",
                    events_received=count,
                    extra={
                        "mean_latency_s": self.sink_mean_latency_s[index],
                        "p50_s": self.sink_p50_s[index],
                        "p99_s": self.sink_p99_s[index],
                    },
                )
            )
        for index in range(len(self.server_completed)):
            extra = {
                "completed": self.server_completed[index],
                "dropped": self.server_dropped[index],
                "utilization": self.server_utilization[index],
                "mean_wait_s": self.server_mean_wait_s[index],
                "mean_queue_len": self.server_mean_queue_len[index],
            }
            if self.server_timed_out[index] or self.server_retried[index]:
                extra["timed_out"] = self.server_timed_out[index]
                extra["retried"] = self.server_retried[index]
            if self.server_outage_dropped[index]:
                extra["outage_dropped"] = self.server_outage_dropped[index]
            if self.transit_dropped[index]:
                extra["transit_dropped"] = self.transit_dropped[index]
            if self.server_fault_dropped and self.server_fault_dropped[index]:
                extra["fault_dropped"] = self.server_fault_dropped[index]
            if self.server_fault_retried and self.server_fault_retried[index]:
                extra["fault_retried"] = self.server_fault_retried[index]
            if self.server_hedged and self.server_hedged[index]:
                extra["hedged"] = self.server_hedged[index]
                extra["hedge_wins"] = self.server_hedge_wins[index]
            if self.server_breaker_dropped and self.server_breaker_dropped[index]:
                extra["breaker_dropped"] = self.server_breaker_dropped[index]
            if self.breaker_tripped and self.breaker_tripped[index]:
                extra["breaker_tripped"] = self.breaker_tripped[index]
            if self.server_shed_dropped and self.server_shed_dropped[index]:
                extra["shed_dropped"] = self.server_shed_dropped[index]
            if self.server_budget_dropped and self.server_budget_dropped[index]:
                extra["budget_dropped"] = self.server_budget_dropped[index]
            entities.append(EntitySummary(name=f"server[{index}]", kind="Server", extra=extra))
        for index in range(len(self.limiter_admitted)):
            entities.append(
                EntitySummary(
                    name=f"limiter[{index}]",
                    kind="RateLimiter",
                    extra={
                        "admitted": self.limiter_admitted[index],
                        "dropped": self.limiter_dropped[index],
                    },
                )
            )
        # The chaos a run absorbed, over the whole model: present when any
        # of it fired.
        chaos_extra = {}
        if self.network_lost:
            chaos_extra["network_lost"] = self.network_lost
        for label, per_server in (
            ("fault_dropped", self.server_fault_dropped),
            ("fault_retried", self.server_fault_retried),
            ("hedged", self.server_hedged),
            ("hedge_wins", self.server_hedge_wins),
            ("transit_dropped", self.transit_dropped),
        ):
            total = sum(per_server)
            if total:
                chaos_extra[f"total_{label}"] = total
        if chaos_extra:
            entities.append(EntitySummary(name="model", kind="Chaos", extra=chaos_extra))
        # The defenses: present whenever the model declares one (a defended
        # run whose breakers never tripped reads apart from an undefended
        # run), with the totals that fired.
        if self.resilience_features:
            res_extra = {"features": ", ".join(self.resilience_features)}
            for label, per_server in (
                ("breaker_tripped", self.breaker_tripped),
                ("breaker_dropped", self.server_breaker_dropped),
                ("shed_dropped", self.server_shed_dropped),
                ("budget_dropped", self.server_budget_dropped),
            ):
                total = sum(per_server)
                if total:
                    res_extra[f"total_{label}"] = total
            if self.breaker_open_fraction and any(f > 0.0 for f in self.breaker_open_fraction):
                res_extra["breaker_open_fraction_max"] = max(self.breaker_open_fraction)
            entities.append(EntitySummary(name="model", kind="Resilience", extra=res_extra))
        # The consensus tier, by the same rule.
        if self.consensus_features:
            con_extra = {"features": ", ".join(self.consensus_features)}
            if self.network_partitioned:
                con_extra["network_partitioned"] = self.network_partitioned
            total_qrm = sum(self.server_quorum_dropped)
            if total_qrm:
                con_extra["total_quorum_dropped"] = total_qrm
            if self.quorum_dark_fraction > 0.0:
                con_extra["quorum_dark_fraction"] = self.quorum_dark_fraction
            if self.leader_changes:
                con_extra["leader_changes"] = self.leader_changes
            if self.time_without_leader_fraction > 0.0:
                con_extra["time_without_leader_max"] = self.time_without_leader_fraction
            entities.append(EntitySummary(name="model", kind="Consensus", extra=con_extra))
        engine_extra = {"engine_path": self.engine_path}
        if self.blocks_total:
            engine_extra["macro_blocks_run"] = self.blocks_total
        if self.kernel_decline:
            engine_extra["kernel_decline"] = self.kernel_decline
        entities.append(EntitySummary(name="engine", kind="Engine", extra=engine_extra))
        return SimulationSummary(
            start_time=Instant.Epoch,
            end_time=Instant.from_seconds(self.horizon_s),
            events_processed=self.simulated_events,
            wall_clock_seconds=self.wall_seconds,
            entities=entities,
            completed=self.truncated_replicas == 0,
            backend="cpu" if self.device_name == "cpu" else "cuda",
            replicas=self.n_replicas,
            truncated_replicas=self.truncated_replicas,
        )

    def engine_report(self) -> dict:
        """Which path ran, where the time went, and the macro-block
        occupancy (the fields of the JAX report this engine fills)."""
        padded = self.padded_replicas or self.n_replicas
        budget = self.max_blocks * self.n_replicas
        return {
            "engine_path": self.engine_path,
            "kernel_decline": self.kernel_decline,
            "kernel_shape": self.kernel_shape,
            "kernel_chaos": tuple(self.kernel_chaos),
            "device": self.device_name,
            "compile_seconds": self.compile_seconds,
            "run_seconds": self.wall_seconds,
            "events_per_second": self.events_per_second,
            "macro_block": self.macro_block,
            "max_blocks": self.max_blocks,
            "blocks_total": self.blocks_total,
            "block_occupancy": dict(self.block_occupancy),
            "events_per_block": (
                self.simulated_events / self.blocks_total
                if self.blocks_total
                else 0.0
            ),
            "early_exit_occupancy": (
                self.blocks_total / budget if budget else 0.0
            ),
            "padded_replicas": padded,
            "padded_lane_fraction": (
                (padded - self.n_replicas) / padded if padded else 0.0
            ),
            "profiler_scopes": PROFILER_SCOPES,
            "telemetry_windows": self.timeseries.n_windows if self.timeseries else 0,
            "mesh": {
                "devices": self.mesh_devices,
                "axes": tuple(self.mesh_axes),
                "shape": tuple(self.mesh_shape),
                "per_shard_replicas": self.per_shard_replicas,
                "reduce_path": self.reduce_path,
                "redistribution_seconds": self.redistribution_seconds,
            },
            # Each defense on or off, and its totals, so a run that had no
            # defenses reads apart from one whose defenses never fired.
            "resilience": {
                "circuit_breaker": "circuit_breaker" in self.resilience_features,
                "load_shed": "load_shed" in self.resilience_features,
                "retry_budget": "retry_budget" in self.resilience_features,
                "breaker_tripped_total": sum(self.breaker_tripped),
                "breaker_dropped_total": sum(self.server_breaker_dropped),
                "shed_dropped_total": sum(self.server_shed_dropped),
                "budget_dropped_total": sum(self.server_budget_dropped),
                "breaker_open_fraction": list(self.breaker_open_fraction),
            },
            # Each consensus feature on or off, and its totals.
            "consensus": {
                "network_partitions": "network_partitions" in self.consensus_features,
                "quorum": "quorum" in self.consensus_features,
                "leader_election": "leader_election" in self.consensus_features,
                "network_partitioned_total": self.network_partitioned,
                "quorum_dropped_total": sum(self.server_quorum_dropped),
                "quorum_dark_fraction": self.quorum_dark_fraction,
                "leader_changes_total": self.leader_changes,
                "time_without_leader_fraction": self.time_without_leader_fraction,
            },
            # Trace ingestion, present (all zero) for a run without a
            # trace too.
            "trace": {
                "enabled": self.trace,
                "chunks_streamed": self.trace_chunks_streamed,
                "chunk_len": self.trace_chunk_len,
                "n_chunks": self.trace_n_chunks,
                "max_resident_chunks": self.trace_max_resident_chunks,
                "buffer_stall_seconds": self.trace_buffer_stall_seconds,
                "stream_steps": self.trace_stream_steps,
                "tenant_arrivals": list(self.trace_tenant_arrivals),
                # The share of the run's wall a launch waited on a page.
                "stall_fraction": (
                    self.trace_buffer_stall_seconds / self.wall_seconds
                    if self.wall_seconds > 0
                    else 0.0
                ),
            },
        }


# Service family ids (JAX numbering).
_SERVICE_KIND_IDS = {
    "constant": 0, "exponential": 1, "erlang": 2,
    "hyperexp": 3, "lognormal": 4, "pareto": 5,
}
# Uniform draws each service family consumes (erlang resolved per-model).
_SERVICE_DRAWS = {0: 0, 1: 1, 2: 2, 3: 2, 4: 1, 5: 1}
# float32 sqrt(2), as jnp.sqrt(2.0) gives it.
_SQRT2 = float(np.sqrt(np.float32(2.0)))


class _Compiled:
    """Static arrays and the vectorised event step derived from a model.

    The branch methods take the state dict and a ``lanes`` mask over the
    replica axis and update the selected lanes IN PLACE (slice assignment
    into the state's tensors); the other lanes keep their bits.
    """

    def __init__(self, model: EnsembleModel, allow_remote: bool = False):
        model.validate(allow_remote=allow_remote)
        # The kernel's plan (JAX's, where JAX's kernel takes the model);
        # the port has no engine path besides the kernel's, so it runs
        # what JAX's kernel declines too.
        self.plan = support.kernel_plan(model)
        self.model = model
        # Event steps per macro-block (a kernel launch, an RNG block).
        self.macro = macro_block_len(model)
        self.nS = len(model.sources)
        self.nV = max(len(model.servers), 1)
        self.nK = len(model.sinks)
        self.nR = max(len(model.routers), 1)
        self.nL = max(len(model.limiters), 1)
        self.C = max(model.max_concurrency, 1)
        self.K = max(model.max_queue_capacity, 1)
        self.TR = model.transit_capacity
        self.warmup = float(model.warmup_s)
        self.horizon = float(model.horizon_s)

        servers = model.servers
        self.slot_valid = np.zeros((self.nV, self.C), np.bool_)
        self.queue_cap = np.zeros((self.nV,), np.int32)
        self.srv_concurrency = np.ones((self.nV,), np.int32)
        # Service family per server and its shape constants, formed in
        # float64 and cast once, as the JAX engine does.
        self.service_kind = np.zeros((self.nV,), np.int32)
        self.srv_erlang_k = np.full((self.nV,), 2.0, np.float32)
        self.srv_hyp_p1 = np.full((self.nV,), 0.5, np.float32)
        self.srv_hyp_f1 = np.ones((self.nV,), np.float32)
        self.srv_hyp_f2 = np.ones((self.nV,), np.float32)
        self.srv_ln_sigma = np.zeros((self.nV,), np.float32)
        self.srv_par_alpha = np.full((self.nV,), 2.5, np.float32)
        self.srv_par_xmf = np.ones((self.nV,), np.float32)
        for v, spec in enumerate(servers):
            self.slot_valid[v, : spec.concurrency] = True
            self.queue_cap[v] = spec.queue_capacity
            self.srv_concurrency[v] = spec.concurrency
            self.service_kind[v] = _SERVICE_KIND_IDS[spec.service]
            if spec.service == "erlang":
                self.srv_erlang_k[v] = float(spec.service_k)
            elif spec.service == "hyperexp":
                # Balanced two-phase: p1 = (1 + sqrt((c2-1)/(c2+1))) / 2,
                # branch means m_i = mean / (2 p_i).
                c2 = spec.service_scv
                p1 = 0.5 * (1.0 + math.sqrt((c2 - 1.0) / (c2 + 1.0)))
                self.srv_hyp_p1[v] = p1
                self.srv_hyp_f1[v] = 1.0 / (2.0 * p1)
                self.srv_hyp_f2[v] = 1.0 / (2.0 * (1.0 - p1))
            elif spec.service == "lognormal":
                # cv^2 = exp(sigma^2) - 1; the sampler keeps the mean.
                self.srv_ln_sigma[v] = math.sqrt(math.log(1.0 + spec.service_scv))
            elif spec.service == "pareto":
                # x_m = mean (alpha-1)/alpha keeps E[S] = mean.
                self.srv_par_alpha[v] = spec.pareto_alpha
                self.srv_par_xmf[v] = (spec.pareto_alpha - 1.0) / spec.pareto_alpha
        # The families present decide how many service-draw slots a step
        # carries; erlang takes k of them.
        present = sorted({int(k) for k in self.service_kind[: len(servers)]}) or [1]
        self.families_present = present
        draws_needed = dict(_SERVICE_DRAWS)
        if 2 in present:
            draws_needed[2] = int(
                max(
                    self.srv_erlang_k[v]
                    for v in range(len(servers))
                    if self.service_kind[v] == 2
                )
            )
        self.n_svc_draws = max(draws_needed[k] for k in present)

        # Deadlines, retries, brownouts, hedges and fault schedules, per
        # server. The attempt budget max_retries is shared by deadline
        # retries and fault-rejection retries.
        self.srv_deadline = np.full((self.nV,), np.inf, np.float32)
        self.srv_max_retries = np.zeros((self.nV,), np.int32)
        self.srv_outage_start = np.full((self.nV,), np.inf, np.float32)
        self.srv_outage_end = np.full((self.nV,), np.inf, np.float32)
        self.srv_backoff = np.zeros((self.nV,), np.float32)
        self.srv_jitter = np.zeros((self.nV,), np.float32)
        self.srv_hedge = np.full((self.nV,), np.inf, np.float32)
        self.flt_can_retry = np.zeros((self.nV,), np.bool_)
        for v, spec in enumerate(servers):
            if spec.deadline_s is not None:
                self.srv_deadline[v] = spec.deadline_s
            self.srv_max_retries[v] = spec.max_retries
            if spec.outage_start_s is not None:
                self.srv_outage_start[v] = spec.outage_start_s
                self.srv_outage_end[v] = spec.outage_end_s
            if spec.retry_backoff_s is not None:
                self.srv_backoff[v] = spec.retry_backoff_s
            self.srv_jitter[v] = spec.retry_jitter
            if spec.hedge_delay_s is not None:
                self.srv_hedge[v] = spec.hedge_delay_s
            self.flt_can_retry[v] = (
                spec.fault is not None
                and spec.fault.mode == "outage"
                and spec.retry_backoff_s is not None
                and spec.max_retries > 0
            )
        self.faults = FaultTable(model)
        self.has_faults = self.faults.has_faults
        self.has_deadlines = any(s.deadline_s is not None for s in servers)
        self.has_outages = any(s.outage_start_s is not None for s in servers)
        self.has_backoff = any(s.retry_backoff_s is not None for s in servers)
        self.has_jitter = any(s.retry_jitter > 0.0 for s in servers)
        self.has_hedge = any(s.hedge_delay_s is not None for s in servers)
        # The consensus tier: partition windows are per-replica registers
        # drawn at init, consulted at a delivery into a member; the
        # quorum gate rejects arrivals at members while the write quorum
        # is out of reach; the quorum's dark time and the election are
        # swept over the members' dark windows at init.
        self.partitions = PartitionTable(model)
        self.has_partitions = self.partitions.has_partitions
        self.quorum = model.quorum_spec
        self.leader = model.leader_election_spec
        self.has_quorum = self.quorum is not None
        self.has_leader = self.leader is not None
        self.qrm_member = np.zeros((self.nV,), np.bool_)
        self.qrm_can_retry = np.zeros((self.nV,), np.bool_)
        self.qrm_write = int(self.quorum.write) if self.has_quorum else 0
        for v in self.quorum.group if self.has_quorum else ():
            self.qrm_member[v] = True
            self.qrm_can_retry[v] = servers[v].retry_backoff_s is not None and servers[v].max_retries > 0
        self.ldr_group = tuple(self.leader.group) if self.has_leader else ()
        self.ldr_delay = float(self.leader.detection_delay_s()) if self.has_leader else 0.0
        # Quorum rejections retry as fault rejections do (attempt numbers,
        # backoff parks, the srv_fault_retried ledger).
        self.has_fault_retries = bool(self.flt_can_retry.any() or self.qrm_can_retry.any())
        # Attempt numbers ride with jobs whenever a budget consumes them.
        self.has_attempts = self.has_deadlines or self.has_fault_retries
        self.has_loss = any(e.loss_p > 0.0 for e in model.iter_edges())
        # The resilience layer: per-(replica, server) leaves and gates at
        # the accounting sites above, each only where its spec is.
        self.breaker = model.circuit_breaker_spec
        self.shed = model.load_shed_spec
        self.budget = model.retry_budget_spec
        self.has_breaker = self.breaker is not None
        self.has_shed = self.shed is not None
        self.has_budget = self.budget is not None
        self.has_resilience = self.has_breaker or self.has_shed or self.has_budget
        # The sliding-window failure ring's width: one slot per counted
        # failure.
        self.brk_F = self.breaker.failure_threshold if self.has_breaker else 0
        if self.has_shed and self.shed.policy == "utilization":
            # Busy slots at or past threshold x concurrency shed; the
            # product is float32, as the JAX engine forms it on the host.
            self.shed_busy_thr = self.shed.threshold * self.srv_concurrency.astype(np.float32)
        else:
            self.shed_busy_thr = np.zeros((self.nV,), np.float32)
        # Any of the above runs the kernel's chaos instantiation (the
        # resilience defenses and the partition and quorum gates with
        # their leaves added).
        self.has_chaos = (
            self.has_deadlines or self.has_outages or self.has_faults
            or self.has_backoff or self.has_hedge or self.has_loss
            or self.has_resilience or self.has_partitions or self.has_quorum
        )

        self.arrival_is_poisson = np.array(
            [s.arrival == "poisson" for s in model.sources], np.bool_
        )
        self.stop_after = np.array(
            [
                s.stop_after_s if s.stop_after_s is not None else np.inf
                for s in model.sources
            ],
            np.float32,
        )
        # Trace-driven arrivals: the padded host arrays stay on the host,
        # and the stream loop pages them to the device two at a time.
        self.trace_src = model.traced_source_index()
        self.has_trace = self.trace_src is not None
        self.trace = None
        self.n_tenants = 0
        if self.has_trace:
            trace = model.sources[self.trace_src].trace
            self.trace = trace
            self.trace_times = trace.padded_times()  # +inf padded
            self.trace_tenants = trace.padded_tenants()
            self.trace_chunk_len = int(trace.chunk_len)
            self.trace_pages = int(trace.n_chunks)
            self.n_tenants = int(trace.n_tenants)
            # The traced source's first arrival (no page is resident at
            # init).
            self.trace_first_time = float(trace.times[0])
        self.lim_rate = np.array(
            [lim.refill_rate for lim in model.limiters] or [1.0], np.float32
        )
        self.lim_cap = np.array(
            [lim.capacity for lim in model.limiters] or [1.0], np.float32
        )
        # Whether any edge into a server carries latency (the transit
        # registers and the transit-arrival branch). A router with any
        # latency-carrying target edge and any server target parks every
        # server it chooses, with zero latency behind a free edge. Backoff
        # retries are delayed re-arrivals and ride the same registers.
        self.has_transit = (
            any(
                edge.mean_s > 0 and dest is not None and self._reaches_server(dest)
                for edge, dest in self._edges()
            )
            or any(
                any(e.mean_s > 0 for e in r.target_latencies)
                and any(t.kind == SERVER for t in r.targets)
                for r in model.routers
            )
            or self.has_backoff
            # A delay-mode cut parks deliveries in the transit registers.
            or self.partitions.has_delay
        )
        self.hop_depth = self._router_hop_depth()
        self._init_telemetry(model)
        self._assign_uniform_slots()
        self._build_profile_tables()
        self._device_tables: dict = {}

    # -- windowed telemetry (telemetry.py) -----------------------------------
    def _init_telemetry(self, model: EnsembleModel) -> None:
        """Compile-time telemetry gating (JAX ``_init_telemetry``): every
        ``tel_*`` leaf and every site exists only when the model carries
        a spec, so a model without one builds the state and the kernel
        arguments it built before. The counter keys are those of the
        features the port runs, in JAX's order. The quorum's dark time
        and the leader's uptime per window are sweep outputs at init, not
        keys here."""
        self.telemetry = model.telemetry_spec
        self.has_telemetry = self.telemetry is not None
        # Every tel_* leaf the model has.
        self.tel_keys: frozenset = frozenset()
        if not self.has_telemetry:
            self.nW = 0
            return
        self.telemetry.validate(model.horizon_s)
        self.nW = self.telemetry.n_windows(model.horizon_s)
        requested = set(self.telemetry.metrics)
        # "spread" needs the per-window counts; "faults" is a reduce-time
        # integral over the sampled fault registers.
        self.tel_throughput = bool({"throughput", "spread"} & requested)
        self.tel_spread = "spread" in requested
        self.tel_latency = "latency" in requested
        self.tel_queue = "queue" in requested
        self.tel_util = "utilization" in requested
        self.tel_rates = "rates" in requested
        self.tel_faults = "faults" in requested and self.has_faults
        # (nW,) float32 window starts and ends, hi[-1] = +inf.
        self.tel_lo, self.tel_hi = window_edges(self.telemetry.window_s, self.nW)
        # XLA turns the compiled step's division by the constant window_s
        # into a multiply by its float32 reciprocal (ROADMAP C).
        self.tel_inv_window = np.float32(1.0) / np.float32(self.telemetry.window_s)
        keys: list[str] = []
        if self.tel_throughput:
            keys.append("tel_sink_count")
        if self.tel_latency:
            keys += ["tel_sink_sum", "tel_sink_hist"]
        if self.tel_queue:
            keys.append("tel_srv_depth_int")
        if self.tel_util:
            keys.append("tel_srv_busy_int")
        if self.tel_rates:
            keys += ["tel_srv_completed", "tel_srv_dropped"]
            if self.has_deadlines:
                keys += ["tel_srv_timed_out", "tel_srv_retried"]
            if self.has_outages:
                keys.append("tel_srv_outage_dropped")
            if self.has_faults:
                keys.append("tel_srv_fault_dropped")
            if self.has_fault_retries:
                keys.append("tel_srv_fault_retried")
            if self.has_hedge:
                keys += ["tel_srv_hedged", "tel_srv_hedge_wins"]
            if model.limiters:
                keys += ["tel_lim_admitted", "tel_lim_dropped"]
            if self.has_transit:
                keys.append("tel_tr_dropped")
            if self.has_loss:
                keys.append("tel_net_lost")
            # The defenses' drop counters, and the breaker's open time
            # booked at trip time across the windows the interval spans.
            if self.has_breaker:
                keys += ["tel_srv_breaker_dropped", "tel_brk_tripped", "tel_brk_open_int"]
            if self.has_shed:
                keys.append("tel_srv_shed_dropped")
            if self.has_budget:
                keys.append("tel_srv_budget_dropped")
            if self.has_partitions:
                keys.append("tel_net_partitioned")
            if self.has_quorum:
                keys.append("tel_qrm_dropped")
            # The traced arrivals per (window, tenant).
            if self.has_trace:
                keys.append("tel_trc_arrivals")
        self.tel_keys = frozenset(keys)

    def _tel_init_state(self, R: int, dev) -> dict:
        """Zeroed per-replica window buffers, JAX's ``_tel_init_state``
        with the replica axis in front."""
        nW, nV, nK, nL = self.nW, self.nV, self.nK, self.nL
        shapes = {
            "tel_sink_count": (nW, nK), "tel_sink_sum": (nW, nK),
            "tel_sink_hist": (nW, nK, HIST_BINS),
            "tel_lim_admitted": (nW, nL), "tel_lim_dropped": (nW, nL),
            "tel_net_lost": (nW,), "tel_net_partitioned": (nW,),
            "tel_trc_arrivals": (nW, self.n_tenants),
        }
        state = {}
        for key in sorted(self.tel_keys):
            dtype = torch.float32 if key in _TEL_FLOAT_KEYS else torch.int32
            state[key] = torch.zeros((R, *shapes.get(key, (nW, nV))), dtype=dtype, device=dev)
        return state

    def _tel_edges(self, dev) -> tuple:
        """The (nW,) window starts and ends on ``dev``."""
        key = ("tel", str(torch.device(dev)))
        if key not in self._device_tables:
            self._device_tables[key] = (
                torch.from_numpy(self.tel_lo).to(dev),
                torch.from_numpy(self.tel_hi).to(dev),
            )
        return self._device_tables[key]

    def _tel_windex(self, t: torch.Tensor) -> torch.Tensor:
        """Each lane's window of time ``t``, as the compiled JAX step
        computes it: ``clip(int32(t * float32(1 / window_s)), 0, nW - 1)``
        (the host twin telemetry.window_index divides instead). Every site
        derives its window here."""
        w = (t * _f32(self.tel_inv_window, t.device)).to(torch.int32)
        return torch.clamp(w, 0, self.nW - 1).long()

    def _tel_overlap(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """``(R, nW)`` seconds of each lane's ``[lo, hi)`` inside each
        window (the last window is open-ended, so the pieces sum to
        ``hi - lo``)."""
        lo_w, hi_w = self._tel_edges(lo.device)
        return torch.clamp_min(
            torch.minimum(hi[:, None], hi_w[None, :]) - torch.maximum(lo[:, None], lo_w[None, :]),
            0.0,
        )

    def _tel_count(self, state, key: str, t, index: int, pred) -> None:
        """One windowed counter bump per lane: ``key[r, w(t), index] +=
        pred`` (JAX ``_tel_count``), a no-op where the model has no such
        buffer (gated as JAX gates it)."""
        if key not in self.tel_keys:
            return
        buf = state[key]
        width = buf.shape[2] if buf.dim() == 3 else 1
        cell = self._tel_windex(t) * width + index
        buf.view(buf.shape[0], -1).scatter_add_(1, cell[:, None], pred.to(torch.int32)[:, None])

    def _tel_integral(self, state, key: str, index: int, lo, hi, lanes) -> None:
        """Add each selected lane's ``[lo, hi)`` to server ``index``'s
        column of the time integral ``key``, split over the windows it
        spans (JAX adds ``where(pred, 1, 0) * overlap``)."""
        if key not in self.tel_keys:
            return
        column = state[key][:, :, index]
        column.copy_(torch.where(lanes[:, None], column + self._tel_overlap(lo, hi), column))

    def _tel_sink(self, state, measure, arrival_t, latency, k: int) -> None:
        """The step's sink-telemetry write (JAX ``_tel_apply_sink``): the
        delivery's count, latency and histogram bin, in the window of its
        arrival time, for the measured lanes (``latency`` is 0 on the
        others)."""
        if not (self.tel_throughput or self.tel_latency):
            return
        R = measure.shape[0]
        cell = (self._tel_windex(arrival_t) * self.nK + k)[:, None]
        one = measure.to(torch.int32)[:, None]
        if self.tel_throughput:
            state["tel_sink_count"].view(R, -1).scatter_add_(1, cell, one)
        if self.tel_latency:
            state["tel_sink_sum"].view(R, -1).scatter_add_(1, cell, latency[:, None])
            hist_cell = cell * HIST_BINS + _hist_bin(latency)[:, None].long()
            state["tel_sink_hist"].view(R, -1).scatter_add_(1, hist_cell, one)

    def _tel_fault_dark(self, final: dict) -> torch.Tensor:
        """Each replica's ``(nW, nV)`` expected dark seconds per window
        (the terms of JAX ``_tel_fault_integral``, whose fixed-point sum
        over replicas :func:`reduce_final` takes), from the sampled fault
        registers: a fault needs no events, so an event-driven integral
        would miss windows opening and closing between events. A replica
        whose own window coincides with a fired shared window counts the
        coincidence twice, as in JAX. The ``(r, nW, nV, W)`` overlaps are
        formed a chunk of replicas at a time; the fixed-point sum runs
        over every replica at once, so its bits do not depend on the
        chunking."""
        dev = final["flt_start"].device
        R, nV, W = final["flt_start"].shape
        horizon = _f32(self.horizon, dev)
        lo_w, hi_w = self._tel_edges(dev)
        lo = lo_w[None, :, None, None]
        hi = torch.minimum(hi_w, horizon)[None, :, None, None]
        participates = torch.as_tensor(self.faults.participates, device=dev).to(torch.float32)
        step = max(1, _FAULT_INTEGRAL_CHUNK // (self.nW * nV * max(W, self.faults.W_sh, 1)))
        parts = []
        for first in range(0, R, step):
            rows = slice(first, first + step)
            starts = final["flt_start"][rows, None, :, :]
            ends = torch.minimum(final["flt_end"][rows], horizon)[:, None, :, :]
            dark = torch.clamp_min(
                torch.minimum(ends, hi) - torch.maximum(starts, lo), 0.0
            ).sum(dim=-1)
            if self.faults.has_shared:
                sh_start = final["flt_sh_start"][rows, None, None, :]
                sh_end = torch.minimum(final["flt_sh_end"][rows], horizon)[:, None, None, :]
                shared = torch.clamp_min(
                    torch.minimum(sh_end, hi) - torch.maximum(sh_start, lo), 0.0
                ).sum(dim=-1)
                dark = dark + shared * participates
            parts.append(dark)
        return torch.cat(parts)

    def _edges(self):
        for s in self.model.sources:
            yield s.latency, s.downstream
        for v in self.model.servers:
            yield v.latency, v.downstream
        for lim in self.model.limiters:
            yield lim.latency, lim.downstream
        for r in self.model.routers:
            yield from zip(r.target_latencies, r.targets)

    def _reaches_server(self, ref: NodeRef) -> bool:
        if ref.kind == SERVER:
            return True
        if ref.kind == ROUTER:
            return any(t.kind == SERVER for t in self.model.routers[ref.index].targets)
        if ref.kind == LIMITER:
            down = self.model.limiters[ref.index].downstream
            return down is not None and self._reaches_server(down)
        return False

    # -- uniform-slot layout -------------------------------------------------
    def _router_hop_depth(self) -> int:
        """Longest chain of DIRECT router->router target edges, plus one:
        the most router hops a single delivery can take (server arrivals,
        sinks and transit parks end a delivery). 0 without routers."""
        memo: dict[int, int] = {}

        def depth(i: int) -> int:
            if i not in memo:
                nested = [
                    depth(t.index)
                    for t in self.model.routers[i].targets
                    if t.kind == ROUTER
                ]
                memo[i] = 1 + max(nested, default=0)
            return memo[i]

        return max((depth(i) for i in range(len(self.model.routers))), default=0)

    def _route_slot(self, hop: int) -> int:
        """The choice-draw slot of a router hop at nesting depth ``hop``
        (0 = the first router a delivery meets)."""
        return self.U_ROUTE_HOPS[min(hop, len(self.U_ROUTE_HOPS) - 1)]

    def _assign_uniform_slots(self) -> None:
        """Draw slots the topology consumes, in JAX's order: the arrival
        gap (a Poisson source), one route draw per router hop (any
        random or weighted router), the edge latency (any exponential
        edge), two service windows (a delivery arrival and a completion's
        queue pull can both sample service in one step), two more for
        the hedges' second samples on those two start paths (any hedged
        server), the packet-loss Bernoulli (any lossy edge), the backoff
        jitter (any jittered server), then the load shed's priority
        Bernoulli (a shed with priority_fraction > 0, so a shed without
        priorities keeps the stream). An M/M/1 has 3 draws per step. The
        order is the RNG stream layout."""
        slot = 0
        self.U_GAP: Optional[int] = None
        if self.arrival_is_poisson.any():
            self.U_GAP = slot
            slot += 1
        self.U_ROUTE_HOPS: tuple = ()
        if any(r.policy in ("random", "weighted") for r in self.model.routers):
            self.U_ROUTE_HOPS = tuple(range(slot, slot + self.hop_depth))
            slot += self.hop_depth
        self.U_LAT: Optional[int] = None
        if any(e.mean_s > 0 and e.kind == "exponential" for e in self.model.iter_edges()):
            self.U_LAT = slot
            slot += 1
        self.U_SVC1: Optional[int] = None
        self.U_SVC2: Optional[int] = None
        if self.model.servers and self.n_svc_draws > 0:
            self.U_SVC1 = slot
            slot += self.n_svc_draws
            self.U_SVC2 = slot
            slot += self.n_svc_draws
        self.U_HED1: Optional[int] = None
        self.U_HED2: Optional[int] = None
        if self.model.servers and self.n_svc_draws > 0 and self.has_hedge:
            self.U_HED1 = slot
            slot += self.n_svc_draws
            self.U_HED2 = slot
            slot += self.n_svc_draws
        self.U_LOSS: Optional[int] = None
        if self.has_loss:
            self.U_LOSS = slot
            slot += 1
        self.U_JIT: Optional[int] = None
        if self.has_jitter:
            self.U_JIT = slot
            slot += 1
        self.U_SHED: Optional[int] = None
        if self.has_shed and self.shed.priority_fraction > 0.0:
            self.U_SHED = slot
            slot += 1
        self.n_draws = max(slot, 1)

    # -- profile tables ------------------------------------------------------
    def _build_profile_tables(self) -> None:
        """Cumulative-rate grids of the profiled sources: Lambda(t), the
        integral of the rate over [0, t], by the trapezoid rule on a
        uniform float64 grid over the horizon, cast to float32. The next
        arrival solves Lambda(t') = Lambda(t) + E by two lookups (forward,
        then inverse), extrapolating at the final rate past the grid."""
        horizon = float(self.model.horizon_s)
        self.has_profile = np.array(
            [s.profile is not None and s.profile.kind != "constant"
             for s in self.model.sources],
            np.bool_,
        )
        n_grid = PROFILE_GRID_POINTS
        self.profile_times = np.zeros((self.nS, n_grid), np.float32)
        self.profile_cum = np.zeros((self.nS, n_grid), np.float32)
        self.profile_end_rate = np.zeros((self.nS,), np.float32)
        for i, source in enumerate(self.model.sources):
            if not self.has_profile[i]:
                continue
            grid = np.linspace(0.0, horizon, n_grid)
            rates = np.array([source.profile.rate_at(source.rate, t) for t in grid])
            cumulative = np.concatenate(
                [[0.0], np.cumsum((rates[1:] + rates[:-1]) / 2.0 * np.diff(grid))]
            )
            self.profile_times[i] = grid
            self.profile_cum[i] = cumulative
            self.profile_end_rate[i] = max(rates[-1], 1e-9)

    def profile_tensors(self, device) -> tuple:
        """The ``(nS, G)`` float32 time and cumulative tables on
        ``device``, made once per device and kept with the model."""
        key = str(torch.device(device))
        if key not in self._device_tables:
            self._device_tables[key] = (
                torch.from_numpy(self.profile_times).to(device),
                torch.from_numpy(self.profile_cum).to(device),
            )
        return self._device_tables[key]

    # -- state -------------------------------------------------------------
    def init_state(self, keys: torch.Tensor, params: dict, draw: bool = True) -> dict:
        """Per-replica state for ``keys`` ``(R, 2)`` uint32: the leaves of
        the JAX ``init_state``, each with a leading replica axis.
        ``draw=False`` builds the same leaves without drawing a uniform
        (the initial gaps zero, the fault and partition windows none
        fired): a template whose leaf names are read, not its values."""
        R = keys.shape[0]
        dev = keys.device
        nV, C, K, nK, nR, nL = self.nV, self.C, self.K, self.nK, self.nR, self.nL
        f32, i32 = torch.float32, torch.int32
        gaps = self._initial_gaps(keys, params) if draw else torch.zeros_like(params["src_rate"])
        if self.has_trace:
            # The traced source's first arrival is the trace's first
            # instant; its gap draw is discarded, so every other draw
            # keeps its slot.
            gaps[:, self.trace_src] = float(np.float32(self.trace_first_time))
        stop = torch.as_tensor(self.stop_after, device=dev)
        gaps = torch.where(gaps > stop, torch.full_like(gaps, INF), gaps)
        state = {
            "t": torch.zeros((R,), dtype=f32, device=dev),
            "key": keys.clone(),
            "src_next": gaps,
            "srv_slot_done": torch.full((R, nV, C), INF, dtype=f32, device=dev),
            "srv_slot_created": torch.zeros((R, nV, C), dtype=f32, device=dev),
            "srv_q_created": torch.zeros((R, nV, K), dtype=f32, device=dev),
            "srv_q_enq": torch.zeros((R, nV, K), dtype=f32, device=dev),
            "srv_q_head": torch.zeros((R, nV), dtype=i32, device=dev),
            "srv_q_len": torch.zeros((R, nV), dtype=i32, device=dev),
            "srv_dropped": torch.zeros((R, nV), dtype=i32, device=dev),
            "srv_outage_dropped": torch.zeros((R, nV), dtype=i32, device=dev),
            "srv_started": torch.zeros((R, nV), dtype=i32, device=dev),
            "srv_completed": torch.zeros((R, nV), dtype=i32, device=dev),
            "srv_timed_out": torch.zeros((R, nV), dtype=i32, device=dev),
            "srv_retried": torch.zeros((R, nV), dtype=i32, device=dev),
            "srv_busy_int": torch.zeros((R, nV), dtype=f32, device=dev),
            "srv_depth_int": torch.zeros((R, nV), dtype=f32, device=dev),
            "srv_wait_sum": torch.zeros((R, nV), dtype=f32, device=dev),
            "srv_wait_n": torch.zeros((R, nV), dtype=i32, device=dev),
            "rr_next": torch.zeros((R, nR), dtype=i32, device=dev),
            "lim_tokens": torch.as_tensor(self.lim_cap, device=dev).repeat(R, 1),
            "lim_last": torch.zeros((R, nL), dtype=f32, device=dev),
            "lim_admitted": torch.zeros((R, nL), dtype=i32, device=dev),
            "lim_dropped": torch.zeros((R, nL), dtype=i32, device=dev),
            "sink_count": torch.zeros((R, nK), dtype=i32, device=dev),
            "sink_sum": torch.zeros((R, nK), dtype=f32, device=dev),
            "sink_sq": torch.zeros((R, nK), dtype=f32, device=dev),
            "sink_hist": torch.zeros((R, nK, HIST_BINS), dtype=i32, device=dev),
            "events": torch.zeros((R,), dtype=i32, device=dev),
        }
        if self.has_attempts:
            state["srv_slot_attempt"] = torch.zeros((R, nV, C), dtype=i32, device=dev)
            state["srv_q_attempt"] = torch.zeros((R, nV, K), dtype=i32, device=dev)
        if self.has_transit:
            state["tr_time"] = torch.full((R, nV, self.TR), INF, dtype=f32, device=dev)
            state["tr_created"] = torch.zeros((R, nV, self.TR), dtype=f32, device=dev)
            state["tr_dropped"] = torch.zeros((R, nV), dtype=i32, device=dev)
            if self.has_backoff:
                state["tr_attempt"] = torch.zeros((R, nV, self.TR), dtype=i32, device=dev)
        if self.has_faults:
            # Each replica's fault timeline, drawn once from its key: a
            # fault needs no events of its own.
            state.update(self.faults.sample_state(keys, draw))
            state["srv_fault_dropped"] = torch.zeros((R, nV), dtype=i32, device=dev)
        if self.has_fault_retries:
            state["srv_fault_retried"] = torch.zeros((R, nV), dtype=i32, device=dev)
        if self.has_hedge:
            state["srv_hedged"] = torch.zeros((R, nV), dtype=i32, device=dev)
            state["srv_hedge_wins"] = torch.zeros((R, nV), dtype=i32, device=dev)
        if self.has_breaker:
            # State (0 closed, 1 open, 2 half-open), the exact sliding
            # window's ring of failure times (-inf: an empty slot) and its
            # cursor, the last trip time, the half-open probes admitted,
            # and the trip, open-time and drop ledgers.
            state["brk_state"] = torch.zeros((R, nV), dtype=i32, device=dev)
            state["brk_fail_t"] = torch.full((R, nV, self.brk_F), -INF, dtype=f32, device=dev)
            state["brk_fail_idx"] = torch.zeros((R, nV), dtype=i32, device=dev)
            state["brk_open_t"] = torch.zeros((R, nV), dtype=f32, device=dev)
            state["brk_probes"] = torch.zeros((R, nV), dtype=i32, device=dev)
            state["brk_tripped"] = torch.zeros((R, nV), dtype=i32, device=dev)
            state["brk_open_time"] = torch.zeros((R, nV), dtype=f32, device=dev)
            state["srv_breaker_dropped"] = torch.zeros((R, nV), dtype=i32, device=dev)
        if self.has_shed:
            state["srv_shed_dropped"] = torch.zeros((R, nV), dtype=i32, device=dev)
        if self.has_budget:
            # The token bucket is born full.
            state["bud_tokens"] = torch.full(
                (R, nV), float(np.float32(self.budget.burst)), dtype=f32, device=dev
            )
            state["bud_last"] = torch.zeros((R, nV), dtype=f32, device=dev)
            state["srv_budget_dropped"] = torch.zeros((R, nV), dtype=i32, device=dev)
        if self.has_loss:
            state["net_lost"] = torch.zeros((R,), dtype=i32, device=dev)
        if self.has_partitions:
            # Each replica's partition timeline, drawn once from its key
            # on its own salted stream.
            state.update(self.partitions.sample_state(keys, draw))
            state["net_partitioned"] = torch.zeros((R,), dtype=i32, device=dev)
        if self.has_quorum:
            state["qrm_dropped"] = torch.zeros((R, nV), dtype=i32, device=dev)
        if self.has_quorum or self.has_leader:
            # Pure functions of the members' dark windows: swept once.
            state.update(self._consensus_sweeps(state))
        if self.has_trace:
            # The read cursor (arrivals fired), the lane's own block count
            # (its RNG stream index, so stalls and resumes never shift
            # the keys), and the arrivals per tenant.
            state["trc_cursor"] = torch.zeros((R,), dtype=torch.uint32, device=dev)
            state["trc_blocks"] = torch.zeros((R,), dtype=i32, device=dev)
            state["trc_arrivals"] = torch.zeros((R, self.n_tenants), dtype=i32, device=dev)
        if self.has_telemetry:
            state.update(self._tel_init_state(R, dev))
        return state

    # -- consensus sweeps ------------------------------------------------------
    def _group_dark_intervals(self, state: dict, group) -> tuple:
        """``(R, len(group), K)`` starts and ends of each member's dark
        windows (JAX ``_group_dark_intervals``): its drop-mode fault
        windows (its own and, subscribed, the shared ones) and the windows
        of every partition group holding it, padded with +inf. Degrade
        faults and brownouts leave a member reachable."""
        R = state["t"].shape[0]
        dev = state["t"].device
        inf = torch.full((R, 1), INF, dtype=torch.float32, device=dev)
        per_starts, per_ends = [], []
        for v in group:
            starts, ends = [], []
            if self.has_faults and self.faults.drop_mode[v]:
                starts.append(state["flt_start"][:, v, :])
                ends.append(state["flt_end"][:, v, :])
                if self.faults.has_shared and self.faults.participates[v]:
                    starts.append(state["flt_sh_start"])
                    ends.append(state["flt_sh_end"])
            if self.has_partitions:
                for p in range(self.partitions.nP):
                    if self.partitions.member[p, v]:
                        starts.append(state["prt_start"][:, p, :])
                        ends.append(state["prt_end"][:, p, :])
            per_starts.append(torch.cat(starts or [inf], dim=1))
            per_ends.append(torch.cat(ends or [inf], dim=1))
        width = max(x.shape[1] for x in per_starts)

        def pad(x):
            return torch.cat([x, inf.expand(R, width - x.shape[1])], dim=1)

        return (
            torch.stack([pad(x) for x in per_starts], dim=1),
            torch.stack([pad(x) for x in per_ends], dim=1),
        )

    def _consensus_sweeps(self, state: dict) -> dict:
        """The quorum's dark time and the leader-election machine (JAX
        ``_consensus_sweeps``), swept over the sorted union of the
        members' window edges: between two edges the dark set is
        constant, so its value at the midpoint holds over the segment.
        The segments run in order, each a few torch ops over every
        replica at once, and the sums add one segment at a time, as JAX's
        scan does. The window integrals exist with telemetry."""
        out = {}
        R = state["t"].shape[0]
        dev = state["t"].device
        hz = _f32(self.horizon, dev)
        zero = torch.zeros((R, 1), dtype=torch.float32, device=dev)
        nW = self.nW if self.has_telemetry else 0

        def segments(edges):
            edges = torch.sort(torch.clamp(edges, 0.0, float(self.horizon)), dim=1).values
            return edges[:, :-1], edges[:, 1:]

        def dark_at(starts, ends, t0, t1):
            mid = 0.5 * (t0 + t1)
            inside = (mid[:, None, None] >= starts) & (mid[:, None, None] < ends)
            return inside.any(dim=2)

        if self.has_quorum:
            starts, ends = self._group_dark_intervals(state, self.quorum.group)
            t0s, t1s = segments(
                torch.cat([zero, starts.flatten(1), ends.flatten(1), zero + hz], dim=1)
            )
            n_members = len(self.quorum.group)
            dark_time = torch.zeros((R,), dtype=torch.float32, device=dev)
            tel = torch.zeros((R, nW), dtype=torch.float32, device=dev)
            for e in range(t0s.shape[1]):
                t0, t1 = t0s[:, e], t1s[:, e]
                alive = n_members - dark_at(starts, ends, t0, t1).sum(dim=1)
                qdark = (alive < self.qrm_write).to(torch.float32)
                dark_time = dark_time + torch.clamp_min(t1 - t0, 0.0) * qdark
                if nW:
                    tel = tel + self._tel_overlap(t0, t1) * qdark[:, None]
            out["qrm_dark_time"] = dark_time
            if nW:
                out["tel_qrm_dark_int"] = tel
        if self.has_leader:
            starts, ends = self._group_dark_intervals(state, self.ldr_group)
            delay = _f32(self.ldr_delay, dev)
            # The t = 0 sentinel's shifted copy covers the first election's
            # deadline; each shifted edge is the same float32 add that arms
            # a deadline, so every deadline falls on a segment boundary.
            base = torch.cat([zero, starts.flatten(1), ends.flatten(1)], dim=1)
            t0s, t1s = segments(torch.cat([base, base + delay, zero + hz], dim=1))
            idxs = torch.arange(len(self.ldr_group), dtype=torch.int32, device=dev)
            leader = torch.full((R,), -1, dtype=torch.int32, device=dev)
            pend = delay.expand(R).clone()  # the first election's deadline
            changes = torch.zeros((R,), dtype=torch.int32, device=dev)
            noleader = torch.zeros((R,), dtype=torch.float32, device=dev)
            upt = torch.zeros((R, nW), dtype=torch.float32, device=dev)
            for e in range(t0s.shape[1]):
                t0, t1 = t0s[:, e], t1s[:, e]
                alive = ~dark_at(starts, ends, t0, t1)
                any_alive = alive.any(dim=1)
                # 1. A pending election completes at its deadline: the
                #    highest-index live member wins (none: still leaderless).
                fire = pend <= t0
                elect = torch.where(alive, idxs, -1).amax(dim=1).to(torch.int32)
                leader = torch.where(fire, elect, leader)
                changes += (fire & (elect >= 0)).to(torch.int32)
                pend = torch.where(fire, INF, pend)
                # 2. The leader back: no pending detection.
                leader_alive = (alive & (idxs == leader[:, None])).any(dim=1)
                pend = torch.where((leader >= 0) & leader_alive, INF, pend)
                # 3. Leaderless: a dark leader arms its detection deadline,
                #    a vacant seat arms once any member is live.
                leaderless = (leader < 0) | ~leader_alive
                arm = leaderless & ((leader >= 0) | any_alive) & torch.isinf(pend)
                pend = torch.where(arm, t0 + delay, pend)
                # 4. The segment's leaderless time and uptime.
                frac = leaderless.to(torch.float32)
                noleader = noleader + torch.clamp_min(t1 - t0, 0.0) * frac
                if nW:
                    upt = upt + self._tel_overlap(t0, t1) * (1.0 - frac)[:, None]
            out["ldr_changes"] = changes
            out["ldr_noleader_time"] = noleader
            if nW:
                out["tel_ldr_uptime_int"] = upt
        return out

    def _initial_gaps(self, keys: torch.Tensor, params: dict) -> torch.Tensor:
        u = rng.uniform(keys, (self.nS,), minval=1e-12, maxval=1.0)
        rate = params["src_rate"]
        poisson_gap = -torch.log(u) / rate
        constant_gap = torch.ones_like(rate) / rate
        poisson = torch.as_tensor(self.arrival_is_poisson, device=rate.device)
        flat = torch.where(poisson, poisson_gap, constant_gap)
        if not self.has_profile.any():
            return flat
        # Profiled sources invert their integral table from t = 0.
        zero = torch.zeros_like(flat[:, 0])
        gaps = []
        for i in range(self.nS):
            if self.has_profile[i]:
                target = -torch.log(u[:, i]) if self.arrival_is_poisson[i] else zero + 1.0
                gaps.append(self._invert_profile(i, zero, target))
            else:
                gaps.append(flat[:, i])
        return torch.stack(gaps, dim=1)

    # -- sampling ----------------------------------------------------------
    def _service_terms(self, u, base: Optional[int], v: int, params):
        """One service draw per lane for server ``v`` from the
        ``n_svc_draws``-wide window at ``base`` (uniforms ua, ub, uc), by
        its family, as JAX's ``_sample_service`` computes it, as the two
        factors ``(x, y)`` of its last multiply: the service is ``x * y``
        (a constant one is ``mean * 1``), which :func:`_fused` adds to a
        time. JAX selects among the families present by kind; the draw is
        the one of server ``v``'s own kind. With several families present
        the select sits between the multiply and any add, and the terms
        are ``(x * y, 1)``."""
        x, y = self._family_terms(u, base, v, params)
        if len(self.families_present) > 1:
            return x * y, torch.ones_like(x)
        return x, y

    def _family_terms(self, u, base: Optional[int], v: int, params):
        mean = params["srv_mean"][:, v]
        kind = int(self.service_kind[v])
        dev = mean.device
        if kind == 0:
            return mean, _f32(1.0, dev)
        ua = u[:, base]
        if kind == 1:
            return -torch.log(ua), mean
        if kind == 2:
            if self.srv_erlang_k[v] == 2.0:
                return -torch.log(ua * u[:, base + 1]) * mean, _f32(0.5, dev)
            # XLA rewrites JAX's "/ 3.0" as a multiply by float32(1/3).
            product = ua * u[:, base + 1] * u[:, base + 2]
            return -torch.log(product) * mean, _f32(1.0 / 3.0, dev)
        if kind == 3:
            factor = torch.where(
                ua < _f32(self.srv_hyp_p1[v], dev),
                _f32(self.srv_hyp_f1[v], dev),
                _f32(self.srv_hyp_f2[v], dev),
            )
            return -torch.log(u[:, base + 1]) * mean, factor
        if kind == 4:
            sigma = _f32(self.srv_ln_sigma[v], dev)
            z = _f32(_SQRT2, dev) * erfinv(2.0 * ua - 1.0)
            return mean, torch.exp(sigma * z - 0.5 * sigma * sigma)
        alpha = _f32(self.srv_par_alpha[v], dev)
        return mean * _f32(self.srv_par_xmf[v], dev), torch.pow(ua, -1.0 / alpha)

    def _sample_service(self, u, base: Optional[int], v: int, params):
        """The service draw of :meth:`_service_terms`, ``x * y``."""
        x, y = self._service_terms(u, base, v, params)
        return x * y

    def _profile_cum_at(self, i: int, t):
        """Lambda_i(t), extrapolated at the final rate past the grid."""
        times, cum = (table[i] for table in self.profile_tensors(t.device))
        inside = interp(t, times, cum)
        end_rate = _f32(self.profile_end_rate[i], t.device)
        beyond = fma_f32(t - times[-1], end_rate.expand_as(t), cum[-1].expand_as(t))
        return torch.where(t <= times[-1], inside, beyond)

    def _invert_profile(self, i: int, t, target_increment):
        """Gap g such that Lambda_i(t+g) - Lambda_i(t) = target_increment."""
        times, cum = (table[i] for table in self.profile_tensors(t.device))
        target = self._profile_cum_at(i, t) + target_increment
        inside = interp(target, cum, times)
        beyond = times[-1] + (target - cum[-1]) / _f32(self.profile_end_rate[i], t.device)
        t_next = torch.where(target <= cum[-1], inside, beyond)
        return torch.clamp_min(t_next - t, 1e-9)

    def _sample_gap(self, u, i: int, t, params):
        poisson = self.arrival_is_poisson[i]
        if self.has_profile[i]:
            increment = -torch.log(u[:, self.U_GAP]) if poisson else torch.ones_like(t)
            return self._invert_profile(i, t, increment)
        rate = params["src_rate"][:, i]
        if poisson:
            return -torch.log(u[:, self.U_GAP]) / rate
        return torch.ones_like(rate) / rate

    def _edge_arrival(self, edge: EdgeLatency, t, u, routed: bool = False):
        """``t`` plus the edge's latency draw (JAX ``_sample_edge``): a
        free edge adds nothing, a constant edge its mean, an exponential
        edge ``-log(u) * mean`` from the U_LAT slot, rounded once with the
        add on an edge out of a source, a server or a limiter; behind a
        router JAX selects among the targets' draws first (``routed``)."""
        if edge.mean_s <= 0:
            return t
        mean = _f32(edge.mean_s, t.device)
        if edge.kind != "exponential":
            return t + mean
        draw = -torch.log(u[:, self.U_LAT])
        return t + draw * mean if routed else _fused(t, (draw, mean))

    # -- chaos helpers -------------------------------------------------------
    def _edge_lost(self, u, t, loss_p, loss_start, loss_end) -> torch.Tensor:
        """The packet-loss Bernoulli of one crossing at ``t``: the U_LOSS
        draw below ``loss_p`` inside [loss_start, loss_end). The three
        may be per-lane tensors (a router's chosen edge) or floats."""
        p, start, end = (
            x if isinstance(x, torch.Tensor) else _f32(x, t.device)
            for x in (loss_p, loss_start, loss_end)
        )
        return (u[:, self.U_LOSS] < p) & (t >= start) & (t < end)

    def _backoff_arrival(self, u, attempt, v: int, t):
        """When server ``v``'s retry re-arrives: ``t + backoff * 2^attempt
        * (1 + jitter * (u - 0.5))``, u the U_JIT draw (0.5 without jitter
        anywhere), so the mean delay is backoff * 2^attempt whatever the
        jitter. Rounded as the compiled JAX step rounds it: XLA's CPU
        backend contracts both ``1 + jitter * (u - 0.5)`` and ``t + delay
        * spread`` into multiply-adds (ROADMAP C)."""
        dev = attempt.device
        u_jit = u[:, self.U_JIT] if self.U_JIT is not None else _f32(0.5, dev).expand_as(t)
        one = _f32(1.0, dev).expand_as(t)
        spread = fma_f32(_f32(self.srv_jitter[v], dev).expand_as(t), u_jit - 0.5, one)
        scale = _f32(self.srv_backoff[v], dev) * torch.exp2(attempt.to(torch.float32))
        return fma_f32(scale, spread, t)

    def _degrade_factor(self, v: int, dark) -> Optional[torch.Tensor]:
        """The service multiplier of a degraded server ``v`` (its latency
        factor while dark, else 1), or None where no window inflates."""
        if dark is None or not self.faults.degrade[v] or self.faults.lat_factor[v] <= 1.0:
            return None
        one = _f32(1.0, dark.device)
        return torch.where(dark, _f32(self.faults.lat_factor[v], dark.device), one)

    def _hedge(self, service, second, v: int, allowed=None):
        """A hedge on server ``v``: a second attempt (of terms ``second``)
        launches when the first runs past the hedge delay h (and, with a
        retry budget, a token is there: ``allowed``); the slot is held for
        min(S1, h + S2), and the hedge wins when h + S2 < S1 strictly.
        Returns (service, hedged, won, would): ``would`` ignores the
        budget."""
        h = _f32(self.srv_hedge[v], service.device)
        would = service > h
        hedged = would if allowed is None else would & allowed
        raced = _fused(h.expand_as(service), second)
        won = hedged & (raced < service)
        return torch.where(hedged, torch.minimum(service, raced), service), hedged, won, would

    # -- resilience helpers ----------------------------------------------------
    # JAX's _breaker_* and _budget_* helpers, written for server v and the
    # lanes a site selects (JAX masks by the server's one-hot row).
    def _breaker_effective(self, state, lanes, v: int, t) -> torch.Tensor:
        """Server ``v``'s breaker state as consulted at ``t``: an open
        breaker whose cooldown has run out reads as half-open with a fresh
        probe quota, written back for ``lanes`` (no timer event needed).
        Returns the ``(R,)`` effective state."""
        bst = state["brk_state"][:, v]
        cooldown = _f32(self.breaker.cooldown_s, t.device)
        cooled = (bst == 1) & (t >= state["brk_open_t"][:, v] + cooldown)
        write = lanes & cooled
        state["brk_probes"][:, v] = torch.where(write, 0, state["brk_probes"][:, v])
        effective = torch.where(cooled, 2, bst)
        state["brk_state"][:, v] = torch.where(write, effective, bst)
        return effective

    def _breaker_record_failure(self, state, v: int, t, failure, bst) -> None:
        """Book the ``failure`` lanes against server ``v``'s breaker, in
        effective state ``bst``: a closed breaker writes the failure time
        at the ring's cursor and trips when the oldest of the F most
        recent failures lies within ``window_s`` (an exact sliding
        window; an empty slot is -inf and never trips); a half-open one
        re-trips at once. A trip resets the ring and books its open
        interval ``min(cooldown, max(horizon - t, 0))`` at once, whole
        and across the telemetry windows it spans: the breaker leaves
        the open state by its cooldown alone."""
        dev = t.device
        F = self.brk_F
        idx = state["brk_fail_idx"][:, v]
        record = failure & (bst == 0)
        ring = state["brk_fail_t"][:, v, :]
        _set_at(ring, idx, record, t)
        cursor = torch.remainder(idx + 1, F)
        oldest = ring.gather(1, cursor.long()[:, None])[:, 0]
        window = _f32(self.breaker.window_s, dev)
        trip = (record & (oldest > t - window)) | (failure & (bst == 2))
        open_len = torch.minimum(
            _f32(self.breaker.cooldown_s, dev), torch.clamp_min(_f32(self.horizon, dev) - t, 0.0)
        )
        ring.copy_(torch.where(trip[:, None], torch.full_like(ring, -INF), ring))
        state["brk_fail_idx"][:, v] = torch.where(trip, 0, torch.where(record, cursor, idx))
        state["brk_state"][:, v] = torch.where(trip, 1, state["brk_state"][:, v])
        state["brk_open_t"][:, v] = torch.where(trip, t, state["brk_open_t"][:, v])
        state["brk_probes"][:, v] = torch.where(trip, 0, state["brk_probes"][:, v])
        state["brk_tripped"][:, v] += trip.to(torch.int32)
        open_time = state["brk_open_time"][:, v]
        state["brk_open_time"][:, v] = torch.where(trip, open_time + open_len, open_time)
        self._tel_count(state, "tel_brk_tripped", t, v, trip)
        self._tel_integral(state, "tel_brk_open_int", v, t, t + open_len, trip)

    def _breaker_close_on_success(self, state, v: int, success, bst) -> None:
        """A half-open breaker that has admitted a probe closes on a
        ``success`` lane (ring, cursor and probes reset); a success in
        any other state changes nothing."""
        close = success & (bst == 2) & (state["brk_probes"][:, v] > 0)
        state["brk_state"][:, v] = torch.where(close, 0, state["brk_state"][:, v])
        ring = state["brk_fail_t"][:, v, :]
        ring.copy_(torch.where(close[:, None], torch.full_like(ring, -INF), ring))
        state["brk_fail_idx"][:, v] = torch.where(close, 0, state["brk_fail_idx"][:, v])
        state["brk_probes"][:, v] = torch.where(close, 0, state["brk_probes"][:, v])

    def _budget_refresh(self, state, lanes, v: int, t, credit) -> torch.Tensor:
        """Refill server ``v``'s retry-budget bucket for ``lanes`` at ``t``:
        ``min(tokens + (t - last) * min_per_s + credit, burst)``, the
        first multiply-add rounded once as XLA's CPU backend contracts it
        in the JAX step (ROADMAP C); ``credit`` is ``ratio`` on a first
        attempt's arrival, else 0. Returns the ``(R,)`` tokens."""
        dev = t.device
        tokens = state["bud_tokens"][:, v]
        last = state["bud_last"][:, v]
        rate = _f32(self.budget.min_per_s, dev).expand_as(t)
        refilled = torch.minimum(
            fma_f32(t - last, rate, tokens) + credit, _f32(self.budget.burst, dev)
        )
        state["bud_tokens"][:, v] = torch.where(lanes, refilled, tokens)
        state["bud_last"][:, v] = torch.where(lanes, t, last)
        return refilled

    def _budget_debit(self, state, v: int, launched) -> None:
        """One token per launch that really happens (a retry bounced by
        full transit registers or a full queue is a drop, not a launch)."""
        tokens = state["bud_tokens"][:, v]
        state["bud_tokens"][:, v] = torch.where(launched, tokens - 1.0, tokens)

    def _book_budget_dropped(self, state, v: int, t, suppressed) -> None:
        """The one booking of a launch the budget suppressed, shared by
        the four launch sites."""
        state["srv_budget_dropped"][:, v] += suppressed.to(torch.int32)
        self._tel_count(state, "tel_srv_budget_dropped", t, v, suppressed)

    # -- job delivery ------------------------------------------------------
    def _deliver(
        self, state, desc, lanes, t, created, u, dest: NodeRef, edge: EdgeLatency,
        params, hop: int = 0, park: bool = False, routed: bool = False,
    ):
        """Hand a job leaving a node at ``t`` to ``dest`` across ``edge``
        (JAX ``_deliver`` / ``_deliver_chosen``). A server behind a
        latency edge, or behind a router with any latency-carrying target
        edge (``park``), is reached through its transit slots. ``hop``
        counts the router hops this delivery has taken; ``routed`` marks
        an edge out of a router. A lossy edge
        (into a sink or a server only) vanishes the crossing with its
        probability inside its window: ``net_lost`` counts it and nothing
        else changes."""
        if edge.loss_p > 0.0:
            lost = lanes & self._edge_lost(
                u, t, float(np.float32(edge.loss_p)), edge.loss_start_s, edge.loss_end_s
            )
            state["net_lost"] += lost.to(torch.int32)
            self._tel_count(state, "tel_net_lost", t, 0, lost)
            lanes = lanes & ~lost
        if dest.kind == LIMITER:
            self._through_limiter(state, desc, lanes, t, created, u, dest.index, params, hop)
        elif dest.kind == SINK:
            arrival = self._edge_arrival(edge, t, u, routed)
            self._deliver_sink(state, lanes, arrival, created, dest.index)
        elif dest.kind == SERVER:
            crossing = park or edge.mean_s > 0
            arrival = self._edge_arrival(edge, t, u, routed) if crossing else t
            if self.has_partitions and self.partitions.touched[dest.index]:
                lanes = self._partition_select(state, lanes, dest.index, t, arrival, created)
            if crossing:
                self._into_transit(state, lanes, dest.index, arrival, created)
            else:
                self._arrive_server(state, desc, lanes, dest.index, t, created, u, params)
        else:
            self._through_router(state, desc, lanes, t, created, u, dest.index, params, hop)

    def _partition_select(self, state, lanes, v: int, t, arrival, created):
        """The partition consult of a delivery into server ``v`` sent at
        ``t`` (JAX ``_partition_select``), after any packet loss: under a
        drop-mode cut the delivery vanishes and ``net_partitioned`` counts
        it; under a delay-mode cut it parks in ``v``'s transit registers
        until ``arrival`` plus the cut's delay. Returns the lanes whose
        delivery goes on; a job already crossing when a cut opens arrives
        as usual (transit arrivals do not consult)."""
        dark, drop, delay = self.partitions.consult(state, v, t)
        cut = lanes & dark & drop
        state["net_partitioned"] += cut.to(torch.int32)
        self._tel_count(state, "tel_net_partitioned", t, 0, cut)
        if self.partitions.has_delay:
            self._into_transit(state, lanes & dark & ~drop, v, arrival + delay, created)
        return lanes & ~dark

    def _through_router(self, state, desc, lanes, t, created, u, r: int, params, hop: int):
        """One router hop: choose a target per lane, advance the
        round-robin cursor, then deliver each target's lanes. JAX computes
        every target and selects per lane; delivering each target to the
        lanes that chose it computes the same thing."""
        router = self.model.routers[r]
        choice = self._route_choice(state, u, r, router, hop)
        if router.policy == "round_robin":
            state["rr_next"][:, r] += lanes.to(torch.int32)
        if any(e.loss_p > 0.0 for e in router.target_latencies):
            # The choice is made (and round-robin advanced), then the
            # crossing is lost with the chosen edge's probability.
            def column(attr):
                values = [getattr(e, attr) for e in router.target_latencies]
                return torch.as_tensor(np.asarray(values, np.float32), device=u.device)[choice]

            lost = lanes & self._edge_lost(
                u, t, column("loss_p"), column("loss_start_s"), column("loss_end_s")
            )
            state["net_lost"] += lost.to(torch.int32)
            self._tel_count(state, "tel_net_lost", t, 0, lost)
            lanes = lanes & ~lost
        park = any(e.mean_s > 0 for e in router.target_latencies)
        for i, (target, edge) in enumerate(zip(router.targets, router.target_latencies)):
            picked = lanes & (choice == i)
            if target.kind == ROUTER:
                self._deliver(state, desc, picked, t, created, u, target, edge, params, hop + 1)
            else:
                self._deliver(
                    state, desc, picked, t, created, u, target, edge, params, hop,
                    park=park, routed=True,
                )

    def _route_choice(self, state, u, r: int, router, hop: int) -> torch.Tensor:
        """The chosen target index per lane (JAX ``_route_choice``)."""
        n = len(router.targets)
        dev = u.device
        if router.policy == "random":
            scaled = u[:, self._route_slot(hop)] * n
            return torch.clamp_max(scaled.to(torch.int32), n - 1)
        if router.policy == "weighted":
            # cum is formed in float64 and cast once, as in JAX.
            weights = np.asarray(router.weights, np.float64)
            cum = torch.as_tensor(
                (np.cumsum(weights) / weights.sum()).astype(np.float32), device=dev
            )
            draw = u[:, self._route_slot(hop)]
            return torch.clamp_max((draw[:, None] >= cum[None, :]).sum(dim=1), n - 1)
        if router.policy == "round_robin":
            return torch.remainder(state["rr_next"][:, r], n)
        # least_outstanding: in-service plus queued per target server, read
        # after a completing slot was freed; argmin keeps the first index.
        index = [ref.index for ref in router.targets]
        valid = torch.as_tensor(self.slot_valid[index], device=dev)
        busy = (torch.isfinite(state["srv_slot_done"][:, index, :]) & valid).sum(dim=2)
        return torch.argmin(busy + state["srv_q_len"][:, index], dim=1)

    def _through_limiter(self, state, desc, lanes, t, created, u, l: int, params, hop: int):
        """Token-bucket admission, inline: refill, spend a token or drop.
        A dropped job changes only the limiter's own leaves."""
        dev = t.device
        tokens = state["lim_tokens"][:, l]
        last = state["lim_last"][:, l]
        rate = _f32(self.lim_rate[l], dev).expand_as(tokens)
        refilled = torch.minimum(_fused(tokens, (t - last, rate)), _f32(self.lim_cap[l], dev))
        admit = refilled >= 1.0
        state["lim_tokens"][:, l] = torch.where(
            lanes, torch.where(admit, refilled - 1.0, refilled), tokens
        )
        state["lim_last"][:, l] = torch.where(lanes, t, last)
        state["lim_admitted"][:, l] += (lanes & admit).to(torch.int32)
        state["lim_dropped"][:, l] += (lanes & ~admit).to(torch.int32)
        self._tel_count(state, "tel_lim_admitted", t, l, lanes & admit)
        self._tel_count(state, "tel_lim_dropped", t, l, lanes & ~admit)
        limiter = self.model.limiters[l]
        self._deliver(
            state, desc, lanes & admit, t, created, u, limiter.downstream,
            limiter.latency, params, hop,
        )

    def _into_transit(self, state, lanes, v: int, arrival_t, created, attempt=None):
        """Park a job on a latency edge in server ``v``'s first free
        transit slot until its arrival fires; with none free the job is
        lost and ``tr_dropped`` counts it. Backoff retries park here too,
        with their ``attempt`` (0 for a job crossing an edge)."""
        row = state["tr_time"][:, v, :]
        free = torch.isinf(row)
        has_free = free.any(dim=1)
        first_free = torch.argmax(free.to(torch.int32), dim=1)
        parked = lanes & has_free
        _set_at(row, first_free, parked, arrival_t)
        _set_at(state["tr_created"][:, v, :], first_free, parked, created)
        if self.has_backoff:
            if attempt is None:
                attempt = torch.zeros_like(first_free, dtype=torch.int32)
            _set_at(state["tr_attempt"][:, v, :], first_free, parked, attempt)
        state["tr_dropped"][:, v] += (lanes & ~has_free).to(torch.int32)
        # Windowed at the would-be arrival, as JAX books it.
        self._tel_count(state, "tel_tr_dropped", arrival_t, v, lanes & ~has_free)

    def _deliver_sink(self, state, lanes, arrival_t, created, k: int):
        """Latency accounting at sink ``k``; only arrivals inside
        [warmup, horizon] are measured."""
        dev = arrival_t.device
        measure = (
            lanes
            & (arrival_t >= _f32(self.warmup, dev))
            & (arrival_t <= _f32(self.horizon, dev))
        )
        latency = torch.where(measure, arrival_t - created, torch.zeros_like(created))
        state["sink_count"][:, k] += measure.to(torch.int32)
        sink_sum = state["sink_sum"][:, k]
        state["sink_sum"][:, k] = torch.where(measure, sink_sum + latency, sink_sum)
        sink_sq = state["sink_sq"][:, k]
        state["sink_sq"][:, k] = torch.where(
            measure, _fused(sink_sq, (latency, latency)), sink_sq
        )
        state["sink_hist"][:, k, :].scatter_add_(
            1, _hist_bin(latency)[:, None].long(), measure.to(torch.int32)[:, None]
        )
        if self.has_telemetry:
            self._tel_sink(state, measure, arrival_t, latency, k)

    def _push(self, desc, lanes, pred, v: int, slot, created, t, attempt) -> None:
        """Describe the step's queue push for ``lanes`` (written by
        :meth:`_apply_qpush` after the step)."""
        desc["pred"] = torch.where(lanes, pred, desc["pred"])
        desc["v"] = torch.where(lanes, torch.full_like(desc["v"], v), desc["v"])
        desc["slot"] = torch.where(lanes, slot.long(), desc["slot"])
        desc["created"] = torch.where(lanes, created, desc["created"])
        desc["enq"] = torch.where(lanes, t, desc["enq"])
        if self.has_attempts:
            desc["attempt"] = torch.where(lanes, attempt, desc["attempt"])

    def _arrive_server(self, state, desc, lanes, v: int, t, created, u, params, attempt=None):
        """One job arriving at server ``v`` with its ``attempt`` number
        (None: a first attempt): start in the first free slot, else
        enqueue at the ring tail, else drop. The gates come first: an
        open breaker (or a half-open one whose probes are spent) rejects
        the arrival before the server sees it (``srv_breaker_dropped``);
        a brownout window loses it (``srv_outage_dropped``); an
        outage-mode fault window rejects it, and with backoff retries,
        attempts and a budget token left it is parked for a re-arrival
        after the backoff, else it is a terminal ``srv_fault_dropped``; a
        load shed rejects what passed those (``srv_shed_dropped``). A
        degrade-mode window caps the active slots and inflates service; a
        hedged server races a second sample when the budget allows it.
        The brownout and fault rejections are the breaker's failures."""
        dev = t.device
        if attempt is None:
            attempt = torch.zeros_like(lanes, dtype=torch.int32)
        no = torch.zeros_like(lanes)
        brk_short = no
        if self.has_breaker:
            bst = self._breaker_effective(state, lanes, v, t)
            probe_ok = state["brk_probes"][:, v] < int(self.breaker.half_open_probes)
            brk_short = lanes & ((bst == 1) | ((bst == 2) & ~probe_ok))
            # The probe quota is spent below, only by an arrival that
            # takes a slot or a queue place.
            probe = (bst == 2) & probe_ok
            state["srv_breaker_dropped"][:, v] += brk_short.to(torch.int32)
            self._tel_count(state, "tel_srv_breaker_dropped", t, v, brk_short)
        bud_ok = None
        if self.has_budget:
            # A first attempt credits ``ratio`` tokens.
            credit = torch.where(
                attempt == 0, _f32(self.budget.ratio, dev), _f32(0.0, dev)
            )
            bud_ok = self._budget_refresh(state, lanes, v, t, credit) >= 1.0
        done_row = state["srv_slot_done"][:, v, :]
        valid = torch.as_tensor(self.slot_valid[v], device=dev)
        free = valid[None, :] & torch.isinf(done_row)
        fault_dark = None  # inside a fault window (a faulted server only)
        if self.has_faults and self.faults.faulted[v]:
            fault_dark = self.faults.dark(state, v, t)
        cap = int(self.faults.cap_slots[v])
        if fault_dark is not None and self.faults.degrade[v] and cap < self.srv_concurrency[v]:
            # No new start while dark and `cap` jobs are already active.
            busy_count = (torch.isfinite(done_row) & valid[None, :]).sum(dim=1)
            free = free & (~fault_dark | (busy_count < cap))[:, None]
        has_free = free.any(dim=1)
        first_free = torch.argmax(free.to(torch.int32), dim=1)
        terms = self._service_terms(u, self.U_SVC1, v, params)
        factor = self._degrade_factor(v, fault_dark)
        if factor is None and self.has_faults and self.faults.has_degrade_lat:
            # JAX multiplies every server's arrivals by its factor, 1 here.
            factor = _f32(1.0, dev)
        if factor is not None:
            terms = (terms[0] * terms[1], factor)
        hedged = won = would = None
        if self.has_hedge and np.isfinite(self.srv_hedge[v]):
            second = self._service_terms(u, self.U_HED1, v, params)
            if factor is not None:
                second = (second[0] * second[1], factor)
            raced, hedged, won, would = self._hedge(terms[0] * terms[1], second, v, bud_ok)
            terms = (raced, _f32(1.0, dev))
        elif self.has_hedge:
            # JAX's hedge select sits before the add at every server's
            # arrival in a model with a hedge.
            terms = (terms[0] * terms[1], _f32(1.0, dev))
        service = terms[0] * terms[1]
        done_at = _fused(t, terms)
        spec = self.model.servers[v]
        dark = no
        if spec.outage_start_s is not None:
            dark = (t >= _f32(self.srv_outage_start[v], dev)) & (
                t < _f32(self.srv_outage_end[v], dev)
            ) & ~brk_short
        # An arrival inside both a brownout and a fault window is only an
        # outage drop: the two ledgers stay disjoint.
        fault_rejected = no
        if fault_dark is not None and self.faults.drop_mode[v]:
            fault_rejected = fault_dark & ~dark & ~brk_short
        quorum_rejected = no
        if self.has_quorum and self.qrm_member[v]:
            # Fewer than `write` members reachable: a member rejecting for
            # its own reasons first is not a quorum rejection.
            quorum_rejected = (self._quorum_alive(state, t) < self.qrm_write) & ~(
                dark | fault_rejected | brk_short
            )
        retryable = (fault_rejected if self.flt_can_retry[v] else no) | (
            quorum_rejected if self.qrm_can_retry[v] else no
        )
        retry = blocked = no
        if self.flt_can_retry[v] or self.qrm_can_retry[v]:
            retry = retryable & (attempt < int(self.srv_max_retries[v]))
            if bud_ok is not None:
                # Without a token the retry is not launched: the job is a
                # terminal rejection, and the launch a budget drop.
                blocked = retry & ~bud_ok
                retry = retry & bud_ok
        rejected = dark | fault_rejected | brk_short | quorum_rejected
        q_len = state["srv_q_len"][:, v]
        shed = no
        if self.has_shed:
            if self.shed.policy == "queue_depth":
                shed = q_len >= int(self.shed.threshold)
            else:
                busy = (torch.isfinite(done_row) & valid[None, :]).sum(dim=1)
                shed = busy.to(torch.float32) >= _f32(self.shed_busy_thr[v], dev)
            if self.U_SHED is not None:
                # Priority traffic is never shed.
                shed = shed & (u[:, self.U_SHED] >= _f32(self.shed.priority_fraction, dev))
            shed = lanes & shed & ~rejected
            rejected = rejected | shed
        if self.has_breaker:
            self._breaker_record_failure(
                state, v, t, lanes & (dark | fault_rejected | quorum_rejected), bst
            )
        if self.has_quorum:
            # Every rejection counts, retried or not.
            state["qrm_dropped"][:, v] += (lanes & quorum_rejected).to(torch.int32)
            self._tel_count(state, "tel_qrm_dropped", t, v, lanes & quorum_rejected)
        has_room = q_len < int(self.queue_cap[v])
        tail = torch.remainder(state["srv_q_head"][:, v] + q_len, self.K)
        start = lanes & has_free & ~rejected
        enq = lanes & ~rejected & ~has_free & has_room
        drop = lanes & ~rejected & ~has_free & ~has_room
        measured = start & (t >= _f32(self.warmup, dev))

        self._push(desc, lanes, enq, v, tail, created, t, attempt)
        _set_at(done_row, first_free, start, done_at)
        _set_at(state["srv_slot_created"][:, v, :], first_free, start, created)
        if self.has_attempts:
            _set_at(state["srv_slot_attempt"][:, v, :], first_free, start, attempt)
        state["srv_started"][:, v] += start.to(torch.int32)
        state["srv_wait_n"][:, v] += measured.to(torch.int32)
        busy = state["srv_busy_int"][:, v]
        state["srv_busy_int"][:, v] = torch.where(measured, busy + service, busy)
        state["srv_q_len"][:, v] += enq.to(torch.int32)
        state["srv_dropped"][:, v] += drop.to(torch.int32)
        state["srv_outage_dropped"][:, v] += (lanes & dark).to(torch.int32)
        if self.has_faults:
            state["srv_fault_dropped"][:, v] += (lanes & fault_rejected & ~retry).to(torch.int32)
        if self.has_shed:
            state["srv_shed_dropped"][:, v] += shed.to(torch.int32)
        if self.has_breaker:
            state["brk_probes"][:, v] += (probe & (start | enq)).to(torch.int32)
        if hedged is not None:
            state["srv_hedged"][:, v] += (start & hedged).to(torch.int32)
            state["srv_hedge_wins"][:, v] += (start & won).to(torch.int32)
            if bud_ok is not None:
                self._budget_debit(state, v, start & hedged)
                self._book_budget_dropped(state, v, t, start & would & ~bud_ok)
        self._tel_integral(state, "tel_srv_busy_int", v, t, done_at, measured)
        self._tel_count(state, "tel_srv_dropped", t, v, drop)
        self._tel_count(state, "tel_srv_outage_dropped", t, v, lanes & dark)
        self._tel_count(state, "tel_srv_fault_dropped", t, v, lanes & fault_rejected & ~retry)
        self._tel_count(state, "tel_srv_shed_dropped", t, v, shed)
        if hedged is not None:
            self._tel_count(state, "tel_srv_hedged", t, v, start & hedged)
            self._tel_count(state, "tel_srv_hedge_wins", t, v, start & won)
        if self.flt_can_retry[v] or self.qrm_can_retry[v]:
            # A retry counts only when a transit register takes it; with
            # none free _into_transit books a tr_dropped instead.
            parked = lanes & retry
            tr_free = torch.isinf(state["tr_time"][:, v, :]).any(dim=1)
            state["srv_fault_retried"][:, v] += (parked & tr_free).to(torch.int32)
            self._tel_count(state, "tel_srv_fault_retried", t, v, parked & tr_free)
            if bud_ok is not None:
                self._budget_debit(state, v, parked & tr_free)
                self._book_budget_dropped(state, v, t, lanes & blocked)
            self._into_transit(
                state, parked, v, self._backoff_arrival(u, attempt, v, t), created, attempt + 1
            )

    def _quorum_alive(self, state, t) -> torch.Tensor:
        """``(R,)`` quorum members reachable at ``t``: not inside a
        drop-mode fault window and not in a cut partition group."""
        cut = self.partitions.group_cut(state, t) if self.has_partitions else None
        dead = torch.zeros_like(t, dtype=torch.int32)
        for m in self.quorum.group:
            gone = torch.zeros_like(t, dtype=torch.bool)
            if self.has_faults and self.faults.drop_mode[m]:
                gone = gone | self.faults.dark(state, m, t)
            if cut is not None:
                gone = gone | (cut & torch.from_numpy(self.partitions.member[:, m]).to(t.device)).any(dim=1)
            dead += gone.to(torch.int32)
        return len(self.quorum.group) - dead

    def _enqueue_retry(self, state, desc, lanes, v: int, t, created, attempt) -> None:
        """Tail re-enqueue of a deadline-expired job (``attempt`` already
        +1); a retry that finds the queue full is a drop."""
        q_len = state["srv_q_len"][:, v]
        has_room = q_len < int(self.queue_cap[v])
        tail = torch.remainder(state["srv_q_head"][:, v] + q_len, self.K)
        self._push(desc, lanes, has_room, v, tail, created, t, attempt)
        pushed = lanes & has_room
        state["srv_q_len"][:, v] += pushed.to(torch.int32)
        state["srv_retried"][:, v] += pushed.to(torch.int32)
        state["srv_dropped"][:, v] += (lanes & ~has_room).to(torch.int32)
        self._tel_count(state, "tel_srv_retried", t, v, pushed)
        self._tel_count(state, "tel_srv_dropped", t, v, lanes & ~has_room)

    def _read_queue_head(self, state, desc, v: int, head):
        """The head item's (created, enqueued, attempt), forwarding a push
        the same step made at ``head`` (the ring write lands after the
        step); attempt is None without attempt numbers."""
        from_push = desc["pred"] & (desc["v"] == v) & (desc["slot"] == head)
        idx = head.long()[:, None]
        created = state["srv_q_created"][:, v, :].gather(1, idx)[:, 0]
        enq = state["srv_q_enq"][:, v, :].gather(1, idx)[:, 0]
        attempt = None
        if self.has_attempts:
            queued = state["srv_q_attempt"][:, v, :].gather(1, idx)[:, 0]
            attempt = torch.where(from_push, desc["attempt"], queued)
        return (
            torch.where(from_push, desc["created"], created),
            torch.where(from_push, desc["enq"], enq),
            attempt,
        )

    def _apply_qpush(self, state, desc) -> None:
        """The step's single queue-ring write (at most one per lane)."""
        R = desc["pred"].shape[0]
        flat = (desc["v"] * self.K + desc["slot"])[:, None]
        rings = [("srv_q_created", desc["created"]), ("srv_q_enq", desc["enq"])]
        if self.has_attempts:
            rings.append(("srv_q_attempt", desc["attempt"]))
        for key, value in rings:
            ring = state[key].view(R, self.nV * self.K)
            current = ring.gather(1, flat)[:, 0]
            ring.scatter_(1, flat, torch.where(desc["pred"], value, current)[:, None])

    # -- event branches ----------------------------------------------------
    def _fire_source(self, i: int, state, desc, lanes, t, u, params, trace_ctx=None):
        if trace_ctx is not None and i == self.trace_src:
            self._fire_trace_source(i, state, desc, lanes, t, u, params, trace_ctx)
            return
        gap = self._sample_gap(u, i, t, params)
        next_time = t + gap
        stopped = next_time > _f32(self.stop_after[i], t.device)
        src_next = state["src_next"][:, i]
        fired = torch.where(stopped, torch.full_like(next_time, INF), next_time)
        state["src_next"][:, i] = torch.where(lanes, fired, src_next)
        source = self.model.sources[i]
        self._deliver(state, desc, lanes, t, t, u, source.downstream, source.latency, params)

    def _fire_trace_source(self, i: int, state, desc, lanes, t, u, params, trace_ctx):
        """Fire the traced source (JAX ``_fire_trace_source``): count the
        arrival at the cursor for its tenant, advance the cursor, and read
        the next instant from the resident pages; ``+inf`` padding past
        the trace's end, or an instant past ``stop_after``, stops the
        source. ``trace_ctx = (resident_t, resident_g, base)``: the two
        resident pages' ``(2P,)`` times and tenants, and the absolute
        index of their first arrival. Offsets are clipped into the window,
        as JAX clips them for the lanes its vmap evaluates without firing.
        No uniform is consumed."""
        resident_t, resident_g, base = trace_ctx
        span = resident_t.shape[0]
        cursor = state["trc_cursor"].to(torch.int64)
        tenant = resident_g[torch.clamp(cursor - base, 0, span - 1)].long()
        advanced = cursor + 1
        next_time = resident_t[torch.clamp(advanced - base, 0, span - 1)]
        stopped = next_time > _f32(self.stop_after[i], t.device)
        state["trc_cursor"].copy_(torch.where(lanes, advanced, cursor).to(torch.uint32))
        state["trc_arrivals"].scatter_add_(1, tenant[:, None], lanes.to(torch.int32)[:, None])
        self._tel_count(state, "tel_trc_arrivals", t, tenant, lanes)
        fired = torch.where(stopped, torch.full_like(next_time, INF), next_time)
        state["src_next"][:, i] = torch.where(lanes, fired, state["src_next"][:, i])
        source = self.model.sources[i]
        self._deliver(state, desc, lanes, t, t, u, source.downstream, source.latency, params)

    def _complete_server(self, v: int, state, desc, lanes, t, u, params):
        dev = t.device
        done_row = state["srv_slot_done"][:, v, :]
        created_row = state["srv_slot_created"][:, v, :]
        valid = torch.as_tensor(self.slot_valid[v], device=dev)
        masked = torch.where(valid[None, :], done_row, torch.full_like(done_row, INF))
        k = torch.argmin(masked, dim=1)
        created = created_row.gather(1, k[:, None])[:, 0]
        attempt = None
        if self.has_attempts:
            attempt = state["srv_slot_attempt"][:, v, :].gather(1, k[:, None])[:, 0]
        _set_at(done_row, k, lanes, torch.full_like(created, INF))
        state["srv_completed"][:, v] += lanes.to(torch.int32)
        self._tel_count(state, "tel_srv_completed", t, v, lanes)
        spec = self.model.servers[v]
        if self.has_breaker:
            # The breaker's cooldown transition is resolved here too; the
            # deadline's verdict below is its failure or its success.
            bst = self._breaker_effective(state, lanes, v, t)
        budgeted = self.has_budget and spec.max_retries > 0
        forward = lanes
        if spec.deadline_s is not None:
            # A completion past its deadline is a timeout: retried while
            # attempts (and budget tokens) last (after a backoff through
            # the transit registers, or at once at the queue's tail), else
            # counted and discarded, forwarding nothing.
            expired = lanes & ((t - created) > _f32(self.srv_deadline[v], dev))
            retry = expired & (attempt < int(self.srv_max_retries[v]))
            if budgeted:
                bud_ok = self._budget_refresh(state, lanes, v, t, _f32(0.0, dev)) >= 1.0
                self._book_budget_dropped(state, v, t, retry & ~bud_ok)
                retry = retry & bud_ok
            state["srv_timed_out"][:, v] += (expired & ~retry).to(torch.int32)
            self._tel_count(state, "tel_srv_timed_out", t, v, expired & ~retry)
            if self.has_breaker:
                self._breaker_record_failure(state, v, t, expired, bst)
                self._breaker_close_on_success(state, v, lanes & ~expired, bst)
            if spec.retry_backoff_s is not None:
                # A retry counts (and spends a token) only when a transit
                # register takes it.
                tr_free = torch.isinf(state["tr_time"][:, v, :]).any(dim=1)
                state["srv_retried"][:, v] += (retry & tr_free).to(torch.int32)
                self._tel_count(state, "tel_srv_retried", t, v, retry & tr_free)
                if budgeted:
                    self._budget_debit(state, v, retry & tr_free)
                self._into_transit(
                    state, retry, v, self._backoff_arrival(u, attempt, v, t), created, attempt + 1
                )
            else:
                if budgeted:
                    # Likewise only when the queue has room.
                    room = state["srv_q_len"][:, v] < int(self.queue_cap[v])
                    self._budget_debit(state, v, retry & room)
                self._enqueue_retry(state, desc, retry, v, t, created, attempt + 1)
            forward = lanes & ~expired
        elif self.has_breaker:
            # Without a deadline every completion is a success.
            self._breaker_close_on_success(state, v, lanes, bst)
        self._deliver(state, desc, forward, t, created, u, spec.downstream, spec.latency, params)
        # Pull the next queued job into the freed slot (FIFO), unless a
        # feedback delivery above re-claimed the slot, or a degrade-mode
        # window caps the active slots.
        q_len = state["srv_q_len"][:, v]
        slot_still_free = torch.isinf(done_row.gather(1, k[:, None])[:, 0])
        has_queued = lanes & (q_len > 0) & slot_still_free
        degraded = None
        if self.has_faults and self.faults.degrade[v]:
            degraded = self.faults.dark(state, v, t)
            cap = int(self.faults.cap_slots[v])
            if cap < self.srv_concurrency[v]:
                busy_now = (torch.isfinite(done_row) & valid[None, :]).sum(dim=1)
                has_queued = has_queued & ~(degraded & (busy_now >= cap))
        head = state["srv_q_head"][:, v]
        queued_created, queued_enq, queued_attempt = self._read_queue_head(state, desc, v, head)
        terms = self._service_terms(u, self.U_SVC2, v, params)
        factor = self._degrade_factor(v, degraded)
        if factor is not None:
            terms = (terms[0] * terms[1], factor)
        if spec.hedge_delay_s is not None:
            second = self._service_terms(u, self.U_HED2, v, params)
            if factor is not None:
                second = (second[0] * second[1], factor)
            allowed = None
            if self.has_budget:
                # Refreshed at every completion, a pull or not, as JAX does.
                allowed = self._budget_refresh(state, lanes, v, t, _f32(0.0, dev)) >= 1.0
            raced, hedged, won, would = self._hedge(terms[0] * terms[1], second, v, allowed)
            terms = (raced, _f32(1.0, dev))
            state["srv_hedged"][:, v] += (has_queued & hedged).to(torch.int32)
            state["srv_hedge_wins"][:, v] += (has_queued & won).to(torch.int32)
            if allowed is not None:
                self._budget_debit(state, v, has_queued & hedged)
                self._book_budget_dropped(state, v, t, has_queued & would & ~allowed)
            self._tel_count(state, "tel_srv_hedged", t, v, has_queued & hedged)
            self._tel_count(state, "tel_srv_hedge_wins", t, v, has_queued & won)
        service = terms[0] * terms[1]
        done_at = _fused(t, terms)
        measured = has_queued & (t >= _f32(self.warmup, dev))
        _set_at(done_row, k, has_queued, done_at)
        _set_at(created_row, k, has_queued, queued_created)
        if self.has_attempts:
            _set_at(state["srv_slot_attempt"][:, v, :], k, has_queued, queued_attempt)
        state["srv_q_head"][:, v] = torch.where(
            has_queued, torch.remainder(head + 1, self.K), head
        )
        state["srv_q_len"][:, v] -= has_queued.to(torch.int32)
        state["srv_started"][:, v] += has_queued.to(torch.int32)
        busy = state["srv_busy_int"][:, v]
        state["srv_busy_int"][:, v] = torch.where(measured, busy + service, busy)
        self._tel_integral(state, "tel_srv_busy_int", v, t, done_at, measured)
        wait_sum = state["srv_wait_sum"][:, v]
        state["srv_wait_sum"][:, v] = torch.where(
            measured, wait_sum + (t - queued_enq), wait_sum
        )
        state["srv_wait_n"][:, v] += measured.to(torch.int32)

    def _transit_arrive(self, v: int, state, desc, lanes, t, u, params):
        """A job finished crossing a latency edge: free the first transit
        slot holding the row's minimum and hand the job to server ``v``."""
        row = state["tr_time"][:, v, :]
        k = torch.argmin(row, dim=1)
        created = state["tr_created"][:, v, :].gather(1, k[:, None])[:, 0]
        attempt = None
        if self.has_backoff:
            # A backoff retry re-arrives with its attempt number; a job
            # that crossed an edge carries 0.
            attempt = state["tr_attempt"][:, v, :].gather(1, k[:, None])[:, 0]
        _set_at(row, k, lanes, torch.full_like(created, INF))
        self._arrive_server(state, desc, lanes, v, t, created, u, params, attempt)

    # -- the step ----------------------------------------------------------
    def next_candidates(self, state) -> torch.Tensor:
        """``(R, nS + nV [+ nV])`` next-event times: each source's next
        arrival, each server's earliest completion, then (with transit)
        each server's earliest transit arrival."""
        done = state["srv_slot_done"]
        nV_real = len(self.model.servers)
        valid = torch.as_tensor(self.slot_valid, device=done.device)
        srv_next = torch.amin(torch.where(valid, done, torch.full_like(done, INF)), dim=2)
        parts = [state["src_next"], srv_next[:, :nV_real]]
        if self.has_transit:
            parts.append(torch.amin(state["tr_time"], dim=2)[:, :nV_real])
        return torch.cat(parts, dim=1)

    def replica_halted(self, state) -> torch.Tensor:
        """True once a replica's next event is past the horizon (or none
        exists). Halted is absorbing: every further step is a no-op."""
        t_min = torch.amin(self.next_candidates(state), dim=1)
        return torch.isinf(t_min) | (t_min > _f32(self.horizon, t_min.device))

    def make_step(self, horizon: Optional[float] = None, trace_ctx=None, windowed: bool = False):
        """The one-event step ``step(state, params, u, gate=None)`` over
        all replicas, with ``u`` the ``(R, n_draws)`` uniform row; it
        updates ``state`` in place. A replica whose next event lies past
        ``horizon`` (or which has none), or outside the ``(R,)`` bool
        ``gate`` where one is given, is left unchanged. ``trace_ctx``:
        the resident trace pages a traced model's step reads
        (:meth:`_fire_trace_source`).

        ``windowed=True`` (the partitioned executor, JAX's
        ``make_step(windowed=True)``): ``step(state, params, limit)``
        stops a replica at the window end ``limit`` instead (a sink still
        measures up to the model's horizon) and draws its own row,
        ``uniform(fold_in(key, events), (n_draws,), 1e-12, 1.0)`` keyed by
        the replica's event count before this event, so a window's rerun
        of the step never replays a stream."""
        if windowed:
            def windowed_step(state, params, limit):
                u = rng.uniform(
                    rng.fold_in(state["key"], state["events"].to(torch.int64)),
                    (self.n_draws,), minval=1e-12, maxval=1.0,
                )
                self.make_step(float(limit), trace_ctx)(state, params, u)

            return windowed_step
        horizon = self.horizon if horizon is None else float(horizon)
        nS = self.nS

        def step(state, params, u, gate=None):
            dev = u.device
            candidates = self.next_candidates(state)
            event_index = torch.argmin(candidates, dim=1)
            t_next = candidates.gather(1, event_index[:, None])[:, 0]
            done = torch.isinf(t_next) | (t_next > _f32(horizon, dev))
            live = ~done if gate is None else gate & ~done

            # process: the depth integral over the measured (post-warmup)
            # part of the interval, then the clock and the event count.
            measured_lo = torch.maximum(state["t"], _f32(self.warmup, dev))
            dt = torch.clamp_min(t_next - measured_lo, 0.0)
            depth = state["srv_depth_int"]
            q_len = state["srv_q_len"].to(torch.float32)
            depth.copy_(
                torch.where(
                    live[:, None], _fused(depth, (q_len, dt[:, None].expand_as(q_len))), depth
                )
            )
            if "tel_srv_depth_int" in self.tel_keys:
                # The same measured interval, split over the windows it
                # spans.
                tel = state["tel_srv_depth_int"]
                overlap = self._tel_overlap(measured_lo, t_next)[:, :, None].expand_as(tel)
                piece = (overlap, q_len[:, None, :].expand_as(tel))
                tel.copy_(torch.where(live[:, None, None], _fused(tel, piece), tel))
            state["t"].copy_(torch.where(live, t_next, state["t"]))
            state["events"] += live.to(torch.int32)
            t = state["t"]

            R = t.shape[0]
            desc = {
                "pred": torch.zeros((R,), dtype=torch.bool, device=dev),
                "v": torch.zeros((R,), dtype=torch.int64, device=dev),
                "slot": torch.zeros((R,), dtype=torch.int64, device=dev),
                "created": torch.zeros((R,), dtype=torch.float32, device=dev),
                "enq": torch.zeros((R,), dtype=torch.float32, device=dev),
            }
            if self.has_attempts:
                desc["attempt"] = torch.zeros((R,), dtype=torch.int32, device=dev)
            for i in range(nS):
                self._fire_source(
                    i, state, desc, live & (event_index == i), t, u, params, trace_ctx
                )
            nV_real = len(self.model.servers)
            for v in range(nV_real):
                self._complete_server(
                    v, state, desc, live & (event_index == nS + v), t, u, params
                )
            if self.has_transit:
                for v in range(nV_real):
                    self._transit_arrive(
                        v, state, desc, live & (event_index == nS + nV_real + v), t, u, params
                    )
            self._apply_qpush(state, desc)

        return step


def _set_at(row: torch.Tensor, index: torch.Tensor, lanes: torch.Tensor, value):
    """``row[r, index[r]] = value[r]`` for the selected lanes, in place
    (``row`` is an ``(R, n)`` view into a state leaf)."""
    idx = index.long()[:, None]
    current = row.gather(1, idx)[:, 0]
    row.scatter_(1, idx, torch.where(lanes, value, current)[:, None])


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def _max_server_chain(model: EnsembleModel) -> int:
    """Longest server chain a job can traverse (for the event budget)."""

    def depth_from(ref: Optional[NodeRef], seen: frozenset) -> int:
        if ref is None or ref.kind == SINK:
            return 0
        if ref.kind == ROUTER:
            return max(
                (depth_from(t, seen) for t in model.routers[ref.index].targets),
                default=0,
            )
        if ref.kind == LIMITER:
            return depth_from(model.limiters[ref.index].downstream, seen)
        if ref.index in seen:  # feedback loop: bounded by the budget anyway
            return 1
        return 1 + depth_from(model.servers[ref.index].downstream, seen | {ref.index})

    return max((depth_from(s.downstream, frozenset()) for s in model.sources), default=1)


def _source_jobs(model: EnsembleModel, source, rate: float) -> float:
    """Expected emissions for one source over its active window."""
    window = (
        min(model.horizon_s, source.stop_after_s)
        if source.stop_after_s is not None
        else model.horizon_s
    )
    if source.trace is not None:
        # A trace is exact: the instants inside the active window.
        return float(np.searchsorted(source.trace.times, window, side="right"))
    if source.profile is not None and source.profile.kind != "constant":
        # Trapezoid over the profile (the integral the tables encode).
        grid = np.linspace(0.0, window, 256)
        rates = np.array([source.profile.rate_at(source.rate, t) for t in grid])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2.0
        return float(trapezoid(rates, grid))
    return rate * window


def _default_max_events(model: EnsembleModel, sweeps) -> int:
    """Event budget: each job costs a source fire plus, per server on its
    path, one completion (and one transit arrival when edges carry
    latency, or when backoff retries travel through transit even on free
    edges); deadline retries re-run service up to 1 + max_retries times;
    25% headroom covers Poisson variance and queue drain."""
    rates = np.asarray([s.rate for s in model.sources], np.float64)
    if sweeps and "source_rate" in sweeps:
        arr = np.asarray(sweeps["source_rate"], np.float64)
        if arr.ndim == 1:
            arr = np.tile(arr[:, None], (1, len(model.sources)))
        rates = np.max(arr, axis=0)
    total_jobs = sum(_source_jobs(model, s, rates[i]) for i, s in enumerate(model.sources))
    hops_per_server = 2 if (
        any(e.mean_s > 0 for e in model.iter_edges())
        or any(s.retry_backoff_s is not None for s in model.servers)
    ) else 1
    retry_factor = 1 + max((s.max_retries for s in model.servers), default=0)
    events_per_job = 1 + hops_per_server * _max_server_chain(model) * retry_factor
    return int(1.25 * events_per_job * total_jobs) + 64


def _shards(final) -> list:
    """A run's final state as the list of this process's shards' states
    (one dict: one shard)."""
    return list(final) if isinstance(final, (list, tuple)) else [final]


def _blocks_reduce(blocks, n_chunks: int, group=None) -> dict:
    """Macro-block occupancy over every shard's ``(r,)`` blocks run (one
    tensor: one shard): a bincount of per-replica blocks run plus a
    limb-encoded total, on the first shard's device."""
    parts = _shards(blocks)
    device = parts[0].device
    hist = None
    for part in parts:
        counts = torch.bincount(torch.clamp(part, 0, n_chunks).long(), minlength=n_chunks + 1)
        counts = counts.to(torch.int32).to(device)
        hist = counts if hist is None else hist + counts
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(hist, group=group)
    return {"blocks_hist": hist, "blocks_total": shard_sum_i64_limbs(parts, device, group)}


def _gather_replicas(xs: list, device, group=None) -> torch.Tensor:
    """Every shard's ``(r, ...)`` rows in shard order on ``device``, from
    every process of ``group`` where given (each holds as many rows)."""
    local = torch.cat([x.to(device) for x in xs])
    if group is None:
        return local
    import torch.distributed as dist

    # The collectives carry no uint32 (the keys, the trace cursors): their
    # bits travel as int32.
    wire = local.view(torch.int32) if local.dtype == torch.uint32 else local
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts).view(local.dtype)


def reduce_final(compiled: _Compiled, final, group=None) -> dict:
    """Every cross-replica reduction of a run, on the device: ``final`` is
    the state of one shard, or the list of this process's shards' states
    (in shard order), reduced on the first shard's device and, with a
    process ``group``, across the processes. The sums are exact across
    shards (:func:`~happysim_tpu_torch.reduce.shard_sum_i64_limbs`,
    :func:`~happysim_tpu_torch.reduce.shard_sum_f32_fixed`), so the
    result is the same bits whatever the shard count."""
    with torch.profiler.record_function("hs.reduce"):
        return _reduce_final(compiled, final, group)


def _reduce_final(compiled: _Compiled, final, group) -> dict:
    shards = _shards(final)
    device = shards[0]["t"].device
    truncated = None
    for part in shards:
        # Pending work before the horizon (a source arrival, an occupied
        # slot, a parked transit job) marks a replica the budget truncated.
        pending = torch.minimum(
            torch.amin(part["src_next"], dim=-1),
            torch.amin(part["srv_slot_done"], dim=(-2, -1)),
        )
        if compiled.has_transit:
            pending = torch.minimum(pending, torch.amin(part["tr_time"], dim=(-2, -1)))
        count = torch.sum((pending < _f32(compiled.horizon, pending.device)).to(torch.int32))
        truncated = count.to(device) if truncated is None else truncated + count.to(device)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(truncated, group=group)
    reduced = {"truncated": truncated}
    keys = sorted((_I64_COUNTER_KEYS | _F64_SUM_KEYS) & shards[0].keys())
    # The sweeps' window integrals (a model with telemetry), and every
    # tel_ counter.
    keys += sorted(
        compiled.tel_keys | ({"tel_qrm_dark_int", "tel_ldr_uptime_int"} & shards[0].keys())
    )
    for key in keys:
        column = [part[key] for part in shards]
        if key in _F64_SUM_KEYS:
            reduced[key] = shard_sum_f32_fixed(column, device, group)
        elif _is_i64_key(key):
            reduced[key] = shard_sum_i64_limbs(column, device, group)
        else:
            raise ValueError(
                f"reduce key {key!r} has no declared encoding: add it to "
                "_I64_COUNTER_KEYS or _F64_SUM_KEYS (engine.py) so _build_result "
                "knows how to decode it"
            )
    if compiled.has_telemetry:
        if compiled.tel_spread:
            # The cross-replica spread of the per-window throughput, as
            # percentiles of the raw counts (the host divides by the
            # window length, which commutes with them), over every
            # replica gathered in order.
            counts = _gather_replicas(
                [part["tel_sink_count"] for part in shards], device, group
            ).to(torch.float32)
            reduced["tel_spread_p10"] = percentile_over_replicas(counts, 10.0)
            reduced["tel_spread_p90"] = percentile_over_replicas(counts, 90.0)
        if compiled.tel_faults:
            reduced["tel_fault_int"] = shard_sum_f32_fixed(
                [compiled._tel_fault_dark(part) for part in shards], device, group
            )
    return reduced


def percentile_over_replicas(x: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(x, pct, axis=0)`` (linear interpolation), in float32
    as JAX computes it: the two order statistics around
    ``pct / 100 * (n - 1)`` from a sort along the replica axis, weighted
    by the fractional part, ``low * low_weight + high * high_weight`` with
    the first product fused into the add as XLA's CPU backend fuses it
    (ROADMAP C). ``torch.quantile`` refuses inputs of more than 2**24
    elements, which 65,536 replicas of 4,096 windows pass."""
    n = x.shape[0]
    ordered = torch.sort(x, dim=0).values
    position = np.float32(np.float32(pct) / np.float32(100.0)) * np.float32(n - 1)
    low, high = math.floor(position), math.ceil(position)
    high_weight = np.float32(position - np.float32(low))
    low_weight = np.float32(1.0) - high_weight
    low, high = min(max(low, 0), n - 1), min(max(high, 0), n - 1)
    low_w, high_w = _f32(low_weight, x.device), _f32(high_weight, x.device)
    return fma_f32(ordered[low], low_w.expand_as(ordered[low]), ordered[high] * high_w)


def _resolve_device(device, entry: str = "run_ensemble") -> torch.device:
    """``device``, or the CUDA card for None (raising where torch finds
    none, naming the entry point)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{entry} runs on a CUDA device and torch finds none; "
                "pass device='cpu' to run the plain torch-op version on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _resolve_params(model: EnsembleModel, compiled: _Compiled, n_replicas: int, sweeps):
    """Per-replica ``src_rate`` ``(R, nS)`` and ``srv_mean`` ``(R, nV)``
    float32 arrays, broadcast from the model or taken from ``sweeps``."""
    src_rate = np.broadcast_to(
        np.asarray([s.rate for s in model.sources], np.float32),
        (n_replicas, compiled.nS),
    )
    srv_mean = np.broadcast_to(
        np.asarray([s.service_mean_s for s in model.servers] or [1.0], np.float32),
        (n_replicas, compiled.nV),
    )
    sweeps = sweeps or {}
    unknown = set(sweeps) - {"source_rate", "service_mean"}
    if unknown:
        raise ValueError(f"unknown sweep parameters {sorted(unknown)}")
    if "source_rate" in sweeps:
        if compiled.has_profile.any():
            raise ValueError("source_rate sweeps are incompatible with profiled sources")
        arr = np.asarray(sweeps["source_rate"], np.float32)
        if arr.ndim == 1:
            arr = np.tile(arr[:, None], (1, compiled.nS))
        if arr.shape[0] != n_replicas:
            arr = np.resize(arr, (n_replicas, compiled.nS))
        src_rate = arr
    if "service_mean" in sweeps:
        arr = np.asarray(sweeps["service_mean"], np.float32)
        if arr.ndim == 1:
            arr = np.tile(arr[:, None], (1, compiled.nV))
        if arr.shape[0] != n_replicas:
            arr = np.resize(arr, (n_replicas, compiled.nV))
        srv_mean = arr
    return {
        "src_rate": np.ascontiguousarray(src_rate, np.float32),
        "srv_mean": np.ascontiguousarray(srv_mean, np.float32),
    }


# Segments of a checkpointed run: the granularity of its wall-clock
# snapshot trigger (each segment is one kernel launch on the card).
CHECKPOINT_SEGMENTS = 32

# Result fields a checkpointed or resumed run may report otherwise than its
# uninterrupted twin: the JAX package's set (its checkpoint tests') less
# the fields the port's result lacks. Timing, the route taken, and the
# block counts (a resumed run counts only its own blocks).
RESUME_EXCLUDED_FIELDS = frozenset({
    "wall_seconds",
    "events_per_second",
    "compile_seconds",
    "redistribution_seconds",
    "engine_path",
    "kernel_decline",
    "macro_block",
    "max_blocks",
    "blocks_total",
    "block_occupancy",
    "padded_replicas",
})


def _same_value(left, right) -> bool:
    if dataclasses.is_dataclass(left):
        return type(left) is type(right) and all(
            _same_value(getattr(left, f.name), getattr(right, f.name))
            for f in dataclasses.fields(left)
        )
    if isinstance(left, np.ndarray) or isinstance(right, np.ndarray):
        return np.array_equal(left, right)
    return left == right


# The trace fields that account for the paging, not the simulation: a
# traced run resumed from a snapshot, or paged in other lengths, streams
# other pages in another number of steps and gives the same bits.
TRACE_PAGING_FIELDS = frozenset({
    "trace_chunks_streamed",
    "trace_chunk_len",
    "trace_n_chunks",
    "trace_max_resident_chunks",
    "trace_buffer_stall_seconds",
    "trace_stream_steps",
})


def resume_mismatches(a: EnsembleResult, b: EnsembleResult, ignore=frozenset()) -> list[str]:
    """The fields outside :data:`RESUME_EXCLUDED_FIELDS` and ``ignore``
    on which two results differ (bit for bit; a window series field by
    field): empty where a segmented or resumed run continued its twin
    exactly. Traced runs pass :data:`TRACE_PAGING_FIELDS` as ``ignore``."""
    return [
        f.name
        for f in dataclasses.fields(a)
        if f.name not in RESUME_EXCLUDED_FIELDS | ignore
        and not _same_value(getattr(a, f.name), getattr(b, f.name))
    ]


def _validate_resume(
    resume_from: EnsembleCheckpoint,
    leaves,
    *,
    n_replicas: int,
    seed: int,
    max_events: int,
    n_chunks: int,
    fingerprint: str,
    p_fingerprint: str,
    macro_block: int,
    telemetry_sig: str,
) -> None:
    """The JAX package's resume gate, check for check and message for
    message: the meta first, then the state's leaf names (``leaves``:
    those of this run's state) and its replica axis, before anything
    moves to the device."""
    mismatches = {
        "n_replicas": (resume_from.n_replicas, n_replicas),
        "seed": (resume_from.seed, seed),
        "max_events": (resume_from.max_events, max_events),
        "n_chunks": (resume_from.n_chunks, n_chunks),
        "model_fingerprint": (resume_from.model_fingerprint, fingerprint),
        "params_fingerprint": (resume_from.params_fingerprint, p_fingerprint),
        "macro_block": (resume_from.macro_block, macro_block),
        "telemetry": (resume_from.telemetry, telemetry_sig),
    }
    # An empty fingerprint or macro_block 0 is "unknown": skipped.
    bad = {
        k: v
        for k, v in mismatches.items()
        if v[0] != v[1]
        and not (k.endswith("fingerprint") and v[0] == "")
        and not (k == "macro_block" and v[0] == 0)
    }
    if bad:
        raise ValueError(
            f"resume_from does not match this run: {bad} "
            "(checkpoint value vs requested value; n_replicas counts "
            "include mesh padding — pad_to_multiple(requested, "
            "mesh.size) must equal the checkpoint's count)"
        )
    missing = sorted(set(leaves) - set(resume_from.state))
    if missing:
        raise ValueError(
            f"resume_from state is missing leaves {missing}: the "
            "archive is truncated or hand-edited (fingerprints match, "
            "so the model expects every compiled state leaf)"
        )
    for name, leaf in resume_from.state.items():
        if name not in leaves:
            raise ValueError(
                f"resume_from state carries unknown leaf {name!r}: "
                "not a state leaf of this model's compiled step "
                "(fingerprints match, so the archive itself is "
                "corrupt or hand-edited)"
            )
        shape = np.shape(leaf)
        if not shape or shape[0] != n_replicas:
            raise ValueError(
                f"resume_from state leaf {name!r} has shape {shape}: "
                f"expected a leading replica axis of {n_replicas} "
                "(the checkpoint's n_replicas) — the state cannot be "
                "redistributed onto this mesh"
            )


@dataclass
class _Shard:
    """One shard of a run on this process: its index in the mesh, its
    device, its replicas' keys and parameters there, its state and its
    per-replica block counts."""

    index: int
    device: torch.device
    keys: torch.Tensor
    params: dict
    blocks: torch.Tensor
    state: Optional[dict] = None


def _host_state(shards: list, group=None) -> dict:
    """The run's state on the host, ``{leaf: (R, ...) numpy}``: every
    shard's rows in shard order, from every process of ``group`` where
    given (a snapshot holds the whole run)."""
    return {
        key: _gather_replicas([sh.state[key] for sh in shards], shards[0].device, group)
        .cpu()
        .numpy()
        for key in shards[0].state
    }


def _run_ensemble_segmented(
    compiled: "_Compiled",
    shards: list,
    *,
    chunk_done: int,
    n_chunks: int,
    checkpoint_every_s: Optional[float],
    checkpoint_callback,
    meta: dict,
    group=None,
) -> None:
    """The checkpointing path (the JAX engine's
    ``_run_ensemble_segmented``): blocks ``chunk_done, ..., n_chunks - 1``
    in segments of ``ceil(n_chunks / CHECKPOINT_SEGMENTS)``, each one
    :func:`~happysim_tpu_torch.kernels.event_step.block_steps` call a
    shard (one kernel launch a shard on the card), updating each shard's
    state and blocks in place. Blocks are keyed by their absolute index,
    so the result is the one-launch run's bit for bit. Nothing waits for
    the device between segments unless a snapshot is due: then every
    shard's state is copied to the host into one
    :class:`EnsembleCheckpoint` (``meta`` holds its other fields) for
    ``checkpoint_callback``. A callback without an interval snapshots
    every segment; the last segment is never snapshotted."""
    seg_chunks = max(1, -(-n_chunks // CHECKPOINT_SEGMENTS))
    every = (
        checkpoint_every_s
        if checkpoint_every_s is not None
        else (0.0 if checkpoint_callback is not None else None)
    )
    last_snapshot = _wall.perf_counter()
    while chunk_done < n_chunks:
        n_seg = min(seg_chunks, n_chunks - chunk_done)
        for sh in shards:
            with torch.profiler.record_function("hs.macro_block"):
                event_step.block_steps(
                    compiled, sh.state, sh.keys, chunk_done, n_seg, sh.params, sh.blocks
                )
        chunk_done += n_seg
        due = every is not None and _wall.perf_counter() - last_snapshot >= every
        if checkpoint_callback is not None and due and chunk_done < n_chunks:
            checkpoint_callback(
                EnsembleCheckpoint(
                    chunk_index=chunk_done,
                    n_chunks=n_chunks,
                    state=_host_state(shards, group),
                    **meta,
                )
            )
            last_snapshot = _wall.perf_counter()


class _TracePages:
    """The padded trace's pages on the run's device: a ring of three page
    slots, filled from one pinned host copy of the trace made once a run.
    A launch reads two pages, ``base`` and ``base + 1``; the third slot
    takes the prefetch of ``base + 2`` while that launch runs, so an
    upload never overwrites a page a running launch reads. On the card
    each upload is a non-blocking copy on a side stream, ordered by
    events: a launch waits for the uploads of the pages it reads, and an
    upload into a slot waits for the last launch that read the slot. A
    page the window needs and no slot holds (a miss) is uploaded and
    waited for at once, its time counted as a buffer stall. Pages past
    the trace's end are ``+inf`` padding, the end-of-trace sentinel. On
    the CPU the copies are plain."""

    SLOTS = 3

    def __init__(self, compiled: "_Compiled", device: torch.device):
        P = self.P = compiled.trace_chunk_len
        self.n_pages = compiled.trace_pages
        self.on_card = device.type == "cuda"
        self.device = device
        host = [
            torch.from_numpy(compiled.trace_times),
            torch.from_numpy(compiled.trace_tenants),
            torch.full((P,), INF, dtype=torch.float32),
            torch.zeros((P,), dtype=torch.int32),
        ]
        if self.on_card:
            host = [x.pin_memory() for x in host]
        self.host = host
        self.times = torch.empty((self.SLOTS, P), dtype=torch.float32, device=device)
        self.tenants = torch.empty((self.SLOTS, P), dtype=torch.int32, device=device)
        self.page = [-1] * self.SLOTS  # the page each slot holds
        self.copied = [None] * self.SLOTS  # event: the slot's upload done
        self.read = [None] * self.SLOTS  # event: the last launch reading it done
        self.stream = torch.cuda.Stream(device) if self.on_card else None
        self.slots: tuple = ()
        self.chunks_streamed = 0
        self.stall_seconds = 0.0

    def _upload(self, idx: int, keep: tuple) -> int:
        """Page ``idx`` into the slot holding the lowest page outside
        ``keep``; returns the slot."""
        free = [s for s in range(self.SLOTS) if self.page[s] not in keep]
        slot = min(free, key=self.page.__getitem__)
        rows = slice(idx * self.P, (idx + 1) * self.P)
        if idx < self.n_pages:
            times, tenants = self.host[0][rows], self.host[1][rows]
        else:
            times, tenants = self.host[2], self.host[3]
        if self.on_card:
            with torch.cuda.stream(self.stream):
                if self.read[slot] is not None:
                    self.stream.wait_event(self.read[slot])
                self.times[slot].copy_(times, non_blocking=True)
                self.tenants[slot].copy_(tenants, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            self.copied[slot] = done
        else:
            self.times[slot].copy_(times)
            self.tenants[slot].copy_(tenants)
        self.page[slot] = idx
        self.chunks_streamed += 1
        return slot

    def prefetch(self, idx: int, keep: tuple) -> None:
        """Start the upload of page ``idx`` unless a slot holds it, keeping
        the pages of ``keep``."""
        if idx not in self.page:
            self._upload(idx, keep)

    def window(self, base_page: int) -> tuple:
        """The ``(t0, g0, t1, g1)`` pages ``base_page`` and ``base_page +
        1`` for the next launch, which waits (on the card) for their
        uploads; a page no slot holds is a miss."""
        keep = (base_page, base_page + 1)
        slots = []
        for idx in keep:
            if idx in self.page:
                slots.append(self.page.index(idx))
                continue
            begin = _wall.perf_counter()
            slot = self._upload(idx, keep)
            if self.on_card:
                self.copied[slot].synchronize()
            self.stall_seconds += _wall.perf_counter() - begin
            slots.append(slot)
        if self.on_card:
            current = torch.cuda.current_stream(self.device)
            for slot in slots:
                current.wait_event(self.copied[slot])
        self.slots = tuple(slots)
        first, second = slots
        return self.times[first], self.tenants[first], self.times[second], self.tenants[second]

    def launched(self) -> None:
        """Mark the window's slots read by the launch just issued."""
        if self.on_card:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            for slot in self.slots:
                self.read[slot] = done

    def resident(self, base_page: int) -> int:
        """The pages of the window at ``base_page`` a slot holds."""
        return sum(base_page <= p <= base_page + 1 for p in self.page)

    def close(self) -> None:
        """Order the ring's release after any upload still in flight."""
        if self.on_card:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


def _trace_base_page(compiled: "_Compiled", state: dict, n_chunks: int) -> int:
    """The window a resumed traced run starts from: the page of the least
    cursor among the lanes still reading the trace in the snapshot
    (``state``, numpy). Halted lanes are included: a base too low costs
    at most one stream step without progress, never a wrong read."""
    cursor = np.asarray(state["trc_cursor"], np.uint32).astype(np.int64)
    blocks = np.asarray(state["trc_blocks"], np.int32)
    reads = np.isfinite(np.asarray(state["src_next"], np.float32)[:, compiled.trace_src])
    reads &= blocks < n_chunks
    return int(cursor[reads].min()) // compiled.trace_chunk_len if reads.any() else 0


def _run_ensemble_traced(
    compiled: "_Compiled",
    shards: list,
    *,
    base_page: int,
    n_chunks: int,
    checkpoint_every_s: Optional[float],
    checkpoint_callback,
    meta: Optional[dict],
    group=None,
) -> dict:
    """The trace path (the JAX engine's ``_run_ensemble_traced``): the
    trace is paged to each of the shards' devices in pages of ``P =
    chunk_len`` arrivals (:class:`_TracePages`, one ring a device, the
    mesh's ``trace_chunk_sharding``), two resident, and each stream step
    is one :func:`~happysim_tpu_torch.kernels.event_step.trace_steps`
    call a shard (one kernel launch a shard on the card) in which every
    replica runs stall-gated blocks against the resident window, updating
    the shard's state in place. Then comes the step's one host sync,
    three numbers reduced over the shards (and the processes of
    ``group``): the lanes still reading the trace, the least cursor among
    them, and the least block count. The window moves on to the least
    cursor's page; the prefetch of the page after the window is issued
    before that sync, so that it overlaps the launches. A lane reading the
    trace is stalled at the end of a step, so its cursor is at least
    ``base + P`` and the window always moves on, except on the first step
    after a resume whose base a halted lane held back (then it moves one
    page). Each lane keys its blocks by its own count, so the result does
    not depend on the paging or on the shards.

    With a callback, a mid-chunk snapshot of the state is taken after a
    step (``chunk_index`` the least block count; ``meta`` holds the
    checkpoint's other fields) where ``checkpoint_every_s`` has passed (0
    or None: after every step), while lanes still read the trace.
    Returns the paging counts (the pages uploaded to the first shard's
    device, and the stall seconds of every ring)."""
    P, ti = compiled.trace_chunk_len, compiled.trace_src
    device = shards[0].device
    rings = {}
    for sh in shards:
        if sh.device not in rings:
            rings[sh.device] = _TracePages(compiled, sh.device)
    for pages in rings.values():
        pages.prefetch(base_page, ())
        pages.prefetch(base_page + 1, (base_page,))
    stats = {"max_resident_chunks": 2, "stream_steps": 0}
    every = (
        checkpoint_every_s
        if checkpoint_every_s is not None
        else (0.0 if checkpoint_callback is not None else None)
    )
    last_snapshot = _wall.perf_counter()
    try:
        while True:
            windows = {dev: pages.window(base_page) for dev, pages in rings.items()}
            summaries = []
            for sh in shards:
                state = sh.state
                with torch.profiler.record_function("hs.macro_block"):
                    halted = event_step.trace_steps(
                        compiled, state, sh.keys, sh.params, windows[sh.device], base_page * P,
                        n_chunks,
                    )
                reads = (
                    torch.isfinite(state["src_next"][:, ti])
                    & (state["trc_blocks"] < n_chunks)
                    & ~halted
                )
                cursor = state["trc_cursor"].to(torch.int64)
                summaries.append(torch.stack([
                    reads.sum().to(torch.int64),
                    torch.where(reads, cursor, torch.full_like(cursor, 0xFFFFFFFF)).min(),
                    state["trc_blocks"].min().to(torch.int64),
                ]).to(device))
            for pages in rings.values():
                pages.launched()
            stats["stream_steps"] += 1
            table = torch.stack(summaries)
            summary = torch.cat([
                reduce_over_processes(table[:, 0].sum().reshape(1), "SUM", group),
                reduce_over_processes(torch.amin(table[:, 1:], dim=0), "MIN", group),
            ])
            for pages in rings.values():
                pages.prefetch(base_page + 2, (base_page, base_page + 1))
            active, min_read, min_blocks = summary.tolist()  # the step's one sync
            due = every is not None and _wall.perf_counter() - last_snapshot >= every
            if checkpoint_callback is not None and due and active > 0:
                checkpoint_callback(
                    EnsembleCheckpoint(
                        chunk_index=int(min_blocks),
                        n_chunks=n_chunks,
                        state=_host_state(shards, group),
                        **meta,
                    )
                )
                last_snapshot = _wall.perf_counter()
            if active == 0:
                break
            new_page = int(min_read) // P
            base_page = new_page if new_page != base_page else base_page + 1
            stats["max_resident_chunks"] = max(
                stats["max_resident_chunks"],
                *(pages.resident(base_page) for pages in rings.values()),
            )
    finally:
        for pages in rings.values():
            pages.close()
    stats["chunks_streamed"] = rings[device].chunks_streamed
    stats["buffer_stall_seconds"] = sum(pages.stall_seconds for pages in rings.values())
    return stats


def _resolve_mesh(mesh, device, entry: str = "run_ensemble") -> "mesh_lib.ReplicaMesh":
    """The run's replica mesh: ``mesh``, or one shard on ``device``
    (resolved by :func:`_resolve_device`). A mesh whose shards this
    process runs lie elsewhere than an explicit ``device`` raises."""
    if mesh is None:
        return mesh_lib.ReplicaMesh((_resolve_device(device, entry),))
    if device is not None:
        want = torch.device(device)
        for shard in mesh.local_shards:
            got = mesh.devices[shard]
            if got.type != want.type or None not in (got.index, want.index) and got.index != want.index:
                raise ValueError(
                    f"{entry}: mesh shard {shard} is on {got}, and device={device!r} "
                    "asks for another device; pass the mesh alone"
                )
    return mesh


def _mesh_fields(mesh: "mesh_lib.ReplicaMesh", n_replicas: int) -> dict:
    """The result's mesh provenance (JAX's fields): the shards, the axes
    and shape, the replicas a shard, and the reduce path: limb sums on
    the device, added across processes by all_reduce where the mesh spans
    them."""
    return {
        "mesh_devices": mesh.size,
        "mesh_axes": tuple(mesh.axis_names),
        "mesh_shape": tuple(mesh.shape),
        "per_shard_replicas": n_replicas // mesh.size,
        "reduce_path": "device-limb-sum+all-reduce" if mesh.spans_processes else "device-limb-sum",
    }


def _partition_gate(compiled: "_Compiled", host_params: dict, mesh) -> None:
    """Every leaf of the run's state has a placement in
    :data:`~happysim_tpu_torch.mesh.STATE_PARTITION_RULES` (raises
    naming the first that has none): the leaf names of one replica's
    state on the CPU, built without a draw (the run's own set-up draws
    the initial gaps once)."""
    template = compiled.init_state(
        rng.split(rng.PRNGKey(0), 1),
        {k: torch.from_numpy(v[:1]) for k, v in host_params.items()},
        draw=False,
    )
    mesh_lib.ensemble_state_specs(tuple(template), mesh)


def run_ensemble(
    model: EnsembleModel,
    n_replicas: int = 8192,
    seed: int = 0,
    max_events: Optional[int] = None,
    sweeps: Optional[dict] = None,
    device=None,
    checkpoint_every_s: Optional[float] = None,
    checkpoint_callback=None,
    resume_from=None,
    mesh=None,
) -> EnsembleResult:
    """Run ``n_replicas`` Monte-Carlo replicas of ``model``.

    ``device=None`` means the CUDA card, and raises when torch finds none;
    ``device="cpu"`` runs the plain versions of the kernels instead.
    ``mesh`` (:mod:`happysim_tpu_torch.mesh`) cuts the replicas into
    shards, padded to a multiple of its size before the keys are split
    (as the JAX engine pads), each a contiguous slab on its device with
    its slice of the keys and sweeps: one launch a shard, shards on
    distinct devices at once and shards of one device in turn, and the
    reductions exact across the shards (and processes), so the result is
    the same bits on any shard count; ``mesh=None`` is one shard on
    ``device``.
    ``sweeps`` maps ``"source_rate"`` / ``"service_mean"`` to per-replica
    ``(R,)`` or ``(R, n)`` arrays. ``max_events`` is the per-replica event
    budget (default: from the arrival rates and the longest server path).
    Checkpoint and resume, as in the JAX engine: ``checkpoint_every_s``
    (wall seconds; 0 = every segment) hands an :class:`EnsembleCheckpoint`
    of the state at a segment boundary to ``checkpoint_callback``; passing
    one back as ``resume_from`` (same model, replicas, seed and budget)
    continues the run, on any shard count, and reproduces the
    uninterrupted result bit for bit. Such a run is the event scan in
    ``CHECKPOINT_SEGMENTS`` segments, one kernel launch a shard each, and
    its ``wall_seconds`` include the snapshots' copies; a resumed run
    counts only its own blocks, and its ``redistribution_seconds`` are
    the seconds it took to cut the snapshot into this mesh's shards.

    A model with a traced source streams its trace in pages, one
    stall-gated kernel launch a shard a stream step
    (:func:`_run_ensemble_traced`); its snapshots are taken mid-chunk
    between steps, and its block counts are each lane's own.

    As in the JAX engine, a call with no ``max_events`` runs a
    Poisson -> FIFO chain -> sink model, or a single random or round-robin
    router over such chains, by the closed form of
    :mod:`~happysim_tpu_torch.chain` (``engine_path == "chain"``), unless
    ``HS_TPU_CHAIN=0`` or its finite-capacity certificate or memory budget
    declines; every other run is the event scan, the whole event budget
    in one kernel launch a shard.
    """
    checkpointing = (
        checkpoint_every_s is not None
        or checkpoint_callback is not None
        or resume_from is not None
    )
    if checkpoint_every_s is not None and checkpoint_callback is None:
        raise ValueError(
            "checkpoint_every_s without checkpoint_callback would take no "
            "snapshots (pass a callback to receive them)"
        )
    mesh = _resolve_mesh(mesh, device)
    # The first shard's device: the run's keys are split and its
    # reductions meet there.
    device = mesh.devices[mesh.local_shards[0]]
    compiled = _Compiled(model)
    n_replicas = mesh_lib.pad_to_multiple(n_replicas, mesh.size)
    if n_replicas > MAX_EXACT_REPLICAS:
        raise ValueError(
            f"n_replicas={n_replicas} exceeds the exact-reduction bound of "
            f"{MAX_EXACT_REPLICAS} replicas (reduce.py limb sums wrap past it)"
        )
    # An explicit event budget is a contract about truncation the chain
    # form does not implement (it has its own arrival budget).
    explicit_max_events = max_events is not None
    if max_events is None:
        max_events = _default_max_events(model, sweeps)
    macro = compiled.macro
    n_chunks = -(-int(max_events) // macro)
    on_card = device.type == "cuda"
    device_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    group = mesh.group
    host_params = _resolve_params(model, compiled, n_replicas, sweeps)
    _partition_gate(compiled, host_params, mesh)
    mesh_fields = _mesh_fields(mesh, n_replicas)

    def shard_inputs() -> list:
        """This process's shards, each with its slice of the keys and the
        parameters on its device."""
        keys = rng.split(rng.PRNGKey(seed, device=device), n_replicas)
        shards = []
        for index in mesh.local_shards:
            rows = mesh.shard_slice(index, n_replicas)
            dev = mesh.devices[index]
            shards.append(_Shard(
                index, dev, keys[rows].to(dev),
                {k: torch.from_numpy(v[rows]).to(dev) for k, v in host_params.items()},
                torch.zeros((rows.stop - rows.start,), dtype=torch.int32, device=dev),
            ))
        return shards

    # Checkpointed and resumed runs always take the scan: its state is
    # the snapshot.
    if (
        not checkpointing
        and not explicit_max_events
        and os.environ.get("HS_TPU_CHAIN", "1") != "0"
    ):
        from happysim_tpu_torch import chain

        plan = chain.fast_plan(model)
        if plan is not None:
            shards = shard_inputs()
            fast = chain.run_chain(
                model, compiled, plan, [sh.keys for sh in shards],
                [sh.params["src_rate"] for sh in shards],
                [sh.params["srv_mean"] for sh in shards], group=group,
            )
            if fast is not None:
                reduced, events_total, wall, compile_s = fast
                return _build_result(
                    model,
                    compiled,
                    reduced,
                    events_total,
                    wall,
                    n_replicas,
                    compile_seconds=compile_s,
                    engine_path="chain",
                    device_name=device_name,
                    mesh_fields=mesh_fields,
                )
    if on_card:
        support.check_kernel_bounds(compiled, macro)
    if compiled.has_trace and compiled.trace_chunk_len < macro:
        raise ValueError(
            f"trace_arrivals: chunk_len={compiled.trace_chunk_len} is smaller than the "
            f"macro-block length {macro} — a replica could stall with "
            "the window unable to cover one block (deadlock). Raise "
            "chunk_len or lower macro_block/HS_TPU_MACRO_BLOCK."
        )

    compile_start = _wall.perf_counter()
    if on_card:
        event_step.load_library()
    compile_seconds = _wall.perf_counter() - compile_start

    start = _wall.perf_counter()
    shards = shard_inputs()
    meta = _checkpoint_meta(compiled, n_replicas, seed, max_events, host_params, mesh.size)
    redistribution_seconds = 0.0
    if resume_from is not None:
        begin = _wall.perf_counter()
        _resume_state(compiled, resume_from, shards, meta, n_chunks, mesh, n_replicas)
        redistribution_seconds = _wall.perf_counter() - begin
    else:
        for sh in shards:
            sh.state = compiled.init_state(sh.keys, sh.params)
    trace_stats = None
    if compiled.has_trace:
        base_page = (
            _trace_base_page(compiled, resume_from.state, n_chunks) if resume_from is not None else 0
        )
        trace_stats = _run_ensemble_traced(
            compiled, shards,
            base_page=base_page,
            n_chunks=n_chunks,
            checkpoint_every_s=checkpoint_every_s,
            checkpoint_callback=checkpoint_callback,
            meta=meta,
            group=group,
        )
        # Each lane's own block count rides the state on this path.
        for sh in shards:
            sh.blocks = sh.state["trc_blocks"]
    elif not checkpointing:
        # The whole budget in one call a shard: on the card one kernel
        # launch, in which each lane runs its blocks until it halts;
        # nothing waits for the device before the reduce.
        if n_chunks:
            for sh in shards:
                with torch.profiler.record_function("hs.macro_block"):
                    event_step.block_steps(
                        compiled, sh.state, sh.keys, 0, n_chunks, sh.params, sh.blocks
                    )
    else:
        _run_ensemble_segmented(
            compiled, shards,
            chunk_done=resume_from.chunk_index if resume_from is not None else 0,
            n_chunks=n_chunks,
            checkpoint_every_s=checkpoint_every_s,
            checkpoint_callback=checkpoint_callback,
            meta=meta,
            group=group,
        )
    reduced = reduce_final(compiled, [sh.state for sh in shards], group)
    reduced.update(_blocks_reduce([sh.blocks for sh in shards], n_chunks, group))
    events_total = int(host_i64(reduced["events"]))
    wall = _wall.perf_counter() - start

    return _build_result(
        model,
        compiled,
        reduced,
        events_total,
        wall,
        n_replicas,
        max_events,
        compile_seconds=compile_seconds,
        engine_path="scan+cuda" if on_card else "scan",
        kernel_decline="" if on_card else _cpu_decline(compiled, macro),
        kernel_shape=compiled.plan["shape"] if on_card else "",
        kernel_chaos=compiled.plan["chaos"] if on_card else (),
        macro_block=macro,
        max_blocks=n_chunks,
        device_name=device_name,
        trace_stats=trace_stats,
        mesh_fields=dict(mesh_fields, redistribution_seconds=redistribution_seconds),
    )


def _cpu_decline(compiled: "_Compiled", macro: int) -> str:
    """Why a CPU run did not launch the kernel: the device, and the
    kernel's bound the model is past, where it is past one."""
    try:
        support.check_kernel_bounds(compiled, macro)
    except ValueError as exc:
        return f'device="cpu"; {exc}'
    return 'device="cpu"'


def _checkpoint_meta(
    compiled: "_Compiled", n_replicas: int, seed: int, max_events, host_params: dict,
    mesh_devices: int = 1,
) -> dict:
    """The fields of a run's snapshots besides the state and the chunk."""
    return {
        "n_replicas": n_replicas,
        "seed": seed,
        "max_events": int(max_events),
        "model_fingerprint": model_fingerprint(compiled.model),
        "params_fingerprint": params_fingerprint(host_params),
        "macro_block": compiled.macro,
        "telemetry": compiled.telemetry.signature() if compiled.has_telemetry else "",
        "mesh_devices": mesh_devices,
    }


def _resume_state(
    compiled, resume_from, shards: list, meta: dict, n_chunks: int, mesh, n_replicas: int
) -> None:
    """The snapshot's state cut into this mesh's shards, each on its
    device (whatever shard count wrote it), after JAX's resume checks
    against this run (``meta``, :func:`_checkpoint_meta`)."""
    # The leaf names of this run's state, from one replica's.
    first = shards[0]
    template = compiled.init_state(first.keys[:1], {k: v[:1] for k, v in first.params.items()})
    _validate_resume(
        resume_from,
        template,
        n_chunks=n_chunks,
        fingerprint=meta["model_fingerprint"],
        p_fingerprint=meta["params_fingerprint"],
        telemetry_sig=meta["telemetry"],
        **{k: meta[k] for k in ("n_replicas", "seed", "max_events", "macro_block")},
    )
    for sh in shards:
        rows = mesh.shard_slice(sh.index, n_replicas)
        sh.state = convert.state_from_numpy(
            {k: np.asarray(v)[rows] for k, v in resume_from.state.items()}, sh.device
        )


def _build_result(
    model,
    compiled,
    reduced,
    events_total,
    wall,
    n_replicas,
    max_events=None,
    compile_seconds: float = 0.0,
    engine_path: str = "scan",
    kernel_decline: str = "",
    kernel_shape: str = "",
    kernel_chaos: tuple = (),
    macro_block: int = 0,
    max_blocks: int = 0,
    device_name: str = "",
    trace_stats: Optional[dict] = None,
    mesh_fields: Optional[dict] = None,
) -> EnsembleResult:
    """Decode the device-reduced totals into an :class:`EnsembleResult`
    (for the event scan and the chain form, which emits the same keys and
    encodings and runs no macro-blocks)."""
    horizon = float(model.horizon_s)
    truncated = int(reduced["truncated"])
    if truncated:
        logger.warning(
            "run_ensemble: %d/%d replicas exhausted the event budget "
            "(max_events=%s) before the %.3fs horizon; pass a larger max_events.",
            truncated,
            n_replicas,
            max_events if max_events is not None else "chain arrival budget",
            horizon,
        )

    def _decode(k, v):
        if _is_i64_key(k):
            return host_i64(v)
        if k in _F64_SUM_KEYS:
            return host_f64(v)
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    host = {k: _decode(k, v) for k, v in reduced.items()}
    nV_real = len(model.servers)
    nL_real = len(model.limiters)
    blocks_total, block_occupancy = 0, {}
    if "blocks_hist" in host:
        hist_counts = host.pop("blocks_hist")
        blocks_total = int(host.pop("blocks_total"))
        block_occupancy = {int(v): int(c) for v, c in enumerate(hist_counts) if c}
    timeseries = None
    if compiled.has_telemetry:
        timeseries = build_timeseries(compiled.telemetry, compiled, host, n_replicas)
    sink_count = host["sink_count"].astype(np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sink_mean = np.where(sink_count > 0, host["sink_sum"] / sink_count, 0.0)
        wait_n = host["srv_wait_n"][:nV_real].astype(np.int64)
        wait_mean = np.where(wait_n > 0, host["srv_wait_sum"][:nV_real] / wait_n, 0.0)
    # Integrals are accumulated only over the measured (post-warmup) window.
    denom = n_replicas * (horizon - compiled.warmup)
    return EnsembleResult(
        n_replicas=n_replicas,
        horizon_s=horizon,
        simulated_events=events_total,
        wall_seconds=wall,
        events_per_second=events_total / wall if wall > 0 else 0.0,
        sink_count=[int(c) for c in sink_count],
        sink_mean_latency_s=[float(m) for m in sink_mean],
        sink_p50_s=[hist_percentile(host["sink_hist"][k], 0.5) for k in range(compiled.nK)],
        sink_p99_s=[hist_percentile(host["sink_hist"][k], 0.99) for k in range(compiled.nK)],
        sink_hist=host["sink_hist"],
        server_completed=[int(c) for c in host["srv_completed"][:nV_real]],
        server_dropped=[int(d) for d in host["srv_dropped"][:nV_real]],
        server_outage_dropped=[int(d) for d in host["srv_outage_dropped"][:nV_real]],
        server_utilization=[
            float(b) / (denom * model.servers[v].concurrency)
            for v, b in enumerate(host["srv_busy_int"][:nV_real])
        ],
        server_mean_wait_s=[float(w) for w in wait_mean],
        server_mean_queue_len=[float(d) / denom for d in host["srv_depth_int"][:nV_real]],
        server_timed_out=[int(x) for x in host["srv_timed_out"][:nV_real]],
        server_retried=[int(x) for x in host["srv_retried"][:nV_real]],
        transit_dropped=(
            [int(d) for d in host["tr_dropped"][:nV_real]]
            if compiled.has_transit
            else [0] * nV_real
        ),
        limiter_admitted=[int(x) for x in host["lim_admitted"][:nL_real]],
        limiter_dropped=[int(x) for x in host["lim_dropped"][:nL_real]],
        truncated_replicas=truncated,
        server_fault_dropped=_per_server(host, "srv_fault_dropped", nV_real),
        server_fault_retried=_per_server(host, "srv_fault_retried", nV_real),
        server_hedged=_per_server(host, "srv_hedged", nV_real),
        server_hedge_wins=_per_server(host, "srv_hedge_wins", nV_real),
        network_lost=int(host.get("net_lost", 0)),
        server_breaker_dropped=_per_server(host, "srv_breaker_dropped", nV_real),
        breaker_tripped=_per_server(host, "brk_tripped", nV_real),
        # Open time is booked at trip time; the fraction is over the whole
        # run (breaker openness is availability, not a latency statistic).
        breaker_open_fraction=(
            [float(x) / (n_replicas * horizon) for x in host["brk_open_time"][:nV_real]]
            if "brk_open_time" in host
            else [0.0] * nV_real
        ),
        server_shed_dropped=_per_server(host, "srv_shed_dropped", nV_real),
        server_budget_dropped=_per_server(host, "srv_budget_dropped", nV_real),
        resilience_features=tuple(model.resilience_features()),
        network_partitioned=int(host.get("net_partitioned", 0)),
        server_quorum_dropped=_per_server(host, "qrm_dropped", nV_real),
        # Availability fractions over replicas x horizon, as the breaker's.
        quorum_dark_fraction=(
            float(host["qrm_dark_time"]) / (n_replicas * horizon) if "qrm_dark_time" in host else 0.0
        ),
        leader_changes=int(host.get("ldr_changes", 0)),
        time_without_leader_fraction=(
            float(host["ldr_noleader_time"]) / (n_replicas * horizon)
            if "ldr_noleader_time" in host
            else 0.0
        ),
        consensus_features=tuple(model.consensus_features()),
        compile_seconds=compile_seconds,
        engine_path=engine_path,
        kernel_decline=kernel_decline,
        kernel_shape=kernel_shape,
        kernel_chaos=tuple(kernel_chaos),
        macro_block=macro_block,
        max_blocks=max_blocks,
        blocks_total=blocks_total,
        block_occupancy=block_occupancy,
        padded_replicas=n_replicas,
        **(mesh_fields or {"per_shard_replicas": n_replicas}),
        device_name=device_name,
        timeseries=timeseries,
        trace=compiled.has_trace,
        trace_chunks_streamed=int(trace_stats["chunks_streamed"]) if trace_stats else 0,
        trace_chunk_len=compiled.trace_chunk_len if compiled.has_trace else 0,
        trace_n_chunks=compiled.trace_pages if compiled.has_trace else 0,
        trace_max_resident_chunks=int(trace_stats["max_resident_chunks"]) if trace_stats else 0,
        trace_buffer_stall_seconds=(
            float(trace_stats["buffer_stall_seconds"]) if trace_stats else 0.0
        ),
        trace_stream_steps=int(trace_stats["stream_steps"]) if trace_stats else 0,
        # Every replica replays the same trace: n_replicas times the
        # trace's arrivals per tenant, where the budget let them all fire.
        trace_tenant_arrivals=(
            [int(x) for x in host["trc_arrivals"]] if "trc_arrivals" in host else []
        ),
    )


def _per_server(host: dict, key: str, nV_real: int) -> list[int]:
    """A per-server counter column, zeros where the model has no such
    leaf."""
    if key not in host:
        return [0] * nV_real
    return [int(x) for x in host[key][:nV_real]]
