"""Windowed telemetry for the ensemble engine (own copy of
``happysim_tpu/tpu/telemetry.py``).

The whole-run counters of :class:`~happysim_tpu_torch.engine.EnsembleResult`
say THAT p99 got worse under a chaos run; the per-window series say WHEN.
A :class:`TelemetrySpec` on the model (``model.telemetry(window_s=...)``)
adds fixed-shape ``(n_windows, ...)`` buffers to every replica's state.
The event step (the plain torch-op step and the CUDA kernel alike) adds
into them at the accounting sites it already has, so the buffers

- add no uniform draw: a telemetry model simulates exactly what the same
  model without a spec simulates, every whole-run counter included;
- are reduced once at the end, like every other leaf, and come back as
  :attr:`EnsembleResult.timeseries <happysim_tpu_torch.engine.EnsembleResult.timeseries>`.

This module owns the spec, the host-side window math and the assembly of
:class:`EnsembleTimeseries`; the step's sites live in
``engine._Compiled`` (prefixed ``_tel_``) and in the kernel.

Metric groups (``TelemetrySpec.metrics``):

``throughput``
    Per-window sink delivery counts (exact limb sums, int64 on the host).
``latency``
    Per-window log-spaced latency histograms (p50(t) and p99(t) through
    :func:`~happysim_tpu_torch.engine.hist_percentile`) and latency sums
    for per-window means.
``queue``
    Per-window queue-depth time integrals: mean queue length L(t).
``utilization``
    Per-window busy-time integrals: utilization U(t). A service interval
    ``[start, start + service)`` is split over the windows it spans.
``rates``
    Per-window counters of what the engine books: completions, queue-full
    drops, brownout and fault drops, deadline timeouts, retries, hedges
    and hedge wins, limiter admits and drops, transit drops, packet loss.
``spread``
    Cross-replica spread of the per-window throughput: the mean and the
    10th and 90th percentiles over replicas, computed on the device.
``faults``
    Per-window fault-window occupancy (the expected dark share per
    server), computed at reduce time from the sampled fault registers.

A group whose machinery the model lacks allocates nothing (no faults, no
occupancy; no limiters, no admission series).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from happysim_tpu_torch.data import Data

#: Every known metric group, and the default set.
DEFAULT_METRICS = (
    "throughput",
    "latency",
    "queue",
    "utilization",
    "rates",
    "spread",
    "faults",
)

#: Window-count bounds: one window is the whole-run aggregate (rejected),
#: and the buffers are per-replica state, so the count is capped.
MIN_WINDOWS = 2
MAX_WINDOWS = 4096


@dataclass(frozen=True)
class TelemetrySpec:
    """Compile-time description of the windowed-telemetry buffers.

    ``window_s`` tiles the horizon into ``ceil(horizon_s / window_s)``
    windows; the last window may be short when the horizon is not a
    multiple of ``window_s``. Window ``w`` covers ``[w * window_s,
    (w+1) * window_s)``: an event exactly on an edge belongs to the later
    window, in float32 like every other simulated time.
    """

    window_s: float
    metrics: tuple[str, ...] = DEFAULT_METRICS

    def validate(self, horizon_s: float) -> None:
        if not self.window_s > 0.0:
            raise ValueError(
                f"telemetry window_s must be > 0, got {self.window_s!r}"
            )
        if not self.metrics:
            raise ValueError("telemetry metrics must not be empty")
        unknown = set(self.metrics) - set(DEFAULT_METRICS)
        if unknown:
            raise ValueError(
                f"unknown telemetry metrics {sorted(unknown)}; "
                f"choose from {DEFAULT_METRICS}"
            )
        n = self.n_windows(horizon_s)
        if n < MIN_WINDOWS:
            raise ValueError(
                f"telemetry window_s={self.window_s} yields {n} window(s) "
                f"over horizon_s={horizon_s}: a single window is the "
                "whole-run aggregate the engine already reports — use "
                f"window_s <= {horizon_s / MIN_WINDOWS}"
            )
        if n > MAX_WINDOWS:
            raise ValueError(
                f"telemetry window_s={self.window_s} yields {n} windows "
                f"over horizon_s={horizon_s} (max {MAX_WINDOWS}): the "
                "buffers are per-replica state — use a coarser window"
            )

    def n_windows(self, horizon_s: float) -> int:
        return int(math.ceil(float(horizon_s) / float(self.window_s) - 1e-9))

    def signature(self) -> str:
        """Canonical string of the spec (the JAX package records it in
        checkpoint meta)."""
        return f"window_s={self.window_s!r};metrics={','.join(self.metrics)}"


def window_index(t: float, window_s: float, n_windows: int) -> int:
    """Host twin of the window assignment: ``floor(t / window_s)`` in
    float32, clipped into ``[0, n_windows)`` so the horizon-end event
    lands in the last window. (The compiled step divides by the constant
    ``window_s`` as a multiply by its float32 reciprocal, which can put a
    time within an ulp of an edge in the other window; the engine follows
    the compiled step, see ``engine._Compiled._tel_windex``.)"""
    w = int(np.float32(t) / np.float32(window_s))
    return min(max(w, 0), n_windows - 1)


def window_edges(
    window_s: float, n_windows: int, horizon_s: Optional[float] = None
) -> tuple[np.ndarray, np.ndarray]:
    """``(lo, hi)`` float32 edge arrays of shape ``(n_windows,)``.

    ``hi[-1]`` is ``+inf``, so time past the nominal grid (a service
    interval running beyond the horizon, a transit drop booked at a
    post-horizon arrival) lands in the last window and the per-window
    integrals sum to their whole-run counterparts. ``horizon_s`` clamps
    ``hi[-1]`` instead (occupancy fractions end at the horizon).
    """
    lo = np.arange(n_windows, dtype=np.float32) * np.float32(window_s)
    hi = lo + np.float32(window_s)
    hi[-1] = np.inf if horizon_s is None else np.float32(horizon_s)
    return lo, hi


def measured_window_lengths(
    window_s: float, n_windows: int, horizon_s: float, warmup_s: float
) -> np.ndarray:
    """Seconds of each window inside the measured ``[warmup, horizon]``
    interval (the denominator of the queue and utilization series)."""
    lo, hi = window_edges(window_s, n_windows, horizon_s=horizon_s)
    return np.clip(
        np.minimum(hi, np.float32(horizon_s))
        - np.maximum(lo, np.float32(warmup_s)),
        0.0,
        None,
    ).astype(np.float64)


def _per_window_percentiles(hist: np.ndarray, q: float) -> np.ndarray:
    """(nW, nK) percentile estimates from (nW, nK, HIST_BINS) histograms."""
    from happysim_tpu_torch.engine import hist_percentile

    n_windows, n_sinks = hist.shape[:2]
    out = np.zeros((n_windows, n_sinks), np.float64)
    for w in range(n_windows):
        for k in range(n_sinks):
            out[w, k] = hist_percentile(hist[w, k], q)
    return out


def _eq(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (
            isinstance(a, np.ndarray)
            and isinstance(b, np.ndarray)
            and a.shape == b.shape
            and bool(np.array_equal(a, b))
        )
    return bool(a == b)


@dataclass(eq=False)
class EnsembleTimeseries:
    """Time-resolved ensemble metrics: one row per telemetry window.

    Array axes: ``nW`` windows x (``nK`` sinks | ``nV`` servers | ``nL``
    limiters). A field is ``None`` when its metric group was not
    requested or the model lacks the machinery.
    Counter series are int64 and sum
    (axis 0) exactly to the whole-run counters; the float integral
    series sum to the whole-run integrals up to float32 re-association.
    """

    window_s: float
    horizon_s: float
    warmup_s: float
    n_windows: int
    n_replicas: int
    metrics: tuple[str, ...]
    window_start_s: np.ndarray  # (nW,)
    window_len_s: np.ndarray  # (nW,) the last window may be short
    measured_len_s: np.ndarray  # (nW,) overlap with [warmup, horizon]
    # throughput / spread
    sink_count: Optional[np.ndarray] = None  # (nW, nK) int64
    replica_throughput_mean: Optional[np.ndarray] = None  # (nW, nK) jobs/s
    replica_throughput_p10: Optional[np.ndarray] = None
    replica_throughput_p90: Optional[np.ndarray] = None
    # latency
    sink_hist: Optional[np.ndarray] = None  # (nW, nK, HIST_BINS) int64
    sink_mean_latency_s: Optional[np.ndarray] = None  # (nW, nK)
    sink_p50_s: Optional[np.ndarray] = None
    sink_p99_s: Optional[np.ndarray] = None
    # queue / utilization
    server_mean_queue_len: Optional[np.ndarray] = None  # (nW, nV)
    server_utilization: Optional[np.ndarray] = None  # (nW, nV)
    # rates (int64 counts per window; divide by window_len_s for rates)
    server_completed: Optional[np.ndarray] = None
    server_dropped: Optional[np.ndarray] = None
    server_outage_dropped: Optional[np.ndarray] = None
    server_fault_dropped: Optional[np.ndarray] = None
    server_fault_retried: Optional[np.ndarray] = None
    server_timed_out: Optional[np.ndarray] = None
    server_retried: Optional[np.ndarray] = None
    server_hedged: Optional[np.ndarray] = None
    server_hedge_wins: Optional[np.ndarray] = None
    transit_dropped: Optional[np.ndarray] = None
    limiter_admitted: Optional[np.ndarray] = None  # (nW, nL)
    limiter_dropped: Optional[np.ndarray] = None
    network_lost: Optional[np.ndarray] = None  # (nW,)
    # resilience defenses
    server_breaker_dropped: Optional[np.ndarray] = None  # (nW, nV)
    breaker_tripped: Optional[np.ndarray] = None  # (nW, nV)
    breaker_open_fraction: Optional[np.ndarray] = None  # (nW, nV)
    server_shed_dropped: Optional[np.ndarray] = None  # (nW, nV)
    server_budget_dropped: Optional[np.ndarray] = None  # (nW, nV)
    # consensus
    server_quorum_dropped: Optional[np.ndarray] = None  # (nW, nV)
    network_partitioned: Optional[np.ndarray] = None  # (nW,)
    quorum_dark_fraction: Optional[np.ndarray] = None  # (nW,)
    leader_uptime_fraction: Optional[np.ndarray] = None  # (nW,)
    # trace-driven load: arrivals per (window, tenant) over all replicas
    trace_tenant_arrivals: Optional[np.ndarray] = None  # (nW, nT) int64
    # faults
    fault_occupancy: Optional[np.ndarray] = None  # (nW, nV) fraction

    _ARRAY_FIELDS = (
        "window_start_s", "window_len_s", "measured_len_s",
        "sink_count", "replica_throughput_mean",
        "replica_throughput_p10", "replica_throughput_p90",
        "sink_hist", "sink_mean_latency_s", "sink_p50_s", "sink_p99_s",
        "server_mean_queue_len", "server_utilization",
        "server_completed", "server_dropped", "server_outage_dropped",
        "server_fault_dropped", "server_fault_retried",
        "server_timed_out", "server_retried",
        "server_hedged", "server_hedge_wins", "transit_dropped",
        "limiter_admitted", "limiter_dropped", "network_lost",
        "server_breaker_dropped", "breaker_tripped",
        "breaker_open_fraction", "server_shed_dropped",
        "server_budget_dropped",
        "server_quorum_dropped", "network_partitioned",
        "quorum_dark_fraction", "leader_uptime_fraction",
        "trace_tenant_arrivals",
        "fault_occupancy",
    )

    def __eq__(self, other) -> bool:
        if not isinstance(other, EnsembleTimeseries):
            return NotImplemented
        scalars = (
            "window_s", "horizon_s", "warmup_s",
            "n_windows", "n_replicas", "metrics",
        )
        return all(
            _eq(getattr(self, name), getattr(other, name))
            for name in scalars + self._ARRAY_FIELDS
        )

    def series(self) -> dict[str, np.ndarray]:
        """Flat column dict: one 1-D float array per (metric, entity)."""
        out: dict[str, np.ndarray] = {
            "window_start_s": np.asarray(self.window_start_s, np.float64),
            "window_len_s": np.asarray(self.window_len_s, np.float64),
        }

        def emit(name: str, arr: Optional[np.ndarray], prefix: str) -> None:
            if arr is None:
                return
            if arr.ndim == 1:
                out[name] = np.asarray(arr, np.float64)
                return
            for j in range(arr.shape[1]):
                out[f"{prefix}[{j}].{name}"] = np.asarray(arr[:, j], np.float64)

        emit("count", self.sink_count, "sink")
        emit("throughput_mean_per_replica_s", self.replica_throughput_mean, "sink")
        emit("throughput_p10_per_replica_s", self.replica_throughput_p10, "sink")
        emit("throughput_p90_per_replica_s", self.replica_throughput_p90, "sink")
        emit("mean_latency_s", self.sink_mean_latency_s, "sink")
        emit("p50_s", self.sink_p50_s, "sink")
        emit("p99_s", self.sink_p99_s, "sink")
        emit("mean_queue_len", self.server_mean_queue_len, "server")
        emit("utilization", self.server_utilization, "server")
        emit("completed", self.server_completed, "server")
        emit("dropped", self.server_dropped, "server")
        emit("outage_dropped", self.server_outage_dropped, "server")
        emit("fault_dropped", self.server_fault_dropped, "server")
        emit("fault_retried", self.server_fault_retried, "server")
        emit("timed_out", self.server_timed_out, "server")
        emit("retried", self.server_retried, "server")
        emit("hedged", self.server_hedged, "server")
        emit("hedge_wins", self.server_hedge_wins, "server")
        emit("transit_dropped", self.transit_dropped, "server")
        emit("admitted", self.limiter_admitted, "limiter")
        emit("dropped", self.limiter_dropped, "limiter")
        emit("network_lost", self.network_lost, "network")
        emit("breaker_dropped", self.server_breaker_dropped, "server")
        emit("breaker_tripped", self.breaker_tripped, "server")
        emit("breaker_open_fraction", self.breaker_open_fraction, "server")
        emit("shed_dropped", self.server_shed_dropped, "server")
        emit("budget_dropped", self.server_budget_dropped, "server")
        emit("quorum_dropped", self.server_quorum_dropped, "server")
        emit("network_partitioned", self.network_partitioned, "network")
        emit("quorum_dark_fraction", self.quorum_dark_fraction, "quorum")
        emit("leader_uptime_fraction", self.leader_uptime_fraction, "leader")
        emit("arrivals", self.trace_tenant_arrivals, "tenant")
        emit("fault_occupancy", self.fault_occupancy, "server")
        return out

    def to_data(self) -> dict:
        """Each column of :meth:`series` but ``window_start_s`` as a
        :class:`~happysim_tpu_torch.data.Data` series sampled at the window
        starts, for code that reads ``Data`` (e.g.
        ``ts.to_data()["sink[0].p99_s"].bucket(...)``)."""
        times = np.asarray(self.window_start_s, np.float64)
        return {
            name: Data.from_arrays(times, values, name=name)
            for name, values in self.series().items()
            if name != "window_start_s"
        }

    def to_dataframe(self):
        """The column dict as a pandas ``DataFrame`` (one row per
        window). Raises ``ImportError`` when pandas is absent."""
        import pandas as pd

        return pd.DataFrame(self.series())


def build_timeseries(
    spec: TelemetrySpec,
    compiled,
    host: dict,
    n_replicas: int,
) -> EnsembleTimeseries:
    """Assemble the series from the decoded reduce output (the
    ``tel_``-prefixed arrays of ``engine.reduce_final``)."""
    horizon = float(compiled.model.horizon_s)
    warmup = float(compiled.warmup)
    n_windows = compiled.nW
    nV = len(compiled.model.servers)
    nL = len(compiled.model.limiters)
    lo, hi = window_edges(spec.window_s, n_windows, horizon_s=horizon)
    window_len = (np.minimum(hi, horizon) - lo).astype(np.float64)
    measured = measured_window_lengths(spec.window_s, n_windows, horizon, warmup)
    ts = EnsembleTimeseries(
        window_s=float(spec.window_s),
        horizon_s=horizon,
        warmup_s=warmup,
        n_windows=n_windows,
        n_replicas=n_replicas,
        metrics=spec.metrics,
        window_start_s=lo.astype(np.float64),
        window_len_s=window_len,
        measured_len_s=measured,
    )

    def counts(key: str) -> Optional[np.ndarray]:
        if key not in host:
            return None
        return np.asarray(host[key]).astype(np.int64)

    if "tel_sink_count" in host:
        ts.sink_count = np.asarray(host["tel_sink_count"]).astype(np.int64)
        if "tel_spread_p10" in host:
            # The mean is the exact total over (n_replicas * window_len);
            # the percentiles were taken over raw counts, and scaling by
            # the window length is monotone, so it commutes with them.
            with np.errstate(divide="ignore", invalid="ignore"):
                ts.replica_throughput_mean = ts.sink_count / (
                    n_replicas * window_len[:, None]
                )
                ts.replica_throughput_p10 = (
                    np.asarray(host["tel_spread_p10"], np.float64)
                    / window_len[:, None]
                )
                ts.replica_throughput_p90 = (
                    np.asarray(host["tel_spread_p90"], np.float64)
                    / window_len[:, None]
                )
    if "tel_sink_hist" in host:
        hist = counts("tel_sink_hist")
        ts.sink_hist = hist
        sink_count = hist.sum(axis=2)
        sink_sum = np.asarray(host["tel_sink_sum"], np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            ts.sink_mean_latency_s = np.where(
                sink_count > 0, sink_sum / sink_count, 0.0
            )
        ts.sink_p50_s = _per_window_percentiles(hist, 0.5)
        ts.sink_p99_s = _per_window_percentiles(hist, 0.99)
    if "tel_srv_depth_int" in host:
        depth = np.asarray(host["tel_srv_depth_int"], np.float64)[:, :nV]
        with np.errstate(divide="ignore", invalid="ignore"):
            ts.server_mean_queue_len = np.where(
                measured[:, None] > 0,
                depth / (n_replicas * measured[:, None]),
                0.0,
            )
    if "tel_srv_busy_int" in host:
        busy = np.asarray(host["tel_srv_busy_int"], np.float64)[:, :nV]
        conc = np.asarray(
            [s.concurrency for s in compiled.model.servers] or [1], np.float64
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            ts.server_utilization = np.where(
                measured[:, None] > 0,
                busy / (n_replicas * measured[:, None] * conc[None, :nV]),
                0.0,
            )
    for attr, key in (
        ("server_completed", "tel_srv_completed"),
        ("server_dropped", "tel_srv_dropped"),
        ("server_outage_dropped", "tel_srv_outage_dropped"),
        ("server_fault_dropped", "tel_srv_fault_dropped"),
        ("server_fault_retried", "tel_srv_fault_retried"),
        ("server_timed_out", "tel_srv_timed_out"),
        ("server_retried", "tel_srv_retried"),
        ("server_hedged", "tel_srv_hedged"),
        ("server_hedge_wins", "tel_srv_hedge_wins"),
        ("transit_dropped", "tel_tr_dropped"),
        ("server_breaker_dropped", "tel_srv_breaker_dropped"),
        ("breaker_tripped", "tel_brk_tripped"),
        ("server_shed_dropped", "tel_srv_shed_dropped"),
        ("server_budget_dropped", "tel_srv_budget_dropped"),
        ("server_quorum_dropped", "tel_qrm_dropped"),
    ):
        arr = counts(key)
        if arr is not None:
            setattr(ts, attr, arr[:, :nV])
    for attr, key in (
        ("limiter_admitted", "tel_lim_admitted"),
        ("limiter_dropped", "tel_lim_dropped"),
    ):
        arr = counts(key)
        if arr is not None:
            setattr(ts, attr, arr[:, :nL])
    if "tel_net_lost" in host:
        ts.network_lost = counts("tel_net_lost")
    if "tel_brk_open_int" in host:
        # Open seconds over the window's [start, min(end, horizon)]
        # coverage, averaged over replicas.
        open_int = np.asarray(host["tel_brk_open_int"], np.float64)[:, :nV]
        with np.errstate(divide="ignore", invalid="ignore"):
            ts.breaker_open_fraction = np.where(
                window_len[:, None] > 0,
                open_int / (n_replicas * window_len[:, None]),
                0.0,
            )
    if "tel_net_partitioned" in host:
        ts.network_partitioned = counts("tel_net_partitioned")
    if "tel_trc_arrivals" in host:
        # The raw reduced counts (every replica replays the same trace).
        ts.trace_tenant_arrivals = counts("tel_trc_arrivals")
    # The quorum's dark and the leader's up seconds over the window's
    # [start, min(end, horizon)] coverage, averaged over replicas.
    for attr, key in (
        ("quorum_dark_fraction", "tel_qrm_dark_int"),
        ("leader_uptime_fraction", "tel_ldr_uptime_int"),
    ):
        if key in host:
            seconds = np.asarray(host[key], np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                setattr(ts, attr, np.where(window_len > 0, seconds / (n_replicas * window_len), 0.0))
    if "tel_fault_int" in host:
        # Dark seconds over the window's [start, min(end, horizon)]
        # coverage, averaged over replicas.
        dark = np.asarray(host["tel_fault_int"], np.float64)[:, :nV]
        with np.errstate(divide="ignore", invalid="ignore"):
            ts.fault_occupancy = np.where(
                window_len[:, None] > 0,
                dark / (n_replicas * window_len[:, None]),
                0.0,
            )
    return ts
