"""Trace-driven load: recorded or synthesized arrival streams for the
engine (counterpart of ``happysim_tpu/tpu/traces.py``, whose code this
module carries as its own copy: the port imports nothing of the JAX
package).

A :class:`TraceSpec` is an explicit array of arrival instants, with a
tenant id per arrival, that every replica replays deterministically. The
engine streams the trace host to device in fixed pages of ``chunk_len``
arrivals, two pages resident at a time, so a trace of any length flows
through a bounded device footprint (``engine._run_ensemble_traced``).

The synthesizers (:func:`diurnal_trace`, :func:`flash_crowd_trace`,
:func:`zipf_tenant_trace`) draw the instants on the host with a seeded
numpy generator, as the JAX package's do, so the same arguments give the
same arrays, the same :meth:`TraceSpec.signature` and therefore the same
model fingerprint in either package.

A trace is data, not randomness: a traced source consumes no uniform,
and every replica sees the same instants, so a traced run gives the same
bits whatever its page size or checkpoint cuts.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "TraceSpec",
    "DEFAULT_CHUNK_LEN",
    "diurnal_trace",
    "flash_crowd_trace",
    "zipf_tenant_trace",
]

# Default page size (arrivals per streamed chunk).  Must be >= the macro
# block length (engine validates) so a replica can always finish one
# macro block inside the 2-page resident window; 2048 comfortably clears
# the default RNG_CHUNK=32 while keeping the resident footprint at
# 2 * 2048 * (4B time + 4B tenant) = 32 KiB per shard.
DEFAULT_CHUNK_LEN = 2048


@dataclass(eq=False)
class TraceSpec:
    """A recorded or synthesized arrival stream.

    ``times`` are absolute sim-time instants (seconds, float32,
    non-decreasing, finite, >= 0).  ``tenants`` maps each arrival to an
    int32 tenant id in ``[0, n_tenants)`` — always present (all-zeros
    for single-tenant traces) so the resident page layout is uniform.
    ``chunk_len`` is the streamed page size; ``kind``/``params`` record
    synthesizer provenance for fingerprints and reports.
    """

    times: np.ndarray
    tenants: np.ndarray
    n_tenants: int = 1
    chunk_len: int = DEFAULT_CHUNK_LEN
    kind: str = "recorded"
    params: tuple = field(default_factory=tuple)

    def __post_init__(self):
        self.times = np.asarray(self.times, dtype=np.float32)
        if self.tenants is None:
            self.tenants = np.zeros(self.times.shape, dtype=np.int32)
        self.tenants = np.asarray(self.tenants, dtype=np.int32)

    # -- validation -----------------------------------------------------
    def validate(self) -> None:
        t = self.times
        if t.ndim != 1 or t.size == 0:
            raise ValueError(
                "trace_arrivals: times must be a non-empty 1-D array, got "
                f"shape {t.shape}"
            )
        if not np.all(np.isfinite(t)):
            raise ValueError("trace_arrivals: times must be finite")
        if float(t[0]) < 0.0:
            raise ValueError(
                f"trace_arrivals: times must be >= 0, first is {float(t[0])!r}"
            )
        if t.size > 1 and np.any(np.diff(t) < 0):
            bad = int(np.argmax(np.diff(t) < 0))
            raise ValueError(
                "trace_arrivals: times must be non-decreasing "
                f"(times[{bad + 1}] < times[{bad}])"
            )
        g = self.tenants
        if g.shape != t.shape:
            raise ValueError(
                f"trace_arrivals: tenants shape {g.shape} != times shape {t.shape}"
            )
        if self.n_tenants < 1:
            raise ValueError(
                f"trace_arrivals: n_tenants must be >= 1, got {self.n_tenants}"
            )
        if g.size and (int(g.min()) < 0 or int(g.max()) >= self.n_tenants):
            raise ValueError(
                "trace_arrivals: tenant ids must lie in "
                f"[0, {self.n_tenants}), got [{int(g.min())}, {int(g.max())}]"
            )
        if self.chunk_len < 1:
            raise ValueError(
                f"trace_arrivals: chunk_len must be >= 1, got {self.chunk_len}"
            )

    # -- paging math ----------------------------------------------------
    @property
    def n_arrivals(self) -> int:
        return int(self.times.size)

    @property
    def n_chunks(self) -> int:
        """Number of ``chunk_len``-sized pages covering the trace."""
        return -(-self.n_arrivals // self.chunk_len)

    def padded_times(self) -> np.ndarray:
        """Times padded with +inf to a whole number of pages.  The inf
        padding doubles as the end-of-trace sentinel: a cursor that walks
        past the last real arrival reads +inf, which the source treats
        exactly like ``stop_after_s`` exhaustion."""
        n = self.n_chunks * self.chunk_len
        out = np.full(n, np.inf, dtype=np.float32)
        out[: self.n_arrivals] = self.times
        return out

    def padded_tenants(self) -> np.ndarray:
        n = self.n_chunks * self.chunk_len
        out = np.zeros(n, dtype=np.int32)
        out[: self.n_arrivals] = self.tenants
        return out

    # -- provenance -----------------------------------------------------
    def signature(self) -> str:
        """Content hash for ``model_fingerprint`` (checkpoint resume
        refuses a different trace the same way it refuses a different
        topology)."""
        h = hashlib.sha256()
        h.update(self.times.tobytes())
        h.update(self.tenants.tobytes())
        h.update(
            f"|{self.n_tenants}|{self.chunk_len}|{self.kind}|{self.params}".encode()
        )
        return h.hexdigest()[:16]

    def __repr__(self) -> str:  # keep model reprs readable
        return (
            f"TraceSpec(kind={self.kind!r}, n_arrivals={self.n_arrivals}, "
            f"n_tenants={self.n_tenants}, chunk_len={self.chunk_len})"
        )


# ---------------------------------------------------------------------------
# Synthesizers, as the JAX package writes them.  All take an
# explicit integer seed and draw from a private numpy Generator so traces
# are reproducible independent of global RNG state.
# ---------------------------------------------------------------------------


def _thin_inhomogeneous(rate_fn, rate_max: float, horizon_s: float, rng) -> np.ndarray:
    """Ogata thinning: sample a homogeneous Poisson stream at ``rate_max``
    and keep each point with probability ``rate_fn(t) / rate_max`` — the
    standard inhomogeneous-Poisson sampler."""
    if rate_max <= 0.0:
        return np.zeros(0, dtype=np.float32)
    # Expected count + 6 sigma of headroom, then trim.
    n_hint = int(rate_max * horizon_s + 6.0 * np.sqrt(rate_max * horizon_s) + 16)
    gaps = rng.exponential(1.0 / rate_max, size=n_hint)
    t = np.cumsum(gaps)
    while t.size and t[-1] < horizon_s:  # pragma: no cover - 6-sigma tail
        extra = np.cumsum(rng.exponential(1.0 / rate_max, size=n_hint)) + t[-1]
        t = np.concatenate([t, extra])
    t = t[t < horizon_s]
    keep = rng.random(t.size) < (np.asarray(rate_fn(t)) / rate_max)
    return t[keep].astype(np.float32)


def diurnal_trace(
    base_rate: float,
    amplitude: float,
    period_s: float,
    horizon_s: float,
    seed: int = 0,
    chunk_len: int = DEFAULT_CHUNK_LEN,
) -> TraceSpec:
    """Diurnal sinusoid: inhomogeneous Poisson arrivals at rate
    ``base_rate * (1 + amplitude * sin(2*pi*t / period_s))``.

    ``amplitude`` must lie in [0, 1] so the rate stays non-negative.
    """
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"diurnal_trace: amplitude must be in [0, 1], got {amplitude}")
    if base_rate <= 0.0 or period_s <= 0.0 or horizon_s <= 0.0:
        raise ValueError(
            "diurnal_trace: base_rate, period_s, horizon_s must be positive"
        )
    rng = np.random.default_rng(seed)
    rate = lambda t: base_rate * (1.0 + amplitude * np.sin(2.0 * np.pi * t / period_s))
    times = _thin_inhomogeneous(rate, base_rate * (1.0 + amplitude), horizon_s, rng)
    return TraceSpec(
        times=times,
        tenants=np.zeros(times.size, dtype=np.int32),
        n_tenants=1,
        chunk_len=chunk_len,
        kind="diurnal",
        params=(base_rate, amplitude, period_s, horizon_s, seed),
    )


def flash_crowd_trace(
    base_rate: float,
    spike_rate: float,
    spike_start_s: float,
    spike_end_s: float,
    horizon_s: float,
    seed: int = 0,
    chunk_len: int = DEFAULT_CHUNK_LEN,
) -> TraceSpec:
    """Flash crowd: ``base_rate`` arrivals with a rectangular burst at
    ``spike_rate`` over ``[spike_start_s, spike_end_s)`` — the open-world
    twin of ``RateProfile(kind="spike")``."""
    if base_rate <= 0.0 or horizon_s <= 0.0:
        raise ValueError("flash_crowd_trace: base_rate and horizon_s must be positive")
    if spike_rate < base_rate:
        raise ValueError(
            f"flash_crowd_trace: spike_rate ({spike_rate}) must be >= "
            f"base_rate ({base_rate})"
        )
    if not 0.0 <= spike_start_s < spike_end_s:
        raise ValueError(
            "flash_crowd_trace: need 0 <= spike_start_s < spike_end_s, got "
            f"[{spike_start_s}, {spike_end_s})"
        )
    rng = np.random.default_rng(seed)
    rate = lambda t: np.where(
        (t >= spike_start_s) & (t < spike_end_s), spike_rate, base_rate
    )
    times = _thin_inhomogeneous(rate, spike_rate, horizon_s, rng)
    return TraceSpec(
        times=times,
        tenants=np.zeros(times.size, dtype=np.int32),
        n_tenants=1,
        chunk_len=chunk_len,
        kind="flash_crowd",
        params=(base_rate, spike_rate, spike_start_s, spike_end_s, horizon_s, seed),
    )


def zipf_tenant_trace(
    rate: float,
    n_tenants: int,
    alpha: float,
    horizon_s: float,
    seed: int = 0,
    chunk_len: int = DEFAULT_CHUNK_LEN,
) -> TraceSpec:
    """Multi-tenant mix: homogeneous Poisson arrivals at ``rate`` with
    each arrival assigned a tenant drawn from a Zipf(``alpha``) law over
    ``n_tenants`` tenants (tenant 0 is the heaviest hitter)."""
    if rate <= 0.0 or horizon_s <= 0.0:
        raise ValueError("zipf_tenant_trace: rate and horizon_s must be positive")
    if n_tenants < 1:
        raise ValueError(f"zipf_tenant_trace: n_tenants must be >= 1, got {n_tenants}")
    if alpha < 0.0:
        raise ValueError(f"zipf_tenant_trace: alpha must be >= 0, got {alpha}")
    rng = np.random.default_rng(seed)
    times = _thin_inhomogeneous(lambda t: np.full_like(t, rate), rate, horizon_s, rng)
    weights = 1.0 / np.power(np.arange(1, n_tenants + 1, dtype=np.float64), alpha)
    weights /= weights.sum()
    tenants = rng.choice(n_tenants, size=times.size, p=weights).astype(np.int32)
    return TraceSpec(
        times=times,
        tenants=tenants,
        n_tenants=n_tenants,
        chunk_len=chunk_len,
        kind="zipf",
        params=(rate, n_tenants, alpha, horizon_s, seed),
    )
