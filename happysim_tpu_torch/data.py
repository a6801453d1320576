"""Time-series samples and their fixed-window buckets (own copy of
``happysim_tpu/instrumentation/data.py``): what
:meth:`EnsembleTimeseries.to_data <happysim_tpu_torch.telemetry.EnsembleTimeseries.to_data>`
returns. Samples are kept as integer nanoseconds and floats in lists;
the statistics call numpy with the reference's arguments, so they give
the same values.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from happysim_tpu_torch.temporal import Instant, as_instant


class Data:
    """Append-only (time, value) samples with statistics."""

    __slots__ = ("name", "_times_ns", "_values")

    def __init__(self, name: str = "data"):
        self.name = name
        self._times_ns: list[int] = []
        self._values: list[float] = []

    def add(self, time: Instant, value: float) -> None:
        self._times_ns.append(time.nanoseconds)
        self._values.append(float(value))

    record = add

    @classmethod
    def from_arrays(
        cls,
        times_s: Sequence[float] | np.ndarray,
        values: Sequence[float] | np.ndarray,
        name: str = "data",
    ) -> "Data":
        """Samples at ``times_s`` (seconds) of ``values``."""
        data = cls(name)
        times = np.asarray(times_s, dtype=np.float64)
        data._times_ns = [int(round(t * 1e9)) for t in times]
        data._values = [float(v) for v in np.asarray(values, dtype=np.float64)]
        return data

    @property
    def times(self) -> list[Instant]:
        return [Instant(ns) for ns in self._times_ns]

    @property
    def times_s(self) -> np.ndarray:
        return np.asarray(self._times_ns, dtype=np.float64) / 1e9

    @property
    def values(self) -> list[float]:
        return list(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(zip(self.times, self._values))

    def between(self, start: Union[Instant, float], end: Union[Instant, float]) -> "Data":
        """The samples with ``start <= time <= end``."""
        start_ns = as_instant(start).nanoseconds
        end_ns = as_instant(end).nanoseconds
        out = Data(self.name)
        for t, v in zip(self._times_ns, self._values):
            if start_ns <= t <= end_ns:
                out._times_ns.append(t)
                out._values.append(v)
        return out

    def count(self) -> int:
        return len(self._values)

    def sum(self) -> float:
        return float(np.sum(self._values)) if self._values else 0.0

    def mean(self) -> float:
        return float(np.mean(self._values)) if self._values else 0.0

    def min(self) -> float:
        return float(np.min(self._values)) if self._values else 0.0

    def max(self) -> float:
        return float(np.max(self._values)) if self._values else 0.0

    def std(self) -> float:
        return float(np.std(self._values)) if self._values else 0.0

    def percentile(self, p: float) -> float:
        return float(np.percentile(self._values, p)) if self._values else 0.0

    def p50(self) -> float:
        return self.percentile(50)

    def p99(self) -> float:
        return self.percentile(99)

    def rate(self, window_s: float = 1.0) -> "Data":
        """Sample counts per window from the first sample, as a rate
        series (samples a second) at each window's start."""
        out = Data(f"{self.name}.rate")
        if not self._times_ns:
            return out
        window_ns = int(round(window_s * 1e9))
        start = self._times_ns[0]
        counts: dict[int, int] = {}
        for t in self._times_ns:
            counts[(t - start) // window_ns] = counts.get((t - start) // window_ns, 0) + 1
        for bucket_index in sorted(counts):
            out._times_ns.append(start + bucket_index * window_ns)
            out._values.append(counts[bucket_index] / window_s)
        return out

    def bucket(self, window_s: float) -> "BucketedData":
        return BucketedData(self, window_s)

    def __repr__(self) -> str:
        return f"Data({self.name!r}, n={len(self._values)})"


class BucketedData:
    """Fixed-window aggregation of a :class:`Data` series: windows of
    ``window_s`` aligned to multiples of it, only those holding samples."""

    __slots__ = (
        "window_s", "starts", "counts", "means", "mins", "maxes", "sums",
        "p50s", "p99s", "p999s",
    )

    def __init__(self, data: Data, window_s: float):
        self.window_s = window_s
        self.starts: list[Instant] = []
        self.counts: list[int] = []
        self.means: list[float] = []
        self.mins: list[float] = []
        self.maxes: list[float] = []
        self.sums: list[float] = []
        self.p50s: list[float] = []
        self.p99s: list[float] = []
        self.p999s: list[float] = []
        if not data._values:
            return
        window_ns = int(round(window_s * 1e9))
        origin = data._times_ns[0] - (data._times_ns[0] % window_ns)
        buckets: dict[int, list[float]] = {}
        for t, v in zip(data._times_ns, data._values):
            buckets.setdefault((t - origin) // window_ns, []).append(v)
        for index in sorted(buckets):
            values = np.asarray(buckets[index])
            self.starts.append(Instant(origin + index * window_ns))
            self.counts.append(len(values))
            self.means.append(float(values.mean()))
            self.mins.append(float(values.min()))
            self.maxes.append(float(values.max()))
            self.sums.append(float(values.sum()))
            self.p50s.append(float(np.percentile(values, 50)))
            self.p99s.append(float(np.percentile(values, 99)))
            self.p999s.append(float(np.percentile(values, 99.9)))

    def __len__(self) -> int:
        return len(self.starts)
