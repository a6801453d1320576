"""The traced window read back from torch.profiler's Chrome trace: the
device's busy intervals, the host's ranges, and which device work each
range launched.

The method of the repository's ``tools/trace_scan.py``: a device op (a
kernel, copy or memset) belongs to the host range in which the runtime
call that launched it ran, matched by its correlation id; the device is
busy where any device op runs. The window runs from the first call's
``bench.call`` range to the last one's end.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation",)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CALL = "bench.call"
# The program's ranges: its budget call, the event-step kernel's launch
# inside it, and the reduce over replicas.
SCOPES = ("hs.macro_block", "hs.kernel", "hs.reduce")


def merge(intervals) -> list:
    """Union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def length(intervals: list) -> float:
    return sum(hi - lo for lo, hi in intervals)


class TracedWindow:
    """Times in microseconds, as the trace holds them."""

    def __init__(self, events: list):
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        host = [e for e in spans if e.get("cat") in HOST_CATS]
        self.calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == CALL)
        if not self.calls:
            raise ValueError(f"no {CALL} range in the trace")
        self.start, self.end = self.calls[0][0], self.calls[-1][1]
        inside = lambda e: e["ts"] >= self.start and e["ts"] + e["dur"] <= self.end  # noqa: E731
        self.device = [e for e in spans if e.get("cat") in DEVICE_CATS and inside(e)]
        self.busy = merge((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        self.ranges = {
            name: merge((e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == name)
            for name in SCOPES
        }
        launched_at = {
            e["args"]["correlation"]: e["ts"]
            for e in spans
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})
        }
        self.launch_ts = [launched_at.get(e.get("args", {}).get("correlation")) for e in self.device]

    @classmethod
    def load(cls, path: Path) -> "TracedWindow":
        return cls(json.loads(Path(path).read_text())["traceEvents"])

    @property
    def window_us(self) -> float:
        return self.end - self.start

    @property
    def busy_us(self) -> float:
        return length(self.busy)

    def launched_under(self, scope: str) -> list:
        """The device ops whose launching call lies in a ``scope`` range."""
        ranges = self.ranges[scope]
        starts = [lo for lo, _ in ranges]
        out = []
        for op, ts in zip(self.device, self.launch_ts):
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= ranges[i][1]:
                out.append(op)
        return out

    def device_us_under(self, scope: str) -> float:
        """Device busy time of the work launched under ``scope``."""
        return length(merge((e["ts"], e["ts"] + e["dur"]) for e in self.launched_under(scope)))

    def host_exposed_us(self) -> list:
        """Per call: its wall time less the device-busy time inside it."""
        return [(hi - lo) - length(intersect(self.busy, [[lo, hi]])) for lo, hi in self.calls]

    def idle_gaps(self) -> list:
        """The device's idle intervals inside the window."""
        gaps, cursor = [], self.start
        for lo, hi in self.busy:
            if lo > cursor:
                gaps.append([cursor, lo])
            cursor = max(cursor, hi)
        if cursor < self.end:
            gaps.append([cursor, self.end])
        return gaps

    def idle_by_host_phase(self) -> dict:
        """Device idle seconds split by what the host was doing, each idle
        moment given to the first that holds it: inside ``hs.kernel``,
        ``hs.reduce`` or the rest of ``hs.macro_block``; in a call before
        its budget call (the engine's set-up) or after its reduce (the
        result); elsewhere in a call; between calls."""
        before, after = [], []
        for lo, hi in self.calls:
            first = min((a for a, _ in self.ranges["hs.macro_block"] if lo <= a <= hi), default=None)
            last = max((b for _, b in self.ranges["hs.reduce"] if lo <= b <= hi), default=None)
            if first is not None:
                before.append((lo, first))
            if last is not None:
                after.append((last, hi))
        phases = (
            ("hs.kernel", self.ranges["hs.kernel"]),
            ("hs.reduce", self.ranges["hs.reduce"]),
            ("hs.macro_block outside hs.kernel", self.ranges["hs.macro_block"]),
            ("engine set-up before hs.macro_block", merge(before)),
            ("result after hs.reduce", merge(after)),
            ("rest of bench.call", merge(self.calls)),
        )
        remaining = self.idle_gaps()
        out = {}
        for label, ranges in phases:
            out[label] = length(intersect(remaining, ranges)) / 1e6
            remaining = subtract(remaining, ranges)
        out["between calls"] = length(remaining) / 1e6
        return out

    def top_device_ops(self, n: int = 10) -> list:
        totals: dict = {}
        for e in self.device:
            totals[e["name"][:120]] = totals.get(e["name"][:120], 0.0) + e["dur"]
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in ranked]


def intersect(a: list, b: list) -> list:
    """The intersection of two merged interval lists, as intervals."""
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: list, b: list) -> list:
    """``a`` less ``b``, both merged interval lists."""
    out = []
    j = 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k, cursor = j, lo
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > cursor:
                out.append([cursor, b[k][0]])
            cursor = max(cursor, b[k][1])
            k += 1
        if cursor < hi:
            out.append([cursor, hi])
    return out
