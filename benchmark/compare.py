"""The comparison that decides ``correct``: a call's result from the
program against the plain reference's totals of the same ensemble, over
the fields the reference names (its ``FIELDS``: ``"exact"`` for integer
totals, ``"float"`` for float statistics).

Two numbers, each with its limit (the readings they were set from are in
PERF.md):

- ``counts_differing``: how many integer totals differ (for the graph
  reference: events, blocks, truncated replicas, and per sink and server
  every count and latency histogram bin). The simulation is exact: the
  same seed gives the same events, so the limit is 0.
- ``stats_rel_gap``: the widest relative gap of the float statistics
  (mean latency per sink; mean wait, utilisation and mean queue length
  per server). A NaN on either side is an infinite gap.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"counts_differing": 0, "stats_rel_gap": 1e-6}


def program_totals(result, fields: dict) -> dict:
    """The compared ``fields`` of an ``EnsembleResult``, as plain numbers."""
    out = {}
    for key in fields["exact"] + fields["float"]:
        value = getattr(result, key)
        out[key] = value.tolist() if isinstance(value, np.ndarray) else value
    return out


def readings(program: dict, reference: dict, fields: dict) -> dict:
    counts = 0
    for key in fields["exact"]:
        a = np.asarray(program[key], np.int64).ravel()
        b = np.asarray(reference[key], np.int64).ravel()
        counts += int(np.sum(a != b)) if a.shape == b.shape else max(a.size, b.size)
    gap = 0.0
    for key in fields["float"]:
        a = np.asarray(program[key], np.float64).ravel()
        b = np.asarray(reference[key], np.float64).ravel()
        if a.shape != b.shape:
            return {"counts_differing": counts, "stats_rel_gap": float("inf")}
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
        rel = np.where(a == b, 0.0, rel)
        rel = np.where(np.isnan(a) | np.isnan(b), np.inf, rel)
        gap = max(gap, float(np.max(rel, initial=0.0)))
    return {"counts_differing": counts, "stats_rel_gap": gap}


def verdict(values: dict) -> bool:
    """Every number within its limit (an infinite or NaN reading fails)."""
    return all(np.isfinite(values[k]) and values[k] <= LIMITS[k] for k in LIMITS)
