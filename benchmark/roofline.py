"""The least time an ensemble's event steps could take on the card: the
peaks of the device, and the bytes and integer operations a call needs,
counted from the cell's graph and the call's own totals.

The counts follow the simulation's definition, not the program's state
layout, so a change of layout moves neither:

- bytes: each replica's inputs read once (its key, its sources' rates,
  its servers' service means) and the totals its reduce reads written
  once (per sink: count, sum, sum of squares and the latency histogram;
  per server: its ten counters and sums; the replica's events, blocks
  and lost crossings), 4 bytes a number;
- integer operations: a threefry2x32 block for each macro-block of each
  replica (its key folded with the block's index), and one for each
  uniform a job needs, plus the three operations that make a uniform of
  its words. Needed uniforms, by the graph: each completion's service
  draw; and for each job that reached a server, the arrival gap of a
  Poisson source that fed it, the latency of an exponential edge and the
  Bernoulli of a lossy edge it crossed; and each crossing lost. Jobs that
  reached server ``v`` are counted as its completions less its retries,
  so jobs still queued at the horizon are left out and the count stays
  a lower bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 (NVIDIA's data sheet, 700 W): HBM3 bandwidth, and the
# 32-bit integer rate of the INT32 lanes: 64 lanes an SM on 132 SMs at
# the 1.98 GHz boost clock, which issue every add, logic op and shift.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# One threefry2x32 block: the third key word (one three-input xor), the
# two initial key adds, 20 rounds of an add, a rotate (one funnel shift)
# and an xor, and five key injections of two three-input adds.
OPS_PER_THREEFRY = 1 + 2 + 20 * 3 + 5 * 2
# A uniform: its counter, the xor of the two words, the shift and the or
# that make the mantissa.
OPS_PER_UNIFORM = OPS_PER_THREEFRY + 4
BYTES_PER_NUMBER = 4
HIST_BINS = 80
COUNTERS_PER_SERVER = 10
COUNTERS_PER_SINK = 3


def _node(text: str) -> tuple:
    kind, index = text.split(":")
    return kind, int(index)


def feeds(spec: dict) -> list:
    """Per server: whether a Poisson source, an exponential edge and a
    lossy edge lie on the way of every job that reaches it."""
    poisson = [s.get("kind", "poisson") == "poisson" for s in spec["sources"]]
    into_router = {}
    out = [{"poisson": False, "exp": False, "loss": False} for _ in spec["servers"]]
    for e in spec["edges"]:
        (fk, fi), (tk, ti) = _node(e["from"]), _node(e["to"])
        if fk == "source" and tk == "router":
            into_router[ti] = poisson[fi]
    for e in spec["edges"]:
        (fk, fi), (tk, ti) = _node(e["from"]), _node(e["to"])
        if tk != "server":
            continue
        if fk == "source":
            out[ti]["poisson"] = poisson[fi]
        elif fk == "router":
            out[ti]["poisson"] = into_router.get(fi, False)
        exp = float(e.get("latency_s", 0.0)) > 0 and e.get("latency_kind") == "exponential"
        out[ti]["exp"] = out[ti]["exp"] or exp
        out[ti]["loss"] = out[ti]["loss"] or float(e.get("loss_p", 0.0)) > 0
    return out


def call_bytes(spec: dict) -> int:
    R, nS, nV, nK = (
        int(spec["replicas"]), len(spec["sources"]), len(spec["servers"]), int(spec["sinks"])
    )
    inputs = 2 + nS + nV
    outputs = nK * (COUNTERS_PER_SINK + HIST_BINS) + nV * COUNTERS_PER_SERVER + 3
    return R * BYTES_PER_NUMBER * (inputs + outputs)


def call_int_ops(spec: dict, totals: dict) -> int:
    """``totals``: the call's ``server_completed``, ``server_retried``,
    ``network_lost`` and ``blocks_total``."""
    uniforms = int(totals["network_lost"])
    for v, f in enumerate(feeds(spec)):
        done = int(totals["server_completed"][v])
        jobs = max(done - int(totals["server_retried"][v]), 0)
        uniforms += done + jobs * (int(f["poisson"]) + int(f["exp"]) + int(f["loss"]))
    return uniforms * OPS_PER_UNIFORM + int(totals["blocks_total"]) * OPS_PER_THREEFRY


def least_seconds(spec: dict, totals: dict) -> tuple:
    """``(seconds, bound)``: the larger of the bytes' and the operations'
    times on the card, and which of the two it is."""
    by_bytes = call_bytes(spec) / PEAK_BYTES_PER_S
    by_ops = call_int_ops(spec, totals) / PEAK_INT32_OPS_PER_S
    return (by_ops, "INT32") if by_ops >= by_bytes else (by_bytes, "bytes")
