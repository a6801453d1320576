"""Shape provenance and the per-replica budget of the event-step kernel
(counterpart of ``happysim_tpu/tpu/kernels/support.py`` and of the sizing
helpers in ``happysim_tpu/tpu/kernels/event_step.py``).

:func:`kernel_plan` is the JAX package's topology walk. For every model
JAX's ``kernel_plan`` approves (one source, one sink, every node on a
walked source->sink graph) it returns JAX's plan dict, shape ("mm1",
"chain", "router" or "graph") and all. It declines nothing: a model
JAX's kernel declines and runs on its lax step instead (several sources
or sinks, nodes no source reaches, no path to a sink) runs on the same
kernel here, and the plan records JAX's reason under ``"declined"``.

The JAX package sizes a replica tile against a VMEM budget. On the card
one thread runs one replica: the kernel keeps each server's small
registers (queue head and length, earliest completion and transit
arrival, counters and integrals) in per-thread register arrays sized at
compile time, reads the topology tables from its launch arguments, and
leaves the queue rings, the histogram and the router/limiter registers in
device memory in the JAX layout. The rows a step scans in lockstep across
a warp (transit, slot, fault-window and breaker rows) go to a tile of
dynamic shared memory, lane-minor, as far as a per-lane budget allows:
:func:`stage_budget` sizes it so that the launch stays one wave on the
card, :func:`stage_plan` picks the leaves in the order a step uses them.
The rest of the budget is a set of launch bounds, checked here before
every launch, plus the device memory the state occupies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from happysim_tpu_torch.model import LIMITER, ROUTER, SERVER, SINK, EnsembleModel
from happysim_tpu_torch.telemetry import MAX_WINDOWS

#: Threads per block of the event-step kernel (csrc/event_step.cuh's
#: HS_THREADS: 64, which tools/ab_block_loop.py timed faster than 128 on
#: the fan-out and the chaos bench; the wrapper checks the library's value
#: when it loads it).
KERNEL_THREADS = 64
#: The card the kernels are built for (sm_90a, the H100): its SMs, the
#: shared memory of one SM, the most one block may take, and what the
#: runtime reserves per resident block.
CARD_SMS = 132
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK = 227 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
#: Leaves the kernel may stage in shared memory, in the order its plan
#: takes them (csrc/event_step.cuh's HS_ST_*): the transit rows a park
#: and an arrival scan, the slot rows a start and a completion scan, the
#: fault windows an arrival at a faulted server scans, the breaker ring
#: a trip or a close resets, the partition windows a delivery into a
#: group's member and an arrival at a quorum member scan; then the two
#: rows of the window cache's counter pairs (no leaves: the trace
#: branch's lean code with telemetry counts the tenants' arrivals and the
#: sink's histogram bins in them, the cached window's and the launch's,
#: and adds them to the leaves when the window or the launch ends).
STAGE_LEAVES = (
    "tr_time", "tr_created", "tr_attempt",
    "srv_slot_done", "srv_slot_created", "srv_slot_attempt",
    "flt_start", "flt_end", "flt_sh_start", "flt_sh_end",
    "brk_fail_t",
    "prt_start", "prt_end",
    "tenant_pairs", "hist_pairs",
)

#: The lean instantiations' tables in the launch arguments: their
#: per-server register arrays are instantiated for 1, 2, 4 and 8 servers,
#: and each source, router, router target, router hop, limiter and
#: partition group is a row of a table in the argument struct
#: (csrc/event_step.cuh's HS_MAX_*). A model past one of them runs the
#: wide code (csrc/event_step_wide.cu: the per-server registers in device
#: memory, the tables in one device buffer), which bounds none of these
#: counts; :func:`wide_reasons` names the tables a model is past.
LEAN_MAX_SERVERS = 8
LEAN_MAX_SOURCES = 8
LEAN_MAX_ROUTERS = 8
LEAN_MAX_TARGETS = 8
LEAN_MAX_HOPS = 8
LEAN_MAX_LIMITERS = 4
LEAN_MAX_PARTITIONS = 8
#: Remote egress nodes of a partitioned model in the lean code's table of
#: their latencies and ingress servers in the argument struct
#: (csrc/event_step.cuh's HS_MAX_REMOTES); a model with more runs the wide
#: code, which reads them from its device tables and bounds none.
KERNEL_MAX_REMOTES = 8
#: Sinks per model: sink 0 adds to a lane's registers and the others to
#: their (R, nK) leaves and (R, nK, 80) histogram rows in device memory,
#: 1.3 GB of histogram at 65,536 replicas at this bound.
KERNEL_MAX_SINKS = 64
#: Partition windows per group (Wp): a loop at each consult.
KERNEL_MAX_PARTITION_WINDOWS = 4096
#: Slots per server (a loop over device memory at each event).
KERNEL_MAX_CONCURRENCY = 1024
#: Queue-ring length.
KERNEL_MAX_QUEUE = 1 << 20
#: Event steps per launch.
KERNEL_MAX_MACRO = 4096
#: In-flight transit slots per server (a loop over device memory at each
#: park and transit arrival).
KERNEL_MAX_TRANSIT = 4096
#: Grid points of a rate profile's tables: the two (G,) float32 tables
#: are staged in a thread block's shared memory, 32 KB at this bound.
KERNEL_MAX_PROFILE_GRID = 4096
#: Fault windows per server (W) and in the shared schedule (W_sh): a loop
#: over device memory at each arrival at, and pull into, a faulted server.
KERNEL_MAX_FAULT_WINDOWS = 4096
#: Telemetry windows: the spec's own bound (telemetry.MAX_WINDOWS); the
#: window buffers stay in device memory, and an interval split loops over
#: the windows it spans.
KERNEL_MAX_WINDOWS = MAX_WINDOWS
#: The breaker's failure ring brk_fail_t, (nV, F) per replica with F the
#: failure threshold. The kernel reads it in device memory: a failure
#: writes one slot and compares one, but a trip or a close resets all F,
#: and the ring takes R * nV * F * 4 bytes (8.6 GB for 65,536 replicas of
#: 8 servers at this bound, inside the card's 80 GB), which bounds F.
KERNEL_MAX_BREAKER_RING = 4096

#: The telemetry leaves, in the order of the kernel's HsTel arguments:
#: (nW, nK) sink counts and latency sums, the (nW, nK, 80) histogram,
#: the (nW, nV) depth and busy integrals and per-server counters, the
#: (nW, nL) limiter counters and the (nW,) packet losses. Each exists
#: only where the spec and the model ask for it.
TEL_LEAVES = (
    "tel_sink_count", "tel_sink_sum", "tel_sink_hist",
    "tel_srv_depth_int", "tel_srv_busy_int",
    "tel_srv_completed", "tel_srv_dropped", "tel_srv_timed_out", "tel_srv_retried",
    "tel_srv_outage_dropped", "tel_srv_fault_dropped", "tel_srv_fault_retried",
    "tel_srv_hedged", "tel_srv_hedge_wins", "tel_tr_dropped",
    "tel_lim_admitted", "tel_lim_dropped", "tel_net_lost",
)
#: The consensus leaves, in the order of the kernel's HsCon arguments: the
#: (nP, Wp) partition windows, the partition drops and the quorum's
#: rejections, then their window buffers (a model with telemetry only).
#: The sweeps' leaves (the quorum's dark time, the elections, their
#: window integrals) are made at init and not touched by the kernel.
CON_LEAVES = (
    "prt_start", "prt_end", "net_partitioned", "qrm_dropped",
    "tel_net_partitioned", "tel_qrm_dropped",
)
#: The resilience leaves, in the order of the kernel's HsRes arguments:
#: the breaker's (nV,) registers and (nV, F) failure ring, the shed's
#: counter, the budget's bucket, then their (nW, nV) window buffers (a
#: model with telemetry only). Each exists only where its spec is.
RES_LEAVES = (
    "brk_state", "brk_fail_t", "brk_fail_idx", "brk_open_t", "brk_probes",
    "brk_tripped", "brk_open_time", "srv_breaker_dropped",
    "srv_shed_dropped",
    "bud_tokens", "bud_last", "srv_budget_dropped",
    "tel_srv_breaker_dropped", "tel_brk_tripped", "tel_brk_open_int",
    "tel_srv_shed_dropped", "tel_srv_budget_dropped",
)
#: The trace-driven leaves, in the order of the kernel's HsTrc arguments:
#: the read cursor (uint32) and the lane's block count, its arrivals per
#: tenant, and their (nW, nT) window buffer (a model with telemetry
#: rates only).
TRC_LEAVES = ("trc_cursor", "trc_blocks", "trc_arrivals", "tel_trc_arrivals")

#: Leaves the kernel reads and writes; the other state leaf (the key) is
#: not touched. The transit leaves exist only when the model has latency
#: edges into servers or backoff retries; the chaos leaves after
#: "tr_dropped" (touched by the chaos instantiation only) only where the
#: model declares the feature, except the three counters every chaos
#: model carries (timed out, retried, brownout drops); the telemetry
#: leaves (touched by the telemetry instantiations only) only with a
#: spec; the resilience leaves (the resilience instantiations only) only
#: where their spec is; the consensus leaves (the consensus
#: instantiations only) only where the model has the feature; the trace
#: leaves (the trace instantiations only) only with a traced source.
KERNEL_LEAVES = (
    "t", "src_next", "events",
    "srv_slot_done", "srv_slot_created", "srv_q_created", "srv_q_enq",
    "srv_q_head", "srv_q_len", "srv_started", "srv_completed",
    "srv_dropped", "srv_wait_n", "srv_busy_int", "srv_depth_int",
    "srv_wait_sum", "sink_count", "sink_sum", "sink_sq", "sink_hist",
    "rr_next", "lim_tokens", "lim_last", "lim_admitted", "lim_dropped",
    "tr_time", "tr_created", "tr_dropped",
    "srv_slot_attempt", "srv_q_attempt", "tr_attempt",
    "flt_start", "flt_end", "flt_sh_start", "flt_sh_end",
    "srv_timed_out", "srv_retried", "srv_outage_dropped",
    "srv_fault_dropped", "srv_fault_retried", "srv_hedged", "srv_hedge_wins",
    "net_lost",
    *TEL_LEAVES,
    *RES_LEAVES,
    *CON_LEAVES,
    *TRC_LEAVES,
)
#: Leaves whose entries a block touches only at events (ring pushes and
#: pulls, transit parks and arrivals, histogram bumps, router and limiter
#: registers, and every chaos leaf: attempt numbers move with jobs, the
#: fault registers are read at arrivals and pulls of faulted servers, the
#: chaos counters are bumped where they count; and every telemetry leaf:
#: a counter is bumped, and an integral added to, only in the windows
#: the event's time or interval falls in; and every resilience leaf: a
#: breaker, shed or budget register is read and written only at an
#: arrival at or a completion of its server; and every consensus leaf:
#: the partition windows are read at a delivery into a group's member or
#: an arrival at a quorum member, a counter bumped where it counts; and
#: the traced arrivals per tenant, bumped at a traced fire): left out of
#: the bytes bound, which keeps it a lower bound.
SPARSE_LEAVES = (
    "srv_q_created", "srv_q_enq", "sink_hist",
    "rr_next", "lim_tokens", "lim_last", "lim_admitted", "lim_dropped",
    "tr_time", "tr_created", "tr_dropped",
    "srv_slot_attempt", "srv_q_attempt", "tr_attempt",
    "flt_start", "flt_end", "flt_sh_start", "flt_sh_end",
    "srv_timed_out", "srv_retried", "srv_outage_dropped",
    "srv_fault_dropped", "srv_fault_retried", "srv_hedged", "srv_hedge_wins",
    "net_lost",
    *TEL_LEAVES,
    *RES_LEAVES,
    *CON_LEAVES,
    "trc_arrivals", "tel_trc_arrivals",
)

#: Router policies the kernel runs: all four.
KERNEL_ROUTER_POLICIES = (
    "random",
    "round_robin",
    "weighted",
    "least_outstanding",
)


def kernel_plan(model: EnsembleModel) -> dict:
    """The kernel's plan: ``{"shape": "mm1" | "chain", "servers": [...]}``
    for router-free lines (servers in the order a job visits them),
    ``{"shape": "router", "servers": [...], "policy": ...}`` for the pure
    load-balancer fan-out (servers in target order), and
    ``{"shape": "graph", "servers", "routers", "policies"}`` (BFS order)
    for every other graph, each with ``"chaos"``: the model's
    :meth:`~happysim_tpu_torch.model.EnsembleModel.chaos_features` (JAX's
    plan dict, where JAX's kernel approves the model).

    A model JAX's kernel declines on its topology gets a plan too, with
    JAX's reasons joined under ``"declined"`` and the nodes no source
    reaches under ``"unreached"`` (they hold their state and report
    zeros, as on JAX's lax step). Its servers and routers are those the
    walk from every source reaches, in BFS order. A model with several
    sources or sinks has the port's own shape, ``"multi"``, with
    ``"sources"`` and ``"sinks"`` counts (JAX's ``kernel_shape`` is ""
    for it: its kernel declined it); a single-source, single-sink model
    keeps the shape the walk classifies. A traced model's plan records
    JAX's trace decline too: the port runs it on the kernel, its pages
    streamed between launches."""
    reasons: list[str] = []
    if model.traced_source_index() is not None:
        reasons.append(
            "model has trace-driven arrivals (streamed trace pages are "
            "not fused in the kernel yet)"
        )
    if len(model.sources) != 1:
        reasons.append(f"{len(model.sources)} sources (kernel supports 1)")
    if len(model.sinks) != 1:
        reasons.append(f"{len(model.sinks)} sinks (kernel supports 1)")
    plan: Optional[dict] = None
    if len(model.sources) == 1:
        plan = _graph_plan(model, reasons)
    if plan is None:
        plan = _reached_plan(model)
    if reasons:
        plan["declined"] = "; ".join(dict.fromkeys(reasons))
    plan["chaos"] = model.chaos_features()
    return plan


def _follow_limiters(model: EnsembleModel, ref, visited: list[int], reasons: list[str]):
    """Resolve a downstream ref through any token-bucket limiters
    (transparent admission hops), recording each limiter visited."""
    walk: set[int] = set()
    while ref is not None and ref.kind == LIMITER:
        if ref.index in walk:  # unreachable via connect(), which forbids
            # limiter->limiter edges — guards hand-mutated specs.
            reasons.append(f"limiter[{ref.index}] is on a feedback loop")
            return None
        walk.add(ref.index)
        if ref.index not in visited:
            visited.append(ref.index)
        ref = model.limiters[ref.index].downstream
    return ref


def _walk(model: EnsembleModel, starts: list, reasons: list[str]) -> tuple:
    """BFS from ``starts`` across every node a job can reach: returns the
    servers, routers and limiters it visited, in BFS order, and whether
    it reached a sink; appends a reason for a router policy outside the
    kernel's set."""
    limiters: list[int] = []
    seen_servers: list[int] = []
    seen_routers: list[int] = []
    reached_sink = False
    visited: set[tuple[str, int]] = set()
    queue = list(starts)
    while queue:
        ref = _follow_limiters(model, queue.pop(0), limiters, reasons)
        if ref is None:
            continue
        if (ref.kind, ref.index) in visited:
            continue
        visited.add((ref.kind, ref.index))
        if ref.kind == SINK:
            reached_sink = True
        elif ref.kind == SERVER:
            seen_servers.append(ref.index)
            queue.append(model.servers[ref.index].downstream)
        elif ref.kind == ROUTER:
            seen_routers.append(ref.index)
            router = model.routers[ref.index]
            if router.policy not in KERNEL_ROUTER_POLICIES:
                reasons.append(
                    f"router[{ref.index}] policy {router.policy!r} is "
                    "outside the kernel set " + "/".join(KERNEL_ROUTER_POLICIES)
                )
            queue.extend(router.targets)
    return seen_servers, seen_routers, limiters, reached_sink


def _graph_plan(model: EnsembleModel, reasons: list[str]) -> Optional[dict]:
    """JAX's walk from the single source; appends a reason for every
    structural decline and returns the plan only when it added none."""
    before = len(reasons)
    seen_servers, seen_routers, limiters, reached_sink = _walk(
        model, [model.sources[0].downstream], reasons
    )
    if len(reasons) == before and not reached_sink:
        reasons.append("no path from the source reaches the sink")
    # Membership checks only when the walk itself succeeded (a broken
    # walk reaches fewer nodes by definition).
    if len(reasons) == before:
        orphans = [i for i in range(len(model.servers)) if i not in seen_servers]
        if orphans:
            reasons.append(
                "servers outside the source->sink graph: "
                + ", ".join(f"server[{i}]" for i in orphans)
            )
        for i in range(len(model.routers)):
            if i not in seen_routers:
                reasons.append(f"router[{i}] is outside the source->sink graph")
        for i in range(len(model.limiters)):
            if i not in limiters:
                reasons.append(f"limiter[{i}] is outside the source->sink path")
    if len(reasons) > before:
        return None
    return _shape_plan(model, seen_servers, seen_routers)


def _shape_plan(model: EnsembleModel, servers: list[int], routers: list[int]) -> dict:
    """The walk's classification of a single-source, single-sink graph."""
    if not routers:
        # BFS order is chain order on a router-free line.
        return {"shape": "mm1" if len(servers) == 1 else "chain", "servers": servers}
    pure = _pure_fanout_plan(model)
    if pure is not None:
        return pure
    return {
        "shape": "graph",
        "servers": servers,
        "routers": routers,
        "policies": tuple(model.routers[i].policy for i in routers),
    }


def _reached_plan(model: EnsembleModel) -> dict:
    """The plan of a model JAX's kernel declines on its topology: the walk
    from every source, in source order, and the nodes it leaves out."""
    scratch: list[str] = []
    servers, routers, limiters, _sink = _walk(
        model, [s.downstream for s in model.sources], scratch
    )
    if len(model.sources) == 1 and len(model.sinks) == 1:
        plan = _shape_plan(model, servers, routers)
    else:
        plan = {
            "shape": "multi",
            "sources": len(model.sources),
            "sinks": len(model.sinks),
            "servers": servers,
            "routers": routers,
        }
    plan["unreached"] = {
        "servers": [i for i in range(len(model.servers)) if i not in servers],
        "routers": [i for i in range(len(model.routers)) if i not in routers],
        "limiters": [i for i in range(len(model.limiters)) if i not in limiters],
    }
    return plan


def _pure_fanout_plan(model: EnsembleModel) -> Optional[dict]:
    """The classic load-balancer shape: 1 source -> (limiter?) -> the ONE
    router -> N distinct servers (every declared server) -> (limiter?) ->
    the sink. Returns the ``"router"`` plan (servers in target order) or
    None for anything richer."""
    if len(model.routers) != 1:
        return None
    router = model.routers[0]
    if any(t.kind != SERVER for t in router.targets):
        return None
    servers = [t.index for t in router.targets]
    if len(set(servers)) != len(servers):
        return None
    if set(servers) != set(range(len(model.servers))):
        return None
    scratch: list[str] = []
    fed = _follow_limiters(model, model.sources[0].downstream, [], scratch)
    if fed is None or fed.kind != ROUTER:
        return None
    for index in servers:
        down = _follow_limiters(model, model.servers[index].downstream, [], scratch)
        if down is None or down.kind != SINK:
            return None
    return {"shape": "router", "servers": servers, "policy": router.policy}


def wide_reasons(compiled) -> list:
    """The lean tables a model is past, each as ``"name=value > bound"``
    (empty: the lean instantiations run it; else the wide code does)."""
    model = compiled.model
    counts = (
        ("servers", compiled.nV, LEAN_MAX_SERVERS),
        ("sources", compiled.nS, LEAN_MAX_SOURCES),
        ("routers", len(model.routers), LEAN_MAX_ROUTERS),
        ("targets per router", max((len(r.targets) for r in model.routers), default=0),
         LEAN_MAX_TARGETS),
        ("router hop depth", compiled.hop_depth, LEAN_MAX_HOPS),
        ("limiters", len(model.limiters), LEAN_MAX_LIMITERS),
        ("partition groups", compiled.partitions.nP if compiled.has_partitions else 0,
         LEAN_MAX_PARTITIONS),
        ("remote egress nodes", len(getattr(model, "remotes", ())), KERNEL_MAX_REMOTES),
    )
    return [f"{name}={value} > {bound}" for name, value, bound in counts if value > bound]


def check_kernel_bounds(compiled, macro: int) -> None:
    """Raise ``ValueError`` naming the bound a launch would break: what
    device memory, shared memory or a loop at each event bounds. The
    model's counts of servers, sources, routers, targets,
    hops, limiters, partition groups and uniform draws bound nothing: past
    the lean tables a model runs the wide code (:func:`wide_reasons`)."""
    bounds = (
        ("sinks", compiled.nK, KERNEL_MAX_SINKS),
        ("concurrency", compiled.C, KERNEL_MAX_CONCURRENCY),
        ("queue_capacity", compiled.K, KERNEL_MAX_QUEUE),
        ("macro_block", macro, KERNEL_MAX_MACRO),
        ("transit_capacity", compiled.TR if compiled.has_transit else 0, KERNEL_MAX_TRANSIT),
        ("fault windows W", compiled.faults.W if compiled.has_faults else 0, KERNEL_MAX_FAULT_WINDOWS),
        (
            "shared fault windows W_sh",
            compiled.faults.W_sh if compiled.has_faults else 0,
            KERNEL_MAX_FAULT_WINDOWS,
        ),
        (
            "profile grid points",
            compiled.profile_times.shape[1] if compiled.has_profile.any() else 0,
            KERNEL_MAX_PROFILE_GRID,
        ),
        ("telemetry windows nW", compiled.nW, KERNEL_MAX_WINDOWS),
        ("breaker ring brk_fail_t width F", compiled.brk_F, KERNEL_MAX_BREAKER_RING),
        (
            "partition windows Wp",
            compiled.partitions.Wp if compiled.has_partitions else 0,
            KERNEL_MAX_PARTITION_WINDOWS,
        ),
        ("profile tables' bytes", profile_table_bytes(compiled), SMEM_PER_BLOCK),
    )
    for name, value, bound in bounds:
        if value > bound:
            raise ValueError(
                f"event-step kernel: {name}={value} exceeds its bound {bound}"
            )


def profile_table_bytes(compiled) -> int:
    """Bytes of a thread block's profile tables: the (G,) time and
    cumulative grids of every profiled source, staged in its shared
    memory ahead of the row tile."""
    n_profiled = int(np.asarray(compiled.has_profile).sum())
    return 2 * n_profiled * int(compiled.profile_times.shape[1]) * 4


def stage_budget(
    n_replicas: int, table_bytes: int = 0, threads: int = KERNEL_THREADS, sms: int = CARD_SMS
) -> int:
    """Bytes of shared memory each lane may stage so that a launch over
    ``n_replicas`` stays one wave: the blocks of ``threads`` lanes spread
    over ``sms`` SMs, each SM's shared memory split among the blocks it
    then holds, less the runtime's reserve and the block's profile tables
    (``table_bytes``), within the most one block may take."""
    blocks = -(-n_replicas // threads)
    per_sm = max(-(-blocks // sms), 1)
    block_bytes = min(SMEM_PER_SM // per_sm - SMEM_RESERVED_PER_BLOCK, SMEM_PER_BLOCK)
    return max(block_bytes - table_bytes, 0) // threads


def stage_plan(row_words: dict, lane_bytes: int) -> tuple:
    """The leaves a lane stages: ``row_words`` maps a leaf of
    :data:`STAGE_LEAVES` to the 4-byte words of one replica's rows (a leaf
    the model has not got is absent), and each leaf, in the order of
    :data:`STAGE_LEAVES`, is staged when it fits what ``lane_bytes`` has
    left. Returns ``(offsets, words)``: each leaf's word offset in a
    lane's column of the tile (-1: left in device memory), and the
    column's words."""
    offsets, words = [], 0
    for leaf in STAGE_LEAVES:
        n = row_words.get(leaf, 0)
        if n and 4 * (words + n) <= lane_bytes:
            offsets.append(words)
            words += n
        else:
            offsets.append(-1)
    return offsets, words


def replica_tile_bytes(leaves) -> int:
    """Bytes one replica's copy of ``leaves`` occupies (tensors without
    the replica axis)."""
    return sum(
        int(np.prod(tuple(leaf.shape), dtype=np.int64)) * leaf.element_size()
        for leaf in leaves
    )


def shared_const_bytes(compiled) -> int:
    """Bytes of the constants a launch shares across replicas: one ``(G,)``
    time grid and one ``(G,)`` cumulative grid per profiled source, plus
    16 bytes of scalars each (JAX ``shared_const_bytes``)."""
    n_profiled = int(np.asarray(compiled.has_profile).sum())
    if n_profiled == 0:
        return 0
    n_grid = int(compiled.profile_times.shape[1])
    return n_profiled * (2 * n_grid * 4 + 16)


def launch_bytes(compiled, state: dict) -> int:
    """Bytes one launch over every replica of ``state`` must move: each
    replica's working set, and the shared profile tables read once. The
    telemetry buffers count as sparse (an event touches the windows its
    time or interval falls in, not the buffer), so a telemetry model has
    the bound of the same model without its spec; so do the resilience
    leaves, touched only at their server's events."""
    R = state["t"].shape[0]
    return R * replica_working_set_bytes(compiled, state) + shared_const_bytes(compiled)


def replica_working_set_bytes(compiled, state: dict) -> int:
    """Bytes one replica must move in one launch on the kernel path,
    whatever its block count: every dense kernel leaf read once and
    written once, and the replica's key (two uint32 words) and parameter
    rows read once; the kernel draws each block's uniforms from the key,
    so none is read. ``state`` is an
    ``(R, ...)`` state dict; the sparse leaves' traffic is left out, and
    so are the shared profile tables (:func:`launch_bytes` counts them
    once per launch)."""
    dense = [
        state[name][0]
        for name in KERNEL_LEAVES
        if name not in SPARSE_LEAVES and name in state
    ]
    return 2 * replica_tile_bytes(dense) + 2 * 4 + (compiled.nS + compiled.nV) * 4


#: Integer operations of one threefry2x32 (csrc/threefry.cuh's
#: HS_THREEFRY_OPS): the key schedule, 20 rounds of an add, a rotate and a
#: xor, and 5 key injections.
THREEFRY_OPS = 79
#: Integer operations of one drawn uniform: its threefry, then b0 ^ b1, the
#: shift, the or of the exponent and the index add.
UNIFORM_INT_OPS = THREEFRY_OPS + 4


#: The integer operations of one threefry2x32 that only the integer ALU
#: pipe issues: its 20 rotates and 20 xors and the key schedule's two xors
#: (its adds may also issue as IMAD on the FMA pipe); one drawn uniform
#: adds the xor, the shift and the or of its mantissa.
THREEFRY_ALU_OPS = 42
UNIFORM_ALU_OPS = THREEFRY_ALU_OPS + 3


def draw_alu_ops(folds: int, drawn: int) -> int:
    """The operations of :func:`draw_int_ops` that only the integer ALU
    pipe issues."""
    return folds * THREEFRY_ALU_OPS + (drawn - folds) * UNIFORM_ALU_OPS


def draw_int_ops(folds: int, drawn: int) -> int:
    """Integer operations of the draws of a launch that ran ``folds``
    lane-blocks and made ``drawn`` threefry evaluations in all, as the
    kernel counts them (``launch_args(..., draws=, blocks=)``): one fold
    of the block index into the key per lane and block it ran, and one
    per uniform a taken branch read."""
    return folds * THREEFRY_OPS + (drawn - folds) * UNIFORM_INT_OPS
