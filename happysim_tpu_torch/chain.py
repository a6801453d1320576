"""Closed-form fast path for tandem-queue chains (counterpart of
``happysim_tpu/tpu/chain.py``).

A single-server FIFO stage is the Lindley recurrence

    start_n = max(A_n, D_{n-1});  D_n = start_n + S_n

whose departures have the max-plus prefix form

    D_n = cumsum(S)_n + cummax_n(A - shifted_cumsum(S))

one ``cumsum`` and one ``cummax`` over the customer axis per stage, for
every replica at once, with no per-event control flow. Each stage's
departures are the next stage's (sorted) arrivals. ``run_ensemble`` takes
this path, as the JAX engine does, for one Poisson source feeding a chain
of FIFO concurrency-1 servers into the sink, or a single random or
round-robin router over such chains, when the call names no event budget.

Finite queue capacity is honoured by certificate: with arrivals and
departures both monotone, "arrival ``n`` found more than ``cap`` in the
system" is the shifted compare ``D[n-cap-1] > A[n]``. If any arrival in
any replica would have found its queue full, :func:`run_chain` declines
(returns None) and the caller runs the event scan.

The draws are JAX's: replica ``r``'s uniforms for purpose ``p`` are
``uniform(fold_in(key_r, p), (n_customers, *extra), 1e-12, 1.0)``, made on
the card by the draw kernel (``kernels/uniform.py``) and on the CPU by
its plain version, :func:`happysim_tpu_torch.rng.uniform`. On the CPU the
prefix sums add in XLA's CPU order (``faults.cumsum_like_xla``); on the
card ``torch.cumsum`` adds in its own, as XLA on a device would.
"""

from __future__ import annotations

import logging
import math
import time as _wall
from typing import Optional

import numpy as np
import torch

from happysim_tpu_torch.engine import _SQRT2, HIST_BINS, _f32, _hist_bin
from happysim_tpu_torch.faults import cumsum_like_xla
from happysim_tpu_torch.kernels import uniform as uniform_kernel
from happysim_tpu_torch.model import ROUTER, SERVER, SINK, EnsembleModel
from happysim_tpu_torch.numerics import erfinv
from happysim_tpu_torch.reduce import N_LIMBS, host_i64, reduce_over_processes, sum_i64_limbs

logger = logging.getLogger("happysim_tpu_torch.chain")

# Cap on elements per (replicas x customers) block: keeps the ~10 live
# (R, N) float32 intermediates under ~6 GB of device memory.
_BLOCK_ELEMENTS = 128 * 1024 * 1024


def _constant_edge(edge) -> Optional[float]:
    """The edge's constant latency in seconds, or None if inexpressible
    (exponential latencies reorder the stream; packet loss thins it)."""
    if edge.loss_p > 0.0:
        return None
    if edge.mean_s == 0.0:
        return 0.0
    return float(edge.mean_s) if edge.kind == "constant" else None


def _source_ok(model: EnsembleModel) -> bool:
    if len(model.sources) != 1 or len(model.sinks) != 1:
        return False
    if model.limiters or getattr(model, "remotes", None):
        return False
    # Windowed telemetry needs the event scan's per-event accounting.
    if model.telemetry_spec is not None:
        return False
    # Correlated fault schedules darken servers over time.
    if model.correlated_faults is not None:
        return False
    # The resilience defenses are event-time dynamics; each declines.
    if model.circuit_breaker_spec is not None:
        return False  # circuit_breaker: open windows thin the arrivals
    if model.load_shed_spec is not None:
        return False  # load_shed: admission depends on live queue state
    if model.retry_budget_spec is not None:
        return False  # retry_budget: token state couples consecutive jobs
    # The consensus layer and trace-driven arrivals (the latter not in
    # this port, ROADMAP A.12) decline by name as in the JAX package.
    if getattr(model, "network_partitions", None):
        return False  # network_partitions: windows drop/delay deliveries
    if getattr(model, "quorum_spec", None) is not None:
        return False  # quorum: availability gate rejects in-window arrivals
    if getattr(model, "leader_election_spec", None) is not None:
        return False  # leader_election: per-replica election state machine
    source = model.sources[0]
    if getattr(source, "trace", None) is not None:
        return False  # trace_arrivals: recorded stream, scan path only
    if source.arrival != "poisson" or source.profile is not None:
        return False
    return _constant_edge(source.latency) is not None


def _walk_chain(model: EnsembleModel, ref, entry_latency: float, seen: set) -> Optional[dict]:
    """Follow server downstreams from ``ref`` to the sink; None if the
    walk hits anything the closed form cannot express. Returns
    ``{"stages": [(server index, latency into it)], "exit_lat": float}``."""
    stages: list = []
    latency_in = entry_latency
    while ref is not None and ref.kind == SERVER:
        if ref.index in seen:
            return None  # feedback loop / shared server
        seen.add(ref.index)
        spec = model.servers[ref.index]
        if (
            spec.concurrency != 1
            or spec.deadline_s is not None
            or spec.outage_start_s is not None
            # Fault windows, backoff retries and hedges change the
            # departure process beyond the Lindley form.
            or spec.fault is not None
            or spec.retry_backoff_s is not None
            or spec.hedge_delay_s is not None
        ):
            return None
        out_latency = _constant_edge(spec.latency)
        if out_latency is None:
            return None
        stages.append((ref.index, latency_in))
        latency_in = out_latency
        ref = spec.downstream
    if ref is None or ref.kind != SINK:
        return None
    return {"stages": stages, "exit_lat": latency_in}


def chain_plan(model: EnsembleModel) -> Optional[list]:
    """Server indices in chain order if the pure-chain fast path applies:
    one stationary Poisson source, a chain of concurrency-1 servers with
    no deadlines, retries, outages, faults or hedges, one sink, constant
    edges, no routers or limiters."""
    branch = _chain_branch(model)
    if branch is None or not branch["stages"]:
        return None
    return [v for v, _ in branch["stages"]]


def _chain_branch(model: EnsembleModel) -> Optional[dict]:
    if not _source_ok(model) or model.routers:
        return None
    seen: set = set()
    entry = _constant_edge(model.sources[0].latency)
    branch = _walk_chain(model, model.sources[0].downstream, entry, seen)
    if branch is None or len(seen) != len(model.servers):
        return None
    return branch


def fanout_plan(model: EnsembleModel) -> Optional[dict]:
    """source -> router -> parallel branches -> sink, if expressible: each
    router target is the sink or the head of a disjoint server chain
    ending at the sink; random and round-robin policies only
    (least-outstanding depends on the state). Returns ``{"policy": ...,
    "branches": [...]}``."""
    if not _source_ok(model) or len(model.routers) != 1:
        return None
    source = model.sources[0]
    if source.downstream is None or source.downstream.kind != ROUTER:
        return None
    router = model.routers[source.downstream.index]
    if router.policy not in ("random", "round_robin") or not router.targets:
        return None
    seen: set = set()
    branches: list = []
    for target, edge in zip(router.targets, router.target_latencies):
        entry = _constant_edge(edge)
        if entry is None:
            return None
        if target.kind == SINK:
            branches.append({"stages": [], "exit_lat": entry})
            continue
        if target.kind != SERVER:
            return None
        branch = _walk_chain(model, target, entry, seen)
        if branch is None:
            return None
        branches.append(branch)
    if len(seen) != len(model.servers):
        return None  # servers outside the fan-out (unreachable or shared)
    return {"policy": router.policy, "branches": branches}


def fast_plan(model: EnsembleModel) -> Optional[dict]:
    """The closed-form plan for this model, or None."""
    chain = _chain_branch(model)
    if chain is not None and chain["stages"]:
        return {"policy": None, "branches": [chain]}
    return fanout_plan(model)


def _sample_service_block(compiled, v: int, draw, shape, mean):
    """Service draws for server ``v`` over a whole ``(R, N)`` block, by
    the closed forms of the event step's sampler as JAX's chain form
    writes them; ``draw(extra)`` yields per-replica uniforms of shape
    ``(*shape, *extra)`` and ``mean`` is ``(R, 1)``."""
    kind = int(compiled.service_kind[v])
    dev = mean.device
    if kind == 0:  # constant
        return mean.expand(shape)
    if kind == 1:  # exponential
        return -torch.log(draw(())) * mean
    if kind == 2:  # erlang-k: the product of k uniforms, then / k
        k = int(compiled.srv_erlang_k[v])
        u = draw((k,))
        product = u[..., 0] * u[..., 1]
        if k == 3:
            product = product * u[..., 2]
        # XLA rewrites "/ k" as a multiply by float32(1 / k).
        return -torch.log(product) * mean * _f32(1.0 / k, dev)
    if kind == 3:  # balanced two-phase hyperexponential
        u = draw((2,))
        factor = torch.where(
            u[..., 0] < _f32(compiled.srv_hyp_p1[v], dev),
            _f32(compiled.srv_hyp_f1[v], dev),
            _f32(compiled.srv_hyp_f2[v], dev),
        )
        return -torch.log(u[..., 1]) * mean * factor
    if kind == 4:  # lognormal (mean-preserving)
        sigma = float(compiled.srv_ln_sigma[v])
        lo, hi = _f32(1e-7, dev), _f32(1.0 - 1e-7, dev)
        u = torch.clamp(draw(()), lo, hi)
        z = _f32(_SQRT2, dev) * erfinv(2.0 * u - 1.0)
        # JAX takes sigma as a Python float: 0.5 * sigma * sigma is formed
        # in double and rounded once.
        return mean * torch.exp(z * _f32(sigma, dev) - _f32(0.5 * sigma * sigma, dev))
    if kind == 5:  # pareto with x_m fit to the mean
        alpha = float(compiled.srv_par_alpha[v])
        xm = mean * _f32(float(compiled.srv_par_xmf[v]), dev)
        return xm * torch.pow(draw(()), _f32(-1.0 / alpha, dev))
    raise AssertionError(f"unknown service kind {kind}")


def run_chain(
    model: EnsembleModel,
    compiled,
    plan,
    keys,
    src_rate,
    srv_mean,
    group=None,
):
    """Closed-form chain / fan-out execution.

    ``plan`` is :func:`fast_plan`'s dict (a bare server list is taken for
    a single chain), ``keys`` the ``(R, 2)`` per-replica keys of
    ``split(PRNGKey(seed), R)``, ``src_rate`` ``(R, 1)`` and ``srv_mean``
    ``(R, nV)`` on the run's device; or each a list of the shards' slices
    of them, each on its shard's device, in shard order (a replica mesh),
    with the process ``group`` of a mesh across processes. The (R, N)
    blocks go by shard, each on its shard's device, and their totals add
    on the first shard's device in block order: a replica's draws are
    keyed by its own key, so where the blocks are the same the bits are
    whatever the shard count. Returns ``(reduced, events_total,
    wall_seconds, compile_seconds)`` in the shape of the event scan's
    ``reduce_final`` output, or None when the block memory budget or the
    finite-capacity certificate declines (the caller runs the scan).
    """
    shard_keys = keys if isinstance(keys, (list, tuple)) else [keys]
    shard_rates = src_rate if isinstance(src_rate, (list, tuple)) else [src_rate]
    shard_means = srv_mean if isinstance(srv_mean, (list, tuple)) else [srv_mean]
    device = shard_keys[0].device
    per_shard = shard_keys[0].shape[0]
    horizon = float(model.horizon_s)
    warmup = float(compiled.warmup)
    source = model.sources[0]
    stop = horizon
    if source.stop_after_s is not None:
        stop = min(stop, float(source.stop_after_s))

    max_rate = max(float(rate.max()) for rate in shard_rates)
    if group is not None:
        max_rate = float(
            reduce_over_processes(torch.tensor(max_rate, dtype=torch.float64, device=device), "MAX", group)
        )
    lam = stop * max_rate
    # The Poisson count at ~6 sigma; a replica that would have produced
    # more arrivals counts as truncated.
    n_customers = int(lam + 6.0 * math.sqrt(max(lam, 1.0)) + 20.0)

    if isinstance(plan, list):
        plan = {"policy": None, "branches": [{"stages": [(v, 0.0) for v in plan], "exit_lat": 0.0}]}
    branches = plan["branches"]
    policy = plan["policy"]
    n_branches = len(branches)
    nV = len(model.servers)
    transit_cap = int(model.transit_capacity)
    has_transit = any(lat > 0.0 for branch in branches for _, lat in branch["stages"])
    caps = {v: int(model.servers[v].queue_capacity) for branch in branches for v, _ in branch["stages"]}

    if n_customers > _BLOCK_ELEMENTS:
        logger.info(
            "chain fast path: %d customers exceed the block memory budget; "
            "falling back to the event scan",
            n_customers,
        )
        return None
    block = min(per_shard, max(1, _BLOCK_ELEMENTS // max(n_customers, 1)))

    on_card = device.type == "cuda"
    cumsum = (lambda x: torch.cumsum(x, dim=1)) if on_card else cumsum_like_xla

    def run_block(keys_b, rate, means):
        B = rate.shape[0]
        shape = (B, n_customers)
        device = keys_b.device
        f32 = lambda value: _f32(value, device)  # noqa: E731
        stop_t, horizon_t, warmup_t = f32(stop), f32(horizon), f32(warmup)
        inf = f32(float("inf"))

        def replica_uniform(purpose, extra=()):
            return uniform_kernel.replica_uniform(keys_b, purpose, (n_customers, *extra))

        gaps = -torch.log(replica_uniform(0)) / rate[:, None]
        arrivals_raw = cumsum(gaps)
        source_live = arrivals_raw <= stop_t
        truncated = arrivals_raw[:, -1] < stop_t
        arrivals = torch.where(source_live, arrivals_raw, inf)
        created = arrivals

        # A customer routed elsewhere is a phantom on this branch: it keeps
        # its place in the sorted arrivals with zero service, which leaves
        # the recurrence unchanged for the real customers after it.
        if n_branches == 1:
            routed = [source_live]
        elif policy == "round_robin":
            lane = torch.remainder(torch.arange(n_customers, device=device), n_branches)[None, :]
            routed = [source_live & (lane == b) for b in range(n_branches)]
        else:  # random: uniform over the targets
            pick = torch.clamp_max(
                (replica_uniform(1) * n_branches).to(torch.int32), n_branches - 1
            )
            routed = [source_live & (pick == b) for b in range(n_branches)]

        def count(mask):
            return torch.sum(mask.to(torch.int32), dtype=torch.int32)

        events_terms = [count(source_live)]  # source fires
        overflow = torch.zeros((), dtype=torch.bool, device=device)
        zeros_f = torch.zeros((nV,), dtype=torch.float32, device=device)
        zeros_i = torch.zeros((nV,), dtype=torch.int32, device=device)
        wait_sum, busy, depth = zeros_f.clone(), zeros_f.clone(), zeros_f.clone()
        wait_n, started, completed = zeros_i.clone(), zeros_i.clone(), zeros_i.clone()
        # Branch sink masks are disjoint: one latency and one bin per
        # customer, reduced once at the end.
        bins_all = torch.full(shape, HIST_BINS, dtype=torch.int32, device=device)
        latency_all = torch.zeros(shape, dtype=torch.float32, device=device)

        def sink_arrival(done_mask, done_time, latency_value):
            m_sink = done_mask & (done_time >= warmup_t)
            bins_all.copy_(torch.where(m_sink, _hist_bin(latency_value), bins_all))
            latency_all.copy_(torch.where(m_sink, latency_value, latency_all))

        purpose = 2  # 0: gaps, 1: the route draw
        for b, branch in enumerate(branches):
            live = routed[b]
            A = arrivals
            D = A
            if not branch["stages"]:
                # Router straight to the sink, maybe across a latency edge.
                exit_lat = f32(branch["exit_lat"])
                done_time = A + exit_lat
                live = live & (done_time <= horizon_t)
                sink_arrival(live, done_time, exit_lat.expand_as(A))
                continue
            for v, entry_lat in branch["stages"]:
                if entry_lat > 0.0:
                    # A constant edge shifts the sorted stream by L; the
                    # destination's transit registers hold at most
                    # transit_cap jobs, each for exactly L.
                    lat = f32(entry_lat)
                    if transit_cap < n_customers:
                        in_transit = (
                            A[:, : n_customers - transit_cap] > A[:, transit_cap:] - lat
                        ) & live[:, transit_cap:]
                        overflow = overflow | torch.any(in_transit)
                    A = A + lat
                    # The transit arrival fires only inside the horizon.
                    live = live & (A <= horizon_t)
                    events_terms.append(count(live))
                service_raw = _sample_service_block(
                    compiled,
                    v,
                    lambda extra, _p=purpose: replica_uniform(_p, extra),
                    shape,
                    means[:, v][:, None],
                )
                purpose += 1
                service = torch.where(live, service_raw, torch.zeros_like(service_raw))
                csum = cumsum(service)
                # D_n = csum_n + max_{k<=n}(A_k - csum_{k-1})
                D = csum + torch.cummax(A - (csum - service), dim=1).values
                start = D - service
                wait = torch.where(live, start - A, torch.zeros_like(A))

                # The certificate: arrival n found more than cap in the
                # system iff D[n-cap-1] > A[n] (both sequences sorted).
                # Other branches' phantoms only make it more cautious.
                shift = caps[v] + 1
                if shift < n_customers:
                    violation = (D[:, : n_customers - shift] > A[:, shift:]) & live[:, shift:]
                    overflow = overflow | torch.any(violation)

                m_start = live & (start >= warmup_t) & (start <= horizon_t)
                m_done = live & (D <= horizon_t)
                wait_sum[v] += torch.sum(torch.where(m_start, wait, torch.zeros_like(wait)))
                wait_n[v] += count(m_start)
                busy[v] += torch.sum(torch.where(m_start, service, torch.zeros_like(service)))
                # The queue-length integral over the measured window: each
                # waiter's in-window waiting interval.
                contrib = torch.clamp_min(
                    torch.minimum(start, horizon_t) - torch.maximum(A, warmup_t), 0.0
                )
                depth[v] += torch.sum(torch.where(live, contrib, torch.zeros_like(contrib)))
                started[v] += count(live & (start <= horizon_t))
                completed[v] += count(m_done)
                events_terms.append(count(m_done))
                # The next stage sees the departures inside the horizon;
                # the whole sorted D stays so later phantoms stay neutral.
                live = m_done
                A = D

            exit_lat = f32(branch["exit_lat"])
            done_time = D + exit_lat
            live = live & (done_time <= horizon_t)
            sink_arrival(live, done_time, torch.where(live, done_time - created, torch.zeros_like(D)))

        m_sink_any = bins_all < HIST_BINS
        hist = torch.bincount(bins_all.reshape(-1).long(), minlength=HIST_BINS + 1)[:HIST_BINS]
        return {
            "truncated": count(truncated),
            "events": torch.stack(events_terms),
            "overflow": overflow,
            "sink_count": count(m_sink_any)[None],
            "sink_sum": torch.sum(latency_all)[None],
            "sink_sq": torch.sum(latency_all * latency_all)[None],
            "sink_hist": hist.to(torch.int32)[None, :],
            "srv_completed": completed,
            "srv_started": started,
            "srv_busy_int": busy,
            "srv_depth_int": depth,
            "srv_wait_sum": wait_sum,
            "srv_wait_n": wait_n,
        }

    compile_start = _wall.perf_counter()
    if on_card:
        uniform_kernel.load_library()  # the draw kernel's build, at first use
    compile_seconds = _wall.perf_counter() - compile_start

    start_t = _wall.perf_counter()
    partials = [
        {
            name: value.to(device)
            for name, value in run_block(
                k[b : b + block], rate[b : b + block, 0], means[b : b + block]
            ).items()
        }
        for k, rate, means in zip(shard_keys, shard_rates, shard_means)
        for b in range(0, per_shard, block)
    ]
    overflow = any(bool(p["overflow"]) for p in partials)
    if group is not None:
        flag = torch.tensor(int(overflow), dtype=torch.int32, device=device)
        overflow = bool(reduce_over_processes(flag, "MAX", group))
    wall = _wall.perf_counter() - start_t
    if overflow:
        logger.info(
            "chain fast path: finite-capacity certificate failed (an arrival "
            "would have been dropped); falling back to the event scan"
        )
        return None

    # Each block's int totals are < 2**31 (the block cap), so their limb
    # columns add exactly across blocks (and processes); floats add in
    # block order, every process's blocks gathered in rank order.
    def total_i64(name):
        limbs = sum_i64_limbs(torch.stack([p[name] for p in partials]), axis=0)
        return reduce_over_processes(limbs, "SUM", group)

    def total_f(name):
        stacked = torch.stack([p[name] for p in partials])
        if group is not None:
            import torch.distributed as dist

            parts = [torch.empty_like(stacked) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, stacked, group=group)
            stacked = torch.cat(parts)
        return torch.sum(stacked, dim=0).cpu().numpy()

    limb_zeros_v = np.zeros((N_LIMBS, nV), np.int32)
    events_limbs = reduce_over_processes(
        sum_i64_limbs(torch.cat([p["events"] for p in partials]), axis=0), "SUM", group
    )
    events_total = int(host_i64(events_limbs))
    truncated = torch.stack([p["truncated"] for p in partials]).sum(dtype=torch.int32)
    reduced = {
        "truncated": int(reduce_over_processes(truncated, "SUM", group)),
        "events": events_limbs,
        "sink_count": total_i64("sink_count"),
        "sink_sum": total_f("sink_sum"),
        "sink_sq": total_f("sink_sq"),
        "sink_hist": total_i64("sink_hist"),
        "srv_completed": total_i64("srv_completed"),
        "srv_dropped": limb_zeros_v,
        "srv_outage_dropped": limb_zeros_v,
        "srv_started": total_i64("srv_started"),
        "srv_timed_out": limb_zeros_v,
        "srv_retried": limb_zeros_v,
        "srv_busy_int": total_f("srv_busy_int"),
        "srv_depth_int": total_f("srv_depth_int"),
        "srv_wait_sum": total_f("srv_wait_sum"),
        "srv_wait_n": total_i64("srv_wait_n"),
        "lim_admitted": np.zeros((N_LIMBS, max(len(model.limiters), 1)), np.int32),
        "lim_dropped": np.zeros((N_LIMBS, max(len(model.limiters), 1)), np.int32),
    }
    if has_transit:
        # No drop by certificate; the key exists for the result assembly.
        reduced["tr_dropped"] = limb_zeros_v
    return reduced, events_total, wall, compile_seconds
