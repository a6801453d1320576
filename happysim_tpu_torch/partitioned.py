"""Entity-sharded execution: partitions exchanging outboxes around a ring
at window barriers (counterpart of ``happysim_tpu/tpu/partitioned.py``).

ONE logical simulation per replica lane, its entities cut into
``n_partitions`` partitions of the same local topology. Jobs delivered to a
``model.remote(...)`` node leave their partition through a fixed-capacity
outbox; at each window barrier every partition's outbox moves one step
around the ring, so partition p receives from p - 1, and its jobs land in
the ingress server's transit registers. The window never exceeds the
least remote latency, so a job sent during window w arrives no earlier
than window w + 1 (the conservative-window contract of the host
``WindowedCoordinator``). Replica r of partition p exchanges only with
replica r of its neighbours: ``n_replicas`` independent partitioned
simulations run at once.

The partitions are laid out partition-major, ``P_local * R`` lanes on a
device (a :class:`~happysim_tpu_torch.mesh.ReplicaMesh` of the
``"partitions"`` axis, devices repeated allowed: ``partition_mesh(["cuda:0"]
* 8)`` is eight partitions on one card). A window is one launch of the
event-step kernel's partitioned instantiation per device
(:func:`~happysim_tpu_torch.kernels.event_step.window_steps`: every lane
runs up to ``max_events_per_window`` events before the window end and
books a truncated window where its budget ran out first), then one launch
of the barrier kernel (:func:`~happysim_tpu_torch.kernels.partition_barrier.barrier`:
the depth integral's close-out, the clock's alignment to the window end,
the neighbour's outbox merged into the transit registers, the outbox
reset). A partition whose ring neighbour lies on another device reads a
copy of that device's boundary outbox, and across processes (a mesh with
a ``torch.distributed`` group) the boundary outboxes travel by
``send``/``recv``. Both kernels of a device scan each transit row only up
to its occupancy bound, which they keep across windows beside the state
(never in it, nor in a snapshot: a resume rebuilds it from ``tr_time``).
CPU tensors run the plain torch-op versions of both. Nothing waits for
the device between windows: the host syncs at the end of a run and at
each checkpoint.
"""

from __future__ import annotations

import logging
import time as _wall
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from happysim_tpu_torch import mesh as mesh_lib
from happysim_tpu_torch import rng
from happysim_tpu_torch.engine import (
    INF,
    _Compiled,
    _gather_replicas,
    _resolve_params,
    load_checkpoint_npz,
    model_fingerprint,
    save_checkpoint_npz,
)
from happysim_tpu_torch.kernels import event_step, partition_barrier
from happysim_tpu_torch.model import REMOTE, ROUTER, EnsembleModel

logger = logging.getLogger("happysim_tpu_torch.partitioned")

PARTITION_AXIS = "partitions"

def partition_mesh(devices=None) -> mesh_lib.ReplicaMesh:
    """1-D mesh whose axis is the partition (entity-shard) dimension: one
    partition per entry of ``devices`` (repeats allowed), or per CUDA
    device of this process (raising where torch finds none). Under an
    initialized multi-process ``torch.distributed`` run it spans every
    process, each running its own partitions."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_partitioned runs on a CUDA device and torch finds none; pass "
                "partition_mesh(['cpu'] * n) (or device='cpu') to run the plain "
                "torch-op version on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in devices]
    group, rank, world = mesh_lib._group_of_world()
    mesh_lib._check_backend(local, group)
    return mesh_lib.ReplicaMesh(
        devices=tuple(local) * world, axis_names=(PARTITION_AXIS,), shape=(len(local) * world,),
        group=group, rank=rank, world_size=world,
    )


@dataclass
class PartitionedCheckpoint:
    """A resumable snapshot of a partitioned run, taken at a window
    barrier (the outboxes are empty there: the exchange already merged),
    the JAX package's ``PartitionedCheckpoint`` field for field. Window
    indices are absolute and the per-event draws are keyed by the carried
    event counter, so a resume reproduces the uninterrupted run bit for
    bit. The optional fields' defaults are impossible sentinels meaning
    "the snapshot predates the field": resume validation skips them."""

    window_index: int  # windows fully executed (including their barrier)
    n_windows: int
    n_partitions: int
    n_replicas: int
    seed: int
    state: dict  # partition-major numpy arrays (P, R, ...)
    model_fingerprint: str = ""
    window_s: float = -1.0
    max_events_per_window: int = -1
    outbox_capacity: int = -1

    def save(self, path: str) -> None:
        meta = {
            "window_index": self.window_index,
            "n_windows": self.n_windows,
            "n_partitions": self.n_partitions,
            "n_replicas": self.n_replicas,
            "seed": self.seed,
            "model_fingerprint": self.model_fingerprint,
            "window_s": self.window_s,
            "max_events_per_window": self.max_events_per_window,
            "outbox_capacity": self.outbox_capacity,
        }
        save_checkpoint_npz(path, meta, self.state)

    @classmethod
    def load(cls, path: str) -> "PartitionedCheckpoint":
        meta, state = load_checkpoint_npz(path)
        return cls(state=state, **meta)


@dataclass
class PartitionedResult:
    """Aggregate statistics across partitions and replicas (the JAX
    package's fields, in its order)."""

    n_partitions: int
    n_replicas: int
    n_windows: int
    window_s: float
    horizon_s: float
    simulated_events: int
    wall_seconds: float
    events_per_second: float
    sink_count: list[int]
    sink_mean_latency_s: list[float]
    server_completed: list[int]
    server_dropped: list[int]
    server_outage_dropped: list[int]
    remote_sent: int
    remote_dropped: int  # outbox overflow (raise outbox_capacity)
    transit_dropped: int  # ingress transit overflow (raise transit_capacity)
    # Windows whose event budget ran out with work still pending: non-zero
    # means the statistics are biased (raise max_events_per_window).
    truncated_windows: int
    per_partition_sink_count: np.ndarray  # (P, nK)


class _PartitionCompiled(_Compiled):
    """The single-partition step, extended with remote-egress outboxes
    (JAX ``_PartitionCompiled``)."""

    def __init__(self, model: EnsembleModel, outbox_capacity: int):
        self.OB = outbox_capacity
        super().__init__(model, allow_remote=True)
        for i, router in enumerate(model.routers):
            if any(t.kind == REMOTE for t in router.targets) and any(
                e.loss_p > 0.0 for e in router.target_latencies
            ):
                raise ValueError(
                    f"router[{i}]: per-target packet loss on a sink/remote "
                    "mixed router is not supported in partitioned mode"
                )
        # Two shapes the JAX package's step cannot trace (its override of
        # _deliver drops the hop argument a limiter passes on, and a router
        # hop into a router reaches the base delivery, which has no remote
        # branch): refused by name.
        if model.limiters:
            raise ValueError(
                "limiters are not supported by run_partitioned: the JAX "
                "package's partitioned step cannot deliver through them"
            )
        for i, router in enumerate(model.routers):
            mixed = any(t.kind == REMOTE for t in router.targets)
            fed = any(
                t.kind == ROUTER and t.index == i for r in model.routers for t in r.targets
            )
            if mixed and fed:
                raise ValueError(
                    f"router[{i}] has remote targets and is reached from another "
                    "router: the JAX package's partitioned step delivers to remotes "
                    "only from a router a source or server feeds"
                )
        # Remote arrivals land in the transit registers, so they (and the
        # transit-arrival branch) are always on in partitioned mode.
        self.has_transit = True
        self.remote_latency = np.asarray(
            [r.latency_s for r in model.remotes] or [0.0], np.float32
        )
        self.remote_ingress = np.asarray(
            [r.ingress.index for r in model.remotes] or [0], np.int32
        )

    def init_state(self, keys: torch.Tensor, params: dict, draw: bool = True) -> dict:
        state = super().init_state(keys, params, draw)
        R, dev = keys.shape[0], keys.device
        state["ob_arrival"] = torch.full((R, self.OB), INF, dtype=torch.float32, device=dev)
        state["ob_created"] = torch.zeros((R, self.OB), dtype=torch.float32, device=dev)
        state["ob_ingress"] = torch.zeros((R, self.OB), dtype=torch.int32, device=dev)
        for leaf in ("ob_len", "ob_sent", "ob_dropped"):
            state[leaf] = torch.zeros((R,), dtype=torch.int32, device=dev)
        return state

    def _deliver(self, state, desc, lanes, t, created, u, dest, edge, params, *rest, **kw):
        if dest.kind == REMOTE:
            self._into_outbox(state, lanes, dest.index, t, created)
            return
        if dest.kind == ROUTER:
            router = self.model.routers[dest.index]
            if any(target.kind == REMOTE for target in router.targets):
                self._route_sink_or_remote(state, lanes, t, created, u, router)
                return
        super()._deliver(state, desc, lanes, t, created, u, dest, edge, params, *rest, **kw)

    def _route_sink_or_remote(self, state, lanes, t, created, u, router) -> None:
        """A 'random' router over a sink+remote mix: stay local or hop
        (JAX ``_route_sink_or_remote``). The choice is the first hop's
        route draw; a sink target keeps its edge's latency, drawn from
        U_LAT behind the router's select; a remote's latency is its
        RemoteSpec's. Each target's lanes book that target's side only."""
        n = len(router.targets)
        choice = torch.clamp_max((u[:, self._route_slot(0)] * n).to(torch.int32), n - 1)
        for i, (target, edge) in enumerate(zip(router.targets, router.target_latencies)):
            picked = lanes & (choice == i)
            if target.kind == REMOTE:
                self._into_outbox(state, picked, target.index, t, created)
            else:
                arrival = self._edge_arrival(edge, t, u, routed=True)
                self._deliver_sink(state, picked, arrival, created, target.index)

    def _into_outbox(self, state, lanes, r: int, t, created) -> None:
        """Queue a job for the neighbour partition in the outbox's next
        slot, arriving ``t + latency`` at the remote's ingress; a full
        outbox drops it (``ob_dropped``)."""
        slot = state["ob_len"]
        has_room = slot < self.OB
        sent = lanes & has_room
        index = torch.clamp_max(slot, self.OB - 1).long()[:, None]
        arrival = t + torch.tensor(self.remote_latency[r], device=t.device)
        ingress = torch.full_like(slot, int(self.remote_ingress[r]))
        for leaf, value in (("ob_arrival", arrival), ("ob_created", created), ("ob_ingress", ingress)):
            row = state[leaf]
            current = row.gather(1, index)[:, 0]
            row.scatter_(1, index, torch.where(sent, value, current)[:, None])
        state["ob_len"] += sent.to(torch.int32)
        state["ob_sent"] += sent.to(torch.int32)
        state["ob_dropped"] += (lanes & ~has_room).to(torch.int32)


def default_max_events_per_window(model: EnsembleModel, window_s: float) -> int:
    """JAX's budget: remote re-injection multiplies the effective
    arrivals by an unknown factor, so budget generously and detect an
    overrun per window (``truncated_windows``)."""
    rate = sum(s.rate for s in model.sources)
    chain = 2 * max(len(model.servers), 1)
    return int(6.0 * max(rate * window_s, 1.0) * (1 + chain)) + 32


def window_end(w: int, window_s: float) -> np.float32:
    """Window ``w``'s end as JAX forms it: ``(float32(w) + 1) *
    float32(window_s)`` in float32."""
    return np.float32(np.float32(w) + np.float32(1.0)) * np.float32(window_s)


def _refuse(model: EnsembleModel, window_s: float, outbox_capacity: int) -> None:
    """JAX's refusals, in its order, each naming the port's remedy."""
    if not model.remotes:
        raise ValueError("run_partitioned needs at least one model.remote(...)")
    if model.telemetry_spec is not None:
        raise ValueError(
            "windowed telemetry is not supported by run_partitioned — this "
            "executor is the entity-sharded special case, not the multi-device "
            "path. Use run_ensemble(mesh=replica_mesh(...)), which shards "
            "replicas over any number of devices WITH telemetry, its window "
            "buffers on the event-step kernel"
        )
    resilience = model.resilience_features()
    if resilience:
        raise ValueError(
            f"the resilience layer ({', '.join(resilience)}) is not supported by "
            "run_partitioned — use run_ensemble(mesh=replica_mesh(...)), which "
            "runs breakers, load shedding and retry budgets at any device count "
            "on the event-step kernel"
        )
    consensus = model.consensus_features()
    if consensus:
        raise ValueError(
            f"the consensus layer ({', '.join(consensus)}) is not supported by "
            "run_partitioned — use run_ensemble(mesh=replica_mesh(...)), which "
            "runs network partitions, quorum replication and leader election at "
            "any device count on the event-step kernel"
        )
    if any(s.trace is not None for s in model.sources):
        raise ValueError(
            "trace-driven arrivals (trace_arrivals) are not supported by "
            "run_partitioned — use run_ensemble(mesh=replica_mesh(...)), which "
            "streams trace pages to every device between kernel launches"
        )
    if outbox_capacity < 1:
        raise ValueError(
            f"outbox_capacity={outbox_capacity} must be >= 1: every remote "
            "edge sends through the fixed-capacity outbox ring"
        )
    min_latency = min(r.latency_s for r in model.remotes)
    if window_s > min_latency + 1e-9:
        raise ValueError(
            f"window_s={window_s} exceeds the minimum remote latency "
            f"{min_latency}: events could affect the window they were sent "
            "in (conservative-window contract)"
        )


def _resolve_partition_mesh(mesh, device) -> mesh_lib.ReplicaMesh:
    """The run's partition mesh: ``mesh``, or every CUDA device (one
    partition each) for no device, or one partition on ``device``."""
    if mesh is None:
        return partition_mesh(None if device is None else [device])
    if device is not None:
        want = torch.device(device)
        for p in mesh.local_shards:
            got = mesh.devices[p]
            if got.type != want.type or None not in (got.index, want.index) and got.index != want.index:
                raise ValueError(
                    f"run_partitioned: mesh partition {p} is on {got}, and "
                    f"device={device!r} asks for another device; pass the mesh alone"
                )
    return mesh


class _Group:
    """This process's consecutive partitions on one device: ``first`` (the
    global index of the first), ``P`` of them, their partition-major
    state, keys and parameters."""

    def __init__(self, first: int, P: int, device: torch.device):
        self.first, self.P, self.device = first, P, device
        self.state: dict = {}
        self.params: dict = {}


def _groups(mesh: mesh_lib.ReplicaMesh) -> list:
    """This process's partitions, cut into runs of one device."""
    out: list = []
    for p in mesh.local_shards:
        device = mesh.devices[p]
        if out and out[-1].device == device:
            out[-1].P += 1
        else:
            out.append(_Group(p, 1, device))
    return out


def _partition_keys(seed: int, first: int, P: int, n_replicas: int) -> torch.Tensor:
    """``(P * R, 2)`` lane keys of partitions ``first, ..., first + P - 1``:
    ``split(fold_in(PRNGKey(seed), p), R)`` each, as JAX folds them."""
    base = rng.PRNGKey(seed)
    return torch.cat([rng.split(rng.fold_in(base, p), n_replicas) for p in range(first, first + P)])


def init_partitions(compiled: _PartitionCompiled, first: int, P: int, n_replicas: int,
                    seed: int, device) -> tuple:
    """``(state, params)`` of partitions ``first, ..., first + P - 1`` on
    ``device``, partition-major (``P * n_replicas`` lanes): JAX's initial
    state of each lane from its key, ``truncated_windows`` at 0, and the
    model's rates and service means broadcast to every lane."""
    host = _resolve_params(compiled.model, compiled, n_replicas, None)
    params = {
        k: torch.from_numpy(np.ascontiguousarray(np.tile(v, (P, 1)))).to(device)
        for k, v in host.items()
    }
    keys = _partition_keys(seed, first, P, n_replicas).to(device)
    state = compiled.init_state(keys, params)
    state["truncated_windows"] = torch.zeros((P * n_replicas,), dtype=torch.int32, device=device)
    return state, params


def _pack(slab: tuple) -> torch.Tensor:
    """The four outbox leaves of a slab as one ``(R, 3 * OB + 1)`` int32
    tensor, float bits as they are (one message a barrier)."""
    arrival, created, ingress, length = slab
    return torch.cat(
        [arrival.view(torch.int32), created.view(torch.int32), ingress, length[:, None]], dim=1
    )


def _unpack(packed: torch.Tensor, OB: int) -> tuple:
    return (
        packed[:, :OB].contiguous().view(torch.float32),
        packed[:, OB:2 * OB].contiguous().view(torch.float32),
        packed[:, 2 * OB:3 * OB].contiguous(),
        packed[:, 3 * OB].contiguous(),
    )


def _ring_inboxes(groups: list, mesh: mesh_lib.ReplicaMesh, OB: int) -> list:
    """Each group's inbox for its first partition: a copy of the ring
    predecessor's outbox rows where that partition lives on another device
    or process, None where it is this group's own last partition (the
    barrier reads it in place). Taken before any barrier clears one."""
    inboxes: list = [None] * len(groups)
    for k in range(1, len(groups)):
        src = partition_barrier.own_slab(groups[k - 1].state, groups[k - 1].P)
        inboxes[k] = tuple(x.to(groups[k].device, copy=True) for x in src)
    last = partition_barrier.own_slab(groups[-1].state, groups[-1].P)
    if mesh.spans_processes:
        import torch.distributed as dist

        world, rank = mesh.world_size, mesh.rank
        outgoing = _pack(last)
        incoming = torch.empty_like(outgoing)
        dst = dist.get_global_rank(mesh.group, (rank + 1) % world)
        src = dist.get_global_rank(mesh.group, (rank - 1) % world)
        send = dist.isend(outgoing, dst, group=mesh.group)
        dist.recv(incoming, src, group=mesh.group)
        send.wait()
        inboxes[0] = _unpack(incoming, OB)
    elif len(groups) > 1:
        inboxes[0] = tuple(x.to(groups[0].device, copy=True) for x in last)
    return inboxes


def _host_state(groups: list, mesh: mesh_lib.ReplicaMesh, n_replicas: int) -> dict:
    """The whole run's state on the host, partition-major ``(P, R, ...)``
    numpy, from every process of the mesh."""
    out = {}
    for leaf in groups[0].state:
        flat = _gather_replicas([g.state[leaf] for g in groups], groups[0].device, mesh.group)
        host = flat.cpu().numpy()
        out[leaf] = host.reshape((mesh.size, n_replicas) + host.shape[1:])
    return out


def _validate_resume(resume_from: PartitionedCheckpoint, **run) -> None:
    """JAX's resume check: every field against this run's, skipping an
    optional field that holds its sentinel."""
    mismatches = {
        "n_partitions": (resume_from.n_partitions, run["n_partitions"]),
        "n_replicas": (resume_from.n_replicas, run["n_replicas"]),
        "seed": (resume_from.seed, run["seed"]),
        "n_windows": (resume_from.n_windows, run["n_windows"]),
        "model_fingerprint": (resume_from.model_fingerprint, run["fingerprint"]),
        "window_s": (resume_from.window_s, run["window_s"]),
        "max_events_per_window": (
            resume_from.max_events_per_window, run["max_events_per_window"]
        ),
        "outbox_capacity": (resume_from.outbox_capacity, run["outbox_capacity"]),
    }
    optional_defaults = {
        "model_fingerprint": "",
        "window_s": -1.0,
        "max_events_per_window": -1,
        "outbox_capacity": -1,
    }
    bad = {
        k: v
        for k, v in mismatches.items()
        if v[0] != v[1] and v[0] != optional_defaults.get(k, object())
    }
    if bad:
        raise ValueError(
            f"resume_from does not match this run: {bad} "
            "(checkpoint value vs requested value)"
        )


class _Runner:
    """The window loop of one run: per window, the event-step launch of
    every group, the ring's copies, then every group's barrier. On the
    card each group has one ``prepared`` dict for its two kernels'
    wrappers: their launch arguments, checked once (only the window end
    changes between windows; a barrier reading an inbox slab, a new
    tensor each window, is checked each window). The transit rows'
    occupancy bounds both kernels keep across windows are tied to the
    group's ``tr_time`` (``event_step.occupancy_bound``), outside the
    state and every snapshot. Where one card holds the whole ring (one
    group, one process), each barrier is folded into the next window's
    launch (:class:`~happysim_tpu_torch.kernels.partition_barrier.FoldedRing`)
    and a barrier launch ends each run of windows, so the state between
    runs of windows, and every snapshot, is the unfolded loop's."""

    def __init__(self, compiled: _PartitionCompiled, groups: list, mesh, budget: int):
        self.compiled, self.groups, self.mesh, self.budget = compiled, groups, mesh, budget
        self.prepared = [{} for _ in groups]
        self.folded = (
            len(groups) == 1 and groups[0].device.type == "cuda" and not mesh.spans_processes
        )

    def run(self, w_first: int, n: int, window_s: float) -> None:
        compiled, groups = self.compiled, self.groups
        if self.folded:
            g = groups[0]
            ring = partition_barrier.folded_ring(compiled, g.state, g.state["key"], g.params, g.P,
                                                 self.budget, self.prepared[0])
            for w in range(w_first, w_first + n):
                ring.window(window_end(w, window_s))
            ring.flush()
            return
        for w in range(w_first, w_first + n):
            limit = window_end(w, window_s)
            for g, prepared in zip(groups, self.prepared):
                event_step.window_steps(compiled, g.state, g.state["key"], g.params, limit,
                                        self.budget, prepared)
            inboxes = _ring_inboxes(groups, self.mesh, compiled.OB)
            for g, inbox, prepared in zip(groups, inboxes, self.prepared):
                partition_barrier.barrier(compiled, g.state, g.P, limit, inbox, prepared)


def run_partitioned(
    model: EnsembleModel,
    window_s: float,
    mesh: Optional[mesh_lib.ReplicaMesh] = None,
    n_replicas: int = 1,
    seed: int = 0,
    max_events_per_window: Optional[int] = None,
    outbox_capacity: int = 128,
    checkpoint_every_windows: Optional[int] = None,
    checkpoint_callback=None,
    resume_from: Optional[PartitionedCheckpoint] = None,
    device=None,
) -> PartitionedResult:
    """Execute ``model`` as one entity-sharded simulation per replica lane
    (JAX's ``run_partitioned``).

    Every partition runs the same local topology; jobs delivered to a
    ``model.remote(...)`` node cross to the NEXT partition on the ring.
    ``window_s`` must not exceed the least remote latency. ``mesh`` is a
    :func:`partition_mesh` (one partition an entry); with none, one
    partition on each CUDA device, or one on ``device`` where given
    (``device="cpu"`` runs the plain torch-op versions on the CPU).
    ``checkpoint_every_windows`` snapshots the state every K window
    barriers and hands each :class:`PartitionedCheckpoint` to
    ``checkpoint_callback``; resuming with the same model, mesh size,
    replicas and seed reproduces the uninterrupted run bit for bit, and a
    snapshot of either package resumes in the other. ``wall_seconds``
    times the window loop alone, after the kernels' build and the state's
    set-up.
    """
    _refuse(model, window_s, outbox_capacity)
    mesh = _resolve_partition_mesh(mesh, device)
    n_partitions = mesh.size
    n_windows = int(np.ceil(model.horizon_s / window_s))
    compiled = _PartitionCompiled(model, outbox_capacity=outbox_capacity)
    if max_events_per_window is None:
        max_events_per_window = default_max_events_per_window(model, window_s)
    if checkpoint_every_windows is not None and checkpoint_callback is None:
        raise ValueError(
            "checkpoint_every_windows without checkpoint_callback would "
            "take no snapshots (pass a callback to receive them)"
        )
    fingerprint = model_fingerprint(model)
    if resume_from is not None:
        _validate_resume(
            resume_from, n_partitions=n_partitions, n_replicas=n_replicas, seed=seed,
            n_windows=n_windows, fingerprint=fingerprint, window_s=window_s,
            max_events_per_window=max_events_per_window, outbox_capacity=outbox_capacity,
        )
    groups = _groups(mesh)
    for g in groups:
        g.state, g.params = init_partitions(compiled, g.first, g.P, n_replicas, seed, g.device)
        if resume_from is not None:
            differ = set(resume_from.state) ^ set(g.state)
            if differ:
                raise ValueError(
                    f"resume_from's state leaves differ from this run's: {sorted(differ)}"
                )
            g.state = {
                leaf: torch.from_numpy(np.ascontiguousarray(
                    value[g.first:g.first + g.P].reshape((g.P * n_replicas,) + value.shape[2:])
                )).to(g.device)
                for leaf, value in resume_from.state.items()
            }
    if any(g.device.type == "cuda" for g in groups):
        # Build (first use) and load both kernels before the clock starts.
        event_step.load_library()
        partition_barrier.load_library()
    windows_done = 0 if resume_from is None else int(resume_from.window_index)
    checkpointing = (
        checkpoint_every_windows is not None
        or checkpoint_callback is not None
        or resume_from is not None
    )
    seg = (checkpoint_every_windows or max(1, n_windows // 8)) if checkpointing else n_windows
    runner = _Runner(compiled, groups, mesh, max_events_per_window)
    start = _wall.perf_counter()
    while windows_done < n_windows:
        n_seg = min(seg, n_windows - windows_done)
        runner.run(windows_done, n_seg, window_s)
        windows_done += n_seg
        if checkpoint_callback is not None and windows_done < n_windows:
            checkpoint_callback(
                PartitionedCheckpoint(
                    window_index=windows_done,
                    n_windows=n_windows,
                    n_partitions=n_partitions,
                    n_replicas=n_replicas,
                    seed=seed,
                    state=_host_state(groups, mesh, n_replicas),
                    model_fingerprint=fingerprint,
                    window_s=window_s,
                    max_events_per_window=max_events_per_window,
                    outbox_capacity=outbox_capacity,
                )
            )
    for g in groups:  # the completion barrier
        if g.device.type == "cuda":
            torch.cuda.synchronize(g.device)
    wall = _wall.perf_counter() - start
    host = _host_state(groups, mesh, n_replicas)
    return partitioned_result(model, compiled, host, n_partitions, n_replicas, n_windows,
                              window_s, wall, max_events_per_window)


def partitioned_result(model, compiled, host: dict, n_partitions: int, n_replicas: int,
                       n_windows: int, window_s: float, wall: float,
                       max_events_per_window: int) -> PartitionedResult:
    """The result of a run's final ``host`` state (partition-major ``(P,
    R, ...)`` numpy): JAX's host sums over ``(P, R)``."""
    events_total = int(host["events"].sum(dtype=np.int64))
    nV_real = len(model.servers)
    nK = compiled.nK
    sink_count = host["sink_count"].sum(axis=(0, 1)).astype(np.int64)
    sink_sum = host["sink_sum"].sum(axis=(0, 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        sink_mean = np.where(sink_count > 0, sink_sum / sink_count, 0.0)
    truncated_windows = int(host["truncated_windows"].sum())
    if truncated_windows:
        logger.warning(
            "run_partitioned: %d window executions exhausted the per-window "
            "event budget (max_events_per_window=%d) with work pending — "
            "statistics are biased; raise max_events_per_window.",
            truncated_windows,
            max_events_per_window,
        )
    return PartitionedResult(
        n_partitions=n_partitions,
        n_replicas=n_replicas,
        n_windows=n_windows,
        window_s=window_s,
        horizon_s=model.horizon_s,
        simulated_events=events_total,
        wall_seconds=wall,
        events_per_second=events_total / wall if wall > 0 else 0.0,
        sink_count=[int(c) for c in sink_count],
        sink_mean_latency_s=[float(m) for m in sink_mean],
        server_completed=[int(c) for c in host["srv_completed"].sum(axis=(0, 1))[:nV_real]],
        server_dropped=[int(d) for d in host["srv_dropped"].sum(axis=(0, 1))[:nV_real]],
        server_outage_dropped=[
            int(d) for d in host["srv_outage_dropped"].sum(axis=(0, 1))[:nV_real]
        ],
        remote_sent=int(host["ob_sent"].sum()),
        remote_dropped=int(host["ob_dropped"].sum()),
        transit_dropped=int(host["tr_dropped"].sum()),
        truncated_windows=truncated_windows,
        per_partition_sink_count=host["sink_count"].sum(axis=1).reshape(n_partitions, nK),
    )
