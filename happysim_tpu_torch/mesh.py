"""The replica mesh of the ensemble executor (counterpart of
``happysim_tpu/tpu/mesh.py``).

The replica axis is the one big data-parallel dimension of an ensemble.
A :class:`ReplicaMesh` cuts it into ``size`` shards, each a contiguous
slab of replicas on one device: the card's devices, several shards of
one device (a virtual mesh, the counterpart of JAX's virtual CPU mesh),
or, once :func:`distributed_initialize` has joined a
``torch.distributed`` process group, the devices of every process, each
process running its own slab of shards. ``run_ensemble(..., mesh=...)``
and ``run_mm1_ensemble(..., mesh=...)`` launch once per shard on the
shard's device (shards on distinct devices run at once, shards of one
device in turn) and reduce across the shards exactly
(:mod:`happysim_tpu_torch.reduce`): limb sums add across shards, and
the fixed-point float sums quantise every shard against the maximum over
all of them, so the results are the same bits whatever the shard count.

The partition-rule table (:data:`STATE_PARTITION_RULES`) is the JAX
package's: every state leaf the engine carries is matched to a placement,
and a leaf without a rule raises, checked once a call.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

REPLICA_AXIS = "replicas"
HOST_AXIS = "hosts"


def pad_to_multiple(n: int, devices: int) -> int:
    """Round replica count up so it divides evenly across devices."""
    return ((n + devices - 1) // devices) * devices


@dataclass(frozen=True)
class ReplicaMesh:
    """A mesh of ``size`` replica shards, shard ``s`` on ``devices[s]``
    (one device may hold several shards). ``axis_names`` and ``shape``
    are JAX's: ``("replicas",)`` or host-major ``("hosts", "replicas")``.
    A mesh that spans processes holds their ``torch.distributed`` group
    and this process's ``rank``: shards are split into ``world_size``
    contiguous slabs, rank ``k`` running slab ``k``, and ``devices`` is
    each process's own list of its shards' devices, repeated per rank
    (every process holds as many shards)."""

    devices: tuple
    axis_names: tuple = (REPLICA_AXIS,)
    shape: tuple = ()
    group: object = None
    rank: int = 0
    world_size: int = 1

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a replica mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if not self.shape:
            object.__setattr__(self, "shape", (len(self.devices),))
        if _prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} does not hold {len(self.devices)} devices")
        if len(self.devices) % self.world_size:
            raise ValueError(
                f"{len(self.devices)} shards do not split evenly over {self.world_size} processes"
            )

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_shards(self) -> range:
        """The shard indices this process runs."""
        per = self.size // self.world_size
        return range(self.rank * per, (self.rank + 1) * per)

    @property
    def spans_processes(self) -> bool:
        return self.world_size > 1

    def shard_slice(self, shard: int, n_replicas: int) -> slice:
        """Shard ``shard``'s replicas of ``n_replicas`` (a multiple of
        ``size``): a contiguous, host-major slab."""
        per = n_replicas // self.size
        return slice(shard * per, (shard + 1) * per)


def _prod(shape) -> int:
    out = 1
    for n in shape:
        out *= int(n)
    return out


def _group_of_world():
    """(group, rank, world size) of an initialized ``torch.distributed``
    run with more than one process, else (None, 0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    return None, 0, 1


def _local_devices(devices) -> list:
    """``devices``, or every CUDA device of this process (raising where
    torch finds none: a mesh never falls back to the CPU)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "replica_mesh takes the CUDA devices and torch finds none; pass "
            "devices=[...] (for example ['cpu'] * 4, a virtual mesh on the CPU)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _check_backend(devices, group) -> None:
    """A mesh across processes reduces with its group's backend: NCCL on
    CUDA devices, gloo on CPUs."""
    if group is None:
        return
    import torch.distributed as dist

    backend = str(dist.get_backend(group)).lower()
    want = "nccl" if devices[0].type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(
            f"a mesh of {devices[0].type} devices across processes reduces over "
            f"{want}, and the process group runs {backend}"
        )


def replica_mesh(devices: Optional[Sequence] = None) -> ReplicaMesh:
    """1-D mesh over this process's CUDA devices (or the given devices,
    one shard each, repeats allowed), axis name "replicas". Under an
    initialized multi-process ``torch.distributed`` run the mesh spans
    every process, each contributing its devices' shards."""
    local = _local_devices(devices)
    group, rank, world = _group_of_world()
    _check_backend(local, group)
    return ReplicaMesh(
        devices=tuple(local) * world, axis_names=(REPLICA_AXIS,), shape=(len(local) * world,),
        group=group, rank=rank, world_size=world,
    )


def host_replica_mesh(devices: Optional[Sequence] = None, n_hosts: Optional[int] = None) -> ReplicaMesh:
    """2-D (hosts, replicas) mesh: the outer axis one row per host
    (process), the inner its shards, host-major. ``n_hosts`` defaults to
    the process count; pass it explicitly to emulate a multi-host layout
    in one process, as the tests do."""
    local = _local_devices(devices)
    group, rank, world = _group_of_world()
    _check_backend(local, group)
    shards = tuple(local) * world
    if n_hosts is None:
        n_hosts = world
    if len(shards) % n_hosts:
        raise ValueError(f"{len(shards)} devices do not split evenly over {n_hosts} hosts")
    return ReplicaMesh(
        devices=shards, axis_names=(HOST_AXIS, REPLICA_AXIS),
        shape=(n_hosts, len(shards) // n_hosts), group=group, rank=rank, world_size=world,
    )


def distributed_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join a multi-process ``torch.distributed`` run (a no-op for one
    process). Wraps ``init_process_group``: NCCL where torch finds a
    CUDA device, gloo on a CPU-only machine. Explicit
    arguments go to a TCP rendezvous at ``coordinator_address``
    (``host:port``) and every failure raises: a mistyped address must
    never degrade into separate single-process runs, whose statistics
    would be wrong on every host. With no arguments torchrun's
    environment (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) is read where
    set. Returns True when a multi-process run is active afterwards."""
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "distributed_initialize needs coordinator_address, num_processes "
                "and process_id together"
            )
        address = coordinator_address
        if "://" not in address:
            address = f"tcp://{address}"
        dist.init_process_group(
            backend, init_method=address, world_size=int(num_processes), rank=int(process_id)
        )
    elif not dist.is_initialized():
        if not all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return False
        dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size() > 1


@dataclass(frozen=True)
class ReplicaSharding:
    """The placement of a leaf whose leading axis is the replica axis:
    shard ``s`` holds ``mesh.shard_slice(s, n)`` on ``mesh.devices[s]``;
    ``spec`` names the mesh axes the leading axis is cut over."""

    mesh: ReplicaMesh
    spec: tuple


@dataclass(frozen=True)
class ReplicatedSharding:
    """The placement of data every shard reads whole: a copy on each of
    the mesh's devices (one per device, whatever its shards)."""

    mesh: ReplicaMesh

    @property
    def devices(self) -> tuple:
        local = [self.mesh.devices[s] for s in self.mesh.local_shards]
        return tuple(dict.fromkeys(local))


def _replica_spec(mesh: Optional[ReplicaMesh]) -> tuple:
    if mesh is not None and HOST_AXIS in mesh.axis_names:
        return ((HOST_AXIS, REPLICA_AXIS),)
    return (REPLICA_AXIS,)


def replica_sharding(mesh: ReplicaMesh) -> ReplicaSharding:
    """Cut the leading (replica) axis over the whole mesh (over both axes,
    host-major, on the 2-D host/replica mesh)."""
    return ReplicaSharding(mesh, _replica_spec(mesh))


def replicated_sharding(mesh: ReplicaMesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)


def trace_chunk_sharding(mesh: ReplicaMesh) -> ReplicatedSharding:
    """The placement of a streamed trace page: a copy on every device of
    the mesh, since every replica replays the same trace; "2 resident
    pages per shard" counts the copies of one device."""
    return replicated_sharding(mesh)


#: Every state leaf the engine carries, matched to its placement by the
#: first pattern that matches its name: the JAX package's table. Every
#: leaf is per-replica data today; a leaf with no rule raises rather than
#: defaulting to replicated, which would copy per-replica state onto every
#: shard and corrupt the reductions that assume one owner per replica.
STATE_PARTITION_RULES: tuple = (
    (r"^(t|key|events)$", "replica"),
    (r"^src_", "replica"),
    (r"^srv_", "replica"),
    (r"^tr_", "replica"),
    (r"^rr_next$", "replica"),
    (r"^lim_", "replica"),
    (r"^sink_", "replica"),
    (r"^net_lost$", "replica"),
    (r"^flt_", "replica"),
    (r"^prt_", "replica"),
    (r"^net_partitioned$", "replica"),
    (r"^qrm_", "replica"),
    (r"^ldr_", "replica"),
    (r"^brk_", "replica"),
    (r"^bud_", "replica"),
    (r"^tel_", "replica"),
    (r"^trc_", "replica"),
)


def match_partition_rules(name: str, rules: tuple = STATE_PARTITION_RULES) -> str:
    """The first placement whose pattern matches ``name``; an unknown leaf
    raises."""
    for pattern, placement in rules:
        if re.search(pattern, name):
            return placement
    raise ValueError(
        f"no partition rule matches state leaf {name!r}: add an entry to "
        "happysim_tpu_torch.mesh.STATE_PARTITION_RULES declaring how the "
        "leaf shards over the replica mesh (unknown leaves fail loudly "
        "rather than defaulting to replicated)"
    )


def ensemble_state_specs(leaf_names: Sequence[str], mesh: Optional[ReplicaMesh] = None) -> dict:
    """Each leaf's spec, the mesh axes its leading axis is cut over
    (``("replicas",)``, or ``(("hosts", "replicas"),)`` on the 2-D mesh).
    Every name must match a rule: ``run_ensemble`` runs this gate once a
    call."""
    spec = _replica_spec(mesh)
    specs = {}
    for name in leaf_names:
        placement = match_partition_rules(name)
        if placement != "replica":  # pragma: no cover - no other placement declared
            raise ValueError(f"unknown placement {placement!r} for state leaf {name!r}")
        specs[name] = spec
    return specs


def ensemble_state_shardings(mesh: ReplicaMesh, leaf_names: Sequence[str]) -> dict:
    """The spec table bound to ``mesh``: each leaf's :class:`ReplicaSharding`."""
    return {
        name: ReplicaSharding(mesh, spec)
        for name, spec in ensemble_state_specs(leaf_names, mesh).items()
    }
