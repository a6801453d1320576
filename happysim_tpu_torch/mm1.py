"""The M/M/1 ensemble by the Lindley recursion (counterpart of
``happysim_tpu/tpu/mm1.py``).

The FIFO single-server queue needs no event heap: customer ``n``'s queue
wait is ``W_{n+1} = max(0, W_n + S_n - A_{n+1})`` with ``S ~ Exp(mu)`` and
``A ~ Exp(lambda)``, one step a customer and two simulated events (an
arrival and a departure). :func:`run_mm1_ensemble` runs the recursion for
every replica in one launch of the CUDA kernel of
:mod:`~happysim_tpu_torch.kernels.mm1_scan`, each lane summing its waits,
their squares and its services after the warmup, then reduces across
replicas with torch ops. Its analytic oracle is the queue wait
``E[Wq] = rho / (mu - lambda)`` (not the sojourn ``Wq + 1/mu``).
"""

from __future__ import annotations

import time as _wall
from dataclasses import dataclass
from typing import Optional

import torch

from happysim_tpu_torch import rng
from happysim_tpu_torch.engine import _gather_replicas, _resolve_mesh
from happysim_tpu_torch.kernels import mm1_scan as _scan
from happysim_tpu_torch.mesh import pad_to_multiple


@dataclass(frozen=True)
class MM1Result:
    """Ensemble statistics of the M/M/1 run (the JAX package's fields, and
    the device the run used)."""

    mean_wait_s: float  # E[Wq] across replicas, after the warmup
    std_wait_s: float
    mean_sojourn_s: float  # Wq + service
    analytic_wait_s: float  # rho / (mu - lambda)
    wait_error_rel: float
    n_replicas: int
    customers_per_replica: int
    simulated_events: int  # 2 per customer (arrival + departure)
    wall_seconds: float
    events_per_second: float
    # Seconds spent building and loading the kernel library, kept out of
    # wall_seconds.
    compile_seconds: float = 0.0
    # torch.cuda.get_device_name, or "cpu"
    device_name: str = ""


def _mm1_stats(sum_w, sum_sq, sum_s, n_customers: int, warmup: int) -> tuple:
    """The cross-replica mean wait, its standard deviation and the mean
    sojourn from the per-replica sums, in float32 as the JAX package
    computes them."""
    count = torch.tensor(float(n_customers - warmup), dtype=torch.float32, device=sum_w.device)
    mean = torch.mean(sum_w / count)
    var = torch.mean(sum_sq / count) - mean * mean
    mean_service = torch.mean(sum_s / count)
    return mean, torch.sqrt(torch.clamp_min(var, 0.0)), mean + mean_service


def run_mm1_ensemble(
    lam: float = 8.0,
    mu: float = 10.0,
    n_replicas: int = 65536,
    n_customers: int = 4096,
    warmup: Optional[int] = None,
    seed: int = 0,
    device=None,
    mesh=None,
) -> MM1Result:
    """Run ``n_replicas`` M/M/1 replicas of ``n_customers`` customers each
    and return the aggregate statistics. ``warmup`` (default a quarter of
    the customers) leaves the first customers out of the statistics.

    ``device=None`` means the CUDA card, and raises when torch finds none;
    ``device="cpu"`` runs the plain torch-op scan. A ``mesh``
    (:mod:`happysim_tpu_torch.mesh`) pads the replicas to a multiple of
    its shards, as the JAX package's does, and runs one launch a shard on
    the shard's device; the per-replica sums are gathered in shard order
    onto the first shard's device and averaged there, as on one shard, so
    the statistics are the same bits whatever the shard count.
    ``compile_seconds`` is the kernel library's build and load, and
    ``wall_seconds`` covers the launches and the fetch of the three
    statistics."""
    if lam >= mu:
        raise ValueError(f"Unstable queue: lambda={lam} >= mu={mu}")
    if warmup is None:
        warmup = n_customers // 4
    mesh = _resolve_mesh(mesh, device, "run_mm1_ensemble")
    n_replicas = pad_to_multiple(n_replicas, mesh.size)
    device = mesh.devices[mesh.local_shards[0]]
    on_card = device.type == "cuda"
    compile_start = _wall.perf_counter()
    if on_card:
        _scan.load_library()
    compile_seconds = _wall.perf_counter() - compile_start

    start = _wall.perf_counter()
    shards = []
    for shard in mesh.local_shards:
        rows = mesh.shard_slice(shard, n_replicas)
        key = rng.PRNGKey(seed, device=mesh.devices[shard])
        shards.append(
            _scan.mm1_scan(
                key, n_replicas, lam, mu, n_customers, warmup, rows.start, rows.stop - rows.start
            )
        )
    sums = [
        _gather_replicas([part[i] for part in shards], device, mesh.group) for i in range(3)
    ]
    mean, std, sojourn = (float(x) for x in _mm1_stats(*sums, n_customers, warmup))
    wall = _wall.perf_counter() - start

    analytic = (lam / mu) / (mu - lam)
    events = 2 * n_replicas * n_customers
    return MM1Result(
        mean_wait_s=mean,
        std_wait_s=std,
        mean_sojourn_s=sojourn,
        analytic_wait_s=analytic,
        wait_error_rel=abs(mean - analytic) / analytic,
        n_replicas=n_replicas,
        customers_per_replica=n_customers,
        simulated_events=events,
        wall_seconds=wall,
        events_per_second=events / wall,
        compile_seconds=compile_seconds,
        device_name=torch.cuda.get_device_name(device) if on_card else "cpu",
    )
