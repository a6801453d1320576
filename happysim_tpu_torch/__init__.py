"""happysim_tpu_torch: the ensemble engine of ``happysim_tpu`` in PyTorch,
with its event step as a hand-written CUDA kernel for NVIDIA Hopper.

It runs thousands of independent Monte-Carlo replicas of a queueing
model as one program on the card::

    from happysim_tpu_torch import mm1_model, run_ensemble
    result = run_ensemble(mm1_model(lam=8, mu=10, horizon_s=160, warmup_s=40),
                          n_replicas=65536)          # on "cuda"
    result.server_mean_wait_s[0]                     # ~ rho/(mu-lam) = 0.4 s

It imports torch and numpy only: nothing of JAX and nothing of the JAX
package, whose modules it mirrors (flattened out of ``tpu/``) and keeps
the function and state-leaf names of:

=================================  =========================================
this package                       JAX package
=================================  =========================================
``model.py``                       ``happysim_tpu/tpu/model.py``
``rng.py``                         ``jax.random`` (threefry2x32, as used in
                                   ``tpu/engine.py``)
``reduce.py``                      ``happysim_tpu/tpu/reduce.py``
``faults.py``                      ``happysim_tpu/tpu/faults.py``
                                   (``FaultTable``, ``PartitionTable``,
                                   ``duty_cycle``)
``engine.py``                      ``happysim_tpu/tpu/engine.py`` (with the
                                   checkpoint format and its fingerprints)
``mm1.py``                         ``happysim_tpu/tpu/mm1.py``
``opinion.py``                     ``happysim_tpu/tpu/opinion.py``
``chain.py``                       ``happysim_tpu/tpu/chain.py``
``telemetry.py``                   ``happysim_tpu/tpu/telemetry.py``
``summary.py``                     ``happysim_tpu/instrumentation/summary.py``
``data.py``                        ``happysim_tpu/instrumentation/data.py``
``temporal.py``                    ``Instant`` and ``Duration`` of
                                   ``happysim_tpu/core/temporal.py``
``traces.py``                      ``happysim_tpu/tpu/traces.py``
``kernels/support.py``             ``happysim_tpu/tpu/kernels/support.py``
``kernels/event_step.py``          ``happysim_tpu/tpu/kernels/event_step.py``
``kernels/csrc/event_step*.cu``    the Pallas kernel of ``build_block_step``
``kernels/uniform.py``,            ``jax.random.uniform`` in ``chain.py``
``kernels/csrc/uniform.cu``        (no Pallas kernel)
``kernels/mm1_scan.py``,           the ``lax.scan`` of ``mm1.py``'s
``kernels/csrc/mm1_scan.cu``       ``_mm1_scan`` (no Pallas kernel)
``partitioned.py``                 ``happysim_tpu/tpu/partitioned.py``
``kernels/partition_barrier.py``,  the barrier of ``partitioned.py``'s
``kernels/csrc/partition_barrier.cu``  ``one_window`` (no Pallas kernel)
``kernels/build.py``               (none: the nvcc build of ``csrc/``)
``numerics.py``                    ``jnp.interp`` and XLA's float32 erfinv
``convert.py``                     (none: numpy state/params across)
=================================  =========================================

What runs: every graph of sources, sinks, servers, routers (random,
round-robin, weighted, least-outstanding) and token-bucket limiters that
the JAX package's ``validate`` accepts, from ``mm1_model`` and
``pipeline_model`` to load-balancer fan-outs, multi-tier DAGs, "done or
continue" feedback, several tenants into their own sinks and nodes no
source reaches (Poisson or constant arrivals, flat or shaped by a ramp or
spike ``RateProfile``, wired to any node or straight to a sink; constant, exponential,
erlang-2/3, hyperexponential, lognormal or pareto service, any
concurrency and queue capacity, zero-latency or latency-carrying edges,
warmup), with the chaos stack on any of them: deadlines with immediate
or backoff (jittered) retries, hedged requests, brownout windows,
stochastic or pinned ``FaultSpec`` schedules (outage or degrade mode),
correlated outages and packet loss on edges, the defenses against it
(``model.circuit_breaker(...)``, ``load_shed(...)``, ``retry_budget(...)``),
the consensus tier (``model.network_partition(...)``, ``quorum(...)``,
``leader_election(...)``) and windowed telemetry (``model.telemetry(...)``, ``result.timeseries``)
on any of them, checkpointed and resumed in segments
(``checkpoint_every_s``, ``checkpoint_callback``, ``resume_from``; the
snapshots load in either package). As in the JAX package, a call with no
``max_events`` runs a
Poisson source into a chain of FIFO single-server stations, or a random or
round-robin router over such chains, by the max-plus closed form of
``chain.py`` (``engine_path == "chain"``). ``run_mm1_ensemble`` runs the
M/M/1 ensemble by its Lindley recursion in one kernel launch, and
``opinion.py`` the DeGroot, bounded-confidence and voter rounds. A source
may replay a recorded or synthesized trace (``model.trace_arrivals(...)``
with a ``TraceSpec`` or the ``diurnal_trace``, ``flash_crowd_trace`` and
``zipf_tenant_trace`` synthesizers), streamed to the card in pages
between kernel launches. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``. ``run_ensemble`` and ``run_mm1_ensemble``
take a ``mesh`` (``replica_mesh``, ``host_replica_mesh``; ``mesh.py``)
that cuts the replicas into shards, one launch a shard, on several
devices, several shards of one device, or the devices of several
processes joined by ``distributed_initialize``, with the same bits on
any shard count.

A result's ``summary()`` is the JAX engine's ``SimulationSummary``
entity for entity, and a timeseries' ``to_data()`` its columns as
``Data`` series, on the port's own copies of those classes. The scan
marks its stages with the JAX engine's scope names
(``engine.PROFILER_SCOPES``, ``engine_report()["profiler_scopes"]``) as
``torch.profiler.record_function`` ranges: ``hs.macro_block`` around
each budget call of the event step, ``hs.kernel`` around the kernel's
launch inside it, ``hs.reduce`` around the reduce over replicas.

The package exports the JAX package's names that it ports. Left out by
design: ``KERNEL_ENV``, ``pallas_available`` and
``maybe_enable_compile_cache`` (XLA and Pallas switches), and
``kernel_decision`` (the Pallas dispatch, which takes a JAX mesh; the
port runs every model on its CUDA kernel, and
``EnsembleModel.kernel_supported()`` names a model's refusal).
``run_partitioned`` (``partitioned.py``, with ``partition_mesh``,
``PARTITION_AXIS``, ``PartitionedCheckpoint`` and ``PartitionedResult``)
runs one simulation per replica whose entities are cut into partitions
around a ring: jobs leave a partition through ``model.remote(...)``
egress nodes and cross at window barriers, each window one launch of the
event-step kernel and one of the barrier kernel a device.
"""

from happysim_tpu_torch.engine import (
    EnsembleCheckpoint,
    EnsembleResult,
    hist_percentile,
    load_checkpoint_npz,
    macro_block_len,
    model_fingerprint,
    params_fingerprint,
    run_ensemble,
    save_checkpoint_npz,
)
from happysim_tpu_torch.faults import duty_cycle
from happysim_tpu_torch.kernels.support import kernel_plan
from happysim_tpu_torch.mesh import (
    HOST_AXIS,
    REPLICA_AXIS,
    STATE_PARTITION_RULES,
    distributed_initialize,
    ensemble_state_shardings,
    ensemble_state_specs,
    host_replica_mesh,
    match_partition_rules,
    pad_to_multiple,
    replica_mesh,
    replica_sharding,
    replicated_sharding,
)
from happysim_tpu_torch.mm1 import MM1Result, run_mm1_ensemble
from happysim_tpu_torch.partitioned import (
    PARTITION_AXIS,
    PartitionedCheckpoint,
    PartitionedResult,
    partition_mesh,
    run_partitioned,
)
from happysim_tpu_torch.model import (
    CircuitBreakerSpec,
    CorrelatedOutages,
    EnsembleModel,
    FaultSpec,
    LoadShedSpec,
    NodeRef,
    RateProfile,
    RetryBudgetSpec,
    mm1_model,
    pipeline_model,
)
from happysim_tpu_torch.reduce import (
    MAX_EXACT_REPLICAS,
    host_f64,
    host_i64,
    sum_f32_fixed,
    sum_i64_limbs,
)
from happysim_tpu_torch.telemetry import DEFAULT_METRICS, EnsembleTimeseries, TelemetrySpec
from happysim_tpu_torch.traces import (
    DEFAULT_CHUNK_LEN,
    TraceSpec,
    diurnal_trace,
    flash_crowd_trace,
    zipf_tenant_trace,
)

__all__ = [
    "PARTITION_AXIS",
    "PartitionedCheckpoint",
    "PartitionedResult",
    "partition_mesh",
    "run_partitioned",
    "HOST_AXIS",
    "REPLICA_AXIS",
    "STATE_PARTITION_RULES",
    "distributed_initialize",
    "ensemble_state_shardings",
    "ensemble_state_specs",
    "host_replica_mesh",
    "match_partition_rules",
    "pad_to_multiple",
    "replica_mesh",
    "replica_sharding",
    "replicated_sharding",
    "CircuitBreakerSpec",
    "CorrelatedOutages",
    "DEFAULT_CHUNK_LEN",
    "DEFAULT_METRICS",
    "EnsembleCheckpoint",
    "EnsembleModel",
    "EnsembleResult",
    "EnsembleTimeseries",
    "FaultSpec",
    "LoadShedSpec",
    "MAX_EXACT_REPLICAS",
    "MM1Result",
    "NodeRef",
    "RateProfile",
    "RetryBudgetSpec",
    "TelemetrySpec",
    "TraceSpec",
    "diurnal_trace",
    "duty_cycle",
    "flash_crowd_trace",
    "hist_percentile",
    "host_f64",
    "host_i64",
    "kernel_plan",
    "load_checkpoint_npz",
    "macro_block_len",
    "mm1_model",
    "model_fingerprint",
    "params_fingerprint",
    "pipeline_model",
    "run_ensemble",
    "run_mm1_ensemble",
    "save_checkpoint_npz",
    "sum_f32_fixed",
    "sum_i64_limbs",
    "zipf_tenant_trace",
]
