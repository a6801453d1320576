"""The port's replica mesh (happysim_tpu_torch/mesh.py) against the JAX
package's: tests/unit/test_tpu_mesh.py's cases (padding at its
boundaries, one-shard meshes and their placements, the padded-replica
truncation round trip, the partition-rule table over the richest
model's leaves, an unknown leaf raising, the host mesh's two axes), the
rule table equal to JAX's, the mesh's construction and its refusals.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu import mesh as jmesh  # noqa: E402
from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu.tpu.model import EnsembleModel as JModel  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import mesh as tmesh  # noqa: E402
from happysim_tpu_torch import rng, run_ensemble, run_mm1_ensemble  # noqa: E402
from happysim_tpu_torch.model import EnsembleModel, FaultSpec, mm1_model  # noqa: E402


def _cpu_mesh(n: int):
    return tmesh.replica_mesh(["cpu"] * n)


@pytest.mark.parametrize(
    "n, devices, want",
    [(8, 4, 8), (4, 4, 4), (65536, 8, 65536), (0, 4, 0), (0, 1, 0), (1, 1, 1), (3, 1, 3),
     (5, 1, 5), (17, 1, 17), (5, 4, 8), (9, 8, 16), (1, 8, 8)],
)
def test_pad_to_multiple_equals_jax(n, devices, want):
    assert tmesh.pad_to_multiple(n, devices) == jmesh.pad_to_multiple(n, devices) == want


def test_replica_mesh_single_device():
    mesh = _cpu_mesh(1)
    assert mesh.size == 1 and mesh.axis_names == (tmesh.REPLICA_AXIS,)
    assert tmesh.HOST_AXIS not in mesh.axis_names
    assert list(mesh.local_shards) == [0] and not mesh.spans_processes
    assert tmesh.replica_sharding(mesh).spec == (tmesh.REPLICA_AXIS,)
    assert tmesh.replicated_sharding(mesh).devices == (torch.device("cpu"),)
    assert tmesh.trace_chunk_sharding(mesh) == tmesh.replicated_sharding(mesh)


def test_a_virtual_mesh_repeats_one_device():
    """Four shards of the CPU: one device, four contiguous slabs."""
    mesh = _cpu_mesh(4)
    assert mesh.size == 4 and mesh.shape == (4,)
    assert [mesh.shard_slice(s, 16) for s in range(4)] == [
        slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)
    ]
    assert tmesh.replicated_sharding(mesh).devices == (torch.device("cpu"),)


def test_replica_mesh_takes_the_card_or_raises(monkeypatch):
    """No device list means every CUDA device, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch finds none"):
        tmesh.replica_mesh()
    with pytest.raises(RuntimeError, match="torch finds none"):
        tmesh.host_replica_mesh()


def test_host_mesh_is_host_major_and_spells_both_axes():
    mesh = tmesh.host_replica_mesh(["cpu"] * 8, n_hosts=2)
    jm = jmesh.host_replica_mesh(jax.devices("cpu")[:8], n_hosts=2)
    assert mesh.axis_names == tuple(jm.axis_names) and mesh.shape == tuple(jm.devices.shape)
    specs = tmesh.ensemble_state_specs(("t", "srv_completed"), mesh)
    assert specs["t"] == ((tmesh.HOST_AXIS, tmesh.REPLICA_AXIS),)
    assert tmesh.replica_sharding(mesh).spec == specs["t"]
    with pytest.raises(ValueError, match="split evenly over 3 hosts"):
        tmesh.host_replica_mesh(["cpu"] * 8, n_hosts=3)


def test_rule_table_equals_jax():
    assert tmesh.STATE_PARTITION_RULES == jmesh.STATE_PARTITION_RULES
    for name in ("t", "key", "src_next", "srv_slot_done", "tel_sink_hist", "trc_cursor",
                 "prt_start", "net_partitioned", "qrm_dropped", "ldr_changes", "bud_tokens"):
        assert tmesh.match_partition_rules(name) == jmesh.match_partition_rules(name)


def _rich(mod):
    """test_tpu_mesh.py's richest shape: a faulted deadline server and a
    plain one behind a round-robin router with a latency edge, a lossy
    exit, telemetry and all three defenses."""
    model = mod(horizon_s=4.0)
    src = model.source(rate=4.0)
    fault = FaultSpec(rate=0.1, mean_duration_s=0.2)
    if mod is JModel:
        from happysim_tpu.tpu.model import FaultSpec as JFaultSpec

        fault = JFaultSpec(rate=0.1, mean_duration_s=0.2)
    first = model.server(service_mean=0.05, queue_capacity=4, deadline_s=1.0, max_retries=1,
                         fault=fault)
    second = model.server(service_mean=0.05, queue_capacity=4)
    router = model.router(policy="round_robin")
    snk = model.sink()
    model.connect(src, router)
    model.connect(router, first, latency_s=0.01)
    model.connect(router, second)
    model.connect(first, snk, loss_p=0.01)
    model.connect(second, snk)
    model.telemetry(window_s=1.0)
    model.circuit_breaker(failure_threshold=2)
    model.load_shed(policy="queue_depth", threshold=2)
    model.retry_budget(ratio=0.2)
    return model


def _leaves(model) -> tuple:
    compiled = tengine._Compiled(model)
    params = {"src_rate": torch.full((1, compiled.nS), 4.0),
              "srv_mean": torch.full((1, compiled.nV), 0.05)}
    return tuple(compiled.init_state(rng.split(rng.PRNGKey(0), 1), params))


def test_every_rich_model_leaf_has_a_rule():
    keys = _leaves(_rich(EnsembleModel))
    for expected in ("flt_start", "tel_sink_count", "tr_time", "srv_q_attempt", "rr_next",
                     "net_lost", "key", "t", "events", "brk_state", "brk_fail_t",
                     "brk_open_time", "bud_tokens", "srv_shed_dropped", "srv_budget_dropped"):
        assert expected in keys, expected
    jkeys = tuple(jax.eval_shape(
        JCompiled(_rich(JModel)).init_state,
        jax.ShapeDtypeStruct((2,), np.uint32),
        {"src_rate": jax.ShapeDtypeStruct((1,), np.float32),
         "srv_mean": jax.ShapeDtypeStruct((2,), np.float32)},
    ))
    assert set(keys) == set(jkeys)
    specs = tmesh.ensemble_state_specs(keys)
    assert set(specs) == set(keys) and set(specs.values()) == {(tmesh.REPLICA_AXIS,)}
    shardings = tmesh.ensemble_state_shardings(_cpu_mesh(4), keys)
    assert {s.mesh.size for s in shardings.values()} == {4}


@pytest.mark.parametrize("model", ["quorum", "trace"])
def test_consensus_and_trace_leaves_have_rules(model):
    import chip_smoke

    if model == "quorum":
        built = chip_smoke.wide_quorum_model(EnsembleModel)
    else:
        from happysim_tpu_torch import flash_crowd_trace

        built = EnsembleModel(horizon_s=4.0)
        srv = built.server(service_mean=0.01)
        built.connect(built.trace_arrivals(flash_crowd_trace(10.0, 20.0, 1.0, 2.0, 4.0, seed=1,
                                                             chunk_len=32)), srv)
        built.connect(srv, built.sink())
        built.telemetry(window_s=1.0)
    tmesh.ensemble_state_specs(_leaves(built))


def test_unknown_leaf_fails_loudly():
    with pytest.raises(ValueError, match="no partition rule matches"):
        tmesh.match_partition_rules("mystery_buffer")
    with pytest.raises(ValueError, match="STATE_PARTITION_RULES"):
        tmesh.ensemble_state_specs(("t", "mystery_buffer"))


def test_run_gates_every_leaf_once(monkeypatch):
    """run_ensemble checks the run's leaves against the table: a table
    without the server rule refuses the run, naming a server leaf."""
    rules = tuple(r for r in tmesh.STATE_PARTITION_RULES if r[0] != r"^srv_")
    monkeypatch.setattr(tmesh, "STATE_PARTITION_RULES", rules)
    monkeypatch.setattr(tmesh.match_partition_rules, "__defaults__", (rules,))
    with pytest.raises(ValueError, match="no partition rule matches state leaf 'srv_"):
        run_ensemble(mm1_model(horizon_s=2.0), n_replicas=4, device="cpu", max_events=8)


@pytest.mark.parametrize("budget, truncated", [(2, 8), (128, 0)])
def test_padded_count_and_truncation_round_trip(budget, truncated):
    """5 replicas pad to 8 on a 4-shard mesh; a 2-event budget truncates
    every lane, padded ones included, and an ample one none."""
    model = mm1_model(horizon_s=20.0) if budget == 2 else mm1_model(lam=2.0, mu=10.0, horizon_s=2.0)
    result = run_ensemble(model, n_replicas=5, seed=0, mesh=_cpu_mesh(4), max_events=budget)
    assert result.n_replicas == 8 and result.truncated_replicas == truncated
    assert result.engine_path == "scan" and result.per_shard_replicas == 2


def test_a_mesh_and_another_device_refuse():
    with pytest.raises(ValueError, match="asks for another device"):
        run_ensemble(mm1_model(horizon_s=2.0), n_replicas=4, device="cuda", mesh=_cpu_mesh(2),
                     max_events=8)
    with pytest.raises(ValueError, match="asks for another device"):
        run_mm1_ensemble(8.0, 10.0, 4, 16, device="cuda", mesh=_cpu_mesh(2))
    # The same device is no disagreement.
    result = run_ensemble(mm1_model(horizon_s=2.0), n_replicas=4, device="cpu",
                          mesh=_cpu_mesh(2), max_events=8)
    assert result.mesh_devices == 2


def test_engine_report_mesh_has_jax_keys():
    result = run_ensemble(mm1_model(horizon_s=2.0), n_replicas=6, mesh=_cpu_mesh(3),
                          max_events=64)
    assert result.engine_report()["mesh"] == {
        "devices": 3, "axes": ("replicas",), "shape": (3,), "per_shard_replicas": 2,
        "reduce_path": "device-limb-sum", "redistribution_seconds": 0.0,
    }
    one = run_ensemble(mm1_model(horizon_s=2.0), n_replicas=6, device="cpu", max_events=64)
    assert one.engine_report()["mesh"]["devices"] == 1 and one.per_shard_replicas == 6


def test_distributed_initialize_without_a_cluster_is_one_process(monkeypatch):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.distributed_initialize() is False
    with pytest.raises(ValueError, match="together"):
        tmesh.distributed_initialize(coordinator_address="localhost:1")


def test_mesh_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="at least one device"):
        tmesh.ReplicaMesh(())
    with pytest.raises(ValueError, match="does not hold"):
        tmesh.ReplicaMesh(("cpu", "cpu"), shape=(3,))
    with pytest.raises(ValueError, match="split evenly over 3 processes"):
        tmesh.ReplicaMesh(("cpu",) * 4, world_size=3)
