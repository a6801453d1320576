"""Whole runs on the port's replica mesh against the JAX package's:
tests/integration/test_tpu_mesh_resume.py's model (a faulted deadline
M/M/1 with windowed telemetry) and KWARGS (16 replicas) on CPU meshes of
1, 4 and 8 shards, the same bits on each and equal to JAX's run on
``replica_mesh(jax.devices("cpu")[:8])``; a 3-shard run padding 16
replicas to 18 as JAX's does; snapshots resumed across shard counts and
from a JAX 8-device snapshot; run_mm1_ensemble, a traced run and the
chain closed form across shard counts.

Parity with JAX is the second level of ROADMAP "How parity is defined":
integer totals and integer window series equal, float means within rel
1e-4. Across the port's shard counts every field is equal but the mesh's
own provenance.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from happysim_tpu.tpu import EnsembleCheckpoint as JCheckpoint  # noqa: E402
from happysim_tpu.tpu import replica_mesh as j_replica_mesh  # noqa: E402
from happysim_tpu.tpu import run_ensemble as j_run  # noqa: E402
from happysim_tpu.tpu import run_mm1_ensemble as j_mm1  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu_torch import (  # noqa: E402
    EnsembleCheckpoint,
    flash_crowd_trace,
    replica_mesh,
    run_ensemble,
    run_mm1_ensemble,
)
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch.engine import resume_mismatches  # noqa: E402

KWARGS = dict(n_replicas=16, seed=11, max_events=480)
# The mesh's provenance, which differs between shard counts by design.
MESH_FIELDS = frozenset({"mesh_devices", "mesh_shape", "per_shard_replicas"})
INT_FIELDS = (
    "n_replicas", "simulated_events", "sink_count", "server_completed", "server_dropped",
    "server_timed_out", "server_retried", "server_fault_dropped", "truncated_replicas",
)
FLOAT_FIELDS = (
    "sink_mean_latency_s", "server_mean_wait_s", "server_utilization", "server_mean_queue_len",
)


def _model(mod):
    """test_tpu_mesh_resume.py's model."""
    model = mod.EnsembleModel(horizon_s=12.0, warmup_s=2.0)
    src = model.source(rate=8.0)
    srv = model.server(
        service_mean=0.1, queue_capacity=64, deadline_s=8.0, max_retries=1,
        fault=mod.FaultSpec(rate=0.05, mean_duration_s=0.5),
    )
    snk = model.sink()
    model.connect(src, srv)
    model.connect(srv, snk)
    model.telemetry(window_s=0.75)  # 16 windows
    return model


def _cpu(n: int):
    return replica_mesh(["cpu"] * n)


def _jax_mesh(n: int):
    return j_replica_mesh(jax.devices("cpu")[:n])


def _same(a, b, label):
    assert resume_mismatches(a, b, MESH_FIELDS) == [], label


def _close_to_jax(got, want):
    for field in INT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.sink_hist, want.sink_hist)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=1e-4,
                                   err_msg=field)
    for name in ("sink_count", "server_completed", "server_dropped"):
        np.testing.assert_array_equal(
            getattr(got.timeseries, name), getattr(want.timeseries, name), err_msg=name
        )


@pytest.fixture(scope="module")
def port_runs():
    """The port's run on 1, 4 and 8 CPU shards."""
    return {n: run_ensemble(_model(tmodel), **KWARGS, mesh=_cpu(n)) for n in (1, 4, 8)}


@pytest.fixture(scope="module")
def jax_golden():
    return j_run(_model(jmodel), **KWARGS, mesh=_jax_mesh(8))


@pytest.mark.parametrize("shards", [4, 8])
def test_runs_are_the_same_bits_on_every_shard_count(port_runs, shards):
    base, other = port_runs[1], port_runs[shards]
    _same(base, other, f"1 vs {shards} shards")
    assert other.timeseries == base.timeseries
    assert (other.mesh_devices, other.per_shard_replicas) == (shards, 16 // shards)
    assert other.engine_path == "scan" and other.reduce_path == "device-limb-sum"


def test_runs_equal_jax_on_its_8_device_mesh(port_runs, jax_golden):
    got = port_runs[8]
    _close_to_jax(got, jax_golden)
    assert (got.blocks_total, got.block_occupancy) == (
        jax_golden.blocks_total, jax_golden.block_occupancy
    )
    report, jreport = got.engine_report()["mesh"], jax_golden.engine_report()["mesh"]
    assert set(report) == set(jreport)
    for key in ("devices", "axes", "shape", "per_shard_replicas"):
        assert report[key] == jreport[key], key


def test_three_shards_pad_sixteen_replicas_to_eighteen(port_runs):
    """JAX pads 16 to 18 on 3 devices: the port's 3-shard run equals its
    1-shard run at 18 replicas and JAX's 3-device run, and reports 18."""
    three = run_ensemble(_model(tmodel), **KWARGS, mesh=_cpu(3))
    eighteen = run_ensemble(_model(tmodel), **dict(KWARGS, n_replicas=18), mesh=_cpu(1))
    assert three.n_replicas == eighteen.n_replicas == 18 and three.per_shard_replicas == 6
    _same(three, eighteen, "3 shards vs 18 replicas on 1")
    jax_three = j_run(_model(jmodel), **KWARGS, mesh=_jax_mesh(3))
    assert jax_three.n_replicas == 18
    _close_to_jax(three, jax_three)


@pytest.fixture(scope="module")
def snapshots():
    """A mid-run snapshot of the port's 1-shard and 8-shard checkpointed
    runs."""
    out = {}
    for n in (1, 8):
        snaps = []
        run_ensemble(_model(tmodel), **KWARGS, mesh=_cpu(n), checkpoint_every_s=0.0,
                     checkpoint_callback=snaps.append)
        assert snaps and all(0 < s.chunk_index < s.n_chunks for s in snaps)
        out[n] = snaps[len(snaps) // 2]
    return out


def test_snapshot_records_its_shard_count(snapshots, tmp_path):
    assert (snapshots[1].mesh_devices, snapshots[8].mesh_devices) == (1, 8)
    for name in snapshots[1].state:
        np.testing.assert_array_equal(snapshots[1].state[name], snapshots[8].state[name],
                                      err_msg=name)
    path = str(tmp_path / "eight.npz")
    snapshots[8].save(path)
    assert EnsembleCheckpoint.load(path).mesh_devices == 8


@pytest.mark.parametrize("source, target", [(1, 8), (8, 1), (8, 4), (1, 4)])
def test_resume_across_shard_counts_lands_on_the_golden(port_runs, snapshots, source, target):
    resumed = run_ensemble(_model(tmodel), **KWARGS, mesh=_cpu(target),
                           resume_from=snapshots[source])
    _same(resumed, port_runs[1], f"{source} -> {target} shards")
    assert resumed.timeseries == port_runs[1].timeseries
    assert resumed.mesh_devices == target and resumed.redistribution_seconds > 0.0
    assert resumed.blocks_total < port_runs[1].blocks_total


def test_jax_8_device_snapshot_resumes_on_port_meshes(port_runs, jax_golden, tmp_path):
    snaps = []
    j_run(_model(jmodel), **KWARGS, mesh=_jax_mesh(8), checkpoint_every_s=0.0,
          checkpoint_callback=snaps.append)
    path = str(tmp_path / "jax8.npz")
    snaps[len(snaps) // 2].save(path)
    loaded = EnsembleCheckpoint.load(path)
    assert loaded.mesh_devices == 8
    for n in (1, 4):
        resumed = run_ensemble(_model(tmodel), **KWARGS, mesh=_cpu(n), resume_from=loaded)
        _close_to_jax(resumed, jax_golden)


def test_port_snapshot_resumes_on_a_jax_mesh(snapshots, jax_golden, tmp_path):
    path = str(tmp_path / "port4.npz")
    snapshots[8].save(path)
    back = j_run(_model(jmodel), **KWARGS, mesh=_jax_mesh(4), resume_from=JCheckpoint.load(path))
    _close_to_jax(back, jax_golden)


def test_a_mismatched_replica_axis_names_the_mesh(snapshots):
    bad = dataclasses.replace(
        snapshots[1], state={k: v[:8] for k, v in snapshots[1].state.items()}
    )
    with pytest.raises(ValueError, match="redistributed onto this mesh"):
        run_ensemble(_model(tmodel), **KWARGS, mesh=_cpu(4), resume_from=bad)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        run_ensemble(_model(tmodel), **dict(KWARGS, n_replicas=15), mesh=_cpu(3),
                     resume_from=snapshots[1])


def test_mm1_ensemble_same_bits_on_every_shard_count_and_close_to_jax():
    runs = [run_mm1_ensemble(8.0, 10.0, 16, 256, mesh=_cpu(n)) for n in (1, 4, 8)]
    fields = ("mean_wait_s", "std_wait_s", "mean_sojourn_s", "n_replicas", "simulated_events")
    for other in runs[1:]:
        assert [getattr(other, f) for f in fields] == [getattr(runs[0], f) for f in fields]
    want = j_mm1(8.0, 10.0, 16, 256, mesh=_jax_mesh(8))
    for field in ("mean_wait_s", "std_wait_s", "mean_sojourn_s"):
        np.testing.assert_allclose(getattr(runs[2], field), getattr(want, field), rtol=1e-6)
    padded = run_mm1_ensemble(8.0, 10.0, 16, 256, mesh=_cpu(3))
    assert padded.n_replicas == 18 == j_mm1(8.0, 10.0, 16, 256, mesh=_jax_mesh(3)).n_replicas
    assert padded.mean_wait_s == run_mm1_ensemble(8.0, 10.0, 18, 256, device="cpu").mean_wait_s


def test_traced_run_same_bits_on_every_shard_count():
    """The flash crowd on 1 and 4 shards: each shard's lanes read the
    pages copied to its device, the stream step's sync reduced over the
    shards, at most 2 pages resident."""
    trace = flash_crowd_trace(100.0, 500.0, 4.0, 6.0, 16.0, seed=11, chunk_len=64)

    def model():
        m = tmodel.EnsembleModel(horizon_s=16.0, macro_block=16)
        srv = m.server(concurrency=4, service_mean=0.004, queue_capacity=64)
        m.connect(m.trace_arrivals(trace), srv)
        m.connect(srv, m.sink())
        return m

    one = run_ensemble(model(), n_replicas=8, mesh=_cpu(1), max_events=16384)
    four = run_ensemble(model(), n_replicas=8, mesh=_cpu(4), max_events=16384)
    _same(one, four, "traced 1 vs 4 shards")
    assert four.trace_tenant_arrivals == [8 * trace.n_arrivals]
    assert four.trace_max_resident_chunks <= 2 and four.trace_stream_steps == one.trace_stream_steps


def test_chain_form_on_a_mesh():
    """The closed form's blocks go by shard: every integer total is the
    same on 1 and 4 shards, and the float totals, summed block by block,
    agree to float32 resolution (the same bits where the blocks do)."""
    model = tmodel.mm1_model(8.0, 10.0, 20.0, warmup_s=5.0)
    one = run_ensemble(model, n_replicas=16, mesh=_cpu(1))
    four = run_ensemble(model, n_replicas=16, mesh=_cpu(4))
    assert one.engine_path == four.engine_path == "chain"
    for field in ("simulated_events", "sink_count", "server_completed", "truncated_replicas"):
        assert getattr(one, field) == getattr(four, field), field
    np.testing.assert_array_equal(one.sink_hist, four.sink_hist)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(one, field), getattr(four, field), rtol=1e-6)
