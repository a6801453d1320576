"""Checkpoint and resume of the partitioned executor on the CPU: a
checkpointed run equals the uninterrupted one, a snapshot saved to an npz
resumes to the same totals, a snapshot of either package resumes in the
other to the JAX package's totals, and a resume is validated field by
field as JAX validates it (its sentinels skipped, its message kept).

Integer totals must be equal; means within rel 1e-4 across the packages
(XLA's CPU ``log``: ROADMAP C), bit for bit within the port.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import partitioned as jpart  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import partitioned as tpart  # noqa: E402
from test_torch_partitioned_models import HOP_S, chaos_ring, ring  # noqa: E402

P, R, HORIZON_S, EVERY = 2, 4, 3.0, 15
KWARGS = dict(window_s=HOP_S, n_replicas=R, seed=6)
INT_FIELDS = (
    "n_partitions", "n_replicas", "n_windows", "simulated_events", "sink_count",
    "server_completed", "server_dropped", "server_outage_dropped", "remote_sent",
    "remote_dropped", "transit_dropped", "truncated_windows",
)


def _tmesh(n=P):
    return tpart.partition_mesh(["cpu"] * n)


def _jmesh(n=P):
    return jpart.partition_mesh(jax.devices("cpu")[:n])


def _same(a, b, exact: bool) -> None:
    for field in INT_FIELDS:
        assert getattr(a, field) == getattr(b, field), field
    np.testing.assert_array_equal(a.per_partition_sink_count, b.per_partition_sink_count)
    if exact:
        assert a.sink_mean_latency_s == b.sink_mean_latency_s
    else:
        np.testing.assert_allclose(a.sink_mean_latency_s, b.sink_mean_latency_s, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's uninterrupted run of the chaos ring and its snapshots."""
    model = chaos_ring(jmodel, HORIZON_S)
    baseline = jpart.run_partitioned(model, mesh=_jmesh(), **KWARGS)
    snaps = []
    jpart.run_partitioned(model, mesh=_jmesh(), **KWARGS, checkpoint_every_windows=EVERY,
                          checkpoint_callback=snaps.append)
    return baseline, snaps


@pytest.fixture(scope="module")
def port_side():
    """The port's uninterrupted run of the chaos ring, its checkpointed
    run and its snapshots."""
    model = chaos_ring(tmodel, HORIZON_S)
    baseline = tpart.run_partitioned(model, mesh=_tmesh(), **KWARGS)
    snaps = []
    checkpointed = tpart.run_partitioned(model, mesh=_tmesh(), **KWARGS,
                                         checkpoint_every_windows=EVERY,
                                         checkpoint_callback=snaps.append)
    return baseline, checkpointed, snaps


def test_checkpointed_run_equals_the_uninterrupted_run(port_side):
    baseline, checkpointed, snaps = port_side
    _same(baseline, checkpointed, exact=True)
    assert [s.window_index for s in snaps] == list(range(EVERY, baseline.n_windows, EVERY))
    assert all(int(s.state["ob_len"].sum()) == 0 for s in snaps), "outboxes reset at a barrier"


@pytest.mark.parametrize("which", ["first", "middle", "last"])
def test_resume_through_an_npz_equals_the_uninterrupted_run(port_side, tmp_path, which):
    baseline, _checkpointed, snaps = port_side
    snap = {"first": snaps[0], "middle": snaps[len(snaps) // 2], "last": snaps[-1]}[which]
    path = str(tmp_path / "partitioned")
    snap.save(path)
    loaded = tpart.PartitionedCheckpoint.load(path)
    assert loaded.window_index == snap.window_index
    assert loaded.model_fingerprint == tpart.model_fingerprint(chaos_ring(tmodel, HORIZON_S))
    resumed = tpart.run_partitioned(chaos_ring(tmodel, HORIZON_S), mesh=_tmesh(), **KWARGS,
                                    resume_from=loaded)
    _same(baseline, resumed, exact=True)


def test_jax_snapshot_resumes_in_the_port(jax_side, tmp_path):
    """A JAX snapshot, written by JAX's save and read by the port's load,
    resumes to JAX's totals."""
    baseline, snaps = jax_side
    path = str(tmp_path / "jax_snapshot.npz")
    snaps[len(snaps) // 2].save(path)
    resumed = tpart.run_partitioned(chaos_ring(tmodel, HORIZON_S), mesh=_tmesh(), **KWARGS,
                                    resume_from=tpart.PartitionedCheckpoint.load(path))
    _same(baseline, resumed, exact=False)


def test_port_snapshot_resumes_in_jax(jax_side, port_side, tmp_path):
    """A port snapshot, written by the port's save and read by JAX's load,
    resumes in JAX to JAX's totals."""
    baseline, _snaps = jax_side
    _port_baseline, _checkpointed, snaps = port_side
    path = str(tmp_path / "port_snapshot.npz")
    snaps[len(snaps) // 2].save(path)
    resumed = jpart.run_partitioned(chaos_ring(jmodel, HORIZON_S), mesh=_jmesh(), **KWARGS,
                                    resume_from=jpart.PartitionedCheckpoint.load(path))
    _same(baseline, resumed, exact=False)


def test_snapshot_leaves_are_jax_s(jax_side, port_side):
    """The same leaves, shapes and dtypes, partition-major (P, R, ...)."""
    jsnap, tsnap = jax_side[1][0], port_side[2][0]
    assert set(jsnap.state) == set(tsnap.state)
    for leaf, value in jsnap.state.items():
        assert tsnap.state[leaf].shape == value.shape and tsnap.state[leaf].dtype == value.dtype, leaf
    meta = {f.name for f in dataclasses.fields(tpart.PartitionedCheckpoint)}
    assert meta == {f.name for f in dataclasses.fields(jpart.PartitionedCheckpoint)}


def test_resume_rejects_mismatched_partitions_with_jax_s_message(jax_side, port_side):
    messages = []
    with pytest.raises(ValueError, match="n_partitions") as info:
        jpart.run_partitioned(chaos_ring(jmodel, HORIZON_S), mesh=_jmesh(3), **KWARGS,
                              resume_from=jax_side[1][0])
    messages.append(str(info.value))
    with pytest.raises(ValueError, match="n_partitions") as info:
        tpart.run_partitioned(chaos_ring(tmodel, HORIZON_S), mesh=_tmesh(3), **KWARGS,
                              resume_from=port_side[2][0])
    messages.append(str(info.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("field, value", [
    ("seed", 7), ("n_replicas", 5), ("window_s", 0.04), ("max_events_per_window", 9),
    ("outbox_capacity", 3), ("model_fingerprint", "0" * 16),
])
def test_resume_rejects_each_mismatched_field(port_side, field, value):
    snap = dataclasses.replace(port_side[2][0], **{field: value})
    with pytest.raises(ValueError, match=field):
        tpart.run_partitioned(chaos_ring(tmodel, HORIZON_S), mesh=_tmesh(), **KWARGS,
                              resume_from=snap)


def test_resume_skips_sentinel_fields(port_side):
    """A snapshot that predates the optional fields (their sentinels)
    resumes."""
    baseline, _checkpointed, snaps = port_side
    snap = dataclasses.replace(snaps[0], model_fingerprint="", window_s=-1.0,
                               max_events_per_window=-1, outbox_capacity=-1)
    resumed = tpart.run_partitioned(chaos_ring(tmodel, HORIZON_S), mesh=_tmesh(), **KWARGS,
                                    resume_from=snap)
    _same(baseline, resumed, exact=True)


def test_resume_rejects_another_model_s_leaves(port_side):
    """A snapshot of a model with other leaves (the chaos ring's attempt
    numbers) is refused before any launch."""
    snap = dataclasses.replace(port_side[2][0], model_fingerprint="")
    with pytest.raises(ValueError, match="leaves differ"):
        tpart.run_partitioned(ring(tmodel, HORIZON_S), mesh=_tmesh(), **KWARGS,
                              resume_from=snap)
