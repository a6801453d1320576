"""Whole partitioned runs of the port (``run_partitioned(..., device=
"cpu")``: the plain window and barrier) against the JAX package's
``run_partitioned`` on ``partition_mesh`` of the conftest's CPU devices:
the example ring, a chaos ring, a two-tenant ring, and an outbox that
overflows with a budget that truncates windows, each run shared by the
tests through a module-scoped fixture.

Integer totals must be equal; means within rel 1e-4 (XLA's CPU ``log``
differs from torch's by an ulp on some draws: ROADMAP C).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import partitioned as jpart  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import partitioned as tpart  # noqa: E402
from test_torch_partitioned_models import HOP_S, PARTITIONED_MODELS  # noqa: E402

# name -> (model, partitions, replicas, horizon, run_partitioned's options)
RUNS = {
    "ring": ("ring", 4, 8, 4.0, {}),
    "chaos-ring": ("chaos-ring", 3, 8, 4.0, {}),
    "two-sink-ring": ("two-sink-ring", 2, 16, 4.0, {}),
    # A one-entry outbox overflows, and a two-event budget truncates windows.
    "overflow-truncated": ("ring", 2, 8, 4.0, {"outbox_capacity": 1, "max_events_per_window": 2}),
}
INT_FIELDS = (
    "n_partitions", "n_replicas", "n_windows", "simulated_events", "sink_count",
    "server_completed", "server_dropped", "server_outage_dropped", "remote_sent",
    "remote_dropped", "transit_dropped", "truncated_windows",
)


def _run(package, name):
    model_name, partitions, replicas, horizon, options = RUNS[name]
    if package == "jax":
        model = PARTITIONED_MODELS[model_name](jmodel, horizon)
        mesh = jpart.partition_mesh(jax.devices("cpu")[:partitions])
        return jpart.run_partitioned(model, window_s=HOP_S, mesh=mesh, n_replicas=replicas,
                                     seed=13, **options)
    model = PARTITIONED_MODELS[model_name](tmodel, horizon)
    mesh = tpart.partition_mesh(["cpu"] * partitions)
    return tpart.run_partitioned(model, window_s=HOP_S, mesh=mesh, n_replicas=replicas,
                                 seed=13, **options)


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _run("jax", name) for name in RUNS}


@pytest.fixture(scope="module")
def torch_runs():
    return {name: _run("torch", name) for name in RUNS}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_jax(jax_runs, torch_runs, name):
    want, got = jax_runs[name], torch_runs[name]
    for field in INT_FIELDS:
        assert getattr(got, field) == getattr(want, field), (name, field)
    np.testing.assert_array_equal(got.per_partition_sink_count, want.per_partition_sink_count)
    np.testing.assert_allclose(got.sink_mean_latency_s, want.sink_mean_latency_s, rtol=1e-4)
    assert (got.window_s, got.horizon_s) == (want.window_s, want.horizon_s)
    assert got.simulated_events > 0 and got.remote_sent > 0
    assert got.wall_seconds > 0 and got.events_per_second > 0


def test_runs_exercise_what_they_name(jax_runs):
    """The overflow drops at the outbox, the small budget truncates
    windows, the chaos ring drops in its brownout, and the default runs
    do neither."""
    assert jax_runs["overflow-truncated"].remote_dropped > 0
    assert jax_runs["overflow-truncated"].truncated_windows > 0
    assert sum(jax_runs["chaos-ring"].server_outage_dropped) > 0
    for name in ("ring", "two-sink-ring"):
        run = jax_runs[name]
        assert run.remote_dropped == run.truncated_windows == run.transit_dropped == 0, name


def test_flow_conservation(torch_runs):
    """Every completion of the ring either sank or hopped (the JAX
    package's test_flow_conservation, on the port)."""
    result = torch_runs["ring"]
    assert result.sink_count[0] + result.remote_sent == result.server_completed[0]
    assert result.transit_dropped == 0 and result.truncated_windows == 0


def test_several_partitions_of_one_device_equal_the_mesh_of_devices():
    """run_partitioned's default mesh on ``device="cpu"`` is one partition;
    a mesh of the CPU repeated runs its partitions as one partition-major
    state, the same bits as JAX's partitions on separate devices (the
    tests above), and a mesh of one partition rings to itself."""
    one = tpart.run_partitioned(PARTITIONED_MODELS["ring"](tmodel, 2.0), window_s=HOP_S,
                                n_replicas=4, seed=2, device="cpu")
    mesh = tpart.run_partitioned(PARTITIONED_MODELS["ring"](tmodel, 2.0), window_s=HOP_S,
                                 mesh=tpart.partition_mesh(["cpu"]), n_replicas=4, seed=2)
    assert one.n_partitions == 1 and one.remote_sent > 0
    for field in INT_FIELDS:
        assert getattr(one, field) == getattr(mesh, field), field
