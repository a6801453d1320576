"""Whole runs of the models of test_torch_multisource.py (several
sources, several sinks, nodes no source reaches): the port's
``run_ensemble`` against the JAX engine's, whose kernel declines these
models and whose lax scan runs them, at the default event budget passed
explicitly: integer totals exactly, float means within rel 1e-4; and
snapshots that resume across the packages.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import run_ensemble as j_run  # noqa: E402
from happysim_tpu.tpu.mesh import replica_mesh  # noqa: E402
from happysim_tpu_torch import EnsembleCheckpoint  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import run_ensemble as t_run  # noqa: E402
from test_torch_multisource import FLOAT_FIELDS, INT_FIELDS, N_REPLICAS  # noqa: E402
from test_torch_multisource_models import MULTI_MODELS  # noqa: E402

# The chaos ledger and the budget's (zeros, or empty, for a model without
# them).
CHAOS_INT_FIELDS = (
    "server_outage_dropped", "server_timed_out", "server_retried", "server_fault_dropped",
    "server_fault_retried", "server_hedged", "server_hedge_wins", "network_lost",
    "server_budget_dropped",
)


@pytest.mark.parametrize("name", sorted(MULTI_MODELS))
def test_whole_run_matches_jax_lax_path(name):
    """run_ensemble(device="cpu") against JAX's run_ensemble, whose kernel
    declines the model and whose lax scan runs it, at the default event
    budget: integer totals equal per sink and per server (nodes no
    source reaches at zero), the histograms equal, float means within
    rel 1e-4, the chaos ledger equal, and the integer window series
    equal with telemetry."""
    build = MULTI_MODELS[name]
    max_events = tengine._default_max_events(build(tmodel), None)
    assert max_events == jengine._default_max_events(build(jmodel), None)
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(build(jmodel), n_replicas=N_REPLICAS, seed=3, mesh=mesh, max_events=max_events)
    got = t_run(build(tmodel), n_replicas=N_REPLICAS, seed=3, max_events=max_events, device="cpu")
    assert expected.engine_path == "scan" and expected.kernel_shape == ""
    assert got.engine_path == "scan"
    for field in INT_FIELDS + CHAOS_INT_FIELDS:
        assert getattr(got, field) == getattr(expected, field), field
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, field), getattr(expected, field), rtol=1e-4, err_msg=field
        )
    if expected.timeseries is not None:
        js, ts = expected.timeseries, got.timeseries
        for field in js._ARRAY_FIELDS:
            left, right = getattr(ts, field), getattr(js, field)
            assert (left is None) == (right is None), field
            if right is not None and np.issubdtype(np.asarray(right).dtype, np.integer):
                np.testing.assert_array_equal(left, right, err_msg=field)
        # Each sink's windows sum to its whole-run count.
        assert ts.sink_count.sum(axis=0).tolist() == got.sink_count
    assert got.truncated_replicas == 0


def test_two_class_runs_each_tenant_into_its_own_sink():
    """The spare server completes nothing; sink 1 counts what server 4
    completed after the warmup (the batch job's deliveries)."""
    got = t_run(MULTI_MODELS["two-class"](tmodel), n_replicas=16, seed=1, device="cpu")
    assert got.server_completed[3] == 0 and got.server_utilization[3] == 0.0
    assert got.sink_count[1] > 0 and got.sink_count[0] > got.sink_count[1]
    assert got.sink_count[1] <= got.server_completed[2]


# Each chaos model with several sources or sinks, and the chaos branches
# its run must take: {result field: the server it is booked at, or None
# for a model-wide count}.
CHAOS_BRANCHES = {
    "two-class-chaos": {
        "network_lost": None, "server_timed_out": 2, "server_retried": 2,
    },
    "two-class-defended": {
        "network_lost": None, "server_timed_out": 2, "server_retried": 2,
        "server_budget_dropped": 2,
    },
    "superpose-faulted": {
        "server_fault_retried": 0, "server_fault_dropped": 0, "server_hedged": 0,
        "server_hedge_wins": 0,
    },
}


@pytest.mark.parametrize("name", sorted(CHAOS_BRANCHES))
def test_chaos_models_take_each_branch(name):
    """The port's run of each chaos model with several sources or sinks
    books every chaos branch it names (so the parity tests above compare
    counts the branches really made), and nothing at the servers that do
    not retry: two-class's front servers time nothing out."""
    got = t_run(MULTI_MODELS[name](tmodel), n_replicas=16, seed=3, device="cpu")
    assert got.engine_path == "scan"
    for field, server in CHAOS_BRANCHES[name].items():
        value = getattr(got, field)
        assert (value if server is None else value[server]) > 0, field
    if name != "superpose-faulted":
        assert got.server_timed_out[:2] == [0, 0] and got.server_retried[:2] == [0, 0]


@pytest.mark.parametrize("name", ["superpose", "two-class"])
def test_default_call_takes_the_scan_in_both_packages(name):
    """The chain form declines several sources or sinks in both packages
    (_source_ok), so a default call runs the event scan."""
    from happysim_tpu.tpu.chain import fast_plan as j_fast_plan
    from happysim_tpu_torch.chain import fast_plan as t_fast_plan

    build = MULTI_MODELS[name]
    assert j_fast_plan(build(jmodel)) is None and t_fast_plan(build(tmodel)) is None
    got = t_run(build(tmodel), n_replicas=8, seed=0, device="cpu")
    assert got.engine_path == "scan"


def test_snapshot_resumes_across_the_packages(tmp_path):
    """Two sources into two sinks with telemetry: a JAX snapshot resumes in
    the port and a port snapshot in JAX, each landing on JAX's
    uninterrupted run (integer totals and window counts equal, float
    means within rel 1e-4)."""

    def build(mod):
        m = mod.EnsembleModel(horizon_s=4.0)
        for rate in (5.0, 3.0):
            srv = m.server(service_mean=0.1, queue_capacity=64)
            m.connect(m.source(rate=rate), srv)
            m.connect(srv, m.sink())
        m.telemetry(window_s=0.5)
        return m

    kwargs = dict(n_replicas=8, seed=3, max_events=tengine._default_max_events(build(tmodel), None))
    mesh = replica_mesh(jax.devices("cpu")[:1])
    j_snaps = []
    expected = j_run(
        build(jmodel), mesh=mesh, **kwargs, checkpoint_every_s=0.0, checkpoint_callback=j_snaps.append
    )
    j_snaps[len(j_snaps) // 3].save(str(tmp_path / "jax.npz"))
    got = t_run(build(tmodel), device="cpu", **kwargs,
                resume_from=EnsembleCheckpoint.load(str(tmp_path / "jax.npz")))
    t_snaps = []
    t_run(build(tmodel), device="cpu", **kwargs, checkpoint_every_s=0.0,
          checkpoint_callback=t_snaps.append)
    t_snaps[len(t_snaps) // 3].save(str(tmp_path / "port.npz"))
    back = j_run(build(jmodel), mesh=mesh, **kwargs,
                 resume_from=jengine.EnsembleCheckpoint.load(str(tmp_path / "port.npz")))
    for result in (got, back):
        for field in ("simulated_events", "sink_count", "server_completed", "server_dropped"):
            assert getattr(result, field) == getattr(expected, field), field
        np.testing.assert_allclose(result.sink_mean_latency_s, expected.sink_mean_latency_s, rtol=1e-4)
        np.testing.assert_array_equal(result.timeseries.sink_count, expected.timeseries.sink_count)
