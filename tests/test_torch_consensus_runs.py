"""Whole runs of the consensus models of test_torch_consensus.py: the
port's ``run_ensemble`` against the JAX engine's (whose kernel declines
the consensus tier and whose lax scan runs it), the contracts of
tests/integration/test_tpu_consensus.py on the port's own runs, and
snapshots that resume across the packages.

Integer totals must be equal (partition drops, quorum rejections,
elections included); float means within rel 1e-4, the quorum's dark and
the leaderless fractions within rel 1e-6 (they are sweeps over windows
that agree to the ``log`` class).
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
from test_torch_consensus_models import CONSENSUS_MODELS, CUT_HIGH, CUT_MID  # noqa: E402

# (replicas, max_events): the integration tests' own for the pinned
# scenarios, the default budget otherwise.
RUNS = {
    "quorum-undefended": (32, 1024),
    "quorum-defended": (32, 1024),
    "election-bully": (8, 256),
    "election-phi": (8, 256),
    "stochastic": (32, None),
    "delay": (32, None),
}
INT_FIELDS = (
    "simulated_events", "sink_count", "server_completed", "server_dropped",
    "transit_dropped", "truncated_replicas", "blocks_total", "block_occupancy",
    "server_fault_dropped", "server_fault_retried", "server_breaker_dropped",
    "breaker_tripped", "server_budget_dropped",
    "network_partitioned", "server_quorum_dropped", "leader_changes",
)
FLOAT_FIELDS = (
    "sink_mean_latency_s", "server_mean_wait_s", "server_utilization", "server_mean_queue_len",
)
_CACHE: dict = {}


def runs(name):
    """(JAX's result, the port's result) of ``name``, seed 11, made once."""
    if name not in _CACHE:
        build = CONSENSUS_MODELS[name]
        n, max_events = RUNS[name]
        if max_events is None:
            max_events = tengine._default_max_events(build(tmodel), None)
            assert max_events == jengine._default_max_events(build(jmodel), None)
        mesh = replica_mesh(jax.devices("cpu")[:1])
        expected = j_run(build(jmodel), n_replicas=n, seed=11, mesh=mesh, max_events=max_events)
        got = t_run(build(tmodel), n_replicas=n, seed=11, max_events=max_events, device="cpu")
        _CACHE[name] = (expected, got)
    return _CACHE[name]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_whole_run_matches_jax_lax_path(name):
    expected, got = runs(name)
    assert expected.engine_path == "scan" and expected.kernel_shape == ""
    assert got.consensus_features == expected.consensus_features
    for field in INT_FIELDS:
        assert getattr(got, field) == getattr(expected, field), field
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, field), getattr(expected, field), rtol=1e-4, err_msg=field)
    for field in ("quorum_dark_fraction", "time_without_leader_fraction"):
        np.testing.assert_allclose(getattr(got, field), getattr(expected, field), rtol=1e-6, err_msg=field)
    assert got.engine_report()["consensus"].keys() == expected.engine_report()["consensus"].keys()
    if expected.timeseries is not None:
        js, ts = expected.timeseries, got.timeseries
        for field in js._ARRAY_FIELDS:
            left, right = getattr(ts, field), getattr(js, field)
            assert (left is None) == (right is None), field
            if right is None:
                continue
            if np.issubdtype(np.asarray(right).dtype, np.integer):
                np.testing.assert_array_equal(left, right, err_msg=field)
            elif field in ("quorum_dark_fraction", "leader_uptime_fraction"):
                np.testing.assert_allclose(left, right, rtol=1e-6, atol=1e-7, err_msg=field)


def test_quorum_contracts_hold():
    """Scenario A's contracts on the port's runs: the quorum is dark for
    exactly the cut (2 of 12 s), arrivals collapse in the window, only
    the reachable member books quorum rejections, and the defended arm
    recovers at least 90% of its goodput after the heal, with trips and
    budget drops, and fewer quorum rejections than the undefended arm."""
    _, undefended = runs("quorum-undefended")
    _, defended = runs("quorum-defended")
    for result in (undefended, defended):
        assert result.quorum_dark_fraction == pytest.approx(2.0 / 12.0, abs=1e-6)
        win = result.timeseries.sink_count[:, 0].astype(float)
        assert win[4:6].mean() < 0.3 * win[1:4].mean()
    assert undefended.network_partitioned > 0 and sum(undefended.server_quorum_dropped) > 0
    assert undefended.server_quorum_dropped[1] == undefended.server_quorum_dropped[2] == 0
    win = defended.timeseries.sink_count[:, 0].astype(float)
    assert win[8:].mean() >= 0.9 * win[1:4].mean()
    assert sum(defended.breaker_tripped) > 0 and sum(defended.server_budget_dropped) > 0
    assert sum(defended.server_quorum_dropped) < sum(undefended.server_quorum_dropped)
    report = undefended.engine_report()["consensus"]
    assert report["network_partitions"] and report["quorum"] and not report["leader_election"]
    assert report["quorum_dropped_total"] == sum(undefended.server_quorum_dropped)


def test_election_contracts_hold():
    """Scenario B's contracts: one election per flap plus the first in
    every replica under both strategies; each costs exactly one detection
    delay of leaderless time; phi re-elects faster; the windowed uptime
    integrates to the whole-run fraction."""
    for name, strategy in (("election-bully", "bully"), ("election-phi", "phi_accrual")):
        _, result = runs(name)
        n = RUNS[name][0]
        assert result.leader_changes == n * (1 + len(CUT_HIGH) + len(CUT_MID))
        delay = tmodel.LeaderElectionSpec(
            group=(0, 1, 2), heartbeat_s=0.4, timeout_s=1.5, strategy=strategy
        ).detection_delay_s()
        assert result.time_without_leader_fraction == pytest.approx(6 * delay / 12.0, rel=1e-4)
        ts = result.timeseries
        leaderless = float(((1.0 - ts.leader_uptime_fraction) * ts.window_len_s).sum())
        assert leaderless / 12.0 == pytest.approx(result.time_without_leader_fraction, rel=1e-5)
    assert runs("election-phi")[1].time_without_leader_fraction < runs("election-bully")[1].time_without_leader_fraction


def test_delay_and_stochastic_runs_exercise_their_paths():
    """The delay model parks deliveries (its drop-mode cut still drops),
    and the stochastic model's cuts drop deliveries, reject arrivals at
    the quorum and cost leaderless time."""
    _, delay = runs("delay")
    _, stoch = runs("stochastic")
    assert delay.network_partitioned > 0 and delay.server_quorum_dropped == [0, 0, 0]
    assert stoch.network_partitioned > 0 and sum(stoch.server_quorum_dropped) > 0
    assert 0.0 < stoch.quorum_dark_fraction < 1.0 and 0.0 < stoch.time_without_leader_fraction < 1.0
    assert stoch.leader_changes >= RUNS["stochastic"][0]


def test_snapshot_resumes_across_the_packages(tmp_path):
    """The bully election storm: a JAX snapshot resumes in the port and a
    port snapshot in JAX, both landing on JAX's uninterrupted run."""
    build = CONSENSUS_MODELS["election-bully"]
    kwargs = dict(n_replicas=8, seed=5, max_events=256)
    mesh = replica_mesh(jax.devices("cpu")[:1])
    j_snaps = []
    expected = j_run(build(jmodel), mesh=mesh, **kwargs, checkpoint_every_s=0.0,
                     checkpoint_callback=j_snaps.append)
    for leaf in ("prt_start", "prt_end", "net_partitioned", "ldr_changes", "ldr_noleader_time",
                 "tel_ldr_uptime_int"):
        assert leaf in j_snaps[0].state, leaf
    j_snaps[len(j_snaps) // 2].save(str(tmp_path / "jax.npz"))
    got = t_run(build(tmodel), device="cpu", **kwargs,
                resume_from=EnsembleCheckpoint.load(str(tmp_path / "jax.npz")))
    t_snaps = []
    t_run(build(tmodel), device="cpu", **kwargs, checkpoint_every_s=0.0,
          checkpoint_callback=t_snaps.append)
    t_snaps[len(t_snaps) // 2].save(str(tmp_path / "port.npz"))
    back = j_run(build(jmodel), mesh=mesh, **kwargs,
                 resume_from=jengine.EnsembleCheckpoint.load(str(tmp_path / "port.npz")))
    for result in (got, back):
        for field in ("simulated_events", "sink_count", "network_partitioned", "leader_changes"):
            assert getattr(result, field) == getattr(expected, field), field
        assert result.time_without_leader_fraction == pytest.approx(
            expected.time_without_leader_fraction, abs=1e-7
        )
        np.testing.assert_array_equal(result.timeseries.sink_count, expected.timeseries.sink_count)
