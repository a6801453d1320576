"""Whole-run parity of the port's ``run_ensemble`` with the JAX engine's
event scan, and the port's entry-point contract.

The JAX runs use an explicit ``max_events`` (which keeps the JAX engine
on its event scan instead of the chain closed form) and a one-device
mesh. Tolerances: integer totals must be exactly equal; float means allow
rel 1e-4 (XLA's CPU ``log`` and its fused multiply-adds differ from torch
by an ulp on some events; the measured gap on these runs is ~2e-7).
"""

import re

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import run_ensemble as j_run  # noqa: E402
from happysim_tpu.tpu.mesh import replica_mesh  # noqa: E402
from happysim_tpu.tpu.model import mm1_model as j_mm1  # noqa: E402
from happysim_tpu.tpu.model import pipeline_model as j_pipeline  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import run_ensemble as t_run  # noqa: E402
from happysim_tpu_torch.kernels import support  # noqa: E402

N_REPLICAS = 256
INT_FIELDS = (
    "simulated_events",
    "sink_count",
    "server_completed",
    "server_dropped",
    "truncated_replicas",
    "blocks_total",
    "block_occupancy",
    "max_blocks",
)
FLOAT_FIELDS = (
    "sink_mean_latency_s",
    "server_mean_wait_s",
    "server_utilization",
    "server_mean_queue_len",
    "sink_p50_s",
    "sink_p99_s",
)

CASES = {
    "mm1": (
        lambda: j_mm1(8.0, 10.0, 20.0, warmup_s=5.0),
        lambda: tmodel.mm1_model(8.0, 10.0, 20.0, warmup_s=5.0),
        2000,
        None,
    ),
    "pipeline": (
        lambda: j_pipeline(8.0, (0.05, 0.08, 0.06), 20.0),
        lambda: tmodel.pipeline_model(8.0, (0.05, 0.08, 0.06), 20.0),
        3000,
        None,
    ),
    "mm1-service-sweep": (
        lambda: j_mm1(8.0, 10.0, 20.0, warmup_s=5.0),
        lambda: tmodel.mm1_model(8.0, 10.0, 20.0, warmup_s=5.0),
        2000,
        {"service_mean": np.linspace(0.05, 0.11, N_REPLICAS).astype(np.float32)},
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_whole_run_matches_jax_event_scan(case):
    build_j, build_t, max_events, sweeps = CASES[case]
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(
        build_j(), n_replicas=N_REPLICAS, seed=3, mesh=mesh, max_events=max_events,
        sweeps=sweeps,
    )
    got = t_run(
        build_t(), n_replicas=N_REPLICAS, seed=3, max_events=max_events,
        sweeps=sweeps, device="cpu",
    )
    assert expected.engine_path == "scan" and got.engine_path == "scan"
    for name in INT_FIELDS:
        assert getattr(got, name) == getattr(expected, name), name
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, name), getattr(expected, name), rtol=1e-4, err_msg=name
        )
    assert got.simulated_events > 50 * N_REPLICAS
    assert got.macro_block == expected.macro_block == 32


def test_default_event_budget_matches_jax():
    sweep = {"source_rate": np.linspace(4.0, 9.0, 16)}
    for jm, tm, sweeps in (
        (j_mm1(8.0, 10.0, 160.0, warmup_s=40.0), tmodel.mm1_model(8.0, 10.0, 160.0, warmup_s=40.0), None),
        (j_pipeline(8.0, (0.05, 0.08, 0.06), 160.0), tmodel.pipeline_model(8.0, (0.05, 0.08, 0.06), 160.0), None),
        (j_mm1(8.0, 10.0, 20.0), tmodel.mm1_model(8.0, 10.0, 20.0), sweep),
    ):
        assert tengine._default_max_events(tm, sweeps) == jengine._default_max_events(jm, sweeps)


def test_hist_percentile_matches_jax():
    hist = np.random.default_rng(0).integers(0, 50, size=jengine.HIST_BINS)
    for q in (0.0, 0.01, 0.5, 0.99, 1.0):
        assert tengine.hist_percentile(hist, q) == jengine.hist_percentile(hist, q)
    assert tengine.hist_percentile(np.zeros(80), 0.5) == 0.0


def test_run_ensemble_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_run(tmodel.mm1_model(8.0, 10.0, 5.0), n_replicas=4)


def test_run_ensemble_rejects_unknown_sweeps_and_huge_ensembles():
    with pytest.raises(ValueError, match="unknown sweep"):
        t_run(tmodel.mm1_model(), n_replicas=4, sweeps={"rate": [1.0]}, device="cpu")
    with pytest.raises(ValueError, match="exact-reduction bound"):
        t_run(tmodel.mm1_model(), n_replicas=(1 << 23) + 1, device="cpu")


def _router(m):
    m.router()


def _limiter(m):
    m.limiter(refill_rate=5.0, capacity=5.0)


def _two_sources(m):
    m.source(rate=1.0)
    m.validate()


def _two_sinks(m):
    m.sink()
    m.validate()


def _erlang_spec(m):
    m.servers[0].service = "erlang"
    tengine._Compiled(m)


def _off_chain_server(m):
    extra = m.server()
    m.connect(extra, tmodel.NodeRef(tmodel.SINK, 0))
    m.validate()


def _source_to_sink(m):
    m.connect(tmodel.NodeRef(tmodel.SOURCE, 0), tmodel.NodeRef(tmodel.SINK, 0))
    m.validate()


@pytest.mark.parametrize(
    "mutate, feature",
    [
        (_router, "routers"),
        (_limiter, "limiters"),
        (lambda m: m.telemetry(window_s=1.0), "telemetry"),
        (lambda m: m.circuit_breaker(), "circuit breakers"),
        (lambda m: m.load_shed(), "load shedding"),
        (lambda m: m.retry_budget(), "retry budgets"),
        (lambda m: m.network_partition(), "network partitions"),
        (lambda m: m.quorum(), "quorum"),
        (lambda m: m.leader_election(), "leader election"),
        (lambda m: m.trace_arrivals(None), "trace-driven arrivals"),
        (lambda m: m.correlated_outages(rate=1.0, mean_duration_s=1.0), "correlated outages"),
        (lambda m: m.ramp_source(1.0, 2.0, 3.0), "rate profiles"),
        (lambda m: m.source(rate=1.0, profile=object()), "rate profiles"),
        (lambda m: m.server(deadline_s=1.0), "deadlines"),
        (lambda m: m.server(max_retries=1), "retries"),
        (lambda m: m.server(hedge_delay_s=0.1), "hedged requests"),
        (lambda m: m.server(outage=(1.0, 2.0)), "brownout"),
        (lambda m: m.server(fault=object()), "fault schedules"),
        (lambda m: m.server(service="erlang"), "erlang"),
        (lambda m: m.server(service="lognormal"), "lognormal"),
        (_erlang_spec, "erlang"),
        (lambda m: m.connect(tmodel.NodeRef(tmodel.SOURCE, 0), tmodel.NodeRef(tmodel.SERVER, 0), latency_s=0.01), "latency edges"),
        (lambda m: m.connect(tmodel.NodeRef(tmodel.SOURCE, 0), tmodel.NodeRef(tmodel.SERVER, 0), loss_p=0.1), "packet-loss"),
        (_two_sources, "several sources"),
        (_two_sinks, "several sinks"),
        (_off_chain_server, "server[1]"),
        (_source_to_sink, "straight to a sink"),
    ],
)
def test_out_of_slice_features_raise_naming_themselves(mutate, feature):
    model = tmodel.mm1_model(8.0, 10.0, 5.0)
    with pytest.raises(NotImplementedError, match=re.escape(feature)) as info:
        mutate(model)
    assert "ROADMAP A." in str(info.value)


def test_kernel_plan_shapes_and_bounds():
    assert support.kernel_plan(tmodel.mm1_model()) == {"shape": "mm1", "servers": [0]}
    pipe = tmodel.pipeline_model(8.0, (0.05, 0.08, 0.06))
    assert support.kernel_plan(pipe) == {"shape": "chain", "servers": [0, 1, 2]}
    wide = tmodel.pipeline_model(8.0, [0.01] * (support.KERNEL_MAX_SERVERS + 1))
    with pytest.raises(ValueError, match="servers=9 exceeds"):
        support.check_kernel_bounds(tengine._Compiled(wide), 32)
    with pytest.raises(ValueError, match="macro_block"):
        support.check_kernel_bounds(tengine._Compiled(pipe), support.KERNEL_MAX_MACRO + 1)


def test_chain_order_follows_the_wiring_not_the_declaration():
    """A chain declared out of order: the port wires by downstream refs,
    exactly as the JAX engine does, and matches it whole-run."""
    def build(mod):
        m = mod.EnsembleModel(horizon_s=10.0)
        src = m.source(rate=6.0)
        back = m.server(service_mean=0.05, queue_capacity=16)
        front = m.server(service_mean=0.08, queue_capacity=16, concurrency=2)
        snk = m.sink()
        m.connect(src, front)
        m.connect(front, back)
        m.connect(back, snk)
        return m

    from happysim_tpu.tpu import model as jmodel

    assert support.kernel_plan(build(tmodel))["servers"] == [1, 0]
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(build(jmodel), n_replicas=64, seed=1, mesh=mesh, max_events=400)
    got = t_run(build(tmodel), n_replicas=64, seed=1, max_events=400, device="cpu")
    for name in INT_FIELDS:
        assert getattr(got, name) == getattr(expected, name), name
    np.testing.assert_allclose(got.server_mean_wait_s, expected.server_mean_wait_s, rtol=1e-4)


def test_working_set_bytes_for_mm1():
    compiled = tengine._Compiled(tmodel.mm1_model())
    params = {
        "src_rate": torch.full((2, 1), 8.0),
        "srv_mean": torch.full((2, 1), 0.1),
    }
    state = compiled.init_state(tengine.rng.split(tengine.rng.PRNGKey(0), 2), params)
    # Dense kernel leaves: t, src_next, events, 2 slot floats, 9 per-server
    # columns, sink count/sum/sq = 17 words, read and written; plus 32 x 3
    # uniforms and 2 parameter words.
    assert support.replica_working_set_bytes(compiled, 32, state) == 2 * 17 * 4 + 32 * 3 * 4 + 2 * 4
