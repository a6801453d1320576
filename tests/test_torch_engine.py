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
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import run_ensemble as j_run  # noqa: E402
from happysim_tpu.tpu.kernels import kernel_plan as j_kernel_plan  # noqa: E402
from happysim_tpu.tpu.mesh import replica_mesh  # noqa: E402
from happysim_tpu.tpu.model import mm1_model as j_mm1  # noqa: E402
from happysim_tpu.tpu.model import pipeline_model as j_pipeline  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import run_ensemble as t_run  # noqa: E402
from happysim_tpu_torch.kernels import support  # noqa: E402
from test_torch_chaos_models import CHAOS_MODELS  # noqa: E402
from test_torch_telemetry_models import TELEMETRY_MODELS  # noqa: E402
from test_torch_event_step import (  # noqa: E402
    GRAPH_MODELS,
    SLICE_MODELS,
    fanout,
    mix,
    shared_backend,
)

N_REPLICAS = 256
INT_FIELDS = (
    "simulated_events",
    "sink_count",
    "server_completed",
    "server_dropped",
    "transit_dropped",
    "limiter_admitted",
    "limiter_dropped",
    "truncated_replicas",
    "blocks_total",
    "block_occupancy",
    "max_blocks",
)
# The chaos counters (zeros on a model without the feature).
CHAOS_FIELDS = (
    "server_timed_out", "server_retried", "server_outage_dropped",
    "server_fault_dropped", "server_fault_retried", "server_hedged",
    "server_hedge_wins", "network_lost",
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


@pytest.mark.parametrize("name", sorted(GRAPH_MODELS))
def test_graph_whole_run_matches_jax_event_scan(name):
    """Router, limiter and transit graphs end to end: every integer total
    equal (the routing trace, transit and limiter drops included), float
    means within rel 1e-4. 64 replicas with an explicit budget keep the
    JAX side on its event scan."""
    build = GRAPH_MODELS[name]
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(build(jmodel), n_replicas=64, seed=3, mesh=mesh, max_events=640)
    got = t_run(build(tmodel), n_replicas=64, seed=3, max_events=640, device="cpu")
    for field in INT_FIELDS:
        assert getattr(got, field) == getattr(expected, field), field
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, field), getattr(expected, field), rtol=1e-4, err_msg=field
        )
    assert min(got.server_completed) > 0 and got.sink_count[0] > 0


@pytest.mark.parametrize("name", sorted(SLICE_MODELS))
def test_family_and_profile_whole_run_matches_jax_event_scan(name):
    """One model per service family, the mixed-family chain, the ramp
    graph and sources wired straight to the sink, end to end: every
    integer total equal (the latency histogram included), float means
    within rel 1e-4, at the default event budget (passed explicitly,
    which keeps the JAX side on its event scan)."""
    build = SLICE_MODELS[name]
    max_events = tengine._default_max_events(build(tmodel), None)
    assert max_events == jengine._default_max_events(build(jmodel), None)
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(build(jmodel), n_replicas=64, seed=3, mesh=mesh, max_events=max_events)
    got = t_run(build(tmodel), n_replicas=64, seed=3, max_events=max_events, device="cpu")
    assert expected.engine_path == "scan" and got.engine_path == "scan"
    for field in INT_FIELDS:
        assert getattr(got, field) == getattr(expected, field), field
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, field), getattr(expected, field), rtol=1e-4, err_msg=field
        )
    assert got.truncated_replicas == 0 and got.sink_count[0] > 0


@pytest.mark.parametrize("name", sorted(SLICE_MODELS))
def test_slice_models_plan_like_jax(name):
    """Families and profiles change no plan; a source wired to the sink
    plans as a server-less "chain", as in JAX."""
    expected, reason = j_kernel_plan(SLICE_MODELS[name](jmodel))
    assert reason == ""
    assert support.kernel_plan(SLICE_MODELS[name](tmodel)) == expected


@pytest.mark.parametrize("name", sorted(GRAPH_MODELS))
def test_kernel_plan_matches_jax(name):
    """The port's plan is JAX's kernel_plan dict, its "chaos" key (the
    model's chaos features: "limiters" on the mix) included."""
    expected, reason = j_kernel_plan(GRAPH_MODELS[name](jmodel))
    assert reason == ""
    assert support.kernel_plan(GRAPH_MODELS[name](tmodel)) == expected
    assert expected["shape"] == ("graph" if name in ("mix", "shared-backend") else "router")


@pytest.mark.parametrize("name", sorted(CHAOS_MODELS))
def test_chaos_whole_run_matches_jax_event_scan(name):
    """run_ensemble(device="cpu") against the JAX run_ensemble at the
    default event budget (passed explicitly, which keeps JAX on its event
    scan), 64 replicas: every integer total equal, the chaos counters
    included; float means within rel 1e-4."""
    build = CHAOS_MODELS[name]
    max_events = tengine._default_max_events(build(tmodel), None)
    assert max_events == jengine._default_max_events(build(jmodel), None)
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(build(jmodel), n_replicas=64, seed=3, mesh=mesh, max_events=max_events)
    got = t_run(build(tmodel), n_replicas=64, seed=3, max_events=max_events, device="cpu")
    for field in INT_FIELDS + CHAOS_FIELDS:
        assert getattr(got, field) == getattr(expected, field), field
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, field), getattr(expected, field), rtol=1e-4, err_msg=field
        )
    assert got.truncated_replicas == 0 and got.sink_count[0] > 0


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


@pytest.mark.parametrize("name", sorted(TELEMETRY_MODELS))
def test_telemetry_whole_run_matches_jax_event_scan(name):
    """Every telemetry model end to end at its default event budget
    (passed explicitly, which keeps JAX on its event scan), 64 replicas:
    every whole-run integer total equal, and every integer window series
    identical to JAX's (test_torch_telemetry.py compares the float
    series too)."""
    build = TELEMETRY_MODELS[name]
    max_events = tengine._default_max_events(build(tmodel), None)
    assert max_events == jengine._default_max_events(build(jmodel), None)
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(build(jmodel), n_replicas=64, seed=3, mesh=mesh, max_events=max_events)
    got = t_run(build(tmodel), n_replicas=64, seed=3, max_events=max_events, device="cpu")
    for field in INT_FIELDS + CHAOS_FIELDS:
        assert getattr(got, field) == getattr(expected, field), field
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    js, ts = expected.timeseries, got.timeseries
    for field in js._ARRAY_FIELDS:
        left, right = getattr(ts, field), getattr(js, field)
        assert (left is None) == (right is None), field
        if right is not None and np.issubdtype(np.asarray(right).dtype, np.integer):
            np.testing.assert_array_equal(left, right, err_msg=field)
    assert got.truncated_replicas == 0


@pytest.mark.parametrize("name", ["mm1-all", "chain-queue-util", "chaos-fanout", "bench-chaos"])
def test_telemetry_models_plan_like_jax(name):
    """A spec changes no shape; the plan's "chaos" key names "telemetry",
    as JAX's does."""
    expected, reason = j_kernel_plan(TELEMETRY_MODELS[name](jmodel))
    assert reason == ""
    got = support.kernel_plan(TELEMETRY_MODELS[name](tmodel))
    assert got == expected and "telemetry" in got["chaos"]


def test_kernel_bounds_name_the_window_count(monkeypatch):
    """The window buffers' bound is the spec's MAX_WINDOWS, checked and
    named before a launch."""
    compiled = tengine._Compiled(TELEMETRY_MODELS["mm1-all"](tmodel))
    support.check_kernel_bounds(compiled, 32)
    assert support.KERNEL_MAX_WINDOWS == 4096 and compiled.nW == 8
    monkeypatch.setattr(support, "KERNEL_MAX_WINDOWS", 7)
    with pytest.raises(ValueError, match=re.escape("telemetry windows nW=8")):
        support.check_kernel_bounds(compiled, 32)


def test_reduce_registry_encodes_every_telemetry_key():
    """Each tel_ counter is limb-encoded, each integral a fixed-point sum,
    as in JAX's registry; a key with no encoding raises."""
    compiled = tengine._Compiled(TELEMETRY_MODELS["chaos-fanout"](tmodel))
    for key in compiled.tel_keys:
        assert tengine._is_i64_key(key) == jengine._is_i64_key(key), key
        assert (key in tengine._F64_SUM_KEYS) == (key in jengine._F64_SUM_KEYS), key
    assert not tengine._is_i64_key("tel_spread_p10") and not jengine._is_i64_key("tel_spread_p10")
    params = {"src_rate": torch.full((2, 1), 6.0), "srv_mean": torch.full((2, 4), 0.05)}
    state = compiled.init_state(tengine.rng.split(tengine.rng.PRNGKey(0), 2), params)
    compiled.tel_keys |= {"odd_key"}
    with pytest.raises(ValueError, match="odd_key"):
        tengine.reduce_final(compiled, dict(state, odd_key=state["events"]))


def test_default_event_budget_matches_jax():
    sweep = {"source_rate": np.linspace(4.0, 9.0, 16)}
    for jm, tm, sweeps in (
        (j_mm1(8.0, 10.0, 160.0, warmup_s=40.0), tmodel.mm1_model(8.0, 10.0, 160.0, warmup_s=40.0), None),
        (j_pipeline(8.0, (0.05, 0.08, 0.06), 160.0), tmodel.pipeline_model(8.0, (0.05, 0.08, 0.06), 160.0), None),
        (j_mm1(8.0, 10.0, 20.0), tmodel.mm1_model(8.0, 10.0, 20.0), sweep),
        (fanout(jmodel, "random"), fanout(tmodel, "random"), sweep),
        (shared_backend(jmodel), shared_backend(tmodel), None),
        (mix(jmodel), mix(tmodel), None),
        *((build(jmodel), build(tmodel), None) for build in CHAOS_MODELS.values()),
        *((build(jmodel), build(tmodel), sweep) for build in CHAOS_MODELS.values()),
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


def _partitioned(mod, m):
    """The M/M/1 with its server cut off over [1, 2)."""
    server = mod.NodeRef(mod.SERVER, 0)
    m.network_partition(group=[server], windows=((1.0, 2.0),))
    return server


def _quorum(mod, m):
    m.quorum([_partitioned(mod, m)], write=1, read=1)


def _leader_election(mod, m):
    m.leader_election([_partitioned(mod, m)], heartbeat_s=0.1, timeout_s=0.3)


def _two_sources(mod, m):
    m.connect(m.source(rate=1.0), mod.NodeRef(mod.SERVER, 0))


def _two_sinks(mod, m):
    m.sink()


def _off_chain_server(mod, m):
    m.connect(m.server(), mod.NodeRef(mod.SINK, 0))


def _orphan_router(mod, m):
    m.router(targets=[mod.NodeRef(mod.SERVER, 0)])


def _orphan_limiter(mod, m):
    limiter = m.limiter(refill_rate=1.0, capacity=1.0)
    m.connect(limiter, mod.NodeRef(mod.SERVER, 0))


def _no_sink(mod, m):
    """A server feeding itself back through a router: the sink is never
    reached (replaces the M/M/1's wiring)."""
    server = mod.NodeRef(mod.SERVER, 0)
    router = m.router(targets=[server])
    m.connect(mod.NodeRef(mod.SOURCE, 0), router)
    m.connect(server, router)


def test_remote_builds_a_remote_node_as_jax():
    """remote(), which raised before the partitioned executor was ported,
    builds JAX's REMOTE node and RemoteSpec, and run_ensemble refuses a
    model holding one with JAX's message (it runs on run_partitioned)."""
    models = {}
    for mod in (jmodel, tmodel):
        m = mod.mm1_model(8.0, 10.0, 5.0)
        server = mod.NodeRef(mod.SERVER, 0)
        refs = [m.remote(ingress=server, latency_s=0.05), m.remote(ingress=server, latency_s=0.1)]
        models[mod] = (m, refs)
    (jm, jrefs), (tm, trefs) = models[jmodel], models[tmodel]
    assert [(r.kind, r.index) for r in trefs] == [(r.kind, r.index) for r in jrefs]
    assert tmodel.REMOTE == jmodel.REMOTE == trefs[0].kind
    assert repr(tm.remotes) == repr(jm.remotes)
    with pytest.raises(ValueError, match="use run_partitioned"):
        t_run(tm, n_replicas=2, device="cpu", max_events=64)
    with pytest.raises(ValueError, match="use run_partitioned"):
        j_run(jm, n_replicas=2, max_events=64)


def test_trace_arrivals_is_ported():
    """trace_arrivals, which raised before the port ran traces, builds a
    traced source whose run_ensemble streams the trace: every replica
    fires each instant once, and the plan names JAX's decline."""
    from happysim_tpu_torch.traces import TraceSpec

    model = tmodel.EnsembleModel(horizon_s=2.0, macro_block=8)
    times = np.asarray([0.1, 0.2, 0.4, 0.8, 1.5], np.float32)
    src = model.trace_arrivals(TraceSpec(times=times, tenants=None, chunk_len=8))
    srv = model.server(service_mean=0.01)
    model.connect(src, srv)
    model.connect(srv, model.sink())
    result = tengine.run_ensemble(model, n_replicas=4, device="cpu")
    assert result.trace and result.trace_tenant_arrivals == [4 * times.size]
    assert result.sink_count == [4 * times.size]
    assert result.engine_report()["trace"]["max_resident_chunks"] == 2
    assert support.kernel_plan(model)["declined"].startswith("model has trace-driven arrivals")


def _on_both(mutate):
    """``mutate`` applied to either package's M/M/1 (horizon 5 s)."""

    def build(mod):
        model = mod.mm1_model(8.0, 10.0, 5.0)
        mutate(mod, model)
        return model

    return build


# The models the port refused before it ran several sources and sinks,
# nodes no source reaches and the consensus tier: JAX's kernel declines
# each, and its lax scan runs it.
ONCE_REFUSED = {
    "network-partitions": _partitioned,
    "quorum": _quorum,
    "leader-election": _leader_election,
    "several-sources": _two_sources,
    "several-sinks": _two_sinks,
    "server-1-unreached": _off_chain_server,
    "orphan-router": _orphan_router,
    "orphan-limiter": _orphan_limiter,
    "no-sink": _no_sink,
}


@pytest.mark.parametrize("name", sorted(ONCE_REFUSED))
def test_once_refused_models_run_like_jax(name):
    """Each model the port once refused now runs, as JAX's lax scan runs
    it: every integer total equal (the consensus counters included),
    float means within rel 1e-4, at the default budget, 32 replicas."""
    build = _on_both(ONCE_REFUSED[name])
    max_events = tengine._default_max_events(build(tmodel), None)
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(build(jmodel), n_replicas=32, seed=3, mesh=mesh, max_events=max_events)
    got = t_run(build(tmodel), n_replicas=32, seed=3, max_events=max_events, device="cpu")
    assert j_kernel_plan(build(jmodel))[0] is None
    for field in INT_FIELDS + ("network_partitioned", "server_quorum_dropped", "leader_changes"):
        assert getattr(got, field) == getattr(expected, field), field
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for field in FLOAT_FIELDS + ("quorum_dark_fraction", "time_without_leader_fraction"):
        np.testing.assert_allclose(
            getattr(got, field), getattr(expected, field), rtol=1e-4, err_msg=field
        )


def _front_router(m):
    """source -> random router -> server[0]."""
    router = m.router()
    m.connect(tmodel.NodeRef(tmodel.SOURCE, 0), router)
    m.connect(router, tmodel.NodeRef(tmodel.SERVER, 0))


def _front_limiter(m):
    """source -> limiter -> round-robin router -> server[0]."""
    limiter = m.limiter(refill_rate=5.0, capacity=5.0)
    router = m.router(policy="round_robin")
    m.connect(tmodel.NodeRef(tmodel.SOURCE, 0), limiter)
    m.connect(limiter, router)
    m.connect(router, tmodel.NodeRef(tmodel.SERVER, 0))


def _latency_exit(m):
    """server[0] -> weighted exit router -> [sink behind a 10 ms edge,
    server[0]] (done-or-continue feedback)."""
    router = m.router(policy="weighted", weights=(0.9, 0.1))
    m.connect(tmodel.NodeRef(tmodel.SERVER, 0), router)
    m.connect(router, tmodel.NodeRef(tmodel.SINK, 0), latency_s=0.01)
    m.connect(router, tmodel.NodeRef(tmodel.SERVER, 0))


@pytest.mark.parametrize(
    "mutate, shape, counter",
    [
        (_front_router, "router", None),
        (_front_limiter, "router", "limiter_admitted"),
        (_latency_exit, "graph", "transit_dropped"),
    ],
    ids=["routers", "limiters", "latency-edges"],
)
def test_slice_features_run_and_plan(mutate, shape, counter):
    """Routers, limiters and latency edges now build, run and plan as
    the kernel's router or graph shape."""
    model = tmodel.mm1_model(8.0, 10.0, 5.0)
    mutate(model)
    assert support.kernel_plan(model)["shape"] == shape
    result = t_run(model, n_replicas=8, seed=0, max_events=200, device="cpu")
    assert result.sink_count[0] > 0 and result.truncated_replicas == 0
    if counter is not None:
        assert len(getattr(result, counter)) == 1


def test_kernel_bounds_name_each_graph_bound(monkeypatch):
    """Each graph count past the lean tables is named as the reason the
    model runs the wide code, and bounds no launch; the transit rows
    remain a launch bound, checked and named."""
    compiled = tengine._Compiled(mix(tmodel))
    support.check_kernel_bounds(compiled, 32)
    assert support.wide_reasons(compiled) == []
    assert (compiled.hop_depth, compiled.n_draws, compiled.TR) == (2, 6, 16)
    for name, attr, bound in (
        ("routers", "LEAN_MAX_ROUTERS", 2),
        ("targets per router", "LEAN_MAX_TARGETS", 1),
        ("router hop depth", "LEAN_MAX_HOPS", 1),
        ("limiters", "LEAN_MAX_LIMITERS", 0),
    ):
        with monkeypatch.context() as patch:
            patch.setattr(support, attr, bound)
            support.check_kernel_bounds(compiled, 32)
            assert [r.split("=")[0] for r in support.wide_reasons(compiled)] == [name]
    with monkeypatch.context() as patch:
        patch.setattr(support, "KERNEL_MAX_TRANSIT", 8)
        with pytest.raises(ValueError, match=re.escape("transit_capacity=")):
            support.check_kernel_bounds(compiled, 32)


def test_kernel_plan_declines_like_jax():
    """Orphan servers, orphan routers and limiters, and a graph that never
    reaches the sink: JAX's kernel declines each; the port's plan records
    JAX's reason as data (``"declined"``) and the model compiles, to run
    on the kernel (test_once_refused_models_run_like_jax runs them)."""
    for name in ("server-1-unreached", "orphan-router", "orphan-limiter", "no-sink"):
        build = _on_both(ONCE_REFUSED[name])
        _plan, reason = j_kernel_plan(build(jmodel))
        jax_reason = reason[reason.index("(") + 1 : reason.index("); the lax")]
        plan = tengine._Compiled(build(tmodel)).plan
        assert plan["declined"] == jax_reason, name
        assert "ROADMAP" not in plan["declined"]


def test_kernel_plan_shapes_and_bounds():
    assert support.kernel_plan(tmodel.mm1_model()) == {"shape": "mm1", "servers": [0], "chaos": ()}
    pipe = tmodel.pipeline_model(8.0, (0.05, 0.08, 0.06))
    assert support.kernel_plan(pipe) == {"shape": "chain", "servers": [0, 1, 2], "chaos": ()}
    wide = tengine._Compiled(tmodel.pipeline_model(8.0, [0.01] * (support.LEAN_MAX_SERVERS + 1)))
    support.check_kernel_bounds(wide, 32)
    assert support.wide_reasons(wide) == ["servers=9 > 8"]
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
    # columns, sink count/sum/sq = 17 words, read and written; plus the
    # replica's two key words and 2 parameter words (the kernel draws its
    # uniforms: none are read).
    assert support.replica_working_set_bytes(compiled, state) == 2 * 17 * 4 + 2 * 4 + 2 * 4
