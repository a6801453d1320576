"""The chain closed form (happysim_tpu_torch/chain.py) against the JAX
package's (happysim_tpu/tpu/chain.py).

- The planner: the port's ``fast_plan`` returns JAX's plan, or None where
  JAX's does, on every model tests/integration/test_tpu_chain.py builds
  and on the port's own test models.
- ``run_ensemble``'s default call in both packages at 256 replicas and the
  JAX tests' horizons: ``engine_path == "chain"`` on both sides, every
  integer total equal, float statistics within rel 1e-4 (the float sums
  over replicas and customers add in another order than XLA's, and XLA's
  CPU ``log`` differs from torch's by an ulp on some inputs, ROADMAP C).
  The latency histogram holds the same counts, but a latency that lies
  within those ulps of a bin edge (10^(k/10) s) may sit in the next bin:
  at most two such moves per run, each to an adjacent bin. With JAX's own
  float32 ``log`` in the port's draws the histograms are equal bin for bin
  (the lognormal family also goes through XLA's ``exp`` and ``log1p``).
- The declines: an explicit ``max_events``, ``HS_TPU_CHAIN=0``, the
  finite-capacity certificate, the memory budget and the
  least-outstanding router all leave the call on the event scan.
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu import chain as jchain  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu.engine import run_ensemble as j_run  # noqa: E402
from happysim_tpu_torch import chain as tchain  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import rng  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.engine import run_ensemble as t_run  # noqa: E402
from test_torch_chaos_models import CHAOS_MODELS  # noqa: E402
from test_torch_event_step import GRAPH_MODELS, SLICE_MODELS  # noqa: E402
from test_torch_resilience_models import RESILIENCE_MODELS  # noqa: E402
from test_torch_telemetry_models import TELEMETRY_MODELS  # noqa: E402

FLOAT_RTOL = 1e-4


# The models of tests/integration/test_tpu_chain.py, written for either
# package's model module.
def chain(mod, n_stages=1, cap=256, service="exponential", means=None, rate=8.0,
          horizon=40.0, warmup=10.0, stop_after=None):
    model = mod.EnsembleModel(horizon_s=horizon, warmup_s=warmup)
    source = model.source(rate=rate, kind="poisson", stop_after_s=stop_after)
    previous = source
    for i in range(n_stages):
        mean = (means or [0.08] * n_stages)[i]
        server = model.server(
            service_mean=mean, service=service, queue_capacity=cap, service_scv=2.0
        )
        model.connect(previous, server)
        previous = server
    model.connect(previous, model.sink())
    return model


def fanout(mod, policy="random", n_servers=3, cap=256, sink_branch=False,
           rate=9.0, mean=0.25, horizon=40.0, warmup=10.0):
    model = mod.EnsembleModel(horizon_s=horizon, warmup_s=warmup)
    source = model.source(rate=rate)
    sink = model.sink()
    router = model.router(policy=policy)
    model.connect(source, router)
    for _ in range(n_servers):
        server = model.server(service_mean=mean, queue_capacity=cap)
        model.connect(router, server)
        model.connect(server, sink)
    if sink_branch:
        model.connect(router, sink)
    return model


def _single(mod, connect_latency=0.0, latency_kind="constant", source_kw=None, **server_kw):
    model = mod.EnsembleModel(horizon_s=10.0)
    source = model.source(rate=5.0, **(source_kw or {}))
    server = model.server(service_mean=0.05, **server_kw)
    model.connect(source, server)
    model.connect(server, model.sink(), latency_s=connect_latency, latency_kind=latency_kind)
    return model


def _router_pair(mod):
    model = mod.EnsembleModel(horizon_s=10.0)
    source = model.source(rate=5.0)
    a = model.server(service_mean=0.05)
    b = model.server(service_mean=0.05)
    sink = model.sink()
    router = model.router(policy="random", targets=[])
    model.connect(source, router)
    model.connect(router, a)
    model.connect(router, b)
    model.connect(a, sink)
    model.connect(b, sink)
    return model


def _lossy(mod):
    model = mod.EnsembleModel(horizon_s=10.0)
    source = model.source(rate=5.0)
    server = model.server(service_mean=0.05)
    model.connect(source, server, loss_p=0.1)
    model.connect(server, model.sink())
    return model


def _correlated(mod):
    model = mod.EnsembleModel(horizon_s=10.0)
    model.correlated_outages(rate=0.1, mean_duration_s=1.0)
    source = model.source(rate=5.0)
    server = model.server(service_mean=0.05, fault=mod.FaultSpec(correlated=True))
    model.connect(source, server)
    model.connect(server, model.sink())
    return model


def _profiled(mod):
    model = mod.EnsembleModel(horizon_s=10.0)
    source = model.ramp_source(start_rate=5.0, end_rate=10.0, ramp_duration_s=5.0)
    server = model.server(service_mean=0.05)
    model.connect(source, server)
    model.connect(server, model.sink())
    return model


def _least_outstanding(mod):
    model = fanout(mod, n_servers=2)
    model.routers[0].policy = "least_outstanding"
    return model


def _edge_fanout(mod):
    """A round-robin fan-out behind constant 5 ms edges and a constant
    exit edge (entry latencies on every branch)."""
    model = mod.EnsembleModel(horizon_s=40.0, warmup_s=10.0, transit_capacity=16)
    source = model.source(rate=12.0)
    sink = model.sink()
    router = model.router(policy="round_robin")
    model.connect(source, router)
    for _ in range(3):
        server = model.server(service_mean=0.2, queue_capacity=256)
        model.connect(router, server, latency_s=0.005)
        model.connect(server, sink, latency_s=0.002)
    return model


PLAN_MODELS = {
    "mm1": lambda mod: mod.mm1_model(),
    "tandem": lambda mod: chain(mod, n_stages=3),
    "router-pair": _router_pair,
    "concurrency-2": lambda mod: _single(mod, concurrency=2),
    "deadline": lambda mod: _single(mod, deadline_s=1.0),
    "outage": lambda mod: _single(mod, outage=(1.0, 2.0)),
    "exponential-sink-edge": lambda mod: _single(mod, 0.01, "exponential"),
    "constant-sink-edge": lambda mod: _single(mod, 0.01),
    "fault-windows": lambda mod: _single(mod, fault=mod.FaultSpec(windows=((1.0, 2.0),))),
    "fault-stochastic": lambda mod: _single(mod, fault=mod.FaultSpec(rate=0.1, mean_duration_s=1.0)),
    "fault-backoff": lambda mod: _single(
        mod, fault=mod.FaultSpec(rate=0.1, mean_duration_s=1.0), retry_backoff_s=0.1, max_retries=2
    ),
    "deadline-backoff": lambda mod: _single(mod, deadline_s=1.0, retry_backoff_s=0.1, max_retries=1),
    "hedge": lambda mod: _single(mod, hedge_delay_s=0.2),
    "lossy": _lossy,
    "correlated": _correlated,
    "profiled": _profiled,
    "constant-arrivals": lambda mod: _single(mod, source_kw={"kind": "constant"}),
    "fanout-sink-branch": lambda mod: fanout(mod, n_servers=3, sink_branch=True),
    "fanout-round-robin": lambda mod: fanout(mod, "round_robin"),
    "least-outstanding": _least_outstanding,
    "edge-fanout": _edge_fanout,
    "capacity-2": lambda mod: chain(mod, cap=2, rate=9.5, means=[0.1], horizon=30.0, warmup=5.0),
    **{f"chaos-{k}": v for k, v in CHAOS_MODELS.items()},
    **{f"telemetry-{k}": v for k, v in TELEMETRY_MODELS.items()},
    **{f"resilience-{k}": v for k, v in RESILIENCE_MODELS.items()},
    **{f"graph-{k}": v for k, v in GRAPH_MODELS.items()},
    **{f"slice-{k}": v for k, v in SLICE_MODELS.items()},
}


@pytest.mark.parametrize("name", sorted(PLAN_MODELS))
def test_fast_plan_matches_jax(name):
    build = PLAN_MODELS[name]
    want = jchain.fast_plan(build(jmodel))
    got = tchain.fast_plan(build(tmodel))
    assert got == want
    assert tchain.chain_plan(build(tmodel)) == jchain.chain_plan(build(jmodel))


def test_the_plans_cover_both_answers():
    """The planner cases hold chains, fan-outs and declines."""
    plans = [tchain.fast_plan(build(tmodel)) for build in PLAN_MODELS.values()]
    assert sum(p is None for p in plans) > 20
    assert any(p and p["policy"] is None for p in plans)
    assert any(p and p["policy"] == "random" for p in plans)
    assert any(p and p["policy"] == "round_robin" for p in plans)


def _without_chain_env():
    return os.environ.pop("HS_TPU_CHAIN", None)


def _restore_chain_env(prior):
    if prior is None:
        os.environ.pop("HS_TPU_CHAIN", None)
    else:
        os.environ["HS_TPU_CHAIN"] = prior


_INT_FIELDS = (
    "simulated_events", "sink_count", "server_completed", "server_dropped",
    "truncated_replicas", "transit_dropped",
)
_FLOAT_FIELDS = (
    "sink_mean_latency_s", "server_mean_wait_s", "server_utilization", "server_mean_queue_len",
)

# (builder, n_replicas, seed, sweeps): the agreement runs of
# test_tpu_chain.py at 256 replicas.
RUNS = {
    "mm1": (lambda mod: mod.mm1_model(lam=8.0, mu=10.0, horizon_s=60.0, warmup_s=15.0), 3, None),
    "pipeline": (lambda mod: mod.pipeline_model(8.0, (0.05, 0.08, 0.06), 40.0), 0, None),
    "stop-after": (lambda mod: chain(mod, stop_after=5.0, horizon=40.0, warmup=0.0), 7, None),
    "sweeps": (lambda mod: chain(mod), 2,
               {"source_rate": np.linspace(2.0, 9.0, 256).astype(np.float32)}),
    "fanout-sink-branch": (lambda mod: fanout(mod, n_servers=2, sink_branch=True), 4, None),
    "fanout-round-robin": (lambda mod: fanout(mod, "round_robin"), 6, None),
    "edge-fanout": (_edge_fanout, 1, None),
    "erlang": (lambda mod: chain(mod, service="erlang", means=[0.06]), 11, None),
    "hyperexp": (lambda mod: chain(mod, service="hyperexp", means=[0.06]), 11, None),
    "lognormal": (lambda mod: chain(mod, service="lognormal", means=[0.06]), 11, None),
    "pareto": (lambda mod: chain(mod, service="pareto", means=[0.06]), 11, None),
}

# Latencies a bin edge apart between the packages, per run (see above).
MAX_BIN_MOVES = 2


def _bin_moves(got, want) -> int:
    """How many latencies moved across one bin edge between two
    histograms of equal totals (the cumulative difference at each edge)."""
    got, want = np.asarray(got, np.int64).ravel(), np.asarray(want, np.int64).ravel()
    assert got.sum() == want.sum()
    return int(np.abs(np.cumsum(got - want)).sum())


@pytest.mark.parametrize("name", sorted(RUNS))
def test_default_call_takes_the_chain_form_as_jax_does(name):
    build, seed, sweeps = RUNS[name]
    prior = _without_chain_env()
    try:
        want = j_run(build(jmodel), n_replicas=256, seed=seed, sweeps=sweeps)
        got = t_run(build(tmodel), n_replicas=256, seed=seed, sweeps=sweeps, device="cpu")
    finally:
        _restore_chain_env(prior)
    assert want.engine_path == got.engine_path == "chain"
    assert got.kernel_shape == "" and got.max_blocks == 0 and got.blocks_total == 0
    for field in _INT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert _bin_moves(got.sink_hist, want.sink_hist) <= MAX_BIN_MOVES
    for field in _FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, field), getattr(want, field), rtol=FLOAT_RTOL, err_msg=field
        )
    assert got.sink_count[0] > 0


@pytest.mark.parametrize("name", ["erlang", "hyperexp", "edge-fanout", "sweeps"])
def test_histograms_are_equal_with_jax_log(monkeypatch, name):
    """The runs whose histograms differ by bin-edge moves, with XLA's CPU
    float32 log in the port's draws: every bin equal."""
    jax_log = jax.jit(jnp.log)
    monkeypatch.setattr(torch, "log", lambda x: torch.from_numpy(np.array(jax_log(x.numpy()))))
    build, seed, sweeps = RUNS[name]
    prior = _without_chain_env()
    try:
        got = t_run(build(tmodel), n_replicas=256, seed=seed, sweeps=sweeps, device="cpu")
        monkeypatch.undo()
        want = j_run(build(jmodel), n_replicas=256, seed=seed, sweeps=sweeps)
    finally:
        _restore_chain_env(prior)
    assert want.engine_path == got.engine_path == "chain"
    np.testing.assert_array_equal(got.sink_hist, np.asarray(want.sink_hist))
    for field in _INT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize(
    "name, build, kwargs",
    [
        ("max-events", lambda mod: mod.mm1_model(8.0, 10.0, 10.0), {"max_events": 256}),
        ("capacity-certificate",
         lambda mod: chain(mod, cap=2, rate=9.5, means=[0.1], horizon=10.0, warmup=2.0), {}),
        ("least-outstanding", lambda mod: fanout(mod, n_servers=2, horizon=10.0, warmup=2.0), {}),
    ],
    ids=lambda x: x if isinstance(x, str) else "",
)
def test_declines_run_the_scan_as_jax_does(name, build, kwargs):
    prior = _without_chain_env()
    try:
        jm, tm = build(jmodel), build(tmodel)
        if name == "least-outstanding":
            jm.routers[0].policy = tm.routers[0].policy = "least_outstanding"
        want = j_run(jm, n_replicas=64, seed=1, **kwargs)
        got = t_run(tm, n_replicas=64, seed=1, device="cpu", **kwargs)
    finally:
        _restore_chain_env(prior)
    assert want.engine_path in ("scan", "scan+pallas")
    assert got.engine_path == "scan"
    for field in _INT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    if name == "capacity-certificate":
        assert got.server_dropped[0] > 0  # the scan's drop accounting ran


def test_hs_tpu_chain_zero_runs_the_scan():
    prior = os.environ.get("HS_TPU_CHAIN")
    os.environ["HS_TPU_CHAIN"] = "0"
    try:
        got = t_run(tmodel.mm1_model(8.0, 10.0, 5.0), n_replicas=32, seed=1, device="cpu")
    finally:
        _restore_chain_env(prior)
    assert got.engine_path == "scan" and got.max_blocks > 0


def test_run_chain_declines_past_the_memory_budget():
    """A very-high-rate model would pass the block memory budget even at
    one replica: run_chain declines before drawing anything."""
    model = chain(tmodel, rate=2e6, horizon=100.0, warmup=0.0)
    keys = rng.split(rng.PRNGKey(0), 8)
    out = tchain.run_chain(
        model, TCompiled(model), [0], keys,
        torch.full((8, 1), 2e6), torch.full((8, 1), 0.08),
    )
    assert out is None


def test_run_chain_declines_on_the_certificate():
    model = chain(tmodel, cap=2, rate=9.5, means=[0.1], horizon=10.0, warmup=2.0)
    keys = rng.split(rng.PRNGKey(1), 16)
    out = tchain.run_chain(
        model, TCompiled(model), tchain.fast_plan(model), keys,
        torch.full((16, 1), 9.5), torch.full((16, 1), 0.1),
    )
    assert out is None
