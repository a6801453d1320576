"""The small models whose whole runs test_torch_summary_runs.py and
test_torch_summary_defense_runs.py make in both packages on the CPU, and
the comparison of their summaries: ``summary().to_dict()`` of the port's
``run_ensemble(device="cpu")`` against the JAX engine's ``summary()`` on
the same model, seed and budget. Entity names, kinds and order and each
entity's extras keys are equal; integers exact; floats within rel 1e-4,
the run tolerance (ROADMAP C). Left out: the wall clock and events/s, and
the fields that differ by design (ROADMAP C): ``backend``, and the
``Engine`` entity's ``engine_path``, ``kernel_decline`` and
``escape_hatches``.
"""

import jax
import numpy as np

from happysim_tpu.tpu import engine as jengine
from happysim_tpu.tpu import model as jmodel
from happysim_tpu.tpu import run_ensemble as j_run
from happysim_tpu.tpu.mesh import replica_mesh
from happysim_tpu_torch import engine as tengine
from happysim_tpu_torch import model as tmodel
from happysim_tpu_torch import run_ensemble as t_run
from test_torch_chaos_models import CHAOS_MODELS
from test_torch_consensus_models import CONSENSUS_MODELS
from test_torch_multisource_models import MULTI_MODELS
from test_torch_resilience_models import RESILIENCE_MODELS, STORM_MAX_EVENTS, STORM_REPLICAS

RTOL = 1e-4
TIMING = ("wall_clock_seconds", "events_per_second")
ENGINE_OWN = ("engine_path", "kernel_decline", "escape_hatches")


def _mm1(mod):
    return mod.mm1_model(8.0, 10.0, 20.0, warmup_s=5.0)


def _limiter_graph(mod):
    """source -> token bucket -> round-robin router over two servers ->
    sink; the bucket drops part of the load."""
    m = mod.EnsembleModel(horizon_s=20.0, warmup_s=2.0)
    src = m.source(rate=12.0)
    limiter = m.limiter(refill_rate=8.0, capacity=4.0)
    router = m.router(policy="round_robin")
    servers = [m.server(service_mean=0.15, queue_capacity=16) for _ in range(2)]
    sink = m.sink()
    m.connect(src, limiter)
    m.connect(limiter, router)
    for srv in servers:
        m.connect(router, srv)
        m.connect(srv, sink)
    return m


# (model builder, replicas, seed, max_events: None for the default scan
# budget, "chain" for no budget: the chain form). The defenses' and the
# consensus tier's runs (whose JAX compiles take longest) are
# test_torch_summary_defense_runs.py's, the others test_torch_summary_runs.py's.
RUNS = {
    "mm1": (_mm1, 64, 3, None),
    "mm1-chain": (_mm1, 64, 3, "chain"),
    "bench-chaos": (CHAOS_MODELS["bench-chaos"], 32, 3, None),
    "storm-defended": (RESILIENCE_MODELS["storm-defended"], STORM_REPLICAS, 7, STORM_MAX_EVENTS),
    "storm-undefended": (RESILIENCE_MODELS["storm-undefended"], STORM_REPLICAS, 7, STORM_MAX_EVENTS),
    "quorum-defended": (CONSENSUS_MODELS["quorum-defended"], 32, 11, 1024),
    "election-bully": (CONSENSUS_MODELS["election-bully"], 8, 11, 256),
    "limiter-graph": (_limiter_graph, 32, 5, None),
    "two-class": (MULTI_MODELS["two-class"], 16, 3, None),
}
DEFENSE_RUNS = ("storm-defended", "storm-undefended", "quorum-defended")


def runs(name: str) -> tuple:
    """(JAX's result, the port's result) of run ``name``."""
    build, n, seed, max_events = RUNS[name]
    kwargs = {}
    if max_events is None:
        kwargs["max_events"] = tengine._default_max_events(build(tmodel), None)
        assert kwargs["max_events"] == jengine._default_max_events(build(jmodel), None)
    elif max_events != "chain":
        kwargs["max_events"] = max_events
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(build(jmodel), n_replicas=n, seed=seed, mesh=mesh, **kwargs)
    got = t_run(build(tmodel), n_replicas=n, seed=seed, device="cpu", **kwargs)
    return expected, got


def same(got, expected, where: str) -> None:
    """Booleans and strings equal, integers exact, floats within RTOL."""
    if isinstance(expected, bool) or isinstance(expected, str):
        assert got == expected, where
    elif isinstance(expected, (int, np.integer)):
        assert isinstance(got, (int, np.integer)) and got == expected, where
    else:
        np.testing.assert_allclose(got, expected, rtol=RTOL, atol=0.0, err_msg=where)


def check_summary_run(name: str) -> None:
    """The port's summary of run ``name`` against JAX's."""
    expected_result, got_result = runs(name)
    expected, got = expected_result.summary().to_dict(), got_result.summary().to_dict()
    assert got["backend"] == "cpu"
    assert set(got) == set(expected)
    for key in sorted(set(expected) - {"entities", "backend", *TIMING}):
        same(got[key], expected[key], key)
    assert [(e["name"], e["kind"]) for e in got["entities"]] == [
        (e["name"], e["kind"]) for e in expected["entities"]
    ]
    for ours, theirs in zip(got["entities"], expected["entities"]):
        own = ENGINE_OWN if theirs["kind"] == "Engine" else ()
        ours = {k: v for k, v in ours.items() if k not in own}
        theirs = {k: v for k, v in theirs.items() if k not in own}
        assert list(ours) == list(theirs), theirs["name"]
        for key, value in theirs.items():
            same(ours[key], value, f"{theirs['name']}.{key}")
    engine = got["entities"][-1]
    assert engine["engine_path"] == got_result.engine_path
    assert "escape_hatches" not in engine
    if RUNS[name][3] == "chain":
        assert got_result.engine_path == expected_result.engine_path == "chain"
