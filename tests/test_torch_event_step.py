"""The port's plain event step against the JAX engine's, block by block.

Both packages start from the same JAX-made state (carried across with
``happysim_tpu_torch.convert``) and the same uniform block. The JAX side
runs as its own tests run it on the CPU: the Pallas kernel in interpret
mode, and the lax block scan of the same step closure.

Tolerances: integer leaves must be exactly equal. Float leaves allow
rel 1e-5, because XLA's CPU ``log`` differs from torch's by an ulp on
some inputs and XLA's CPU backend contracts multiply-adds that the torch
step rounds twice (both measured on this package's inputs).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu.tpu.kernels import build_block_step  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu.model import mm1_model as j_mm1  # noqa: E402
from happysim_tpu.tpu.model import pipeline_model as j_pipeline  # noqa: E402
from happysim_tpu_torch import convert, rng  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.kernels.event_step import (  # noqa: E402
    _static_args,
    block_step,
    launch_args,
    plain_block_step,
)
from happysim_tpu_torch.model import mm1_model as t_mm1  # noqa: E402
from happysim_tpu_torch.model import pipeline_model as t_pipeline  # noqa: E402
from test_torch_chaos_models import CHAOS_MODELS  # noqa: E402
from test_torch_telemetry_models import TELEMETRY_MODELS  # noqa: E402

FLOAT_RTOL = 1e-5
# Graph models also allow an absolute float difference of GRAPH_ULPS ulp
# of the horizon. Their float leaves take differences of event times
# (t - last in the limiter refill, t - enqueued in the wait sums, the
# interval in the depth integral) after exponential edge draws, so a
# one-ulp time difference from XLA's CPU log is large next to a small
# result (a token count near zero, a short wait). Measured worst over
# the graph models below: 11 ulp (the mix model's wait sums and tokens);
# every integer leaf stays exactly equal.
GRAPH_ULPS = 32


# Graph models, built with the same code in both packages (``mod`` is
# either package's model module).
def fanout(mod, policy, horizon_s=20.0, rate=8.0):
    """The 4-server load-balancer fan-out with the edge mix of
    tests/regression/test_graph_regression.py::_lo_fanout (telemetry
    left out): constant, exponential and free per-target edges."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=2.0, transit_capacity=8)
    src = m.source(rate=rate)
    servers = [m.server(service_mean=0.05, queue_capacity=16) for _ in range(4)]
    weights = {"weights": (0.4, 0.3, 0.2, 0.1)} if policy == "weighted" else {}
    router = m.router(policy=policy, **weights)
    snk = m.sink()
    m.connect(src, router)
    edge_mix = [(0.01, "constant"), (0.02, "exponential"), (0.0, "constant")]
    for index, server in enumerate(servers):
        latency_s, kind = edge_mix[index % len(edge_mix)]
        m.connect(router, server, latency_s=latency_s, latency_kind=kind)
        m.connect(server, snk)
    return m


def shared_backend(mod, horizon_s=20.0):
    """The two-tier least_outstanding DAG of test_graph_regression.py
    with a constant-rate Poisson source in place of the ramp; the back
    router is declared first, so router indices differ from BFS order."""
    m = mod.EnsembleModel(horizon_s=horizon_s, transit_capacity=8)
    src = m.source(rate=12.0)
    front = [m.server(service_mean=0.06, queue_capacity=16) for _ in range(2)]
    back = [m.server(service_mean=0.05, queue_capacity=16) for _ in range(2)]
    back_router = m.router(policy="least_outstanding", targets=back)
    front_router = m.router(policy="least_outstanding", targets=front)
    snk = m.sink()
    m.connect(src, front_router)
    for server in front:
        m.connect(server, back_router)
    for server in back:
        m.connect(server, snk)
    return m


def mix(mod, horizon_s=40.0, warmup_s=10.0):
    """Limiter -> random router over [weighted router over s0, s1; s2];
    every server exits through a weighted router over [sink behind a
    2 ms exponential edge, s2]: two route-draw depths, a limiter that
    drops, zero-latency transit parks, and feedback into s2."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=warmup_s, transit_capacity=16)
    src = m.source(rate=20.0)
    lim = m.limiter(refill_rate=18.0, capacity=8.0)
    s0 = m.server(service_mean=0.05, concurrency=1)
    s1 = m.server(service_mean=0.05, concurrency=2)
    s2 = m.server(service_mean=0.05, concurrency=1)
    inner = m.router(policy="weighted", targets=[s0, s1], weights=(0.7, 0.3))
    front = m.router(policy="random", targets=[inner, s2])
    snk = m.sink()
    exit_router = m.router(policy="weighted", weights=(0.8, 0.2))
    m.connect(src, lim)
    m.connect(lim, front)
    m.connect(exit_router, snk, latency_s=0.002, latency_kind="exponential")
    m.connect(exit_router, s2)
    for server in (s0, s1, s2):
        m.connect(server, exit_router)
    return m


GRAPH_MODELS = {
    **{
        f"fanout-{policy}": (lambda mod, policy=policy: fanout(mod, policy))
        for policy in ("random", "round_robin", "weighted", "least_outstanding")
    },
    "shared-backend": shared_backend,
    "mix": lambda mod: mix(mod, horizon_s=10.0, warmup_s=2.0),
}


def mg1(mod, service, horizon_s=20.0, **shape):
    """The M/G/1 of tests/integration/test_tpu_mg1.py (lambda=8, mean
    0.1, queue 512) at a short horizon."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=5.0)
    src = m.source(rate=8.0)
    srv = m.server(service_mean=0.1, service=service, queue_capacity=512, **shape)
    m.connect(src, srv)
    m.connect(srv, m.sink())
    return m


def families_chain(mod, horizon_s=20.0):
    """erlang-3 -> lognormal -> pareto (3-wide service windows)."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    src = m.source(rate=8.0)
    stages = [
        m.server(service_mean=0.05, service="erlang", service_k=3, queue_capacity=64),
        m.server(service_mean=0.08, service="lognormal", service_scv=2.0, queue_capacity=64),
        m.server(service_mean=0.06, service="pareto", pareto_alpha=3.0, queue_capacity=64),
    ]
    m.connect(src, stages[0])
    m.connect(stages[0], stages[1])
    m.connect(stages[1], stages[2])
    m.connect(stages[2], m.sink())
    return m


def ramp_graph(mod, horizon_s=20.0):
    """bench.py's bench_kernel_graph DAG at a short horizon: a ramp to
    twice the start rate over half the horizon, two least_outstanding
    tiers of 2 servers."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=horizon_s / 4, transit_capacity=16)
    src = m.ramp_source(20.0, 40.0, horizon_s / 2)
    front = [m.server(service_mean=0.02, queue_capacity=64) for _ in range(2)]
    back = [m.server(service_mean=0.02, queue_capacity=64) for _ in range(2)]
    front_lb = m.router(policy="least_outstanding", targets=front)
    back_lb = m.router(policy="least_outstanding", targets=back)
    snk = m.sink()
    m.connect(src, front_lb)
    for server in front:
        m.connect(server, back_lb)
    for server in back:
        m.connect(server, snk)
    return m


def to_sink(mod, build_source, horizon_s=30.0):
    """A source wired straight to the sink (no server)."""
    m = mod.EnsembleModel(horizon_s=horizon_s)
    m.connect(build_source(m), m.sink())
    return m


def spike_off_mixed(mod, horizon_s=30.0):
    """A spike of rate 0 (a flat cumulative table) feeding a random
    router over a hyperexp server behind a 10 ms exponential edge, a
    constant one and an erlang-2 one. The constant service is 0.08 s:
    at 0.1 s an unqueued job's latency sits on a histogram bin edge
    (10^(k/10) s), where a one-ulp arrival-time difference from XLA's
    CPU log moves it to the next bin (ROADMAP C)."""
    m = mod.EnsembleModel(horizon_s=horizon_s, warmup_s=5.0, transit_capacity=8)
    src = m.spike_source(6.0, 0.0, 10.0, 20.0)
    servers = [
        m.server(service_mean=0.1, service="hyperexp", service_scv=4.0),
        m.server(service_mean=0.08, service="constant"),
        m.server(service_mean=0.1, service="erlang", service_k=2),
    ]
    router = m.router(policy="random")
    m.connect(src, router)
    m.connect(router, servers[0], latency_s=0.01, latency_kind="exponential")
    for server in servers[1:]:
        m.connect(router, server)
    snk = m.sink()
    for server in servers:
        m.connect(server, snk)
    return m


SLICE_MODELS = {
    "mg1-erlang2": lambda mod: mg1(mod, "erlang", service_k=2),
    "mg1-erlang3": lambda mod: mg1(mod, "erlang", service_k=3),
    "mg1-hyperexp": lambda mod: mg1(mod, "hyperexp", service_scv=4.0),
    "mg1-lognormal": lambda mod: mg1(mod, "lognormal", service_scv=2.0),
    "mg1-pareto": lambda mod: mg1(mod, "pareto", pareto_alpha=3.0),
    "families-chain": families_chain,
    "ramp-graph": ramp_graph,
    "ramp-sink": lambda mod: to_sink(mod, lambda m: m.ramp_source(2.0, 10.0, 30.0)),
    "ramp-constant-sink": lambda mod: to_sink(
        mod, lambda m: m.ramp_source(2.0, 10.0, 30.0, kind="constant")
    ),
    "spike-sink": lambda mod: to_sink(mod, lambda m: m.spike_source(2.0, 20.0, 10.0, 20.0)),
    "spike-off-mixed": spike_off_mixed,
}


def _params(model, n):
    return {
        "src_rate": np.full((n, 1), model.sources[0].rate, np.float32),
        "srv_mean": np.broadcast_to(
            np.asarray([s.service_mean_s for s in model.servers], np.float32),
            (n, len(model.servers)),
        ).copy(),
    }


def _jax_state(compiled, params, n, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    return jax.vmap(compiled.init_state)(keys, jparams)


def _block_u(keys, block, macro, n_draws):
    return jax.vmap(
        lambda k: jax.random.uniform(
            jax.random.fold_in(k, jnp.uint32(block)),
            (macro, n_draws),
            minval=1e-12,
            maxval=1.0,
        )
    )(keys)


def _torch_keys(keys) -> torch.Tensor:
    """JAX's (R, 2) uint32 replica keys as the port's tensor."""
    return torch.from_numpy(np.array(keys, dtype=np.uint32))


def _with_macro(model, macro: int):
    """The port's model with ``macro`` event steps per block, the block
    length the JAX kernel under test is built for."""
    model.macro_block = macro
    return model


def _assert_leaves_match(expected: dict, got: dict, context: str, atol: float = 0.0):
    assert set(expected) <= set(got), set(expected) - set(got)
    for name in sorted(expected):
        e = np.asarray(expected[name])
        g = got[name].cpu().numpy()
        assert g.dtype == e.dtype and g.shape == e.shape, (name, g.dtype, e.dtype)
        if np.issubdtype(e.dtype, np.floating):
            np.testing.assert_allclose(
                g, e, rtol=FLOAT_RTOL, atol=atol, err_msg=f"{context}: {name}"
            )
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{context}: {name}")


@pytest.mark.parametrize(
    "build_j, build_t",
    [
        (lambda: j_mm1(8.0, 10.0, 20.0, warmup_s=5.0), lambda: t_mm1(8.0, 10.0, 20.0, warmup_s=5.0)),
        (
            lambda: j_pipeline(8.0, (0.05, 0.08, 0.06), 20.0, concurrency=2),
            lambda: t_pipeline(8.0, (0.05, 0.08, 0.06), 20.0, concurrency=2),
        ),
        (lambda: shared_backend(jmodel), lambda: shared_backend(tmodel)),
        (lambda: mix(jmodel), lambda: mix(tmodel)),
    ],
    ids=["mm1", "pipeline-c2", "router-dag", "limiter-transit"],
)
def test_init_state_matches_jax(build_j, build_t):
    jm, tm = build_j(), build_t()
    params = _params(jm, 32)
    expected = _jax_state(JCompiled(jm), params, 32, seed=4)
    compiled = TCompiled(tm)
    keys = rng.split(rng.PRNGKey(4), 32)
    got = compiled.init_state(keys, convert.params_from_numpy(params))
    assert set(got) == set(expected)
    _assert_leaves_match(expected, got, "init_state")


def test_plain_step_matches_pallas_interpret_kernel():
    """The JAX kernel as its own unit tier runs it: build_block_step in
    interpret mode, MACRO=2, 4 replicas, mm1_model(5, 9, 3, queue 8);
    two chained blocks."""
    macro, n = 2, 4
    jm = j_mm1(lam=5.0, mu=9.0, horizon_s=3.0, queue_capacity=8)
    tm = t_mm1(lam=5.0, mu=9.0, horizon_s=3.0, queue_capacity=8)
    jc, tc = JCompiled(jm), TCompiled(_with_macro(tm, macro))
    assert tc.n_draws == jc.n_draws == 3
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=9)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    block_fn, _meta = build_block_step(jc, float(jm.horizon_s), macro, n, interpret=True)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(2):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = block_fn(jstate, U, jparams)
        block_step(tc, tstate, _torch_keys(keys), block, tparams)
        _assert_leaves_match(jstate, tstate, f"pallas block {block}")


def test_plain_step_matches_pallas_interpret_kernel_on_a_router():
    """build_block_step in interpret mode on the round-robin fan-out
    (transit slots and latency draws live), MACRO=2, 4 replicas, two
    chained blocks."""
    macro, n = 2, 4
    jm, tm = fanout(jmodel, "round_robin", 3.0), fanout(tmodel, "round_robin", 3.0)
    jc, tc = JCompiled(jm), TCompiled(_with_macro(tm, macro))
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=9)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    block_fn, _meta = build_block_step(jc, float(jm.horizon_s), macro, n, interpret=True)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(2):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = block_fn(jstate, U, jparams)
        block_step(tc, tstate, _torch_keys(keys), block, tparams)
        _assert_leaves_match(jstate, tstate, f"pallas block {block}")
    # The round-robin cursor advanced once per source fire.
    assert int(tstate["rr_next"].sum()) > 0


def _lax_block(compiled, horizon):
    step = compiled.make_step(horizon, external_u=True)

    def one(state_row, u_rows, params_row):
        (out, _), _ = lax.scan(step, (state_row, params_row), u_rows)
        return out

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize(
    "build_j, build_t",
    [
        (lambda: j_mm1(8.0, 10.0, 20.0, warmup_s=5.0), lambda: t_mm1(8.0, 10.0, 20.0, warmup_s=5.0)),
        (
            lambda: j_pipeline(8.0, (0.05, 0.08, 0.06), 20.0),
            lambda: t_pipeline(8.0, (0.05, 0.08, 0.06), 20.0),
        ),
    ],
    ids=["mm1", "pipeline"],
)
def test_plain_step_matches_lax_block_scan(build_j, build_t):
    """MACRO=32 on 64 replicas: each package advances its own state
    through 8 chained blocks of the same uniforms; every leaf is compared
    after every block."""
    macro, n = 32, 64
    jm, tm = build_j(), build_t()
    jc, tc = JCompiled(jm), TCompiled(tm)
    assert tc.n_draws == jc.n_draws
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=2)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(8):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        halted = plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(jstate, tstate, f"lax block {block}")
        assert halted.dtype == torch.bool and halted.shape == (n,)
    # The blocks did real work: every replica served jobs.
    assert int(tstate["srv_completed"].min()) > 0


@pytest.mark.parametrize("name", sorted(GRAPH_MODELS))
def test_plain_step_matches_lax_block_scan_on_graphs(name):
    """The same block-by-block parity on router and limiter graphs with
    latency edges and transit slots: MACRO=32, 64 replicas, 8 chained
    blocks, every leaf compared after every block (integer leaves
    exactly, the routing trace included)."""
    macro, n = 32, 64
    jm, tm = GRAPH_MODELS[name](jmodel), GRAPH_MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    assert (tc.n_draws, tc.has_transit) == (jc.n_draws, jc.has_transit)
    assert tc.U_ROUTE_HOPS == jc.U_ROUTE_HOPS and tc.U_LAT == jc.U_LAT
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=2)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(8):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(
            jstate, tstate, f"{name} lax block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    # Every replica served jobs, and every server saw work somewhere.
    assert int(tstate["srv_completed"].sum(dim=1).min()) > 0
    assert int(tstate["srv_completed"].sum(dim=0).min()) > 0


@pytest.mark.parametrize("name", sorted(SLICE_MODELS))
def test_plain_step_matches_lax_block_scan_on_families_and_profiles(name):
    """Block-by-block parity for each service family, the mixed-family
    chain, each profile kind (a spike of rate 0 included) and sources
    wired straight to the sink: MACRO=32, 64 replicas, 8 chained
    blocks, every leaf compared after every block, integer leaves
    exactly, float leaves to rel 1e-5 plus GRAPH_ULPS ulp of the
    horizon."""
    macro, n = 32, 64
    jm, tm = SLICE_MODELS[name](jmodel), SLICE_MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    assert (tc.n_draws, tc.U_SVC1, tc.U_SVC2) == (jc.n_draws, jc.U_SVC1, jc.U_SVC2)
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=2)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(8):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(
            jstate, tstate, f"{name} lax block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    # The blocks did real work: every server completed jobs somewhere,
    # and without a server every replica's sink counted arrivals.
    if tm.servers:
        assert int(tstate["srv_completed"].sum(dim=0).min()) > 0
    else:
        assert int(tstate["sink_count"].min()) > 0


@pytest.mark.parametrize("name", ["mg1-lognormal", "ramp-graph", "spike-off-mixed"])
def test_profiled_and_family_init_state_matches_jax(name):
    """The first gaps of profiled sources invert the table from t = 0."""
    jm, tm = SLICE_MODELS[name](jmodel), SLICE_MODELS[name](tmodel)
    params = _params(jm, 32)
    expected = _jax_state(JCompiled(jm), params, 32, seed=4)
    got = TCompiled(tm).init_state(rng.split(rng.PRNGKey(4), 32), convert.params_from_numpy(params))
    assert set(got) == set(expected)
    _assert_leaves_match(expected, got, "init_state")


@pytest.mark.parametrize("name", ["mg1-lognormal", "families-chain", "ramp-graph", "spike-off-mixed"])
def test_plain_step_matches_pallas_interpret_kernel_on_families_and_profiles(name):
    """build_block_step in interpret mode, which hoists the profile
    tables and the family constants as kernel operands: MACRO=2, 4
    replicas, two chained blocks. (JAX's interpreter cannot run a model
    without a server; the lax test above covers those.)"""
    macro, n = 2, 4
    jm, tm = SLICE_MODELS[name](jmodel), SLICE_MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(_with_macro(tm, macro))
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=9)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    block_fn, _meta = build_block_step(jc, float(jm.horizon_s), macro, n, interpret=True)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(2):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = block_fn(jstate, U, jparams)
        block_step(tc, tstate, _torch_keys(keys), block, tparams)
        _assert_leaves_match(
            jstate, tstate, f"{name} pallas block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    assert int(tstate["events"].min()) == 2 * macro


@pytest.mark.parametrize("name", ["bench-chaos", "pinned"])
def test_plain_step_matches_pallas_interpret_kernel_on_chaos_models(name):
    """build_block_step in interpret mode on the chaos bench model (fault
    registers, transit retries, hedges and loss as kernel operands) and
    the pinned-window chain: MACRO=2, 4 replicas, two chained blocks."""
    macro, n = 2, 4
    jm, tm = CHAOS_MODELS[name](jmodel), CHAOS_MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(_with_macro(tm, macro))
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=9)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    block_fn, _meta = build_block_step(jc, float(jm.horizon_s), macro, n, interpret=True)
    tparams = convert.params_from_numpy(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(2):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = block_fn(jstate, U, jparams)
        block_step(tc, tstate, _torch_keys(keys), block, tparams)
        _assert_leaves_match(
            jstate, tstate, f"{name} pallas block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    assert int(tstate["events"].min()) == 2 * macro


@pytest.mark.parametrize("name", sorted(TELEMETRY_MODELS))
def test_plain_step_matches_lax_block_scan_on_telemetry_models(name):
    """Block-by-block parity of every telemetry model (each metric group,
    a metric subset, services spanning many windows, a short last window,
    a warmup inside a window, faults, routers, the chaos stack, the two
    benches' models): MACRO=32, 64 replicas, 8 chained blocks, every
    leaf compared after every block, the tel_* leaves included: integer
    leaves exactly, float leaves to rel 1e-5 plus GRAPH_ULPS ulp of the
    horizon (XLA's CPU backend may contract the windowed depth integral's
    multiply-add, which the torch step rounds twice)."""
    macro, n = 32, 64
    jm, tm = TELEMETRY_MODELS[name](jmodel), TELEMETRY_MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    assert tc.n_draws == jc.n_draws and tc.nW == jc.nW
    assert tc.tel_keys == set(jc.tel_sum_keys) | set(jc.tel_sink_keys)
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=2)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(8):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(
            jstate, tstate, f"{name} lax block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    # The windows saw work: some window counted a completion or a
    # delivery, or the integrals grew.
    tel = [k for k in tstate if k.startswith("tel_")]
    assert tel and any(float(tstate[k].double().sum()) > 0 for k in tel)


@pytest.mark.parametrize("name", ["mm1-all", "faulted-chain", "router-faulted"])
def test_plain_step_matches_pallas_interpret_kernel_on_telemetry_models(name):
    """build_block_step in interpret mode with the (nW, ...) window
    buffers riding the tile: MACRO=2, 4 replicas, two chained blocks (the
    chaos fan-out, 50 s in the interpreter, is held against the lax scan
    above)."""
    macro, n = 2, 4
    jm, tm = TELEMETRY_MODELS[name](jmodel), TELEMETRY_MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(_with_macro(tm, macro))
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=9)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    block_fn, _meta = build_block_step(jc, float(jm.horizon_s), macro, n, interpret=True)
    tparams = convert.params_from_numpy(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(2):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = block_fn(jstate, U, jparams)
        block_step(tc, tstate, _torch_keys(keys), block, tparams)
        _assert_leaves_match(
            jstate, tstate, f"{name} pallas block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    assert int(tstate["events"].min()) == 2 * macro


@pytest.mark.parametrize("name", ["mm1-all", "chain-queue-util", "chaos-fanout", "bench-chaos"])
def test_telemetry_init_state_matches_jax(name):
    """The tel_* leaves JAX allocates, and only those, zeroed."""
    jm, tm = TELEMETRY_MODELS[name](jmodel), TELEMETRY_MODELS[name](tmodel)
    params = _params(jm, 16)
    expected = _jax_state(JCompiled(jm), params, 16, seed=4)
    got = TCompiled(tm).init_state(rng.split(rng.PRNGKey(4), 16), convert.params_from_numpy(params))
    assert set(got) == set(expected)
    assert {k for k in got if k.startswith("tel_")}
    _assert_leaves_match(expected, got, "init_state")


def test_state_round_trips_through_numpy():
    tm = t_pipeline(8.0, (0.05, 0.08), 5.0)
    compiled = TCompiled(tm)
    params = convert.params_from_numpy(_params(tm, 8))
    state = compiled.init_state(rng.split(rng.PRNGKey(0), 8), params)
    back = convert.state_from_numpy(convert.state_to_numpy(state))
    for name, value in state.items():
        assert back[name].dtype == value.dtype
        torch.testing.assert_close(back[name], value, rtol=0, atol=0)


def test_graph_state_round_trips_through_numpy():
    """The router, limiter and transit leaves cross between the packages
    unchanged, and the port's leaves equal JAX's after a round trip."""
    tm, jm = mix(tmodel), mix(jmodel)
    compiled = TCompiled(tm)
    params = _params(tm, 8)
    state = compiled.init_state(rng.split(rng.PRNGKey(0), 8), convert.params_from_numpy(params))
    assert {"rr_next", "lim_tokens", "tr_time", "tr_created", "tr_dropped"} <= set(state)
    back = convert.state_from_numpy(convert.state_to_numpy(state))
    for name, value in state.items():
        assert back[name].dtype == value.dtype
        torch.testing.assert_close(back[name], value, rtol=0, atol=0)
    expected = _jax_state(JCompiled(jm), params, 8, seed=0)
    _assert_leaves_match(expected, back, "round trip")


def _sink_latency_chain(mod):
    """Two servers joined by free edges, then a 10 ms exponential edge
    into the sink: a "chain" plan that still needs the graph code."""
    m = mod.EnsembleModel(horizon_s=10.0)
    src = m.source(rate=6.0)
    front = m.server(service_mean=0.05)
    back = m.server(service_mean=0.08)
    snk = m.sink()
    m.connect(src, front)
    m.connect(front, back)
    m.connect(back, snk, latency_s=0.01, latency_kind="exponential")
    return m


@pytest.mark.parametrize(
    "build, graph, chaos",
    [
        (lambda: t_mm1(8.0, 10.0, 5.0), 0, 0),
        (lambda: t_pipeline(8.0, (0.05, 0.08), 5.0), 0, 0),
        (lambda: _sink_latency_chain(tmodel), 1, 0),
        (lambda: fanout(tmodel, "random"), 1, 0),
        (lambda: mix(tmodel), 1, 0),
        (lambda: CHAOS_MODELS["deadline-mm1"](tmodel), 1, 1),
        (lambda: CHAOS_MODELS["backoff-chain"](tmodel), 1, 1),
        (lambda: TELEMETRY_MODELS["mm1-all"](tmodel), 1, 0),
        (lambda: TELEMETRY_MODELS["chaos-line"](tmodel), 1, 1),
    ],
    ids=[
        "mm1", "pipeline", "sink-latency-chain", "fanout", "mix", "deadline-mm1",
        "backoff-chain", "mm1-telemetry", "chaos-telemetry",
    ],
)
def test_line_instantiation_only_for_lines_of_free_edges(build, graph, chaos):
    """The kernel's line code ignores edge latency, so any model with a
    router, a limiter or a latency edge must launch the graph code; so
    does every chaos model, a line of free edges included (its chaos
    instantiation is graph code: backoff retries park in the transit
    registers), and every telemetry model (the telemetry instantiations
    are extended graph code, with or without the chaos branches)."""
    compiled = TCompiled(build())
    args = _static_args(compiled)
    assert (args.graph, args.chaos) == (graph, chaos)
    assert args.tel.nW == compiled.nW and args.ext == (1 if compiled.nW else args.ext)


def test_launch_args_point_the_telemetry_sub_struct_at_the_window_buffers():
    """Each tel_* leaf's pointer sits in the HsTel sub-struct; a buffer
    the model has not got stays null; the grid is JAX's: the float32
    window width and the float32 reciprocal the compiled step multiplies
    by. A model without a spec launches with nW = 0."""
    model = TELEMETRY_MODELS["chaos-line"](tmodel)
    compiled = TCompiled(model)
    n = 8
    params = convert.params_from_numpy(_params(model, n))
    keys = rng.split(rng.PRNGKey(3), n)
    state = compiled.init_state(keys, params)
    args = launch_args(compiled, state, keys, 0, params, torch.empty((n,), dtype=torch.uint8))
    assert args.tel.nW == compiled.nW == 10
    assert args.tel.window_s == 2.0 and args.tel.inv_window_s == np.float32(0.5)
    assert args.tel.completed == state["tel_srv_completed"].data_ptr()
    assert args.tel.sink_hist == state["tel_sink_hist"].data_ptr()
    assert args.tel.net_lost == state["tel_net_lost"].data_ptr()
    assert args.tel.hedged is None  # no hedged server
    with pytest.raises(ValueError, match="tel_srv_busy_int"):
        launch_args(
            compiled, dict(state, tel_srv_busy_int=state["tel_srv_busy_int"][:, :2].contiguous()),
            keys, 0, params, torch.empty((n,), dtype=torch.uint8),
        )
    plain = TCompiled(CHAOS_MODELS["backoff-chain"](tmodel))
    assert _static_args(plain).tel.nW == 0


def test_launch_args_check_the_state_once_and_u_every_time():
    """The state is checked once; the keys that key the block's uniforms,
    the block index and the draw counter at every call."""
    model = mix(tmodel)
    model.macro_block = 4
    compiled = TCompiled(model)
    n = 8
    params = convert.params_from_numpy(_params(model, n))
    keys = rng.split(rng.PRNGKey(3), n)
    state = compiled.init_state(keys, params)
    halted = torch.empty((n,), dtype=torch.uint8)
    first = launch_args(compiled, state, keys, 5, params, halted)
    assert (first.R, first.macro, first.keys, first.block) == (n, 4, keys.data_ptr(), 5)
    assert first.draws is None
    assert first.t == state["t"].data_ptr() and first.tr_time == state["tr_time"].data_ptr()
    fresh, draws = keys.clone(), torch.zeros((n,), dtype=torch.int32)
    again = launch_args(compiled, state, fresh, (1 << 32) - 1, params, halted, draws)
    assert again.t == first.t and again.keys == fresh.data_ptr()
    assert again.block == (1 << 32) - 1 and again.draws == draws.data_ptr()
    # The keys are checked on every call, a tensor not seen before is
    # checked again, and so is every leaf for another replica count.
    with pytest.raises(ValueError, match="uint32"):
        launch_args(compiled, state, keys.long(), 0, params, halted)
    with pytest.raises(ValueError, match="uint32"):
        launch_args(compiled, state, keys, 1 << 32, params, halted)
    with pytest.raises(ValueError, match="draws"):
        launch_args(compiled, state, keys, 0, params, halted, draws.float())
    with pytest.raises(ValueError, match="srv_q_len"):
        launch_args(compiled, dict(state, srv_q_len=state["srv_q_len"].float()), keys, 0, params, halted)
    with pytest.raises(ValueError, match="shape"):
        launch_args(compiled, state, keys[: n // 2].contiguous(), 0, params, halted)


def test_fused_add_matches_xla_bit_for_bit():
    """2^20 event times t + e * m, with e JAX's own -log(u) of uniform
    draws, t in [0, 160) and m a service mean: engine._fused rounds once,
    bit-equal to the compiled ``t + e * m``, which XLA's CPU backend
    contracts into one multiply-add; two roundings differ on some."""
    n = 1 << 20
    draws = np.random.default_rng(7)
    u = draws.uniform(1e-7, 1.0, n).astype(np.float32)
    e = np.array(jax.jit(lambda x: -jnp.log(x))(u))
    t = draws.uniform(0.0, 160.0, n).astype(np.float32)
    m = draws.uniform(0.01, 1.0, n).astype(np.float32)
    want = np.asarray(jax.jit(lambda t, e, m: t + e * m)(t, e, m))
    tt, te, tm_ = (torch.from_numpy(x) for x in (t, e, m))
    got = tengine._fused(tt, (te, tm_)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert int(((tt + te * tm_).numpy() != want).sum()) > 0


def _log_agreeing_uniforms(draws, shape):
    """Uniforms whose float32 log torch and XLA's CPU backend round alike,
    so a difference in the event times is one of rounding, not of log."""
    n = int(np.prod(shape))
    u = draws.uniform(1e-7, 1.0, 2 * n).astype(np.float32)
    same = np.asarray(jax.jit(jnp.log)(u)) == torch.log(torch.from_numpy(u)).numpy()
    return u[same][:n].reshape(shape)


@pytest.mark.parametrize("name", ["mm1", "pinned", "hedged-mm1", "backoff-chain", "chaos-line"])
def test_event_times_match_the_lax_step_bit_for_bit(name):
    """One event step at a time from JAX's state, 256 replicas, 24 steps,
    on uniforms whose log both packages round alike: every leaf of the
    port's step bit-equal to the compiled lax step's. The service ends
    (at a start, a pull and a hedge's race), an exponential edge's
    arrival, the limiter's refill, the sink's sum of squares and the
    depth integrals are the sums XLA contracts with a product, rounded
    once; the degrade factor and the hedge's select as JAX places them."""
    build = {
        "mm1": lambda mod: mod.mm1_model(8.0, 10.0, 20.0, warmup_s=1.0),
        "chaos-line": TELEMETRY_MODELS["chaos-line"],
        **CHAOS_MODELS,
    }[name]
    jm, tm = build(jmodel), build(tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    n = 256
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=5)
    jstate.pop("key")
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    draws = np.random.default_rng(1)
    for step in range(24):
        U = _log_agreeing_uniforms(draws, (n, 1, jc.n_draws))
        tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
        jstate = run_block(jstate, jnp.asarray(U), jparams)
        plain_block_step(tc, tstate, torch.from_numpy(U), tparams)
        for leaf, value in jstate.items():
            want, got = np.asarray(value), tstate[leaf].numpy()
            same = (want == got) | (np.isnan(want) & np.isnan(got))
            assert same.all(), f"step {step}: {leaf} differs on {int((~same).sum())} entries"
