"""Circuit breakers, load shedding and retry budgets: the port against the
JAX package.

Every test builds the same model in both packages
(``test_torch_resilience_models.py``) and holds the port against the JAX
engine: the model API's validation, the uniform-slot layout, the initial
state, the plain event step block by block against JAX's lax block scan
(and once against the Pallas kernel in interpret mode), whole runs
against JAX's event scan, and the contracts of
``tests/integration/test_tpu_resilience.py`` on the port. It also pins
the two multiply-adds XLA's CPU backend contracts on this path: the
backoff's re-arrival time and the budget's refill (ROADMAP C).

Tolerances: integer leaves, totals and window series must be exactly
equal. Float leaves allow rel 1e-5 plus GRAPH_ULPS ulp of the horizon
per block, as the chaos and telemetry tests do (XLA's CPU ``log``
differs from torch's by an ulp on some inputs); whole-run float means
and the breaker's open fraction allow rel 1e-4.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import run_ensemble as j_run  # noqa: E402
from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu.tpu.kernels import build_block_step  # noqa: E402
from happysim_tpu.tpu.kernels import kernel_plan as j_kernel_plan  # noqa: E402
from happysim_tpu.tpu.mesh import replica_mesh  # noqa: E402
from happysim_tpu_torch import convert, rng  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import run_ensemble as t_run  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.kernels import event_step, support  # noqa: E402
from happysim_tpu_torch.kernels.event_step import (  # noqa: E402
    _static_args,
    block_step,
    launch_args,
    library_of,
    plain_block_step,
)
from test_torch_engine import CHAOS_FIELDS, FLOAT_FIELDS, INT_FIELDS  # noqa: E402
from test_torch_event_step import (  # noqa: E402
    GRAPH_ULPS,
    _assert_leaves_match,
    _block_u,
    _lax_block,
    _params,
)
from test_torch_resilience_models import (  # noqa: E402
    RESILIENCE_MODELS,
    STORM_LAM,
    STORM_MAX_EVENTS,
    STORM_REPLICAS,
    SWEPT,
    bench_resilience_max_events,
    hedge_budget,
    resilience_fanout,
    shed,
    storm,
)

RESILIENCE_FIELDS = (
    "server_breaker_dropped", "breaker_tripped", "server_shed_dropped", "server_budget_dropped",
)
WHOLE_RUN_RTOL = 1e-4


# -- the model API -------------------------------------------------------------
def _src_srv(m, **server):
    src = m.source(rate=5.0)
    srv = m.server(**server)
    m.connect(src, srv)
    m.connect(srv, m.sink())
    return m


REJECTS = {
    "breaker-threshold": lambda mod: mod.EnsembleModel().circuit_breaker(failure_threshold=0),
    "breaker-window": lambda mod: mod.EnsembleModel().circuit_breaker(window_s=0.0),
    "breaker-cooldown": lambda mod: mod.EnsembleModel().circuit_breaker(cooldown_s=-1.0),
    "breaker-probes": lambda mod: mod.EnsembleModel().circuit_breaker(half_open_probes=0),
    "shed-policy": lambda mod: mod.EnsembleModel().load_shed(policy="random"),
    "shed-depth": lambda mod: mod.EnsembleModel().load_shed(threshold=0.5),
    "shed-utilization-zero": lambda mod: mod.EnsembleModel().load_shed(policy="utilization", threshold=0.0),
    "shed-utilization-above-one": lambda mod: mod.EnsembleModel().load_shed(
        policy="utilization", threshold=1.5
    ),
    "shed-priority-one": lambda mod: mod.EnsembleModel().load_shed(priority_fraction=1.0),
    "shed-priority-negative": lambda mod: mod.EnsembleModel().load_shed(priority_fraction=-0.1),
    "budget-ratio": lambda mod: mod.EnsembleModel().retry_budget(ratio=-0.1),
    "budget-min-per-s": lambda mod: mod.EnsembleModel().retry_budget(min_per_s=-1.0),
    "budget-never-refills": lambda mod: mod.EnsembleModel().retry_budget(ratio=0.0, min_per_s=0.0),
    "budget-burst": lambda mod: mod.EnsembleModel().retry_budget(burst=0.5),
    # validate()'s clauses (tests/unit/test_tpu_model_validation.py:407-470)
    "validate-breaker-without-failure-site": lambda mod: _breaker_without_failure_site(mod),
    "validate-breaker-degrade-only": lambda mod: _breaker_degrade_only(mod),
    "validate-shed-without-servers": lambda mod: _shed_without_servers(mod),
    "validate-budget-without-consumer": lambda mod: _budget_without_consumer(mod),
}


def _breaker_without_failure_site(mod):
    m = _src_srv(mod.EnsembleModel())
    m.circuit_breaker()
    m.validate()


def _breaker_degrade_only(mod):
    """A degrade-mode fault rejects nothing, so it is no failure site."""
    m = _src_srv(
        mod.EnsembleModel(),
        fault=mod.FaultSpec(rate=0.5, mean_duration_s=0.2, mode="degrade", latency_factor=2.0),
    )
    m.circuit_breaker()
    m.validate()


def _shed_without_servers(mod):
    m = mod.EnsembleModel()
    m.connect(m.source(rate=5.0), m.sink())
    m.load_shed()
    m.validate()


def _budget_without_consumer(mod):
    m = _src_srv(mod.EnsembleModel(), deadline_s=1.0)
    m.retry_budget()
    m.validate()


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_model_api_rejects_like_jax(case):
    """Each validation error of the resilience API, in both packages, with
    JAX's message."""
    with pytest.raises(ValueError) as expected:
        REJECTS[case](jmodel)
    with pytest.raises(ValueError) as got:
        REJECTS[case](tmodel)
    assert str(got.value) == str(expected.value)


def test_builders_return_and_install_the_spec():
    m = tmodel.EnsembleModel()
    specs = (m.circuit_breaker(failure_threshold=3), m.load_shed(threshold=4), m.retry_budget(ratio=0.2))
    assert specs == (m.circuit_breaker_spec, m.load_shed_spec, m.retry_budget_spec)
    assert m.resilience_features() == ("circuit_breaker", "load_shed", "retry_budget")
    assert tmodel.LOAD_SHED_POLICIES == jmodel.LOAD_SHED_POLICIES


@pytest.mark.parametrize("name", sorted(RESILIENCE_MODELS))
def test_resilience_models_build_validate_and_plan_like_jax(name):
    """Every model is accepted by both packages, declares the same chaos
    and resilience features, plans as in JAX, and launches the
    resilience library (the chaos code) where it has a defense."""
    jm, tm = RESILIENCE_MODELS[name](jmodel), RESILIENCE_MODELS[name](tmodel)
    jm.validate()
    tm.validate()
    assert tm.chaos_features() == jm.chaos_features()
    assert tm.resilience_features() == jm.resilience_features()
    expected, reason = j_kernel_plan(jm)
    assert reason == ""
    assert support.kernel_plan(tm) == expected
    args = _static_args(TCompiled(tm))
    assert (args.chaos, args.graph, args.ext) == (1, 1, 1)
    defended = bool(tm.resilience_features())
    assert args.res.on == int(defended)
    assert library_of(args) == (
        "event_step_resilience" if defended else "event_step_telemetry"
    )


# -- compile-time gating ---------------------------------------------------------
def _slot_models():
    """Every resilience model, and the chaos fan-out's defenses with a
    shed without and with another priority fraction."""
    models = dict(RESILIENCE_MODELS)
    models["fanout-shed-no-priority"] = lambda mod: _fanout_shed(mod, 0.0)
    models["fanout-shed-priority"] = lambda mod: _fanout_shed(mod, 0.3)
    return models


def _fanout_shed(mod, priority):
    m = resilience_fanout(mod)
    m.load_shed(policy="queue_depth", threshold=3, priority_fraction=priority)
    return m


SLOTS = ("n_draws", "U_GAP", "U_ROUTE_HOPS", "U_LAT", "U_SVC1", "U_SVC2", "U_HED1", "U_HED2",
         "U_LOSS", "U_JIT", "U_SHED")


@pytest.mark.parametrize("name", sorted(_slot_models()))
def test_uniform_slots_and_gating_match_jax(name):
    """The same draw count and slot indices as JAX (U_SHED only with a
    priority fraction, after U_JIT), and the same compile-time gates:
    ring width, the utilisation shed's float32 busy thresholds, the
    telemetry keys."""
    build = _slot_models()[name]
    jc, tc = JCompiled(build(jmodel)), TCompiled(build(tmodel))
    assert tuple(getattr(tc, k) for k in SLOTS) == tuple(getattr(jc, k) for k in SLOTS)
    flags = ("has_breaker", "has_shed", "has_budget", "has_resilience", "brk_F")
    assert tuple(getattr(tc, k) for k in flags) == tuple(getattr(jc, k) for k in flags)
    assert tc.shed_busy_thr.dtype == jc.shed_busy_thr.dtype == np.float32
    np.testing.assert_array_equal(tc.shed_busy_thr, jc.shed_busy_thr)
    if tc.has_telemetry:
        assert tc.tel_keys == set(jc.tel_sum_keys) | set(jc.tel_sink_keys)


def test_shed_without_priority_keeps_the_stream_layout():
    """A shed with no priority fraction takes no draw: its model's slots
    are those of the same model without the shed; a priority fraction
    appends one."""
    with_shed = TCompiled(shed(tmodel, "queue_depth", threshold=4))
    bare = shed(tmodel, "queue_depth", threshold=4)
    bare.load_shed_spec = None
    without = TCompiled(bare)
    assert tuple(getattr(with_shed, k) for k in SLOTS) == tuple(getattr(without, k) for k in SLOTS)
    assert with_shed.U_SHED is None
    priority = TCompiled(shed(tmodel, "queue_depth", threshold=2, priority_fraction=0.5))
    assert priority.U_SHED == with_shed.n_draws and priority.n_draws == with_shed.n_draws + 1


@pytest.mark.parametrize("name", sorted(RESILIENCE_MODELS))
def test_init_state_matches_jax_on_resilience_models(name):
    """The resilience leaves are JAX's: the same names, dtypes and shapes,
    the failure ring at -inf, the bucket born at burst."""
    jm, tm = RESILIENCE_MODELS[name](jmodel), RESILIENCE_MODELS[name](tmodel)
    params = _params(jm, 16)
    keys = jax.random.split(jax.random.PRNGKey(4), 16)
    expected = jax.vmap(JCompiled(jm).init_state)(keys, {k: jnp.asarray(v) for k, v in params.items()})
    got = TCompiled(tm).init_state(rng.split(rng.PRNGKey(4), 16), convert.params_from_numpy(params))
    assert set(got) == set(expected)
    expected = {k: v for k, v in expected.items() if not k.startswith("flt_")}
    _assert_leaves_match(expected, got, "init_state")


# -- block-level parity --------------------------------------------------------
def _swept_params(name, model, n):
    params = _params(model, n)
    if name in SWEPT:
        params["src_rate"] = SWEPT[name](n)["source_rate"][:, None].copy()
    return params


@pytest.mark.parametrize("name", sorted(RESILIENCE_MODELS))
def test_plain_step_matches_lax_block_scan_on_resilience_models(name):
    """MACRO=32, 64 replicas, 8 chained blocks of the same uniforms
    through JAX's make_step(external_u=True) scan and the port's plain
    step from the same JAX-made state: every leaf compared after every
    block, the brk_*, bud_* and resilience tel_* leaves included; integer
    leaves exactly, float leaves to rel 1e-5 plus GRAPH_ULPS ulp of the
    horizon."""
    macro, n = 32, 64
    jm, tm = RESILIENCE_MODELS[name](jmodel), RESILIENCE_MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    params = _swept_params(name, jm, n)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax.vmap(jc.init_state)(jax.random.split(jax.random.PRNGKey(2), n), jparams)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    atol = GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s)))
    for block in range(8):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(jstate, tstate, f"{name} lax block {block}", atol=atol)
    for leaf in EXERCISED[name]:
        assert int(tstate[leaf].sum()) > 0, leaf


# Which resilience counters each model moves within those 8 blocks.
EXERCISED = {
    "storm-undefended": ("srv_fault_retried",),
    "storm-defended": ("brk_tripped", "srv_breaker_dropped", "srv_budget_dropped"),
    "cascade": ("brk_tripped", "srv_breaker_dropped"),
    "shed-queue-depth": ("srv_shed_dropped",),
    "shed-utilization": ("srv_shed_dropped",),
    "shed-priority": ("srv_shed_dropped",),
    "hedge-budget": ("srv_hedged", "srv_budget_dropped"),
    "resilience-fanout": ("brk_tripped", "srv_breaker_dropped", "srv_budget_dropped"),
    "breaker-trip-on-first": ("brk_tripped", "srv_breaker_dropped"),
    "breaker-sliding-3": ("brk_tripped", "srv_breaker_dropped"),
    "breaker-wide-5": ("brk_tripped",),
    "bench-defended": ("brk_tripped", "srv_breaker_dropped"),
    "immediate-budget": ("srv_budget_dropped", "srv_shed_dropped", "srv_retried"),
}


def test_plain_step_matches_pallas_interpret_kernel_on_resilience_fanout():
    """build_block_step in interpret mode on _resilience_fanout (the chaos
    fan-out with every defense and telemetry), as the JAX package's own
    tests run it: MACRO=2, 4 replicas, two chained blocks."""
    macro, n = 2, 4
    jm, tm = resilience_fanout(jmodel), resilience_fanout(tmodel)
    tm.macro_block = macro  # the block length the JAX kernel is built for
    jc, tc = JCompiled(jm), TCompiled(tm)
    params = _params(jm, n)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax.vmap(jc.init_state)(jax.random.split(jax.random.PRNGKey(9), n), jparams)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    block_fn, _meta = build_block_step(jc, float(jm.horizon_s), macro, n, interpret=True)
    for block in range(2):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = block_fn(jstate, U, jparams)
        block_step(tc, tstate, torch.from_numpy(np.array(keys, dtype=np.uint32)), block, tparams)
        _assert_leaves_match(
            jstate, tstate, f"resilience-fanout pallas block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    assert int(tstate["events"].min()) == 2 * macro
    assert {"brk_fail_t", "bud_tokens", "srv_shed_dropped", "tel_brk_open_int"} <= set(tstate)


# -- the two multiply-adds XLA contracts -------------------------------------------
def _log_free_backoff(mod, jitter):
    """Constant arrivals and service (no log anywhere, so every time is
    exact in both packages) into a server whose deadline expiries and
    pinned outage rejections retry after a jittered backoff."""
    m = mod.EnsembleModel(horizon_s=20.0, transit_capacity=16)
    src = m.source(rate=10.0, kind="constant")
    srv = m.server(
        service_mean=0.15, service="constant", queue_capacity=32, deadline_s=0.2,
        max_retries=3, retry_backoff_s=0.05, retry_jitter=jitter,
        fault=mod.FaultSpec(windows=((2.0, 3.0), (7.0, 8.0))),
    )
    m.connect(src, srv)
    m.connect(srv, m.sink())
    return m


@pytest.mark.parametrize("jitter", [1.0, 0.3])
def test_backoff_jitter_matches_the_lax_scan_bit_for_bit(jitter):
    """The backoff's re-arrival t + backoff * 2^a * (1 + jitter (u - 0.5))
    through JAX's compiled step, where XLA contracts the spread and the
    sum into multiply-adds, and the port's step: on a model with no log
    every leaf is bit-equal after every block, the transit times of the
    deadline and fault retries included (ROADMAP C: with two roundings
    the port's times were an ulp off on about 2% of the retries)."""
    macro, n = 32, 64
    jm, tm = _log_free_backoff(jmodel, jitter), _log_free_backoff(tmodel, jitter)
    jc, tc = JCompiled(jm), TCompiled(tm)
    params = _params(jm, n)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax.vmap(jc.init_state)(jax.random.split(jax.random.PRNGKey(2), n), jparams)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    for block in range(8):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        for name in sorted(jstate):
            np.testing.assert_array_equal(
                tstate[name].numpy(), np.asarray(jstate[name]), err_msg=f"block {block}: {name}"
            )
    assert int(tstate["srv_retried"].sum()) > 0 and int(tstate["srv_fault_retried"].sum()) > 0


@pytest.mark.parametrize("min_per_s", [0.5, 0.3])
def test_budget_refresh_matches_jax_bit_for_bit(min_per_s):
    """min(tokens + (t - last) * min_per_s + credit, burst) over 2^18
    random buckets, against JAX's _budget_refresh under jit: XLA rounds
    the first multiply-add once, and so does the port."""
    def build(mod):
        m = _src_srv(mod.EnsembleModel(), deadline_s=1.0, max_retries=2)
        m.retry_budget(ratio=0.2, min_per_s=min_per_s, burst=3.0)
        return m

    jc, tc = JCompiled(build(jmodel)), TCompiled(build(tmodel))
    n = 1 << 18
    gen = np.random.default_rng(3)
    tokens = (gen.random(n) * 3.0).astype(np.float32)
    last = (gen.random(n) * 10.0).astype(np.float32)
    t = (last + gen.random(n) * 4.0).astype(np.float32)
    first = gen.random(n) < 0.5
    row = jnp.ones((1,), jnp.bool_)

    def jrefresh(tok, la, tt, fi):
        credit = jnp.where(fi, jnp.float32(0.2), 0.0)
        return jc._budget_refresh({"bud_tokens": tok[None], "bud_last": la[None]}, row, tt, credit)[1]

    expected = np.asarray(jax.jit(jax.vmap(jrefresh))(tokens, last, t, first))
    state = {"bud_tokens": torch.from_numpy(tokens[:, None].copy()),
             "bud_last": torch.from_numpy(last[:, None].copy())}
    credit = torch.where(torch.from_numpy(first), torch.tensor(np.float32(0.2)), torch.tensor(0.0))
    got = tc._budget_refresh(state, torch.ones(n, dtype=torch.bool), 0, torch.from_numpy(t), credit)
    np.testing.assert_array_equal(got.numpy(), expected)


# -- whole runs ------------------------------------------------------------------
# (replicas, seed, max_events) of each model's whole run: the JAX tests' own
# for the models of test_tpu_resilience.py, else 64 replicas at the
# default budget (bench_resilience's own for its model).
RUNS = {
    "storm-undefended": (STORM_REPLICAS, 7, STORM_MAX_EVENTS),
    "storm-defended": (STORM_REPLICAS, 7, STORM_MAX_EVENTS),
    "cascade": (32, 11, 2048),
    "shed-queue-depth": (16, 3, 1024),
    "shed-utilization": (16, 3, 1024),
    "shed-priority": (16, 3, 1024),
    "hedge-budget": (16, 9, 512),
    "bench-defended": (64, 0, bench_resilience_max_events()),
}


@functools.lru_cache(maxsize=None)
def _whole_run(name: str, package: str):
    """One model's whole run in one package (run once, shared by the
    parity tests and the contracts)."""
    n, seed, max_events = RUNS.get(name, (64, 3, None))
    build = RESILIENCE_MODELS[name] if name in RESILIENCE_MODELS else _EXTRA_RUNS[name]
    if max_events is None:
        max_events = tengine._default_max_events(build(tmodel), None)
    sweeps = SWEPT[name](n) if name in SWEPT else None
    if package == "jax":
        mesh = replica_mesh(jax.devices("cpu")[:1])
        return j_run(build(jmodel), n_replicas=n, seed=seed, mesh=mesh, max_events=max_events,
                     sweeps=sweeps)
    return t_run(build(tmodel), n_replicas=n, seed=seed, max_events=max_events, sweeps=sweeps,
                 device="cpu")


_EXTRA_RUNS = {
    "hedge-free": lambda mod: hedge_budget(mod, budget=False),
    "shed-priority-seed-0": RESILIENCE_MODELS["shed-priority"],
}
RUNS["hedge-free"] = RUNS["hedge-budget"]
RUNS["shed-priority-seed-0"] = (16, 0, 1024)


# Whole-run parity holds on every model, shed-priority at the JAX test's
# own seed 3 included: there replica 8 meets a completion and an arrival
# at the same float32 time (block 7, step 5), which the port's event times
# matched only once the service end t + (-log u) * mean was rounded once,
# as XLA contracts it (ROADMAP C). Its whole run at seed 0 stays too.
WHOLE_RUN_MODELS = sorted(RESILIENCE_MODELS) + ["shed-priority-seed-0"]


@pytest.mark.parametrize("name", WHOLE_RUN_MODELS)
def test_resilience_whole_run_matches_jax_event_scan(name):
    """run_ensemble(device="cpu") against JAX's run_ensemble with
    max_events set (its event scan): every integer total equal, the
    resilience counters included, every integer window series equal,
    the breaker's open fraction and float means within rel 1e-4, and the
    engine report's "resilience" entry JAX's."""
    expected, got = _whole_run(name, "jax"), _whole_run(name, "torch")
    assert expected.engine_path == "scan" and got.engine_path == "scan"
    for field in INT_FIELDS + CHAOS_FIELDS + RESILIENCE_FIELDS:
        assert getattr(got, field) == getattr(expected, field), field
    assert got.resilience_features == expected.resilience_features
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for field in FLOAT_FIELDS + ("breaker_open_fraction",):
        np.testing.assert_allclose(
            getattr(got, field), getattr(expected, field), rtol=WHOLE_RUN_RTOL, err_msg=field
        )
    report, jreport = got.engine_report()["resilience"], expected.engine_report()["resilience"]
    assert set(report) == set(jreport)
    for key, value in jreport.items():
        if key == "breaker_open_fraction":
            np.testing.assert_allclose(report[key], value, rtol=WHOLE_RUN_RTOL)
        else:
            assert report[key] == value, key
    js, ts = expected.timeseries, got.timeseries
    assert (js is None) == (ts is None)
    if js is not None:
        for field in js._ARRAY_FIELDS:
            left, right = getattr(ts, field), getattr(js, field)
            assert (left is None) == (right is None), field
            if right is None:
                continue
            if np.issubdtype(np.asarray(right).dtype, np.integer):
                np.testing.assert_array_equal(left, right, err_msg=field)
            else:
                np.testing.assert_allclose(left, right, rtol=WHOLE_RUN_RTOL, atol=1e-12, err_msg=field)
    assert got.truncated_replicas == 0


def test_reduce_registry_encodes_every_resilience_key():
    """The four counters limb-encode, the open time and its windowed
    integral are fixed-point sums, as in JAX's registry."""
    compiled = TCompiled(resilience_fanout(tmodel))
    keys = {"srv_breaker_dropped", "brk_tripped", "srv_shed_dropped", "srv_budget_dropped",
            "brk_open_time", *compiled.tel_keys}
    for key in keys:
        assert tengine._is_i64_key(key) == jengine._is_i64_key(key), key
        assert (key in tengine._F64_SUM_KEYS) == (key in jengine._F64_SUM_KEYS), key
    assert "tel_brk_open_int" in compiled.tel_keys and not tengine._is_i64_key("tel_brk_open_int")


# -- the contracts of tests/integration/test_tpu_resilience.py ----------------------
def _goodput(result):
    windows = result.timeseries.sink_count[:, 0].astype(np.float64)
    return windows[:2].mean(), windows[-3:].mean()


def test_undefended_storm_goodput_stays_collapsed():
    result = _whole_run("storm-undefended", "torch")
    pre, post = _goodput(result)
    assert result.truncated_replicas == 0
    assert pre > 0.8 * STORM_LAM * STORM_REPLICAS
    assert post < 0.1 * pre, post / pre
    assert result.server_retried[0] > STORM_REPLICAS * STORM_LAM * 12.0 * 0.5


def test_defended_storm_goodput_recovers_and_the_defenses_fired():
    result = _whole_run("storm-defended", "torch")
    undefended = _whole_run("storm-undefended", "torch")
    pre, post = _goodput(result)
    assert post >= 0.9 * pre, post / pre
    assert sum(result.server_budget_dropped) > 0
    assert sum(result.breaker_tripped) > 0 and sum(result.server_breaker_dropped) > 0
    series = result.timeseries
    for windowed, whole in (
        ("server_budget_dropped", "server_budget_dropped"),
        ("breaker_tripped", "breaker_tripped"),
        ("server_breaker_dropped", "server_breaker_dropped"),
        ("server_fault_retried", "server_fault_retried"),
    ):
        np.testing.assert_array_equal(getattr(series, windowed).sum(axis=0), getattr(result, whole))
    # Suppressed retries are budget drops, not parked transit jobs.
    assert sum(result.transit_dropped) <= sum(undefended.transit_dropped)
    assert sum(result.server_fault_retried) < sum(undefended.server_fault_retried)
    report = result.engine_report()["resilience"]
    assert report["circuit_breaker"] and report["retry_budget"] and not report["load_shed"]
    assert result.resilience_features == ("circuit_breaker", "retry_budget")
    off = undefended.engine_report()["resilience"]
    assert not (off["circuit_breaker"] or off["load_shed"] or off["retry_budget"])


def test_inert_defenses_leave_the_simulation_unchanged():
    """A breaker that cannot trip (1,000 failures within 1 ms) and a budget
    that cannot run dry (born at 1e9 tokens) keep their books without
    changing a single event of the undefended storm: no draw is added,
    no gate acts (the model chip_smoke.py times against the undefended
    arm for the defenses' own cost)."""
    model = storm(tmodel, defended=False)
    model.circuit_breaker(failure_threshold=1000, window_s=1e-3, cooldown_s=0.5, half_open_probes=2)
    model.retry_budget(ratio=0.1, min_per_s=0.5, burst=1e9)
    inert = t_run(model, n_replicas=STORM_REPLICAS, seed=7, max_events=STORM_MAX_EVENTS, device="cpu")
    bare = _whole_run("storm-undefended", "torch")
    for field in INT_FIELDS + CHAOS_FIELDS + FLOAT_FIELDS:
        assert getattr(inert, field) == getattr(bare, field), field
    assert sum(inert.breaker_tripped) == 0 and sum(inert.server_budget_dropped) == 0
    np.testing.assert_array_equal(inert.timeseries.sink_count, bare.timeseries.sink_count)


def test_cascade_trips_downstream_and_recloses():
    result = _whole_run("cascade", "torch")
    assert result.breaker_tripped[1] > 0 and result.breaker_tripped[0] == 0
    assert result.server_breaker_dropped[1] > 0 and result.server_breaker_dropped[0] == 0
    assert result.server_outage_dropped[1] <= result.breaker_tripped[1] * 4 + 4
    series = result.timeseries
    open_frac = series.breaker_open_fraction[:, 1]
    assert open_frac[3] > 0.2 and open_frac[-1] == 0.0 and open_frac[-2] == 0.0
    windows = series.sink_count[:, 0].astype(np.float64)
    assert windows[-3:].mean() >= 0.9 * windows[:3].mean()
    # The whole-run open fraction is the windowed integral re-expressed.
    np.testing.assert_allclose(
        result.breaker_open_fraction[1],
        float((open_frac * series.window_len_s).sum() / result.horizon_s),
        rtol=1e-6,
    )


def test_load_shed_contracts():
    """Queue-depth shedding at 4 (queue 16) forestalls every queue-full
    drop; utilisation shedding at 1.0 admits no job that would wait;
    exempting half the traffic sheds strictly less."""
    depth = _whole_run("shed-queue-depth", "torch")
    assert sum(depth.server_shed_dropped) > 0 and sum(depth.server_dropped) == 0
    utilization = _whole_run("shed-utilization", "torch")
    assert sum(utilization.server_shed_dropped) > 0
    assert utilization.server_mean_wait_s[0] == 0.0
    full = t_run(shed(tmodel, "queue_depth", threshold=2), n_replicas=16, seed=3,
                 max_events=1024, device="cpu")
    exempt = _whole_run("shed-priority", "torch")
    assert 0 < sum(exempt.server_shed_dropped) < sum(full.server_shed_dropped)


def test_budget_caps_hedges():
    free, capped = _whole_run("hedge-free", "torch"), _whole_run("hedge-budget", "torch")
    assert sum(capped.server_hedged) < sum(free.server_hedged)
    assert sum(capped.server_budget_dropped) > 0
    assert sum(capped.server_hedged) <= 16 * (2 + 0.5 * 6.0) + 16


def test_bench_resilience_defended_recovers():
    """bench.py's recovery ratio (windows 1 to the outage's first against
    the last three) of the defended arm at 64 replicas: the defenses hold
    the post-outage goodput near the pre-outage one."""
    result = _whole_run("bench-defended", "torch")
    windows = result.timeseries.sink_count[:, 0].astype(np.float64)
    first_dark = int(0.3 * 40.0 / (40.0 / 16))
    ratio = windows[-3:].mean() / windows[1:first_dark].mean()
    assert ratio >= 0.9, ratio
    assert sum(result.breaker_tripped) > 0 and sum(result.server_budget_dropped) > 0


# -- the kernel's arguments and bounds ----------------------------------------------
def test_kernel_bounds_name_the_breaker_ring(monkeypatch):
    """The ring's width F is a launch bound, named after brk_fail_t."""
    compiled = TCompiled(RESILIENCE_MODELS["breaker-wide-5"](tmodel))
    support.check_kernel_bounds(compiled, 32)
    assert compiled.brk_F == 5 and support.KERNEL_MAX_BREAKER_RING == 4096
    monkeypatch.setattr(support, "KERNEL_MAX_BREAKER_RING", 4)
    with pytest.raises(ValueError, match="brk_fail_t width F=5 exceeds its bound 4"):
        support.check_kernel_bounds(compiled, 32)


def test_launch_args_point_the_res_sub_struct_at_the_resilience_leaves():
    """The HsRes pointers and constants of a model with every defense and
    telemetry; a leaf the model has not got stays null; a mistyped leaf
    raises naming it."""
    model = resilience_fanout(tmodel)
    compiled = TCompiled(model)
    n = 8
    params = convert.params_from_numpy(_params(model, n))
    keys = rng.split(rng.PRNGKey(3), n)
    state = compiled.init_state(keys, params)
    halted = torch.empty((n,), dtype=torch.uint8)
    args = launch_args(compiled, state, keys, 0, params, halted)
    res = args.res
    assert (res.on, res.breaker, res.shed, res.budget, res.F) == (1, 1, 1, 1, 2)
    assert res.brk_fail_t == state["brk_fail_t"].data_ptr()
    assert res.bud_tokens == state["bud_tokens"].data_ptr()
    assert res.tel_brk_open_int == state["tel_brk_open_int"].data_ptr()
    assert res.u_shed == compiled.U_SHED and res.shed_depth == 2 and res.shed_policy == 0
    assert res.shed_priority == np.float32(0.25) and res.bud_min_per_s == np.float32(0.5)
    assert library_of(args) == "event_step_resilience"
    with pytest.raises(ValueError, match="brk_probes"):
        launch_args(compiled, dict(state, brk_probes=state["brk_probes"].float()), keys, 0, params, halted)
    without = {k: v for k, v in state.items() if k != "brk_fail_t"}
    with pytest.raises(ValueError, match="brk_fail_t is missing"):
        launch_args(compiled, without, keys, 0, params, halted)
    shed_only = TCompiled(shed(tmodel, "utilization", threshold=1.0))
    state = shed_only.init_state(rng.split(rng.PRNGKey(3), n), params | {
        "srv_mean": torch.full((n, 1), 0.1)})
    args = launch_args(shed_only, state, keys, 0,
                       {"src_rate": params["src_rate"], "srv_mean": torch.full((n, 1), 0.1)}, halted)
    assert (args.res.breaker, args.res.shed, args.res.budget, args.res.brk_fail_t) == (0, 1, 0, None)
    assert args.res.shed_busy_thr[0] == 2.0 and args.tel.nW == 0


def _host_compiler():
    return shutil.which("g++") or shutil.which("c++")


def test_argument_struct_mirror_matches_the_header(tmp_path):
    """ctypes' _Args (and its HsTel, HsRes, HsStage, HsSrc and HsCon parts,
    and the block loop's fields) have the size and offsets the header's
    EventStepArgs has, compiled as host C++ (the
    card's library checks hs_event_step_args_size() against the same
    mirror when it loads), within CUDA 12.1's 32,764-byte parameter
    limit the header asserts."""
    compiler = _host_compiler()
    if compiler is None:
        pytest.skip("needs a host C++ compiler to lay out the header's struct")
    (tmp_path / "cuda_runtime.h").write_text("")
    probe = tmp_path / "probe.cpp"
    probe.write_text(
        "#include <cstddef>\n#include <cstdio>\n#include <cmath>\n"
        "#define __global__\n#define __device__\n#define __forceinline__ inline\n#define __noinline__\n"
        "#define __launch_bounds__(...)\n#define __grid_constant__\n#define __shared__\n"
        "struct dim3 { unsigned x, y, z; };\nstatic dim3 blockIdx, threadIdx, blockDim;\n"
        "inline void __syncthreads() {}\nusing std::isinf;\nusing std::isfinite;\n"
        "inline int min(int a, int b) { return a < b ? a : b; }\n"
        "inline int max(int a, int b) { return a > b ? a : b; }\n"
        '#include "event_step.cuh"\n'
        "int main() { std::printf(\"%zu %zu %zu %zu %zu %zu %zu %zu %zu %zu %zu %zu %zu\\n\", "
        "sizeof(EventStepArgs), offsetof(EventStepArgs, tel), offsetof(EventStepArgs, res), "
        "sizeof(HsRes), offsetof(HsRes, shed_busy_thr), offsetof(EventStepArgs, blocks), "
        "offsetof(EventStepArgs, n_blocks), offsetof(EventStepArgs, stage), sizeof(HsStage), "
        "offsetof(EventStepArgs, src), sizeof(HsSrc), offsetof(EventStepArgs, con), "
        "sizeof(HsCon)); }\n"
    )
    exe = tmp_path / "probe"
    subprocess.run(
        [compiler, "-std=c++17", "-O0", f"-I{tmp_path}",
         f"-I{event_step.CSRC}", "-o", str(exe), str(probe)],
        check=True, capture_output=True, timeout=120,
    )
    sizes = [int(x) for x in subprocess.run([str(exe)], capture_output=True, text=True,
                                            check=True).stdout.split()]
    mirror = [
        ctypes.sizeof(event_step._Args), event_step._Args.tel.offset, event_step._Args.res.offset,
        ctypes.sizeof(event_step._Res), event_step._Res.shed_busy_thr.offset,
        event_step._Args.blocks.offset, event_step._Args.n_blocks.offset,
        event_step._Args.stage.offset, ctypes.sizeof(event_step._Stage),
        event_step._Args.src.offset, ctypes.sizeof(event_step._Src), event_step._Args.con.offset,
        ctypes.sizeof(event_step._Con),
    ]
    assert sizes == mirror
    assert 4096 < sizes[0] <= 32764
