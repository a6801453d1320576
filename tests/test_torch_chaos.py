"""Deadlines, retries, hedges, brownouts, fault schedules and packet loss:
the port against the JAX package.

Every test builds the same model in both packages
(``test_torch_chaos_models.py``) and holds the port against the JAX
engine: the model API's validation, the fault-window draw, the backoff
delay, the plain event step block by block against JAX's lax block scan,
and the analytic contracts of ``tests/integration/test_tpu_faults.py``
(the Pallas interpreter's blocks are in test_torch_event_step.py, the
whole runs in test_torch_engine.py).

Tolerances: integer leaves and totals must be exactly equal. Float
leaves allow rel 1e-5 plus GRAPH_ULPS ulp of the horizon, as the graph
tests of test_torch_event_step.py do (XLA's CPU ``log`` differs from
torch's by an ulp on some inputs); whole-run float means allow rel 1e-4.
The fault draw's window times take ``-log(u)``, so the port's draw equals
JAX's bit for bit given the same logs (tested), and within a few ulp
through torch's own ``log``; the block tests carry JAX's drawn windows
across.
"""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu.tpu.faults import FAULT_KEY_SALT as J_FAULT_KEY_SALT  # noqa: E402
from happysim_tpu.tpu.faults import FaultTable as JFaultTable  # noqa: E402
from happysim_tpu.tpu.kernels import kernel_plan as j_kernel_plan  # noqa: E402
from happysim_tpu_torch import convert, faults, rng  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import run_ensemble as t_run  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.kernels import support  # noqa: E402
from happysim_tpu_torch.kernels.event_step import (  # noqa: E402
    _static_args,
    launch_args,
    plain_block_step,
)
from test_torch_chaos_models import CHAOS_MODELS, bench_chaos, hedged  # noqa: E402
from test_torch_event_step import (  # noqa: E402
    GRAPH_ULPS,
    _assert_leaves_match,
    _block_u,
    _jax_state,
    _lax_block,
    _params,
)

# -- the model API -------------------------------------------------------------
def _src_srv(m, **server):
    src = m.source(rate=5.0)
    srv = m.server(**server)
    m.connect(src, srv)
    m.connect(srv, m.sink())
    return m


def _lossy_into(kind):
    def build(mod):
        m = mod.EnsembleModel()
        src = m.source(rate=5.0)
        target = m.router() if kind == "router" else m.limiter(refill_rate=5.0, capacity=5.0)
        m.connect(src, target, loss_p=0.1)

    return build


REJECTS = {
    "deadline-zero": lambda mod: mod.EnsembleModel().server(deadline_s=0.0),
    "negative-retries": lambda mod: mod.EnsembleModel().server(max_retries=-1),
    "retries-without-source": lambda mod: mod.EnsembleModel().server(max_retries=1),
    "backoff-zero": lambda mod: mod.EnsembleModel().server(max_retries=1, retry_backoff_s=0.0),
    "backoff-without-retries": lambda mod: mod.EnsembleModel().server(retry_backoff_s=0.1),
    "jitter-above-one": lambda mod: mod.EnsembleModel().server(
        max_retries=1, retry_backoff_s=0.1, deadline_s=1.0, retry_jitter=1.5
    ),
    "jitter-without-backoff": lambda mod: mod.EnsembleModel().server(retry_jitter=0.5),
    "hedge-zero": lambda mod: mod.EnsembleModel().server(hedge_delay_s=0.0),
    "outage-negative": lambda mod: mod.EnsembleModel().server(outage=(-1.0, 2.0)),
    "outage-empty": lambda mod: mod.EnsembleModel().server(outage=(3.0, 3.0)),
    "fault-mode": lambda mod: mod.EnsembleModel().server(fault=mod.FaultSpec(rate=1.0, mean_duration_s=1.0, mode="x")),
    "fault-duration": lambda mod: mod.EnsembleModel().server(
        fault=mod.FaultSpec(rate=1.0, mean_duration_s=1.0, duration="x")
    ),
    "fault-window-empty": lambda mod: mod.EnsembleModel().server(fault=mod.FaultSpec(windows=((2.0, 1.0),))),
    "fault-window-negative": lambda mod: mod.EnsembleModel().server(fault=mod.FaultSpec(windows=((-1.0, 1.0),))),
    "fault-no-rate": lambda mod: mod.EnsembleModel().server(fault=mod.FaultSpec()),
    "fault-no-duration": lambda mod: mod.EnsembleModel().server(fault=mod.FaultSpec(rate=1.0)),
    "fault-max-windows": lambda mod: mod.EnsembleModel().server(
        fault=mod.FaultSpec(rate=1.0, mean_duration_s=1.0, max_windows=0)
    ),
    "fault-capacity": lambda mod: mod.EnsembleModel().server(
        fault=mod.FaultSpec(rate=1.0, mean_duration_s=1.0, mode="degrade", capacity_factor=1.5)
    ),
    "fault-latency": lambda mod: mod.EnsembleModel().server(
        fault=mod.FaultSpec(rate=1.0, mean_duration_s=1.0, mode="degrade", latency_factor=0.5)
    ),
    "fault-outage-factors": lambda mod: mod.EnsembleModel().server(
        fault=mod.FaultSpec(rate=1.0, mean_duration_s=1.0, capacity_factor=0.5)
    ),
    "correlated-rate": lambda mod: mod.EnsembleModel().correlated_outages(rate=0.0, mean_duration_s=1.0),
    "correlated-duration": lambda mod: mod.EnsembleModel().correlated_outages(rate=1.0, mean_duration_s=0.0),
    "correlated-trigger": lambda mod: mod.EnsembleModel().correlated_outages(
        rate=1.0, mean_duration_s=1.0, trigger_p=0.0
    ),
    "correlated-windows": lambda mod: mod.EnsembleModel().correlated_outages(
        rate=1.0, mean_duration_s=1.0, max_windows=0
    ),
    "validate-backoff-without-fault": lambda mod: _src_srv(
        mod.EnsembleModel(), max_retries=1, retry_backoff_s=0.1
    ).validate(),
    "validate-correlated-without-schedule": lambda mod: _src_srv(
        mod.EnsembleModel(), fault=mod.FaultSpec(correlated=True)
    ).validate(),
    "loss-one": lambda mod: mod.EnsembleModel().connect(
        mod.NodeRef(mod.SOURCE, 0), mod.NodeRef(mod.SERVER, 0), loss_p=1.0
    ),
    "loss-negative": lambda mod: mod.EnsembleModel().connect(
        mod.NodeRef(mod.SOURCE, 0), mod.NodeRef(mod.SERVER, 0), loss_p=-0.1
    ),
    "loss-window-without-loss": lambda mod: mod.EnsembleModel().connect(
        mod.NodeRef(mod.SOURCE, 0), mod.NodeRef(mod.SERVER, 0), loss_window=(1.0, 2.0)
    ),
    "loss-window-empty": lambda mod: mod.EnsembleModel().connect(
        mod.NodeRef(mod.SOURCE, 0), mod.NodeRef(mod.SERVER, 0), loss_p=0.1, loss_window=(2.0, 1.0)
    ),
    "loss-into-router": _lossy_into("router"),
    "loss-into-limiter": _lossy_into("limiter"),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_model_api_rejects_like_jax(case):
    """Each validation error of the chaos API, in both packages, with
    JAX's message."""
    with pytest.raises(ValueError) as expected:
        REJECTS[case](jmodel)
    with pytest.raises(ValueError) as got:
        REJECTS[case](tmodel)
    assert str(got.value) == str(expected.value)


@pytest.mark.parametrize("name", sorted(CHAOS_MODELS))
def test_chaos_models_build_validate_and_plan_like_jax(name):
    """Every chaos model is accepted by both packages and plans as in
    JAX, its "chaos" features included."""
    jm, tm = CHAOS_MODELS[name](jmodel), CHAOS_MODELS[name](tmodel)
    jm.validate()
    tm.validate()
    assert tm.chaos_features() == jm.chaos_features()
    expected, reason = j_kernel_plan(jm)
    assert reason == ""
    assert support.kernel_plan(tm) == expected
    # Every chaos model launches the chaos instantiation (graph code).
    args = _static_args(TCompiled(tm))
    assert (args.chaos, args.graph, args.ext) == (1, 1, 1)


# -- the fault draw ----------------------------------------------------------------
FAULT_CASES = {
    "exponential": dict(nV=2, W=4, shared=False, constant=False),
    "constant-wide": dict(nV=3, W=24, shared=False, constant=True),
    "correlated": dict(nV=2, W=8, shared=True, constant=False),
    "wide-correlated": dict(nV=4, W=64, shared=True, constant=True),
}


def _fault_model(mod, nV, W, shared, constant):
    """A chain of nV faulted servers: exponential-duration windows, then
    (constant) constant-duration ones, then pinned windows on the last;
    with ``shared`` the first subscribes to a correlated schedule."""
    m = mod.EnsembleModel(horizon_s=10.0)
    if shared:
        m.correlated_outages(rate=0.3, mean_duration_s=0.7, trigger_p=0.5, max_windows=W)
    prev = m.source(rate=5.0)
    for v in range(nV):
        if v == nV - 1:
            spec = mod.FaultSpec(windows=((1.0, 2.0), (4.5, 6.25)))
        else:
            spec = mod.FaultSpec(
                rate=0.2 + 0.1 * v, mean_duration_s=1.3 - 0.2 * v, max_windows=W,
                duration="constant" if constant and v % 2 else "exponential",
                correlated=shared and v == 0,
            )
        srv = m.server(fault=spec)
        m.connect(prev, srv)
        prev = srv
    m.connect(prev, m.sink())
    return m


@pytest.mark.parametrize("W", [1, 2, 3, 4, 15, 16, 17, 24, 32, 33, 64, 100])
def test_cumsum_like_xla_matches_jnp_cumsum_bit_for_bit(W):
    x = (-np.log(np.random.default_rng(W).random((256, 3, W)))).astype(np.float32) * np.float32(3.7)
    expected = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(faults.cumsum_like_xla(torch.from_numpy(x)).numpy(), expected)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_fault_draw_matches_jax_bit_for_bit(case, seed):
    """The port's fault uniforms equal JAX's bit for bit; its window
    registers, formed from the same exponential draws (JAX's ``log``),
    equal FaultTable.sample_state's bit for bit; through torch's ``log``
    they agree to a few ulp, and the pinned rows exactly."""
    spec = FAULT_CASES[case]
    jm, tm = _fault_model(jmodel, **spec), _fault_model(tmodel, **spec)
    jt, tt = JFaultTable(jm), faults.FaultTable(tm)
    assert (tt.W, tt.W_sh, tt.has_shared) == (jt.W, jt.W_sh, jt.has_shared)
    n = 64
    jkeys = jax.random.split(jax.random.PRNGKey(seed), n)
    expected = {k: np.asarray(v) for k, v in jax.vmap(jt.sample_state)(jkeys).items()}
    tkeys = rng.split(rng.PRNGKey(seed), n)
    u = tt.draw_uniforms(tkeys)
    assert faults.FAULT_KEY_SALT == J_FAULT_KEY_SALT
    fkeys = jax.vmap(lambda k: jax.random.fold_in(k, J_FAULT_KEY_SALT))(jkeys)

    def juniform(block, shape):
        return np.asarray(jax.vmap(
            lambda k: jax.random.uniform(jax.random.fold_in(k, block), shape, minval=1e-12, maxval=1.0)
        )(fkeys))

    ju = juniform(0, (tt.nV, tt.W, 2))
    np.testing.assert_array_equal(u["servers"].numpy(), ju)
    # JAX's exponential draws, then the port's window arithmetic.
    log0, log1 = (np.asarray(jnp.log(jnp.asarray(ju[..., i]))) for i in range(2))
    gaps = torch.from_numpy(-log0) / torch.from_numpy(tt.rate)[:, None]
    durs = torch.where(
        torch.from_numpy(tt.dur_const)[:, None],
        torch.from_numpy(tt.mean_dur)[:, None].expand(-1, tt.W),
        torch.from_numpy(-log1) * torch.from_numpy(tt.mean_dur)[:, None],
    )
    start, end = faults.windows_from(gaps, durs)
    stoch = tt.stochastic[:, None]
    np.testing.assert_array_equal(np.where(stoch, start.numpy(), tt.det_start), expected["flt_start"])
    np.testing.assert_array_equal(np.where(stoch, end.numpy(), tt.det_end), expected["flt_end"])
    if tt.has_shared:
        js = juniform(1, (tt.W_sh, 3))
        np.testing.assert_array_equal(u["shared"].numpy(), js)
        s0, s1 = (np.asarray(jnp.log(jnp.asarray(js[..., i]))) for i in range(2))
        start, end = faults.windows_from(
            torch.from_numpy(-s0) / np.float32(tm.correlated_faults.rate),
            torch.from_numpy(-s1) * np.float32(tm.correlated_faults.mean_duration_s),
        )
        fired = js[..., 2] < np.float32(tm.correlated_faults.trigger_p)
        np.testing.assert_array_equal(np.where(fired, start.numpy(), np.inf), expected["flt_sh_start"])
        np.testing.assert_array_equal(np.where(fired, end.numpy(), np.inf), expected["flt_sh_end"])
    # The port's own draw: torch's log, so a few ulp; pinned rows exact.
    got = {k: v.numpy() for k, v in tt.sample_state(tkeys).items()}
    assert set(got) == set(expected)
    for name in expected:
        np.testing.assert_array_equal(np.isinf(got[name]), np.isinf(expected[name]))
        np.testing.assert_allclose(got[name], expected[name], rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got["flt_start"][:, ~tt.stochastic], expected["flt_start"][:, ~jt.stochastic])


def test_duty_cycle_matches_jax():
    from happysim_tpu.tpu.faults import duty_cycle as j_duty

    for rate, mean in ((0.2, 1.0), (0.05, 0.5), (0.0, 1.0), (1.0, 0.0)):
        assert faults.duty_cycle(rate, mean) == j_duty(rate, mean)


# -- the backoff delay ---------------------------------------------------------
@pytest.mark.parametrize("jitter", [0.0, 0.25, 0.5, 1.0, 0.3])
def test_backoff_delay_matches_jax_bit_for_bit(jitter):
    """The re-arrival t + backoff * 2^attempt * (1 + jitter (u - 0.5)) over
    2^18 uniforms and times and attempts 0-5, against JAX's t +
    _backoff_delay(...) jitted with the jitter as an operand (as
    _arrive_server picks it): XLA contracts the spread and the sum into
    multiply-adds, and the port rounds them once too (ROADMAP C). A
    jitter that is no power of two (0.3) tells one rounding from two in
    the spread as well."""

    def build(mod):
        return _src_srv(
            mod.EnsembleModel(), deadline_s=1.0, max_retries=5, retry_backoff_s=0.05,
            retry_jitter=jitter,
        )

    jc, tc = JCompiled(build(jmodel)), TCompiled(build(tmodel))
    assert tc.U_JIT == jc.U_JIT
    n = 1 << 18
    keys = rng.split(rng.PRNGKey(11), 2)
    u = rng.uniform(keys[0], (n,), minval=1e-12, maxval=1.0)
    t = rng.uniform(keys[1], (n,), minval=0.0, maxval=20.0)
    rows = torch.full((n, tc.n_draws), 0.5)
    if tc.U_JIT is not None:
        rows[:, tc.U_JIT] = u
    jarrival = jax.jit(
        lambda tt, uu, a, j: tt + jc._backoff_delay(uu, a, jnp.float32(0.05), j)
    )
    u_jit = rows[:, tc.U_JIT].numpy() if tc.U_JIT is not None else np.full(n, 0.5, np.float32)
    for attempt in range(6):
        got = tc._backoff_arrival(rows, torch.full((n,), attempt, dtype=torch.int32), 0, t)
        expected = np.asarray(
            jarrival(jnp.asarray(t.numpy()), jnp.asarray(u_jit), jnp.int32(attempt), jnp.float32(jitter))
        )
        np.testing.assert_array_equal(got.numpy(), expected)


# -- block-level parity --------------------------------------------------------
def _carry_across(jm, tm, n, seed):
    """(jc, tc, jstate, keys, tstate, params): JAX's initial state (its
    drawn fault windows included) carried into the port."""
    jc, tc = JCompiled(jm), TCompiled(tm)
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    return jc, tc, jstate, keys, tstate, params


@pytest.mark.parametrize("name", sorted(CHAOS_MODELS))
def test_plain_step_matches_lax_block_scan_on_chaos_models(name):
    """MACRO=32, 64 replicas, 8 chained blocks of the same uniforms
    through JAX's make_step(external_u=True) scan and the port's plain
    step: every leaf compared after every block, integer leaves (the
    attempt numbers and every chaos counter included) exactly, float
    leaves to rel 1e-5 plus GRAPH_ULPS ulp of the horizon."""
    macro, n = 32, 64
    jm, tm = CHAOS_MODELS[name](jmodel), CHAOS_MODELS[name](tmodel)
    jc, tc, jstate, keys, tstate, params = _carry_across(jm, tm, n, seed=2)
    slots = ("n_draws", "U_SVC1", "U_SVC2", "U_HED1", "U_HED2", "U_LOSS", "U_JIT")
    assert tuple(getattr(tc, k) for k in slots) == tuple(getattr(jc, k) for k in slots)
    assert set(tstate) | {"key"} == set(
        tc.init_state(rng.split(rng.PRNGKey(2), n), convert.params_from_numpy(params))
    )
    run_block = _lax_block(jc, float(jm.horizon_s))
    tparams = convert.params_from_numpy(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    atol = GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s)))
    for block in range(8):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(jstate, tstate, f"{name} lax block {block}", atol=atol)
    # Not vacuous: every server worked, and the blocks moved the counters
    # of the branches the model is built for.
    assert int(tstate["srv_completed"].sum(dim=0).min()) > 0
    for leaf in EXERCISED[name]:
        assert int(tstate[leaf].sum()) > 0, leaf


# Which chaos counters each model moves within those 8 blocks.
EXERCISED = {
    "deadline-mm1": ("srv_timed_out", "srv_retried", "srv_dropped"),
    "backoff-chain": ("srv_timed_out", "srv_retried"),
    "hedged-mm1": ("srv_hedged", "srv_hedge_wins"),
    "hedged-erlang2": ("srv_hedged", "srv_hedge_wins"),
    "brownout": ("srv_outage_dropped",),
    "pinned": ("srv_fault_dropped", "srv_outage_dropped"),
    "stochastic": ("srv_fault_dropped", "srv_fault_retried"),
    "correlated": ("srv_fault_dropped", "srv_fault_retried"),
    "lossy": ("net_lost",),
    "bench-chaos": ("srv_fault_retried", "srv_hedged", "net_lost"),
}


@pytest.mark.parametrize("name", sorted(CHAOS_MODELS))
def test_init_state_matches_jax_on_chaos_models(name):
    """The chaos leaves are the JAX package's: the same names, dtypes and
    shapes, zero counters and attempt numbers, and fault windows within a
    few ulp (torch's log; see the fault-draw test)."""
    jm, tm = CHAOS_MODELS[name](jmodel), CHAOS_MODELS[name](tmodel)
    params = _params(jm, 32)
    expected = _jax_state(JCompiled(jm), params, 32, seed=4)
    got = TCompiled(tm).init_state(rng.split(rng.PRNGKey(4), 32), convert.params_from_numpy(params))
    assert set(got) == set(expected)
    windows = {k: expected.pop(k) for k in list(expected) if k.startswith("flt_")}
    _assert_leaves_match(expected, got, "init_state")
    for k, v in windows.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6, err_msg=k)


# -- the analytic contracts of tests/integration/test_tpu_faults.py -------------------
def test_drop_rate_matches_duty_cycle_within_3_sigma():
    """4,096 replicas, each with its own Exp(0.2)-gap / Exp(1)-duration
    outage timeline: total fault drops against the two-state Markov
    closed form (occupation-time variance 2rm/(r+m)^3 per second)."""
    r_up, m_down = 0.2, 1.0
    lam, horizon, replicas = 4.0, 30.0, 4096
    model = tmodel.EnsembleModel(horizon_s=horizon)
    src = model.source(rate=lam, kind="poisson")
    srv = model.server(
        service_mean=0.02, queue_capacity=512,
        fault=tmodel.FaultSpec(rate=r_up, mean_duration_s=1.0 / m_down, max_windows=24),
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    result = t_run(model, n_replicas=replicas, seed=3, device="cpu")
    d = faults.duty_cycle(r_up, 1.0 / m_down)
    rate_sum = r_up + m_down
    expected_dark = d * horizon - d / rate_sum * (1.0 - math.exp(-rate_sum * horizon))
    var_dark = 2.0 * r_up * m_down / rate_sum**3 * horizon
    mean_drops = replicas * lam * expected_dark
    sigma = math.sqrt(replicas * (lam**2 * var_dark + lam * expected_dark))
    drops = result.server_fault_dropped[0]
    assert abs(drops - mean_drops) < 3.0 * sigma, (drops, mean_drops, sigma)
    assert result.truncated_replicas == 0


def test_retry_accounting_is_exact():
    """A whole-horizon outage rejects every attempt: each arrival spends
    its whole budget (max_retries parks), then drops once."""
    horizon, rate, retries = 30.0, 10.0, 2
    model = tmodel.EnsembleModel(horizon_s=horizon)
    src = model.source(rate=rate, kind="constant", stop_after_s=horizon - 2.0)
    srv = model.server(
        service_mean=0.05, queue_capacity=256,
        fault=tmodel.FaultSpec(windows=((0.0, horizon + 1.0),), mode="outage"),
        retry_backoff_s=0.01, max_retries=retries,
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    result = t_run(model, n_replicas=32, seed=6, device="cpu")
    assert result.sink_count[0] == 0
    assert result.server_fault_dropped[0] > 0
    assert result.server_fault_retried[0] == retries * result.server_fault_dropped[0]
    assert result.truncated_replicas == 0


def test_hedge_fraction_and_wins():
    """Hedged M/M/1 (λ=4, mean 0.1, hedge 0.2): a hedge launches on
    P(S > 0.2) = e^-2 of starts, and a memoryless service makes the race
    a coin toss, so about half the hedges win; the tail thins."""
    hedged_r = t_run(hedged(tmodel, horizon_s=40.0), n_replicas=512, seed=8, device="cpu")
    plain_m = hedged(tmodel, horizon_s=40.0)
    plain_m.servers[0].hedge_delay_s = None
    plain_r = t_run(plain_m, n_replicas=512, seed=8, device="cpu")
    started = hedged_r.server_completed[0]
    assert hedged_r.server_hedged[0] / started == pytest.approx(math.exp(-2.0), rel=0.1)
    wins = hedged_r.server_hedge_wins[0] / hedged_r.server_hedged[0]
    assert wins == pytest.approx(0.5, rel=0.1)
    assert hedged_r.sink_p99_s[0] < plain_r.sink_p99_s[0]
    assert plain_r.server_hedged == [0]


def test_packet_loss_rate_within_3_sigma():
    p, rate, stop = 0.2, 10.0, 28.0
    model = tmodel.EnsembleModel(horizon_s=30.0)
    src = model.source(rate=rate, kind="constant", stop_after_s=stop)
    srv = model.server(service_mean=0.001, service="constant", queue_capacity=256)
    model.connect(src, srv, loss_p=p)
    model.connect(srv, model.sink())
    result = t_run(model, n_replicas=256, seed=9, device="cpu")
    crossings = result.network_lost + result.sink_count[0]
    assert crossings / result.n_replicas == pytest.approx(rate * stop, abs=2)
    sigma = math.sqrt(crossings * p * (1.0 - p))
    assert abs(result.network_lost - crossings * p) < 3.0 * sigma


def test_loss_window_bounds_the_bernoulli():
    """Window edges mid-gap between the 0.1 s-spaced arrivals: exactly 50
    in-window crossings per replica."""
    p, rate, window = 0.5, 10.0, (5.05, 10.05)
    model = tmodel.EnsembleModel(horizon_s=30.0)
    src = model.source(rate=rate, kind="constant", stop_after_s=28.0)
    srv = model.server(service_mean=0.001, service="constant", queue_capacity=256)
    model.connect(src, srv, loss_p=p, loss_window=window)
    model.connect(srv, model.sink())
    result = t_run(model, n_replicas=256, seed=10, device="cpu")
    in_window = 256 * int(rate * (window[1] - window[0]))
    sigma = math.sqrt(in_window * p * (1.0 - p))
    assert abs(result.network_lost - in_window * p) < 3.0 * sigma


def test_transit_overflow_not_counted_as_fault_retried():
    """Arrivals at t=1..10 inside a pinned outage, a 1000 s backoff and 2
    transit registers: exactly 2 retries park per replica, the other 8
    overflow into tr_dropped and are not retries."""
    model = tmodel.EnsembleModel(horizon_s=10.0, transit_capacity=2)
    src = model.source(rate=1.0, kind="constant")
    srv = model.server(
        concurrency=1, service_mean=0.05,
        fault=tmodel.FaultSpec(windows=((0.0, 100.0),), mode="outage"),
        retry_backoff_s=1000.0, max_retries=5,
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    result = t_run(model, n_replicas=8, seed=0, device="cpu")
    n = result.n_replicas
    assert result.server_fault_retried[0] == 2 * n
    assert result.transit_dropped[0] == 8 * n
    assert result.server_fault_dropped[0] == 0
    assert result.sink_count[0] == 0 and result.truncated_replicas == 0


# -- launch bounds -------------------------------------------------------------
def _wide_draws(mod):
    """erlang-3 hedged servers behind two levels of random routers with
    exponential, lossy edges: 1 + 2 + 2*3 + 2*3 + 1 + 1 = 17 draws."""
    m = mod.EnsembleModel(horizon_s=5.0)
    src = m.source(rate=5.0)
    inner = m.router(policy="random")
    outer = m.router(policy="random")
    snk = m.sink()
    m.connect(src, outer)
    m.connect(outer, inner)
    for _ in range(2):
        srv = m.server(service="erlang", service_k=3, hedge_delay_s=0.1)
        m.connect(inner, srv, latency_s=0.01, latency_kind="exponential", loss_p=0.1)
        m.connect(srv, snk)
    return m


def test_kernel_bounds_name_the_draw_count_and_fault_windows(monkeypatch):
    """Hedging adds two service windows: erlang-3 hedged behind a two-hop
    router with exponential lossy edges needs 17 draws (the JAX engine
    draws the same 17). The kernel draws each uniform by its index, so no
    draw count bounds it: the model passes the launch bounds and runs on
    the lean chaos code. The fault window budgets W and W_sh are launch
    bounds and raise naming themselves."""
    compiled = TCompiled(_wide_draws(tmodel))
    assert compiled.n_draws == JCompiled(_wide_draws(jmodel)).n_draws == 17
    support.check_kernel_bounds(compiled, 32)
    assert support.wide_reasons(compiled) == []
    assert _wide_draws(tmodel).kernel_supported() == (True, "")
    bench = TCompiled(bench_chaos(tmodel))
    support.check_kernel_bounds(bench, 32)
    assert (bench.faults.W, bench.faults.W_sh) == (4, 4)
    with monkeypatch.context() as patch:
        patch.setattr(support, "KERNEL_MAX_FAULT_WINDOWS", 3)
        with pytest.raises(ValueError, match="fault windows W=4"):
            support.check_kernel_bounds(bench, 32)


def test_launch_args_point_at_the_chaos_leaves():
    """The argument struct of a chaos model points at each chaos leaf the
    model has, and a missing or mistyped one raises naming it."""
    model = bench_chaos(tmodel, horizon_s=5.0)
    compiled = TCompiled(model)
    n = 8
    params = convert.params_from_numpy(_params(model, n))
    keys = rng.split(rng.PRNGKey(3), n)
    state = compiled.init_state(keys, params)
    halted = torch.empty((n,), dtype=torch.uint8)
    args = launch_args(compiled, state, keys, 0, params, halted)
    assert args.chaos == 1 and args.flt_sh_start == state["flt_sh_start"].data_ptr()
    assert args.tr_attempt == state["tr_attempt"].data_ptr()
    assert args.net_lost == state["net_lost"].data_ptr()
    assert args.u_hed1 == compiled.U_HED1 and args.u_jit == compiled.U_JIT
    with pytest.raises(ValueError, match="srv_hedged"):
        launch_args(compiled, dict(state, srv_hedged=state["srv_hedged"].float()), keys, 0, params, halted)
    without = {k: v for k, v in state.items() if k != "tr_attempt"}
    with pytest.raises(ValueError, match="tr_attempt is missing"):
        launch_args(compiled, without, keys, 0, params, halted)
