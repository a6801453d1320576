"""Trace-driven arrivals in the port against the JAX package: the port's
own copy of ``traces.py`` (the synthesizers' arrays and signatures, the
paging math, ``TraceSpec.validate``'s errors), the model builder and its
validation, the model fingerprint, the initial state, and the plain step
with the traced fire against JAX's lax step given the same state, the
same uniforms and the same resident pages (integer leaves exactly, floats
within rel 1e-5 plus 32 ulp of the horizon, test_torch_event_step.py's
tolerance). The whole runs are test_torch_trace_runs.py's.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import traces as jtraces  # noqa: E402
from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu.tpu.kernels import kernel_plan as j_kernel_plan  # noqa: E402
from happysim_tpu_torch import convert, rng  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import traces as ttraces  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.kernels import event_step, support  # noqa: E402
from test_torch_event_step import GRAPH_ULPS, _assert_leaves_match, _block_u, _jax_state  # noqa: E402
from test_torch_multisource import params_of  # noqa: E402
from test_torch_trace_models import TRACE_MODELS  # noqa: E402

SYNTHESIZED = {
    "diurnal": ("diurnal_trace", (200.0, 0.6, 8.0, 16.0), {"seed": 11, "chunk_len": 64}),
    "diurnal-full": ("diurnal_trace", (50.0, 1.0, 3.0, 9.0), {"seed": 2}),
    "flash": ("flash_crowd_trace", (100.0, 500.0, 4.0, 6.0, 16.0), {"seed": 11, "chunk_len": 64}),
    "flash-regression": ("flash_crowd_trace", (100.0, 500.0, 4.0, 6.0, 16.0), {"seed": 42, "chunk_len": 32}),
    "zipf": ("zipf_tenant_trace", (60.0, 4, 1.1, 6.0), {"seed": 3, "chunk_len": 16}),
    "zipf-flat": ("zipf_tenant_trace", (30.0, 3, 0.0, 5.0), {"seed": 0}),
}


@pytest.mark.parametrize("name", sorted(SYNTHESIZED))
def test_synthesizers_match_jax(name):
    """The same arguments give the same times, tenants, paging and
    signature in both packages."""
    func, args, kwargs = SYNTHESIZED[name]
    want = getattr(jtraces, func)(*args, **kwargs)
    got = getattr(ttraces, func)(*args, **kwargs)
    assert got.times.dtype == np.float32 and got.tenants.dtype == np.int32
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.tenants, want.tenants)
    assert (got.n_tenants, got.chunk_len, got.kind, got.params) == (
        want.n_tenants, want.chunk_len, want.kind, want.params
    )
    assert (got.n_arrivals, got.n_chunks) == (want.n_arrivals, want.n_chunks)
    np.testing.assert_array_equal(got.padded_times(), want.padded_times())
    np.testing.assert_array_equal(got.padded_tenants(), want.padded_tenants())
    assert got.signature() == want.signature()
    assert repr(got) == repr(want)
    got.validate()


def test_default_chunk_len_matches_jax():
    assert ttraces.DEFAULT_CHUNK_LEN == jtraces.DEFAULT_CHUNK_LEN


# (times, tenants, keyword arguments) TraceSpec.validate refuses.
BAD_SPECS = {
    "empty": ([], None, {}),
    "two-dimensional": ([[0.1, 0.2]], None, {}),
    "non-finite": ([0.1, np.inf], None, {}),
    "negative": ([-0.5, 1.0], None, {}),
    "decreasing": ([0.1, 0.5, 0.3], None, {}),
    "tenant-shape": ([0.1, 0.5], [0], {}),
    "no-tenants": ([0.1], [0], {"n_tenants": 0}),
    "tenant-range": ([0.1, 0.5], [0, 2], {"n_tenants": 2}),
    "chunk-len": ([0.1], None, {"chunk_len": 0}),
}


@pytest.mark.parametrize("name", sorted(BAD_SPECS))
def test_validate_raises_jax_errors(name):
    times, tenants, kwargs = BAD_SPECS[name]
    with pytest.raises(ValueError) as want:
        jtraces.TraceSpec(times=np.asarray(times, np.float32), tenants=tenants, **kwargs).validate()
    with pytest.raises(ValueError) as got:
        ttraces.TraceSpec(times=np.asarray(times, np.float32), tenants=tenants, **kwargs).validate()
    assert str(got.value) == str(want.value)


# (synthesizer, arguments) each package refuses with the same message.
BAD_SYNTH = {
    "amplitude": ("diurnal_trace", (10.0, 1.5, 1.0, 2.0)),
    "diurnal-rate": ("diurnal_trace", (0.0, 0.5, 1.0, 2.0)),
    "flash-rate": ("flash_crowd_trace", (0.0, 5.0, 1.0, 2.0, 3.0)),
    "spike-rate": ("flash_crowd_trace", (10.0, 5.0, 1.0, 2.0, 3.0)),
    "spike-window": ("flash_crowd_trace", (10.0, 20.0, 2.0, 1.0, 3.0)),
    "zipf-rate": ("zipf_tenant_trace", (0.0, 2, 1.0, 3.0)),
    "zipf-tenants": ("zipf_tenant_trace", (10.0, 0, 1.0, 3.0)),
    "zipf-alpha": ("zipf_tenant_trace", (10.0, 2, -1.0, 3.0)),
}


@pytest.mark.parametrize("name", sorted(BAD_SYNTH))
def test_synthesizer_errors_match_jax(name):
    func, args = BAD_SYNTH[name]
    with pytest.raises(ValueError) as want:
        getattr(jtraces, func)(*args)
    with pytest.raises(ValueError) as got:
        getattr(ttraces, func)(*args)
    assert str(got.value) == str(want.value)


def _traced(mod, traces, **kwargs):
    model = mod.EnsembleModel(horizon_s=2.0)
    spec = traces.TraceSpec(times=np.asarray([0.1, 0.5, 1.2], np.float32), tenants=None, chunk_len=8)
    src = model.trace_arrivals(spec, **kwargs)
    srv = model.server(service_mean=0.1)
    model.connect(src, srv)
    model.connect(srv, model.sink())
    return model


def _second_trace(mod, traces, model):
    model.trace_arrivals(traces.TraceSpec(times=np.asarray([0.2], np.float32), tenants=None, chunk_len=8))


def _profile_on_trace(mod, traces, model):
    model.sources[0].profile = mod.RateProfile(kind="ramp", end_rate=2.0, ramp_duration_s=1.0)


def _trace_kind_without_spec(mod, traces, model):
    model.sources[0].trace = None


def _spec_on_poisson_source(mod, traces, model):
    model.sources[0].arrival = "poisson"


# Models each package's validate refuses, with the same message.
BAD_MODELS = {
    "two-traces": _second_trace,
    "profile-and-trace": _profile_on_trace,
    "trace-kind-without-spec": _trace_kind_without_spec,
    "spec-on-poisson": _spec_on_poisson_source,
}


@pytest.mark.parametrize("name", sorted(BAD_MODELS))
def test_model_validation_matches_jax(name):
    messages = []
    for mod, traces in ((jmodel, jtraces), (tmodel, ttraces)):
        model = _traced(mod, traces)
        BAD_MODELS[name](mod, traces, model)
        with pytest.raises(ValueError) as info:
            model.validate()
        messages.append(str(info.value))
    assert messages[1] == messages[0]


def test_trace_arrivals_builds_the_traced_source():
    """trace_arrivals needs a TraceSpec (TypeError otherwise, as in JAX),
    adds a source of arrival kind "trace" with no rate, names it in the
    features and in traced_source_index, and its plan records JAX's
    decline by name."""
    with pytest.raises(TypeError, match="TraceSpec"):
        tmodel.EnsembleModel(horizon_s=2.0).trace_arrivals([0.1, 0.5])
    for mod, traces in ((jmodel, jtraces), (tmodel, ttraces)):
        model = _traced(mod, traces, stop_after_s=1.0)
        model.validate()
        source = model.sources[0]
        assert (source.arrival, source.rate, source.stop_after_s) == ("trace", 0.0, 1.0)
        assert model.traced_source_index() == 0
        assert "trace_arrivals" in model.chaos_features()
    jm, tm = _traced(jmodel, jtraces), _traced(tmodel, ttraces)
    assert repr(tm.sources) == repr(jm.sources)
    plan = support.kernel_plan(tm)
    assert plan["shape"] == "mm1" and plan["declined"].startswith("model has trace-driven arrivals")
    jax_plan, reason = j_kernel_plan(jm)
    assert jax_plan is None and plan["declined"] in reason
    assert tm.kernel_supported() == (True, "")


@pytest.mark.parametrize("name", sorted(TRACE_MODELS))
def test_model_fingerprint_equals_jax(name):
    build = TRACE_MODELS[name]
    assert tengine.model_fingerprint(build(tmodel)) == jengine.model_fingerprint(build(jmodel))


def test_fingerprint_follows_the_trace():
    """Another page length or another seed is another trace."""
    fingerprints = {
        tengine.model_fingerprint(build(tmodel))
        for build in (
            lambda m: TRACE_MODELS["flash-regression"](m),
            lambda m: TRACE_MODELS["flash-regression"](m, chunk_len=64),
        )
    }
    assert len(fingerprints) == 2


@pytest.mark.parametrize("name", sorted(TRACE_MODELS))
def test_init_state_matches_jax(name):
    """The traced source's first arrival is the trace's first instant, the
    other sources' gaps keep their draws, and the trace leaves start at
    zero."""
    build = TRACE_MODELS[name]
    jm, tm = build(jmodel), build(tmodel)
    params = params_of(jm, 16)
    expected = _jax_state(JCompiled(jm), params, 16, seed=4)
    got = TCompiled(tm).init_state(rng.split(rng.PRNGKey(4), 16), convert.params_from_numpy(params))
    assert set(got) == set(expected)
    _assert_leaves_match(expected, got, "init_state")
    ti = tm.traced_source_index()
    assert bool((got["src_next"][:, ti] == float(tm.sources[ti].trace.times[0])).all())


def test_compiled_traced_model_matches_jax():
    """The paging constants, the tenants and the draw slots: a traced
    source takes no gap slot."""
    for name, build in TRACE_MODELS.items():
        jc, tc = JCompiled(build(jmodel)), TCompiled(build(tmodel))
        assert (tc.trace_src, tc.trace_chunk_len, tc.trace_pages, tc.n_tenants) == (
            jc.trace_src, jc.trace_chunk_len, jc.trace_pages, jc.n_tenants
        ), name
        assert tc.trace_first_time == jc.trace_first_time, name
        np.testing.assert_array_equal(tc.trace_times, jc.trace_times)
        assert (tc.n_draws, tc.U_GAP) == (jc.n_draws, jc.U_GAP), name
        assert ("tel_trc_arrivals" in tc.tel_keys) == ("tel_trc_arrivals" in getattr(jc, "tel_sum_keys", ())), name


def _resident(compiled, base_page):
    """The (2P,) resident times and tenants from page base_page on."""
    P = compiled.trace_chunk_len
    times = np.full(2 * P, np.inf, np.float32)
    tenants = np.zeros(2 * P, np.int32)
    lo = base_page * P
    n = max(min(2 * P, compiled.trace_times.size - lo), 0)
    times[:n] = compiled.trace_times[lo : lo + n]
    tenants[:n] = compiled.trace_tenants[lo : lo + n]
    return times, tenants


def _lax_trace_block(compiled, horizon):
    """JAX's lax block of traced steps, ``run(state, U, params, resident_t,
    resident_g, base)``, the resident window an argument (as in its stream
    step), so one compile serves every window."""

    def run(state, U, params, resident_t, resident_g, base):
        step = compiled.make_step(horizon, external_u=True, trace_ctx=(resident_t, resident_g, base))

        def one(state_row, u_rows, params_row):
            (out, _), _ = lax.scan(step, (state_row, params_row), u_rows)
            return out

        return jax.vmap(one)(state, U, params)

    return jax.jit(run)


@pytest.mark.parametrize("name", sorted(TRACE_MODELS))
def test_plain_traced_step_matches_lax_block_scan(name):
    """64 replicas, 6 chained blocks of the same uniforms from JAX's
    initial state, the window moved to the least cursor's page before
    each block (lanes past it read clipped offsets, the same in both):
    every leaf after every block."""
    n = 64
    build = TRACE_MODELS[name]
    jm, tm = build(jmodel), build(tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    params = params_of(jm, n)
    jstate = _jax_state(jc, params, n, seed=2)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    P = tc.trace_chunk_len
    run_block = _lax_trace_block(jc, float(jm.horizon_s))
    for block in range(6):
        base_page = int(np.asarray(jstate["trc_cursor"]).min()) // P
        resident_t, resident_g = _resident(tc, base_page)
        U = _block_u(keys, block, tc.macro, jc.n_draws)
        jstate = run_block(
            jstate, U, jparams, jnp.asarray(resident_t), jnp.asarray(resident_g), jnp.int32(base_page * P)
        )
        step = tc.make_step(
            trace_ctx=(torch.from_numpy(resident_t), torch.from_numpy(resident_g), base_page * P)
        )
        Ut = torch.from_numpy(np.array(U))
        for k in range(tc.macro):
            step(tstate, tparams, Ut[:, k, :])
        _assert_leaves_match(
            jstate, tstate, f"{name} lax block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    assert int(tstate["trc_cursor"].to(torch.int64).min()) > 0


def test_plain_trace_steps_gate_and_keys():
    """plain_trace_steps runs each lane until its budget, its halt or its
    stall: a stalled lane's cursor is within a block of the window's end,
    and a lane's blocks are keyed by its own count (the same blocks run
    through one window of everything, or paged, give the same state)."""
    model = TRACE_MODELS["short-trace"](tmodel)
    compiled = TCompiled(model)
    n, P, macro = 16, compiled.trace_chunk_len, compiled.macro
    params = convert.params_from_numpy(params_of(model, n))
    keys = rng.split(rng.PRNGKey(5), n)
    paged = compiled.init_state(keys, params)
    whole = {k: v.clone() for k, v in paged.items()}
    budget = 4096
    base_page = 0
    while True:
        t0, g0 = _resident(compiled, base_page)
        pages = (
            torch.from_numpy(t0[:P].copy()), torch.from_numpy(g0[:P].copy()),
            torch.from_numpy(t0[P:].copy()), torch.from_numpy(g0[P:].copy()),
        )
        halted = event_step.plain_trace_steps(compiled, paged, keys, params, pages, base_page * P, budget)
        reads = torch.isfinite(paged["src_next"][:, 0]) & ~halted
        if not bool(reads.any()):
            break
        cursor = paged["trc_cursor"].to(torch.int64)
        assert bool((cursor[reads] + macro >= base_page * P + 2 * P).all())
        base_page = int(cursor[reads].min()) // P
    # One window holding the whole trace: no lane ever stalls.
    span = compiled.trace_times.size
    whole_t = torch.from_numpy(np.concatenate([compiled.trace_times, np.full(span, np.inf, np.float32)]))
    whole_g = torch.from_numpy(np.concatenate([compiled.trace_tenants, np.zeros(span, np.int32)]))
    halted = event_step.plain_trace_steps(
        compiled, whole, keys, params, (whole_t[:span], whole_g[:span], whole_t[span:], whole_g[span:]),
        0, budget,
    )
    assert bool(halted.all())
    for leaf in paged:
        assert torch.equal(paged[leaf], whole[leaf]), leaf


def test_untraced_block_path_refuses_a_traced_model():
    """block_steps and plain_block_step would fire the traced source with
    no pages: both raise, naming trace_steps."""
    model = TRACE_MODELS["short-trace"](tmodel)
    compiled = TCompiled(model)
    params = convert.params_from_numpy(params_of(model, 4))
    keys = rng.split(rng.PRNGKey(1), 4)
    state = compiled.init_state(keys, params)
    with pytest.raises(ValueError, match="trace_steps"):
        event_step.block_steps(compiled, state, keys, 0, 1, params)
    with pytest.raises(ValueError, match="trace_steps"):
        event_step.plain_block_step(compiled, state, event_step.block_uniforms(compiled, keys, 0), params)
