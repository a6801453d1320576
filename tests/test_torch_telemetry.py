"""Windowed telemetry in the port against the JAX package.

- The spec and the host-side window math: every case of
  tests/unit/test_telemetry_spec.py, run through both packages, with the
  same results (or the same error) from each.
- The window index at window edges: the compiled JAX step multiplies by
  the float32 reciprocal of window_s where its host twin divides (ROADMAP
  C); the port's step follows the compiled step, through jit, the lax
  scan and the Pallas interpreter alike.
- End to end: ``run_ensemble(device="cpu").timeseries`` against JAX's,
  field by field: integer series identical, the spread identical, float
  series within rel 1e-4 (fault occupancy within rel 1e-5: the port's
  fault windows differ from JAX's by a few ulp, ROADMAP C).
- The invariants of tests/integration/test_tpu_telemetry.py on the
  port: window sums equal the whole-run counters, the chaos counters
  partition exactly, fault occupancy tracks the duty cycle, the spread
  brackets the mean, telemetry changes nothing of the simulation, a
  metric subset allocates only its buffers, the DataFrame schema.

The block-by-block parity of the step's telemetry sites is in
test_torch_event_step.py; whole-run parity of the integer totals with
telemetry on is in test_torch_engine.py.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import run_ensemble as j_run  # noqa: E402
from happysim_tpu.tpu import telemetry as jtel  # noqa: E402
from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu.tpu.kernels import build_block_step  # noqa: E402
from happysim_tpu.tpu.mesh import replica_mesh  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import rng  # noqa: E402
from happysim_tpu_torch import run_ensemble as t_run  # noqa: E402
from happysim_tpu_torch import telemetry as ttel  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.engine import _resolve_params, percentile_over_replicas  # noqa: E402
from happysim_tpu_torch.faults import duty_cycle  # noqa: E402
from happysim_tpu_torch.kernels.event_step import _static_args  # noqa: E402
from test_torch_telemetry_models import TELEMETRY_MODELS, chaos_line, feedback  # noqa: E402

FLOAT_RTOL = 1e-4
FAULT_OCCUPANCY_RTOL = 1e-5


# -- the spec and the window math ---------------------------------------------
def _outcome(fn):
    """fn()'s value, or the type and message of what it raised."""
    try:
        return ("value", fn())
    except Exception as err:  # noqa: BLE001 - compared across packages
        return ("raised", type(err).__name__, str(err))


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _case_model_telemetry(tel, mod):
    model = mod.mm1_model(horizon_s=10.0)
    bad = _outcome(lambda: model.telemetry(window_s=0.0))
    unset = model.telemetry_spec is None
    spec = model.telemetry(window_s=2.0)
    return bad, unset, model.telemetry_spec is spec, spec.metrics == tel.DEFAULT_METRICS


def _case_validate_checks_spec(tel, mod):
    model = mod.mm1_model(horizon_s=10.0)
    model.telemetry_spec = tel.TelemetrySpec(window_s=-1.0)
    return _outcome(model.validate)


def _case_signatures(tel, mod):
    a = tel.TelemetrySpec(window_s=1.5, metrics=("latency", "rates"))
    b = tel.TelemetrySpec(window_s=1.5, metrics=("latency", "rates"))
    c = tel.TelemetrySpec(window_s=1.5, metrics=("rates", "latency"))
    return a.signature(), b.signature(), c.signature(), mod.EnsembleModel(horizon_s=4.0).telemetry_spec


def _case_random_window_math(tel, mod):
    gen = np.random.default_rng(5)
    out = []
    for window_s, n, horizon, warmup in ((0.625, 64, 40.0, 10.0), (1.875, 64, 120.0, 20.0), (3.0, 4, 10.0, 2.0)):
        times = gen.uniform(-1.0, horizon * 1.1, 2000).astype(np.float32)
        out.append([tel.window_index(float(t), window_s, n) for t in times])
        out.append(tel.window_edges(window_s, n))
        out.append(tel.window_edges(window_s, n, horizon_s=horizon))
        out.append(tel.measured_window_lengths(window_s, n, horizon, warmup))
    return out


SPEC_CASES = {
    # TestValidation
    "rejects-nonpositive-window": lambda tel, mod: [
        _outcome(lambda: tel.TelemetrySpec(window_s=bad).validate(10.0)) for bad in (0.0, -1.0)
    ],
    "rejects-single-window": lambda tel, mod: [
        _outcome(lambda: tel.TelemetrySpec(window_s=w).validate(10.0)) for w in (10.0, 50.0)
    ],
    "rejects-more-than-max-windows": lambda tel, mod: [
        _outcome(lambda: tel.TelemetrySpec(window_s=10.0 / (tel.MAX_WINDOWS + 1)).validate(10.0)),
        _outcome(lambda: tel.TelemetrySpec(window_s=10.0 / tel.MAX_WINDOWS).validate(10.0)),
        tel.MIN_WINDOWS, tel.MAX_WINDOWS,
    ],
    "rejects-unknown-and-empty-metrics": lambda tel, mod: [
        _outcome(lambda: tel.TelemetrySpec(window_s=1.0, metrics=("latency", "bogus")).validate(10.0)),
        _outcome(lambda: tel.TelemetrySpec(window_s=1.0, metrics=()).validate(10.0)),
    ],
    "model-telemetry-validates-at-call": _case_model_telemetry,
    "model-validate-checks-spec": _case_validate_checks_spec,
    # TestWindowMath
    "n-windows-ceils-indivisible-horizon": lambda tel, mod: [
        tel.TelemetrySpec(window_s=w).n_windows(10.0) for w in (3.0, 2.5, 0.1)
    ],
    "boundary-event-belongs-to-later-window": lambda tel, mod: [
        tel.window_index(*args) for args in ((0.0, 1.0, 8), (3.0, 1.0, 8), (2.999999, 1.0, 8), (1.5, 0.5, 8))
    ],
    "horizon-end-event-clips-into-last-window": lambda tel, mod: [
        tel.window_index(*args) for args in ((8.0, 1.0, 8), (1e9, 1.0, 8), (-0.5, 1.0, 8))
    ],
    "edges-last-window-open-then-clamped": lambda tel, mod: [
        tel.window_edges(3.0, 4), tel.window_edges(3.0, 4, horizon_s=10.0)
    ],
    "measured-lengths-respect-warmup-and-horizon": lambda tel, mod: tel.measured_window_lengths(
        3.0, 4, horizon_s=10.0, warmup_s=2.0
    ),
    "signature-roundtrip-identity": _case_signatures,
    # window_index, window_edges and measured_window_lengths on random inputs
    "random-window-math": _case_random_window_math,
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_and_window_math_match_jax(case):
    expected = SPEC_CASES[case](jtel, jmodel)
    got = SPEC_CASES[case](ttel, tmodel)
    assert _same(got, expected), (got, expected)


def test_spec_pins_the_boundary_values():
    """The values tests/unit/test_telemetry_spec.py pins, on the port."""
    assert [ttel.TelemetrySpec(window_s=w).n_windows(10.0) for w in (3.0, 2.5, 0.1)] == [4, 4, 100]
    assert ttel.window_index(3.0, 1.0, 8) == 3 and ttel.window_index(2.999999, 1.0, 8) == 2
    assert ttel.window_index(8.0, 1.0, 8) == 7 and ttel.window_index(-0.5, 1.0, 8) == 0
    np.testing.assert_array_equal(
        ttel.measured_window_lengths(3.0, 4, horizon_s=10.0, warmup_s=2.0), [1.0, 3.0, 3.0, 1.0]
    )


# -- the window index at the edges --------------------------------------------
def _edge_times(window_s: float, n_windows: int) -> np.ndarray:
    """Every window edge k * window_s and two ulps either side, and random
    times, as float32."""
    ws = np.float32(window_s)
    times = []
    for k in range(n_windows + 1):
        edge = np.float32(k) * ws
        below, above = edge, edge
        times.append(edge)
        for _ in range(2):
            below = np.nextafter(below, np.float32(-np.inf))
            above = np.nextafter(above, np.float32(np.inf))
            times += [below, above]
    gen = np.random.default_rng(0)
    times = np.asarray(times, np.float32)
    return np.concatenate([times[times >= 0], gen.uniform(0, n_windows * window_s, 50000).astype(np.float32)])


@pytest.mark.parametrize("horizon, n_windows", [(40.0, 64), (120.0, 64), (160.0, 64), (10.0, 7), (30.0, 13)])
def test_window_index_follows_the_compiled_step(horizon, n_windows):
    """The port's _tel_windex equals JAX's _tel_windex under jit at every
    edge, one and two ulps either side and on 50,000 random times: both
    multiply by float32(1 / window_s)."""
    jm, tm = jmodel.mm1_model(8.0, 10.0, horizon), tmodel.mm1_model(8.0, 10.0, horizon)
    jm.telemetry(window_s=horizon / n_windows)
    tm.telemetry(window_s=horizon / n_windows)
    jc, tc = JCompiled(jm), TCompiled(tm)
    times = _edge_times(jc.telemetry.window_s, jc.nW)
    expected = np.asarray(jax.jit(jax.vmap(jc._tel_windex))(jnp.asarray(times)))
    got = tc._tel_windex(torch.from_numpy(times)).numpy()
    np.testing.assert_array_equal(got, expected)


def test_window_index_differs_from_the_host_twin_within_an_ulp_of_an_edge():
    """With 1.875 s windows (bench.py's _hetero_model at 64 windows) the
    reciprocal 1 / 1.875 is inexact in float32, and the compiled step and
    the host twin window_index put some times within an ulp of an edge
    in different windows; the port's step takes the compiled step's."""
    tm = tmodel.mm1_model(8.0, 10.0, 120.0)
    tm.telemetry(window_s=120.0 / 64)
    tc = TCompiled(tm)
    times = _edge_times(tc.telemetry.window_s, tc.nW)
    step = tc._tel_windex(torch.from_numpy(times)).numpy()
    twin = np.array([ttel.window_index(float(t), tc.telemetry.window_s, tc.nW) for t in times])
    differ = np.nonzero(step != twin)[0]
    assert differ.size > 0
    assert (np.abs(step[differ] - twin[differ]) == 1).all()


def _completion_probe(jc, times):
    """A state whose only event is a completion at each lane's time."""
    n = len(times)
    params = {"src_rate": jnp.full((n, 1), 8.0, jnp.float32), "srv_mean": jnp.full((n, 1), 0.1, jnp.float32)}
    state = dict(jax.vmap(jc.init_state)(jax.random.split(jax.random.PRNGKey(0), n), params))
    state.pop("key")
    state["src_next"] = jnp.full((n, 1), jnp.inf, jnp.float32)
    state["srv_slot_done"] = jnp.asarray(times)[:, None, None]
    return state, params


def test_window_index_of_the_lax_scan_and_the_pallas_interpreter():
    """The completion counter of a step whose one event lies within an ulp
    of an edge (times where multiplying by the reciprocal and dividing
    disagree): the lax scan and the Pallas kernel in interpret mode book
    it in the window the port's _tel_windex gives."""
    horizon = 120.0
    jm, tm = jmodel.mm1_model(8.0, 10.0, horizon), tmodel.mm1_model(8.0, 10.0, horizon)
    jm.telemetry(window_s=horizon / 64)
    tm.telemetry(window_s=horizon / 64)
    jc, tc = JCompiled(jm), TCompiled(tm)
    times = _edge_times(jc.telemetry.window_s, jc.nW)[:-50000]
    twin = np.array([jtel.window_index(float(t), jc.telemetry.window_s, jc.nW) for t in times])
    port = tc._tel_windex(torch.from_numpy(times)).numpy()
    picked = np.concatenate([np.nonzero(port != twin)[0], np.arange(16)])[:16]
    times = times[picked]
    state, params = _completion_probe(jc, times)
    U = jnp.full((len(times), 1, jc.n_draws), 0.5, jnp.float32)
    step = jc.make_step(horizon, external_u=True)

    def one(s, u, p):
        (out, _), _ = lax.scan(step, (s, p), u)
        return out

    scanned = jax.jit(jax.vmap(one))(state, U, params)
    block_fn, _meta = build_block_step(jc, horizon, 1, len(times), interpret=True)
    kernel = block_fn(state, U, params)
    expected = tc._tel_windex(torch.from_numpy(times)).numpy()
    for out in (scanned, kernel):
        windows = np.argmax(np.asarray(out["tel_srv_completed"])[:, :, 0], axis=1)
        np.testing.assert_array_equal(windows, expected)
    assert (expected != twin[picked]).any()


def test_spread_percentile_is_jax_percentile():
    """percentile_over_replicas equals jnp.percentile(axis=0) under jit,
    bit for bit, on integer-valued counts (as tel_sink_count is) and on
    general floats, for replica counts whose interpolation position has
    a fractional part and for ones where it is whole."""
    gen = np.random.default_rng(1)
    for n in (16, 64, 100, 257, 1000):
        for x in (
            gen.integers(0, 400, size=(n, 12, 1)).astype(np.float32),
            gen.gamma(2.0, 3.0, size=(n, 12, 1)).astype(np.float32),
        ):
            for pct in (10.0, 90.0):
                expected = np.asarray(jax.jit(lambda a, q=pct: jnp.percentile(a, q, axis=0))(x))
                got = percentile_over_replicas(torch.from_numpy(x), pct).numpy()
                np.testing.assert_array_equal(got, expected)


# -- end to end against JAX ---------------------------------------------------
E2E_CASES = {
    "warmup-inside": (TELEMETRY_MODELS["warmup-inside"], 64, 960),
    "chaos-line": (TELEMETRY_MODELS["chaos-line"], 64, None),
    "bench-chaos": (TELEMETRY_MODELS["bench-chaos"], 64, 4000),
    "feedback": (TELEMETRY_MODELS["feedback"], 32, 2000),
}


@pytest.mark.parametrize("name", sorted(E2E_CASES))
def test_timeseries_matches_jax_field_by_field(name):
    build, n, max_events = E2E_CASES[name]
    jm, tm = build(jmodel), build(tmodel)
    if max_events is None:
        max_events = 4000
    jr = j_run(jm, n_replicas=n, seed=7, max_events=max_events, mesh=replica_mesh(jax.devices()[:1]))
    tr = t_run(tm, n_replicas=n, seed=7, max_events=max_events, device="cpu")
    js, ts = jr.timeseries, tr.timeseries
    for name_ in ("window_s", "horizon_s", "warmup_s", "n_windows", "n_replicas", "metrics"):
        assert getattr(ts, name_) == getattr(js, name_), name_
    compared = 0
    for field in js._ARRAY_FIELDS:
        expected, got = getattr(js, field), getattr(ts, field)
        assert (expected is None) == (got is None), field
        if expected is None:
            continue
        compared += 1
        expected, got = np.asarray(expected), np.asarray(got)
        assert got.shape == expected.shape and got.dtype == expected.dtype, field
        if np.issubdtype(expected.dtype, np.integer) or field.startswith("replica_throughput_p"):
            np.testing.assert_array_equal(got, expected, err_msg=field)
        else:
            rtol = FAULT_OCCUPANCY_RTOL if field == "fault_occupancy" else FLOAT_RTOL
            np.testing.assert_allclose(got, expected, rtol=rtol, atol=1e-12, err_msg=field)
    assert compared >= 12
    assert tr.sink_count == jr.sink_count and tr.server_completed == jr.server_completed


# -- invariants (tests/integration/test_tpu_telemetry.py) ---------------------
SIM_FIELDS_EXCLUDED = {
    "wall_seconds", "events_per_second", "timeseries", "compile_seconds",
    "engine_path", "kernel_chaos",
}


def assert_simulation_identical(a, b):
    for field in dataclasses.fields(a):
        if field.name in SIM_FIELDS_EXCLUDED:
            continue
        left, right = getattr(a, field.name), getattr(b, field.name)
        if isinstance(left, np.ndarray):
            assert np.array_equal(left, right), field.name
        else:
            assert left == right, f"{field.name}: {left!r} != {right!r}"


def _mm1(window_s=None):
    model = tmodel.mm1_model(lam=8.0, mu=10.0, horizon_s=12.0, warmup_s=2.0)
    if window_s is not None:
        model.telemetry(window_s=window_s)
    return model


def test_mm1_window_sums_equal_whole_run():
    result = t_run(_mm1(1.5), n_replicas=32, seed=11, max_events=480, device="cpu")
    ts = result.timeseries
    assert ts is not None and ts.n_windows == 8
    assert ts.sink_count.sum(axis=0).tolist() == result.sink_count
    assert np.array_equal(ts.sink_hist.sum(axis=0), result.sink_hist)
    assert ts.server_completed.sum(axis=0).tolist() == result.server_completed
    denominator = result.n_replicas * ts.measured_len_s
    whole_depth = result.server_mean_queue_len[0] * denominator.sum()
    windowed_depth = (np.asarray(ts.server_mean_queue_len)[:, 0] * denominator).sum()
    assert windowed_depth == pytest.approx(whole_depth, rel=1e-5)
    whole_busy = result.server_utilization[0] * denominator.sum()
    windowed_busy = (np.asarray(ts.server_utilization)[:, 0] * denominator).sum()
    assert windowed_busy == pytest.approx(whole_busy, rel=1e-5)


def test_chaos_counters_all_partition_exactly():
    result = t_run(chaos_line(tmodel), n_replicas=64, seed=7, device="cpu")
    ts = result.timeseries
    pairs = [
        (ts.sink_count, result.sink_count),
        (ts.server_completed, result.server_completed),
        (ts.server_dropped, result.server_dropped),
        (ts.server_timed_out, result.server_timed_out),
        (ts.server_retried, result.server_retried),
        (ts.server_fault_dropped, result.server_fault_dropped),
        (ts.server_fault_retried, result.server_fault_retried),
        (ts.limiter_admitted, result.limiter_admitted),
        (ts.limiter_dropped, result.limiter_dropped),
        (ts.transit_dropped, result.transit_dropped),
    ]
    for series, whole in pairs:
        assert series.sum(axis=0).tolist() == whole
    assert int(ts.network_lost.sum()) == result.network_lost
    assert np.array_equal(ts.sink_hist.sum(axis=0), result.sink_hist)
    assert result.network_lost > 0
    assert result.server_fault_dropped[0] > 0
    assert result.server_fault_retried[0] > 0
    assert result.limiter_dropped[0] > 0


def test_fault_occupancy_tracks_duty_cycle():
    result = t_run(chaos_line(tmodel), n_replicas=256, seed=5, device="cpu")
    occupancy = np.asarray(result.timeseries.fault_occupancy)[:, 0]
    expected = duty_cycle(0.2, 1.0)
    assert occupancy[:5].mean() == pytest.approx(expected, rel=0.5)
    assert (occupancy >= 0.0).all() and (occupancy <= 1.0).all()


def test_spread_percentiles_bracket_the_mean():
    result = t_run(_mm1(1.5), n_replicas=64, seed=2, max_events=960, device="cpu")
    ts = result.timeseries
    busy = slice(2, ts.n_windows)
    assert (ts.replica_throughput_p10[busy, 0] <= ts.replica_throughput_mean[busy, 0]).all()
    assert (ts.replica_throughput_mean[busy, 0] <= ts.replica_throughput_p90[busy, 0]).all()
    rebuilt = ts.replica_throughput_mean[:, 0] * result.n_replicas * ts.window_len_s
    np.testing.assert_allclose(rebuilt, ts.sink_count[:, 0], rtol=1e-6)


def test_mixed_feedback_router_with_sink_edge_latency():
    result = t_run(feedback(tmodel), n_replicas=16, seed=4, max_events=2000, device="cpu")
    base = t_run(feedback(tmodel, None), n_replicas=16, seed=4, max_events=2000, device="cpu")
    ts = result.timeseries
    assert ts.sink_count.sum(axis=0).tolist() == result.sink_count
    assert np.array_equal(ts.sink_hist.sum(axis=0), result.sink_hist)
    assert_simulation_identical(result, base)


def test_simulation_bit_identical_with_and_without_telemetry():
    with_tel = t_run(_mm1(1.5), n_replicas=32, seed=11, max_events=480, device="cpu")
    without = t_run(_mm1(), n_replicas=32, seed=11, max_events=480, device="cpu")
    assert with_tel.timeseries is not None and without.timeseries is None
    assert_simulation_identical(with_tel, without)


def test_chaos_simulation_bit_identical():
    with_tel = t_run(chaos_line(tmodel), n_replicas=32, seed=7, device="cpu")
    without = t_run(chaos_line(tmodel, None), n_replicas=32, seed=7, device="cpu")
    assert_simulation_identical(with_tel, without)


def test_telemetry_free_model_builds_the_same_state_and_arguments():
    """A model whose spec was cleared builds the state of one that never
    had a spec (no tel_ leaf) and the same kernel argument bytes; telemetry
    draws no uniform."""
    never, cleared, enabled = _mm1(), _mm1(1.0), _mm1(1.0)
    cleared.telemetry_spec = None
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(never, TCompiled(never), 4, None).items()}
    keys = rng.split(rng.PRNGKey(0), 4)
    states = [TCompiled(m).init_state(keys, params) for m in (never, cleared, enabled)]
    assert set(states[0]) == set(states[1]) and not any(k.startswith("tel_") for k in states[0])
    assert {k for k in states[2] if k.startswith("tel_")}
    args = [bytes(_static_args(TCompiled(m))) for m in (never, cleared)]
    assert args[0] == args[1]
    assert TCompiled(enabled).n_draws == TCompiled(never).n_draws


def test_metric_subset_allocates_only_requested_buffers():
    model = _mm1()
    model.telemetry(window_s=1.5, metrics=("latency",))
    compiled = TCompiled(model)
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, 2, None).items()}
    state = compiled.init_state(rng.split(rng.PRNGKey(0), 2), params)
    assert {key for key in state if key.startswith("tel_")} == {"tel_sink_sum", "tel_sink_hist"}
    result = t_run(model, n_replicas=8, seed=0, max_events=200, device="cpu")
    ts = result.timeseries
    assert ts.sink_p99_s is not None and ts.sink_count is None
    assert ts.server_mean_queue_len is None and ts.server_completed is None


def test_to_dataframe_schema():
    pandas = pytest.importorskip("pandas")
    result = t_run(_mm1(1.5), n_replicas=16, seed=3, max_events=400, device="cpu")
    frame = result.timeseries.to_dataframe()
    assert isinstance(frame, pandas.DataFrame)
    assert len(frame) == 8
    for column in (
        "window_start_s", "sink[0].count", "sink[0].p99_s",
        "server[0].mean_queue_len", "server[0].utilization", "server[0].completed",
    ):
        assert column in frame.columns
    assert frame["sink[0].count"].sum() == result.sink_count[0]
    assert result.engine_report()["telemetry_windows"] == 8


def test_timeseries_equality_is_field_by_field():
    a = t_run(_mm1(1.5), n_replicas=8, seed=3, max_events=300, device="cpu").timeseries
    b = t_run(_mm1(1.5), n_replicas=8, seed=3, max_events=300, device="cpu").timeseries
    c = t_run(_mm1(1.5), n_replicas=8, seed=4, max_events=300, device="cpu").timeseries
    assert a == b and not a == c
