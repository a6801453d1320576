"""The port's result surface against the JAX package's: the run summary,
the telemetry series as ``Data``, the ``Data`` and ``Instant`` copies
they rest on, and the profiler scopes.

- ``EnsembleResult.summary()``: the same field dicts build JAX's result
  and the port's (as tests/unit/test_ensemble_summary_chaos.py builds
  JAX's), and their summaries' ``to_dict()`` and ``str()`` are equal but
  for the fields that differ by design (ROADMAP C): ``backend``, and the
  ``Engine`` entity's ``engine_path``, ``kernel_decline`` and
  ``escape_hatches``. Whole runs are in test_torch_summary_runs.py.
- ``EnsembleTimeseries.to_data()`` of a telemetry model in both packages:
  the same keys, the same sample times, the values within the telemetry
  tests' rel 1e-4.
- ``data.Data`` / ``BucketedData`` against ``happysim_tpu.instrumentation
  .data`` on the same numpy arrays, method for method, and the port's
  ``Instant`` against ``core.temporal.Instant`` on a grid of seconds.
- The scopes ``hs.macro_block`` and ``hs.reduce`` under torch.profiler on
  the CPU: one each on the one-call scan, one a segment on a segmented
  run, one a stream step on a traced run, none on the chain form; the
  CPU's plain step runs outside ``hs.kernel``.
"""

import collections
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.core import temporal as jtemporal  # noqa: E402
from happysim_tpu.instrumentation import data as jdata  # noqa: E402
from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import run_ensemble as j_run  # noqa: E402
from happysim_tpu.tpu.mesh import replica_mesh  # noqa: E402
from happysim_tpu_torch import data as tdata  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import run_ensemble as t_run  # noqa: E402
from happysim_tpu_torch import summary as tsummary  # noqa: E402
from happysim_tpu_torch import temporal as ttemporal  # noqa: E402
from happysim_tpu_torch import flash_crowd_trace  # noqa: E402
from test_torch_telemetry_models import TELEMETRY_MODELS  # noqa: E402

# The port's own fields (ROADMAP C): the backend, and what the Engine
# entity says of the path.
ENGINE_OWN = ("engine_path", "kernel_decline", "escape_hatches")
TELEMETRY_RTOL = 1e-4


# -- summary() on field dicts ---------------------------------------------------
def _fields(**overrides) -> dict:
    base = dict(
        n_replicas=4,
        horizon_s=10.0,
        simulated_events=100,
        wall_seconds=0.5,
        events_per_second=200.0,
        sink_count=[40],
        sink_mean_latency_s=[0.2],
        sink_p50_s=[0.1],
        sink_p99_s=[0.9],
        sink_hist=np.zeros((1, tengine.HIST_BINS), np.int32),
        server_completed=[42],
        server_dropped=[1],
        server_outage_dropped=[0],
        server_utilization=[0.5],
        server_mean_wait_s=[0.05],
        server_mean_queue_len=[0.4],
        server_timed_out=[0],
        server_retried=[0],
        transit_dropped=[0],
        limiter_admitted=[],
        limiter_dropped=[],
    )
    base.update(overrides)
    return base


def _two_servers(**overrides) -> dict:
    return _fields(**{
        "server_completed": [42, 10],
        "server_dropped": [1, 0],
        "server_outage_dropped": [0, 0],
        "server_utilization": [0.5, 0.1],
        "server_mean_wait_s": [0.05, 0.0],
        "server_mean_queue_len": [0.4, 0.0],
        "server_timed_out": [0, 0],
        "server_retried": [0, 0],
        "transit_dropped": [0, 0],
        **overrides,
    })


FIELD_CASES = {
    "clean": _fields(),
    "network-lost": _fields(network_lost=257),
    "faults-and-retries": _two_servers(
        server_fault_dropped=[3, 5],
        server_fault_retried=[7, 0],
        server_timed_out=[0, 2],
        server_retried=[1, 0],
        server_outage_dropped=[4, 0],
        transit_dropped=[0, 4],
    ),
    "hedges": _two_servers(server_hedged=[2, 2], server_hedge_wins=[1, 0]),
    "zero-totals": _fields(server_fault_dropped=[0], server_hedged=[0], network_lost=0),
    "resilience": _two_servers(
        resilience_features=("circuit_breaker", "load_shed", "retry_budget"),
        server_breaker_dropped=[9, 0],
        breaker_tripped=[2, 0],
        breaker_open_fraction=[0.125, 0.0],
        server_shed_dropped=[0, 6],
        server_budget_dropped=[3, 1],
    ),
    "resilience-declared-silent": _fields(
        resilience_features=("circuit_breaker",),
        server_breaker_dropped=[0],
        breaker_tripped=[0],
        breaker_open_fraction=[0.0],
    ),
    "consensus": _two_servers(
        consensus_features=("network_partitions", "quorum", "leader_election"),
        network_partitioned=31,
        server_quorum_dropped=[5, 2],
        quorum_dark_fraction=1 / 6,
        leader_changes=48,
        time_without_leader_fraction=0.75,
    ),
    "consensus-declared-silent": _fields(consensus_features=("quorum",), server_quorum_dropped=[0]),
    "limiters": _fields(limiter_admitted=[30, 12], limiter_dropped=[3, 0]),
    "truncated": _fields(truncated_replicas=2),
    "kernel-decline": _fields(
        engine_path="scan",
        kernel_decline="Pallas kernel declined (router policy 'least_outstanding' is adaptive)",
        blocks_total=96,
    ),
    "chain": _fields(engine_path="chain"),
    "several-sinks": _fields(
        sink_count=[40, 7],
        sink_mean_latency_s=[0.2, 1.5],
        sink_p50_s=[0.1, 1.0],
        sink_p99_s=[0.9, 3.0],
        sink_hist=np.zeros((2, tengine.HIST_BINS), np.int32),
        wall_seconds=0.0,
    ),
}


def _without_own_fields(summary):
    """The summary's dict and text with the fields that differ by design
    set aside: the backend, and the Engine entity's path fields."""
    entities = []
    for entity in summary.entities:
        if entity.kind == "Engine":
            extra = {k: v for k, v in entity.extra.items() if k not in ENGINE_OWN}
            entity = dataclasses.replace(entity, extra=extra)
        entities.append(entity)
    view = dataclasses.replace(summary, entities=entities, backend="-")
    return view.to_dict(), str(view)


@pytest.mark.parametrize("case", sorted(FIELD_CASES))
def test_summary_of_the_same_fields_equals_jax(case):
    fields = FIELD_CASES[case]
    expected = jengine.EnsembleResult(**fields).summary()
    got = tengine.EnsembleResult(**fields).summary()
    assert isinstance(got, tsummary.SimulationSummary)
    assert _without_own_fields(got) == _without_own_fields(expected)
    assert got.simulated_seconds == expected.simulated_seconds
    assert got.events_per_second == expected.events_per_second
    assert [(e.name, e.kind) for e in got.entities] == [(e.name, e.kind) for e in expected.entities]


@pytest.mark.parametrize("case", sorted(FIELD_CASES))
def test_summary_engine_entity_is_the_port_s(case):
    """The Engine entity carries the path as the port reports it, and no
    escape hatch (the port has no XLA or Pallas switch); the backend
    names the device."""
    fields = FIELD_CASES[case]
    result = tengine.EnsembleResult(**fields)
    summary = result.summary()
    (engine,) = [e for e in summary.entities if e.kind == "Engine"]
    assert summary.entities[-1] is engine and engine.name == "engine"
    assert engine.extra["engine_path"] == result.engine_path
    assert "escape_hatches" not in engine.extra
    assert engine.extra.get("kernel_decline", "") == result.kernel_decline
    assert engine.extra.get("macro_blocks_run", 0) == result.blocks_total
    assert summary.backend == "cuda"
    assert tengine.EnsembleResult(**fields, device_name="cpu").summary().backend == "cpu"
    assert summary.completed == (result.truncated_replicas == 0)


def test_summary_is_a_view_of_the_fields():
    """The extras are the result's own values, not copies made on a
    device."""
    result = tengine.EnsembleResult(**FIELD_CASES["consensus"])
    summary = result.summary()
    servers = [e for e in summary.entities if e.kind == "Server"]
    assert [e.extra["utilization"] for e in servers] == result.server_utilization
    (consensus,) = [e for e in summary.entities if e.kind == "Consensus"]
    assert consensus.extra["quorum_dark_fraction"] is result.quorum_dark_fraction


# -- to_data() ------------------------------------------------------------------
def test_to_data_equals_jax_s_on_a_telemetry_model():
    build = TELEMETRY_MODELS["warmup-inside"]
    mesh = replica_mesh(jax.devices("cpu")[:1])
    jr = j_run(build(jmodel), n_replicas=32, seed=7, max_events=960, mesh=mesh)
    tr = t_run(build(tmodel), n_replicas=32, seed=7, max_events=960, device="cpu")
    expected, got = jr.timeseries.to_data(), tr.timeseries.to_data()
    series = tr.timeseries.series()
    assert set(series) >= {"window_start_s", "sink[0].p50_s"}
    assert list(got) == list(expected) == [k for k in series if k != "window_start_s"]
    for name, data in got.items():
        assert isinstance(data, tdata.Data) and data.name == name
        np.testing.assert_array_equal(data.times_s, expected[name].times_s, err_msg=name)
        np.testing.assert_array_equal(data.times_s, series["window_start_s"], err_msg=name)
        np.testing.assert_allclose(
            data.values, expected[name].values, rtol=TELEMETRY_RTOL, atol=1e-12, err_msg=name
        )
        np.testing.assert_array_equal(data.values, series[name], err_msg=name)


# -- Data, BucketedData and Instant -----------------------------------------------
def _samples(seed: int, n: int):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 20.0, n))
    if n > 3:
        times[2] = times[1]  # a tie
    values = rng.lognormal(0.0, 1.0, n)
    return times, values


def _results(mod, times, values, via_add: bool) -> dict:
    """Every method's result on the samples, in plain Python values."""
    instant_of = jtemporal.Instant if mod is jdata else ttemporal.Instant
    if via_add:
        data = mod.Data("x")
        for t, v in zip(times, values):
            data.record(instant_of.from_seconds(float(t)), v)
    else:
        data = mod.Data.from_arrays(times, values, name="x")
    out = {
        "len": len(data), "repr": repr(data),
        "times_ns": [t.nanoseconds for t in data.times], "times_s": data.times_s.tolist(),
        "values": data.values, "iter": [(t.nanoseconds, v) for t, v in data],
        "count": data.count(), "sum": data.sum(), "mean": data.mean(), "min": data.min(),
        "max": data.max(), "std": data.std(), "p50": data.p50(), "p99": data.p99(),
        "percentiles": [data.percentile(p) for p in (0, 10, 25, 50, 90, 99, 99.9, 100)],
    }
    for lo, hi in ((2.0, 7.5), (0.0, 20.0), (19.0, 25.0)):
        part = data.between(lo, hi)
        same = data.between(instant_of.from_seconds(lo), instant_of.from_seconds(hi))
        out[f"between {lo} {hi}"] = (part.name, part._times_ns, part._values, same._times_ns)
    for window in (0.5, 1.0, 3.0):
        rate = data.rate(window)
        out[f"rate {window}"] = (rate.name, rate._times_ns, rate._values)
        bucketed = data.bucket(window)
        out[f"bucket {window}"] = (
            len(bucketed), bucketed.window_s, [s.nanoseconds for s in bucketed.starts],
            bucketed.counts, bucketed.means, bucketed.mins, bucketed.maxes, bucketed.sums,
            bucketed.p50s, bucketed.p99s, bucketed.p999s,
        )
    out["rate default"] = data.rate()._values
    return out


@pytest.mark.parametrize("via_add", [False, True], ids=["from_arrays", "add"])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 64, 500])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_data_and_buckets_equal_jax_s(seed, n, via_add):
    times, values = _samples(seed, n)
    assert _results(tdata, times, values, via_add) == _results(jdata, times, values, via_add)


def test_data_from_float32_arrays_equals_jax_s():
    times, values = _samples(5, 100)
    times, values = times.astype(np.float32), values.astype(np.float32)
    assert _results(tdata, times, values, False) == _results(jdata, times, values, False)


SECONDS = sorted({
    *np.linspace(0.0, 160.0, 257).tolist(), 0.1, 0.2, 0.3, 1 / 3, 2.5e-10, 5e-10, 1.5e-9,
    2.5e-9, 1e-9, 123456.789012345, 1e6 + 0.123456789, -0.7, -2.5e-9, 0.625 * 13, 7.0,
    *np.random.default_rng(3).uniform(0.0, 40.0, 64).tolist(),
})


@pytest.mark.parametrize("seconds", SECONDS)
def test_instant_round_trips_as_jax_s(seconds):
    got, expected = ttemporal.Instant.from_seconds(seconds), jtemporal.Instant.from_seconds(seconds)
    assert got.nanoseconds == expected.nanoseconds
    assert got.to_seconds() == expected.to_seconds()
    assert ttemporal.as_instant(seconds).nanoseconds == jtemporal.as_instant(seconds).nanoseconds
    span = got - ttemporal.Instant.Epoch
    assert span.to_seconds() == (expected - jtemporal.Instant.Epoch).to_seconds()
    assert span == ttemporal.Duration(expected.nanoseconds)
    assert repr(span) == repr(expected - jtemporal.Instant.Epoch)
    assert got == ttemporal.Instant(expected.nanoseconds)
    assert (got == ttemporal.Instant.Epoch) == (expected.nanoseconds == 0)
    assert repr(got) == repr(expected)


# -- profiler scopes --------------------------------------------------------------
def _scopes(run) -> tuple:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        result = run()
    counts = collections.Counter(e.name for e in prof.events() if e.name.startswith("hs."))
    return result, counts


# Short runs: the profiler records every torch op of the CPU's plain step.
def _mm1():
    model = tmodel.mm1_model(8.0, 10.0, 2.0)
    model.macro_block = 8
    return model


def _traced_model():
    trace = flash_crowd_trace(10.0, 40.0, 1.0, 1.5, 3.0, seed=11, chunk_len=8)
    model = tmodel.EnsembleModel(horizon_s=3.0, macro_block=4)
    srv = model.server(concurrency=4, service_mean=0.004, queue_capacity=64)
    model.connect(model.trace_arrivals(trace), srv)
    model.connect(srv, model.sink())
    return model


def test_scopes_on_the_one_call_scan():
    result, counts = _scopes(lambda: t_run(_mm1(), n_replicas=4, device="cpu", max_events=64))
    assert result.engine_path == "scan"
    assert counts == {"hs.macro_block": 1, "hs.reduce": 1}


def test_scopes_on_a_segmented_run():
    snaps = []
    result, counts = _scopes(lambda: t_run(
        _mm1(), n_replicas=4, device="cpu", max_events=64, checkpoint_every_s=0.0,
        checkpoint_callback=snaps.append,
    ))
    per_segment = -(-result.max_blocks // tengine.CHECKPOINT_SEGMENTS)
    segments = -(-result.max_blocks // per_segment)
    assert segments > 1 and len(snaps) == segments - 1
    assert counts == {"hs.macro_block": segments, "hs.reduce": 1}


def test_scopes_on_a_traced_run():
    result, counts = _scopes(
        lambda: t_run(_traced_model(), n_replicas=4, device="cpu", max_events=512)
    )
    assert result.trace_stream_steps > 1
    assert counts == {"hs.macro_block": result.trace_stream_steps, "hs.reduce": 1}


def test_no_scope_on_the_chain_form():
    result, counts = _scopes(lambda: t_run(_mm1(), n_replicas=4, device="cpu"))
    assert result.engine_path == "chain"
    assert counts == {}


def test_engine_report_names_jax_s_scopes():
    model = jmodel.mm1_model(8.0, 10.0, 5.0)
    mesh = replica_mesh(jax.devices("cpu")[:1])
    expected = j_run(model, n_replicas=4, seed=0, max_events=64, mesh=mesh).engine_report()
    got = t_run(tmodel.mm1_model(8.0, 10.0, 5.0), n_replicas=4, device="cpu", max_events=64)
    assert got.engine_report()["profiler_scopes"] == expected["profiler_scopes"]
    assert tengine.PROFILER_SCOPES == expected["profiler_scopes"]
