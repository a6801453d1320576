"""Models with a traced source, built with the same code in both packages
(``mod`` is either package's model module; its package's ``traces``
module synthesizes the trace), at the sizes the CPU tests run.

This module holds no test and imports neither package, so the CPU
parity tests (test_torch_traces.py, test_torch_trace_runs.py,
test_torch_trace_model_runs.py, test_torch_trace_kernel.py) and the
card's tests (test_torch_gpu.py, run
where JAX is not installed) share it."""

import importlib


def traces_of(mod):
    """The ``traces`` module beside the model module ``mod``."""
    return importlib.import_module(mod.__name__.rsplit(".", 1)[0] + ".traces")


def flash_regression(mod, chunk_len=32):
    """tests/regression/test_trace_regression.py's model: a flash crowd
    (100/s, 500/s over [4, 6) s, horizon 16 s, seed 42, 2,415 arrivals)
    into a two-slot server (12 ms, queue 16) -> sink, macro_block 16, 2 s
    windows of throughput, latency and rates."""
    trace = traces_of(mod).flash_crowd_trace(
        base_rate=100.0, spike_rate=500.0, spike_start_s=4.0, spike_end_s=6.0,
        horizon_s=16.0, seed=42, chunk_len=chunk_len,
    )
    m = mod.EnsembleModel(horizon_s=16.0, macro_block=16)
    src = m.trace_arrivals(trace)
    srv = m.server(concurrency=2, service_mean=0.012, queue_capacity=16)
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)
    m.telemetry(window_s=2.0, metrics=("throughput", "latency", "rates"))
    return m


def trace_bench(mod, kind="flash", chunk_len=64, horizon_s=16.0, telemetry=True):
    """bench.py's _trace_measure model (its horizon cut by ``horizon_s``):
    the diurnal trace (200/s, amplitude 0.6, period 8 s) or the flash
    crowd (100/s, 500/s over [4, 6) s), seed 11, into a four-slot server
    (4 ms, queue 64) -> sink, macro_block 16, 2 s windows of throughput,
    latency and rates."""
    synth = traces_of(mod)
    if kind == "diurnal":
        trace = synth.diurnal_trace(200.0, 0.6, 8.0, horizon_s, seed=11, chunk_len=chunk_len)
    else:
        trace = synth.flash_crowd_trace(100.0, 500.0, 4.0, 6.0, horizon_s, seed=11, chunk_len=chunk_len)
    m = mod.EnsembleModel(horizon_s=horizon_s, macro_block=16)
    src = m.trace_arrivals(trace)
    srv = m.server(concurrency=4, service_mean=0.004, queue_capacity=64)
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)
    if telemetry:
        m.telemetry(window_s=2.0, metrics=("throughput", "latency", "rates"))
    return m


def zipf_tenants(mod, chunk_len=16):
    """Four Zipf(1.1) tenants at 60/s over 6 s, each arrival's tenant
    counted, into a server (20 ms, queue 8) -> sink; the trace stops at 4
    s (stop_after_s) and 1 s windows count the arrivals per tenant."""
    trace = traces_of(mod).zipf_tenant_trace(60.0, 4, 1.1, 6.0, seed=3, chunk_len=chunk_len)
    m = mod.EnsembleModel(horizon_s=6.0, macro_block=16)
    src = m.trace_arrivals(trace, stop_after_s=4.0)
    srv = m.server(service_mean=0.02, queue_capacity=8)
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)
    m.telemetry(window_s=1.0, metrics=("throughput", "rates"))
    return m


def short_trace(mod, chunk_len=16):
    """A diurnal trace over 3 s in a 6 s run: every lane reads past the
    trace's end (the +inf padding) and drains its server, on the lean
    code without telemetry."""
    trace = traces_of(mod).diurnal_trace(40.0, 0.5, 2.0, 3.0, seed=5, chunk_len=chunk_len)
    m = mod.EnsembleModel(horizon_s=6.0, macro_block=16)
    src = m.trace_arrivals(trace)
    srv = m.server(service_mean=0.03, queue_capacity=16)
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)
    return m


def trace_poisson(mod, chunk_len=16):
    """A traced flash crowd (20/s, 80/s over [1, 2) s, 4 s) and a Poisson
    source at 10/s superposed on one server (25 ms, queue 32) -> sink:
    several sources, the trace second, on the code for them."""
    trace = traces_of(mod).flash_crowd_trace(20.0, 80.0, 1.0, 2.0, 4.0, seed=8, chunk_len=chunk_len)
    m = mod.EnsembleModel(horizon_s=4.0, macro_block=16)
    poisson = m.source(rate=10.0)
    traced = m.trace_arrivals(trace)
    srv = m.server(service_mean=0.025, queue_capacity=32)
    m.connect(poisson, srv)
    m.connect(traced, srv)
    m.connect(srv, m.sink())
    return m


def trace_chaos(mod, chunk_len=16):
    """A traced diurnal stream (50/s, 4 s) into a server with a 60 ms
    deadline and two retries (40 ms service, queue 16), over a 5 ms
    exponential edge into the sink: the chaos code with the trace."""
    trace = traces_of(mod).diurnal_trace(50.0, 0.8, 2.0, 4.0, seed=9, chunk_len=chunk_len)
    m = mod.EnsembleModel(horizon_s=4.0, macro_block=16)
    src = m.trace_arrivals(trace)
    srv = m.server(service_mean=0.04, queue_capacity=16, deadline_s=0.06, max_retries=2)
    m.connect(src, srv)
    m.connect(srv, m.sink(), latency_s=0.005, latency_kind="exponential")
    return m


# name -> builder(mod); the CPU parity tests and the card's tests run each.
TRACE_MODELS = {
    "flash-regression": flash_regression,
    "flash-bench": lambda mod: trace_bench(mod, "flash", horizon_s=5.0),
    "diurnal-bench": lambda mod: trace_bench(mod, "diurnal", horizon_s=4.0, telemetry=False),
    "zipf-tenants": zipf_tenants,
    "short-trace": short_trace,
    "trace-poisson": trace_poisson,
    "trace-chaos": trace_chaos,
}
