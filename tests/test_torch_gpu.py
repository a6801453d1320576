"""The CUDA kernels against their plain torch-op versions, on the card: the
event-step kernel, which draws its own uniforms, against the plain step
fed by the torch-op threefry, the standalone draw kernel against
rng.uniform, and the M/M/1 Lindley kernel against plain_mm1_scan; a
checkpointed run's segment launches against its one launch, and the
opinion rounds against the CPU; the event-step kernel's trace branch
against plain_trace_steps over whole traced runs, traced runs on the card
against the CPU's, and a traced run resumed mid-chunk; the wide code (the
models past the lean tables) against the plain step and its whole runs
against chained launches; run_ensemble and run_mm1_ensemble on 4
shards of the card against 1; and the partitioned executor's window
kernel and barrier against their plain versions, window by window and
over a whole ring run through run_partitioned.

Run on a machine with an NVIDIA GPU (sm_90a) and nvcc:

    python -m pytest tests/test_torch_gpu.py -q -m gpu

Whether a card is present is decided inside the ``cuda`` fixture, so
every worker collects the same tests; without a card they skip.
Tolerance: none. Kernel and plain version run the same float32 ops in
the same order on the same card (no multiply-add contraction in either),
and the same threefry, so every leaf must match bit for bit.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import rng  # noqa: E402
from happysim_tpu_torch.engine import (  # noqa: E402
    _Compiled,
    _default_max_events,
    _resolve_params,
    run_ensemble,
)
from happysim_tpu_torch import opinion, run_mm1_ensemble  # noqa: E402
from happysim_tpu_torch.engine import (  # noqa: E402
    CHECKPOINT_SEGMENTS,
    TRACE_PAGING_FIELDS,
    resume_mismatches,
)
from happysim_tpu_torch.kernels import event_step, mm1_scan, support, uniform  # noqa: E402
from happysim_tpu_torch.model import EnsembleModel, mm1_model, pipeline_model  # noqa: E402
from test_torch_chaos_models import CHAOS_MODELS  # noqa: E402
from test_torch_consensus_models import CONSENSUS_MODELS  # noqa: E402
from test_torch_multisource_models import MULTI_MODELS, two_class  # noqa: E402
from test_torch_partitioned_models import HOP_S, PARTITIONED_MODELS  # noqa: E402
from test_torch_resilience_models import RESILIENCE_MODELS  # noqa: E402
from test_torch_telemetry_models import TELEMETRY_MODELS  # noqa: E402
from test_torch_trace_models import TRACE_MODELS  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the event-step kernel has no CPU build)")
    return torch.device("cuda")


def _mixed_chain():
    """Constant arrivals with a stop, a constant-service stage with
    concurrency 3, a small queue that drops, declared out of order."""
    m = EnsembleModel(horizon_s=30.0, warmup_s=3.0)
    src = m.source(rate=20.0, kind="constant", stop_after_s=25.0)
    tail = m.server(service_mean=0.04, queue_capacity=4)
    head = m.server(concurrency=3, service_mean=0.12, service="constant", queue_capacity=2)
    snk = m.sink()
    m.connect(src, head)
    m.connect(head, tail)
    m.connect(tail, snk)
    return m


def _router():
    """The round-robin load-balancer fan-out: 4 servers behind per-target
    5 ms edges, alternately constant and exponential (the "router"
    shape, with transit slots and the latency draw live)."""
    m = EnsembleModel(horizon_s=40.0, warmup_s=10.0, transit_capacity=16)
    src = m.source(rate=30.0)
    router = m.router(policy="round_robin")
    snk = m.sink()
    m.connect(src, router)
    for index in range(4):
        server = m.server(service_mean=0.1, queue_capacity=256)
        m.connect(router, server, latency_s=0.005,
                  latency_kind="exponential" if index % 2 else "constant")
        m.connect(server, snk)
    return m


def _graph(build_source=lambda m: m.source(rate=30.0)):
    """Two least_outstanding tiers of two servers, the back tier shared
    (the "graph" shape)."""
    m = EnsembleModel(horizon_s=40.0, warmup_s=10.0, transit_capacity=16)
    src = build_source(m)
    front = [m.server(service_mean=0.02, queue_capacity=256) for _ in range(2)]
    back = [m.server(service_mean=0.02, queue_capacity=256) for _ in range(2)]
    front_lb = m.router(policy="least_outstanding", targets=front)
    back_lb = m.router(policy="least_outstanding", targets=back)
    snk = m.sink()
    m.connect(src, front_lb)
    for server in front:
        m.connect(server, back_lb)
    for server in back:
        m.connect(server, snk)
    return m


def _mix():
    """Limiter, random over [weighted over s0, s1; s2], and a weighted
    exit over [sink behind a 2 ms exponential edge, s2]: route draws at
    two depths, limiter drops, zero-latency transit parks and feedback."""
    m = EnsembleModel(horizon_s=40.0, warmup_s=10.0, transit_capacity=16)
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


def _latency_chain():
    """A chain with a limiter and latency edges (the graph kernel on the
    "chain" shape), a transit capacity of 2 that drops."""
    m = EnsembleModel(horizon_s=30.0, warmup_s=3.0, transit_capacity=2)
    src = m.source(rate=9.0)
    lim = m.limiter(refill_rate=7.0, capacity=3.0)
    a = m.server(service_mean=0.05, concurrency=2, queue_capacity=4)
    b = m.server(service_mean=0.04, service="constant")
    snk = m.sink()
    m.connect(src, lim)
    m.connect(lim, a, latency_s=0.3, latency_kind="exponential")
    m.connect(a, b, latency_s=0.02)
    m.connect(b, snk, latency_s=0.01)
    return m


def _sink_latency_chain():
    """Two servers joined by free edges, then a 10 ms exponential edge
    into the sink: a "chain" plan on the graph code, which draws the
    edge's latency."""
    m = EnsembleModel(horizon_s=30.0, warmup_s=3.0)
    src = m.source(rate=6.0)
    front = m.server(service_mean=0.05)
    back = m.server(service_mean=0.08)
    snk = m.sink()
    m.connect(src, front)
    m.connect(front, back)
    m.connect(back, snk, latency_s=0.01, latency_kind="exponential")
    return m


def _mg1(service, **shape):
    """The M/G/1 of tests/integration/test_tpu_mg1.py (lambda=8, mean
    0.1, queue 512) at a 40 s horizon."""
    m = EnsembleModel(horizon_s=40.0, warmup_s=10.0)
    src = m.source(rate=8.0)
    srv = m.server(service_mean=0.1, service=service, queue_capacity=512, **shape)
    snk = m.sink()
    m.connect(src, srv)
    m.connect(srv, snk)
    return m


def _families_chain():
    """erlang-3 -> lognormal -> pareto: the family select with 3-wide
    service windows."""
    m = EnsembleModel(horizon_s=40.0)
    src = m.source(rate=8.0)
    stages = [
        m.server(service_mean=0.05, service="erlang", service_k=3, queue_capacity=512),
        m.server(service_mean=0.08, service="lognormal", service_scv=2.0, queue_capacity=512),
        m.server(service_mean=0.06, service="pareto", pareto_alpha=3.0, queue_capacity=512),
    ]
    snk = m.sink()
    m.connect(src, stages[0])
    m.connect(stages[0], stages[1])
    m.connect(stages[1], stages[2])
    m.connect(stages[2], snk)
    return m


def _ramp_graph():
    """The graph model behind a 20 -> 40 req/s ramp over 20 s (the
    profile tables staged in shared memory)."""
    return _graph(lambda m: m.ramp_source(20.0, 40.0, 20.0))


def _to_sink(build_source):
    m = EnsembleModel(horizon_s=30.0)
    src = build_source(m)
    m.connect(src, m.sink())
    return m


def _spike_off_mixed():
    """A spike of rate 0 (a flat cumulative table) feeding a random router
    over hyperexp (behind a 10 ms exponential edge), constant and
    erlang-2 servers."""
    m = EnsembleModel(horizon_s=30.0, warmup_s=5.0, transit_capacity=8)
    src = m.spike_source(6.0, 0.0, 10.0, 20.0)
    servers = [
        m.server(service_mean=0.1, service="hyperexp", service_scv=4.0),
        m.server(service_mean=0.1, service="constant"),
        m.server(service_mean=0.1, service="erlang", service_k=2),
    ]
    router = m.router(policy="random")
    snk = m.sink()
    m.connect(src, router)
    m.connect(router, servers[0], latency_s=0.01, latency_kind="exponential")
    for server in servers[1:]:
        m.connect(router, server)
    for server in servers:
        m.connect(server, snk)
    return m


MODELS = {
    "router": _router,
    "graph": _graph,
    "mix": _mix,
    "latency-chain": _latency_chain,
    "sink-latency-chain": _sink_latency_chain,
    "mm1": lambda: mm1_model(8.0, 10.0, 40.0, warmup_s=10.0),
    "pipeline": lambda: pipeline_model(8.0, (0.05, 0.08, 0.06), 40.0),
    "mixed-chain": _mixed_chain,
    "eight-stage": lambda: pipeline_model(5.0, [0.02 * (i + 1) for i in range(8)], 20.0, queue_capacity=16),
    "mg1-erlang2": lambda: _mg1("erlang", service_k=2),
    "mg1-erlang3": lambda: _mg1("erlang", service_k=3),
    "mg1-hyperexp": lambda: _mg1("hyperexp", service_scv=4.0),
    "mg1-lognormal": lambda: _mg1("lognormal", service_scv=2.0),
    "mg1-pareto": lambda: _mg1("pareto", pareto_alpha=3.0),
    "families-chain": _families_chain,
    "ramp-graph": _ramp_graph,
    "spike-off-mixed": _spike_off_mixed,
    "ramp-sink": lambda: _to_sink(lambda m: m.ramp_source(2.0, 10.0, 30.0)),
    "ramp-constant-sink": lambda: _to_sink(lambda m: m.ramp_source(2.0, 10.0, 30.0, kind="constant")),
    "spike-sink": lambda: _to_sink(lambda m: m.spike_source(2.0, 20.0, 10.0, 20.0)),
    # the chaos instantiation (deadlines, retries, hedges, brownouts,
    # fault schedules, packet loss)
    **{f"chaos-{name}": (lambda build=build: build(tmodel)) for name, build in CHAOS_MODELS.items()},
    # the telemetry instantiations (the window buffers, with and without
    # the chaos branches)
    **{f"telemetry-{name}": (lambda build=build: build(tmodel)) for name, build in TELEMETRY_MODELS.items()},
    # the resilience instantiations (breakers, shedding, budgets, with and
    # without telemetry)
    **{f"resilience-{name}": (lambda build=build: build(tmodel)) for name, build in RESILIENCE_MODELS.items()},
    # several sources and sinks, and nodes no source reaches, on the line,
    # graph, extended and telemetry codes
    **{f"multi-{name}": (lambda build=build: build(tmodel)) for name, build in MULTI_MODELS.items()},
    # the consensus instantiations (partition consults, the quorum gate,
    # with and without telemetry and the defenses)
    **{f"consensus-{name}": (lambda build=build: build(tmodel)) for name, build in CONSENSUS_MODELS.items()},
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_kernel_matches_plain_bit_for_bit(cuda, name):
    """60 chained blocks at 512 replicas, block indices from 2^16 on: the
    kernel drawing its own uniforms against the plain step on the
    torch-op draw of the same block."""
    model = MODELS[name]()
    compiled = _Compiled(model)
    n = 512
    params = {
        k: torch.from_numpy(v).to(cuda)
        for k, v in _resolve_params(model, compiled, n, None).items()
    }
    keys = rng.split(rng.PRNGKey(7, device=cuda), n)
    kstate = compiled.init_state(keys, params)
    pstate = {k: v.clone() for k, v in kstate.items()}
    before = event_step.block_step.launches
    for block in range(1 << 16, (1 << 16) + 60):
        U = event_step.block_uniforms(compiled, keys, block)
        khalted = event_step.block_step(compiled, kstate, keys, block, params)
        phalted = event_step.plain_block_step(compiled, pstate, U, params)
        torch.testing.assert_close(khalted, phalted, rtol=0, atol=0)
        for leaf in pstate:
            a, b = kstate[leaf], pstate[leaf]
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"block {block}: {leaf}")
    assert event_step.block_step.launches - before == 60
    assert int(kstate["srv_completed"].sum()) > 0 or not model.servers
    # A graph with no path to a sink delivers nothing there.
    assert int(kstate["sink_count"].sum()) > 0 or "no path" in compiled.plan.get("declined", "")


def _chained_in_place(compiled, state, keys, params, n):
    """The per-block structure: one block a launch with every row in device
    memory, a host loop that stops once every replica halted and counts a
    replica's block iff it was live when the block began."""
    R = state["t"].shape[0]
    blocks = torch.zeros((R,), dtype=torch.int32, device=state["t"].device)
    out = torch.empty((R,), dtype=torch.uint8, device=state["t"].device)
    live = ~compiled.replica_halted(state)
    empty = event_step._Stage((ctypes.c_int * len(support.STAGE_LEAVES))(*[-1] * len(support.STAGE_LEAVES)), 0)
    for c in range(n):
        if not bool(live.any()):
            break
        blocks += live.to(torch.int32)
        args = event_step.launch_args(compiled, state, keys, c, params, out)
        args.stage = empty
        event_step.launch(args, state["t"].device)
        live = out == 0
    return blocks, out.bool()


@pytest.mark.parametrize(
    "name",
    ["mm1", "router", "mix", "ramp-graph", "chaos-bench-chaos", "telemetry-chaos-fanout",
     "resilience-storm-defended", "router-transit-1024", "multi-two-class-telemetry",
     "multi-profiled", "consensus-quorum-defended", "consensus-delay"],
)
def test_whole_run_launch_equals_chained_one_block_launches(cuda, name):
    """A run's whole budget in one launch, the rows the plan stages in
    shared memory, against chained one-block launches with every row in
    device memory, at 512 replicas: every leaf, the blocks each replica
    ran and the halted mask bit for bit. ``router-transit-1024`` has
    transit rows of 16 KB a lane, past the tile: its plan keeps tr_time in
    device memory, as does the two-tenant service's (6 KB a lane)."""
    if name == "router-transit-1024":
        model = _router()
        model.transit_capacity = 1024
    else:
        model = MODELS[name]()
    compiled = _Compiled(model)
    n = 512
    params = {
        k: torch.from_numpy(v).to(cuda)
        for k, v in _resolve_params(model, compiled, n, None).items()
    }
    keys = rng.split(rng.PRNGKey(9, device=cuda), n)
    state = compiled.init_state(keys, params)
    chained = {k: v.clone() for k, v in state.items()}
    budget = -(-_default_max_events(model, None) // compiled.macro)
    blocks = torch.zeros((n,), dtype=torch.int32, device=cuda)
    before = event_step.block_step.launches
    halted = event_step.block_steps(compiled, state, keys, 0, budget, params, blocks)
    assert event_step.block_step.launches - before == 1
    halted_out = torch.empty((n,), dtype=torch.uint8, device=cuda)
    plan = event_step.launch_args(compiled, state, keys, 0, params, halted_out).stage
    tr_time_in_tile = plan.off[support.STAGE_LEAVES.index("tr_time")] >= 0
    assert tr_time_in_tile == (
        "tr_time" in state and name not in ("router-transit-1024", "multi-two-class-telemetry")
    )
    chained_blocks, chained_halted = _chained_in_place(compiled, chained, keys, params, budget)
    torch.cuda.synchronize()
    for leaf in chained:
        a, b = state[leaf], chained[leaf]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=leaf)
    torch.testing.assert_close(blocks, chained_blocks, rtol=0, atol=0)
    torch.testing.assert_close(halted, chained_halted, rtol=0, atol=0)
    assert bool(halted.all()) and int(blocks.max()) > 1


def test_kernel_rejects_bad_inputs(cuda):
    model = mm1_model()
    compiled = _Compiled(model)
    params = {
        k: torch.from_numpy(v).to(cuda)
        for k, v in _resolve_params(model, compiled, 8, None).items()
    }
    keys = rng.split(rng.PRNGKey(0, device=cuda), 8)
    state = compiled.init_state(keys, params)
    with pytest.raises(ValueError, match="uint32"):
        event_step.block_step(compiled, state, keys.long(), 0, params)
    with pytest.raises(ValueError, match="shape"):
        event_step.block_step(compiled, state, keys[:4].contiguous(), 0, params)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.empty((2, 8), dtype=torch.uint32, device=cuda).t()
        event_step.block_step(compiled, state, strided, 0, params)
    with pytest.raises(ValueError, match="cpu"):
        event_step.block_step(compiled, state, keys.cpu(), 0, params)
    with pytest.raises(ValueError, match="uint32"):
        event_step.block_step(compiled, state, keys, 1 << 32, params)


def test_uniform_kernel_matches_rng_bit_for_bit(cuda):
    """The draw kernel against rng.uniform, its plain version, for row
    lengths around its block of 1,024 elements, a trailing axis, purposes
    up to 2^32 - 1 and another interval; each launch counted."""
    keys = rng.split(rng.PRNGKey(11, device=cuda), 512)
    before = uniform.replica_uniform.launches
    cases = [
        (0, (1,), 1e-12, 1.0), (1, (1023,), 1e-12, 1.0), (2, (1025,), 1e-12, 1.0),
        (7, (1515, 3), 1e-12, 1.0), (0xFFFFFFFF, (4096,), 1e-12, 1.0), (3, (777,), -2.5, 3.25),
    ]
    for purpose, shape, lo, hi in cases:
        got = uniform.replica_uniform(keys, purpose, shape, lo, hi)
        want = uniform.plain_replica_uniform(keys, purpose, shape, lo, hi)
        assert got.shape == (512, *shape) and got.dtype == torch.float32
        torch.testing.assert_close(got.view(torch.int32), want.view(torch.int32), rtol=0, atol=0)
    assert uniform.replica_uniform.launches - before == len(cases)
    with pytest.raises(ValueError, match="uint32"):
        uniform.replica_uniform(keys.long(), 0, (8,))


def test_the_scan_on_the_card_draws_no_torch_op_uniform_per_block(cuda, monkeypatch):
    """run_ensemble of the M/M/1 on the scan: the torch-op uniform runs
    only at set-up (the initial gaps), the same number of times for a run
    of 33 blocks as for one of 65, each run one kernel launch that draws
    every block's."""
    calls = []
    plain = rng.uniform
    monkeypatch.setattr(rng, "uniform", lambda *a, **k: calls.append(1) or plain(*a, **k))
    counts = {}
    for horizon in (20.0, 40.0):
        model = mm1_model(8.0, 10.0, horizon, warmup_s=5.0)
        calls.clear()
        before = event_step.block_step.launches
        result = run_ensemble(model, n_replicas=256, seed=2, max_events=_default_max_events(model, None))
        launches = event_step.block_step.launches - before
        assert result.engine_path == "scan+cuda" and launches == 1
        counts[horizon] = (len(calls), max(result.block_occupancy))
    assert counts[20.0][0] == counts[40.0][0] <= 1, counts
    assert counts[40.0][1] > counts[20.0][1], counts


@pytest.mark.parametrize(
    "build",
    [
        lambda: mm1_model(8.0, 10.0, 40.0, warmup_s=10.0),
        lambda: pipeline_model(8.0, (0.05, 0.08, 0.06), 40.0),
        lambda: _mg1("lognormal", service_scv=2.0),
    ],
    ids=["mm1", "pipeline", "mg1-lognormal"],
)
def test_chain_form_on_the_card_matches_the_cpu_run(cuda, build):
    """The default call takes the chain form on the card as on the CPU,
    its draws through the draw kernel: the integer totals equal, the
    float statistics within rel 1e-5. The card's cumsum adds in another
    order than XLA's CPU one, which the CPU run follows, and its logf
    rounds otherwise than torch's CPU log on some inputs, so event times
    differ by ulps and a latency that close to a bin edge (10^(k/10) s)
    may sit in the next bin: at most 1e-4 of the latencies move so, each
    by one bin."""
    model = build()
    before = uniform.replica_uniform.launches
    card = run_ensemble(model, n_replicas=512, seed=4)
    launches = uniform.replica_uniform.launches - before
    cpu = run_ensemble(model, n_replicas=512, seed=4, device="cpu")
    assert card.engine_path == cpu.engine_path == "chain"
    # One launch for the gaps and one for each stage's service draws.
    assert launches == 1 + len(model.servers)
    for field in ("simulated_events", "sink_count", "server_completed", "truncated_replicas"):
        assert getattr(card, field) == getattr(cpu, field), field
    moved = np.abs(np.cumsum(card.sink_hist.ravel() - cpu.sink_hist.ravel())).sum()
    assert card.sink_hist.sum() == cpu.sink_hist.sum() and moved <= 1e-4 * cpu.sink_count[0]
    np.testing.assert_allclose(card.server_mean_wait_s, cpu.server_mean_wait_s, rtol=1e-5)
    np.testing.assert_allclose(card.sink_mean_latency_s, cpu.sink_mean_latency_s, rtol=1e-5)


@pytest.mark.parametrize(
    "build, shape",
    [
        (lambda: pipeline_model(8.0, (0.05, 0.08, 0.06), 20.0), "chain"),
        (_mix, "graph"),
        (_families_chain, "chain"),
        (_ramp_graph, "graph"),
        (lambda: CHAOS_MODELS["backoff-chain"](tmodel), "chain"),
        (lambda: CHAOS_MODELS["bench-chaos"](tmodel), "router"),
    ],
    ids=["chain", "mix", "families-chain", "ramp-graph", "backoff-chain", "bench-chaos"],
)
def test_run_ensemble_on_the_card_matches_the_cpu_run(cuda, build, shape):
    """The event scan at the budget it takes by default (an explicit one
    keeps the chain-form models on the scan)."""
    model = build()
    budget = _default_max_events(model, None)
    before = event_step.block_step.launches
    card = run_ensemble(model, n_replicas=128, seed=5, max_events=budget)
    launches = event_step.block_step.launches - before
    cpu = run_ensemble(model, n_replicas=128, seed=5, device="cpu", max_events=budget)
    assert card.engine_path == "scan+cuda" and card.kernel_shape == shape
    assert cpu.engine_path == "scan"
    assert launches == 1  # the whole budget in one launch
    for field in (
        "simulated_events", "sink_count", "server_completed", "blocks_total",
        "transit_dropped", "limiter_admitted", "limiter_dropped",
        "server_timed_out", "server_retried", "server_fault_dropped",
        "server_fault_retried", "server_hedged", "server_hedge_wins", "network_lost",
    ):
        assert getattr(card, field) == getattr(cpu, field), field
    assert int(card.sink_hist.sum()) == int(cpu.sink_hist.sum())
    np.testing.assert_allclose(card.server_mean_wait_s, cpu.server_mean_wait_s, rtol=1e-5)


@pytest.mark.parametrize("name", ["mm1-all", "chaos-line", "bench-chaos", "pareto"])
def test_telemetry_on_the_card_matches_the_cpu_run(cuda, name):
    """run_ensemble with a telemetry spec on the card, once per block
    through the telemetry library, against the CPU run: the whole-run
    totals, every integer window series and the spread equal; and the
    same model without its spec simulates the same totals."""
    model = TELEMETRY_MODELS[name](tmodel)
    before = event_step.block_step.launches
    card = run_ensemble(model, n_replicas=128, seed=5)
    launches = event_step.block_step.launches - before
    cpu = run_ensemble(model, n_replicas=128, seed=5, device="cpu")
    assert card.engine_path == "scan+cuda" and launches == 1
    for field in ("simulated_events", "sink_count", "server_completed", "network_lost"):
        assert getattr(card, field) == getattr(cpu, field), field
    cs, ps = card.timeseries, cpu.timeseries
    for field in cs._ARRAY_FIELDS:
        left, right = getattr(cs, field), getattr(ps, field)
        assert (left is None) == (right is None), field
        if right is not None and (np.asarray(right).dtype.kind == "i" or "throughput_p" in field):
            np.testing.assert_array_equal(left, right, err_msg=field)
    model.telemetry_spec = None
    # Without its spec the M/M/1 qualifies for the chain form: the
    # scan's own budget keeps it on the scan.
    plain = run_ensemble(model, n_replicas=128, seed=5, max_events=_default_max_events(model, None))
    assert plain.timeseries is None
    for field in ("simulated_events", "sink_count", "server_completed", "server_dropped"):
        assert getattr(plain, field) == getattr(card, field), field


@pytest.mark.parametrize("name", ["storm-defended", "resilience-fanout", "shed-priority", "hedge-budget"])
def test_resilience_on_the_card_matches_the_cpu_run(cuda, name):
    """run_ensemble of a model with defenses on the card, once per block
    through the resilience library, against the CPU run: the whole-run
    totals, the resilience counters and every integer window series
    equal, the open fraction to rel 1e-5."""
    model = RESILIENCE_MODELS[name](tmodel)
    before = event_step.block_step.launches
    card = run_ensemble(model, n_replicas=128, seed=5)
    launches = event_step.block_step.launches - before
    cpu = run_ensemble(model, n_replicas=128, seed=5, device="cpu")
    assert card.engine_path == "scan+cuda" and launches == 1
    for field in (
        "simulated_events", "sink_count", "server_completed", "server_dropped",
        "server_timed_out", "server_retried", "server_fault_dropped", "server_fault_retried",
        "server_hedged", "server_breaker_dropped", "breaker_tripped", "server_shed_dropped",
        "server_budget_dropped", "transit_dropped",
    ):
        assert getattr(card, field) == getattr(cpu, field), field
    np.testing.assert_allclose(card.breaker_open_fraction, cpu.breaker_open_fraction, rtol=1e-5)
    assert card.resilience_features == model.resilience_features()
    if cpu.timeseries is not None:
        for field in cpu.timeseries._ARRAY_FIELDS:
            left, right = getattr(card.timeseries, field), getattr(cpu.timeseries, field)
            assert (left is None) == (right is None), field
            if right is not None and np.asarray(right).dtype.kind == "i":
                np.testing.assert_array_equal(left, right, err_msg=field)


# Models whose card and CPU runs moved a latency across a bin edge at
# seed 5 (ROADMAP C; tools/device_divergence.py names the op).
_ULP_HISTOGRAMS = ("two-class-chaos", "two-class-defended")


@pytest.mark.parametrize(
    "name",
    ["superpose-tie", "two-class-wide", "profiled", "no-sink", "superpose-faulted",
     "two-class-chaos", "two-class-defended", "quorum-defended", "election-phi", "stochastic",
     "delay"],
)
def test_multisource_and_consensus_on_the_card_match_the_cpu_run(cuda, name):
    """run_ensemble of several sources and sinks and of the consensus tier
    on the card (one launch of the kernel's line, graph, telemetry or
    consensus library) against the CPU run: every integer total per
    source, sink and server equal, the quorum's dark and the leaderless
    fractions within rel 1e-6 (the cut and fault windows are drawn with
    each device's float32 log, which differ by an ulp on some draws), the
    kernel shape the plan names, and the latency histograms equal. On the
    models of _ULP_HISTOGRAMS the plain step's float32 math rounds
    otherwise on the card than on the CPU on some inputs (its log by one
    ulp: tools/device_divergence.py), so a latency that close to a bin
    edge may sit in the next bin: at most 1e-4 of the latencies move so,
    each by one bin."""
    if name == "two-class-wide":
        model = two_class(tmodel, horizon_s=20.0, window_s=2.5)
    else:
        model = {**MULTI_MODELS, **CONSENSUS_MODELS}[name](tmodel)
    budget = _default_max_events(model, None)
    before = event_step.block_step.launches
    card = run_ensemble(model, n_replicas=256, seed=5, max_events=budget)
    launches = event_step.block_step.launches - before
    cpu = run_ensemble(model, n_replicas=256, seed=5, device="cpu", max_events=budget)
    assert card.engine_path == "scan+cuda" and launches == 1
    assert card.kernel_shape == _Compiled(model).plan["shape"]
    for field in (
        "simulated_events", "sink_count", "server_completed", "server_dropped", "transit_dropped",
        "limiter_admitted", "server_fault_dropped", "server_fault_retried", "breaker_tripped",
        "server_budget_dropped", "network_partitioned", "server_quorum_dropped", "leader_changes",
        "server_timed_out", "server_retried", "server_hedged", "server_hedge_wins", "network_lost",
    ):
        assert getattr(card, field) == getattr(cpu, field), field
    for field in ("quorum_dark_fraction", "time_without_leader_fraction"):
        np.testing.assert_allclose(getattr(card, field), getattr(cpu, field), rtol=1e-6, err_msg=field)
    if name in _ULP_HISTOGRAMS:
        np.testing.assert_array_equal(card.sink_hist.sum(axis=-1), cpu.sink_hist.sum(axis=-1))
        moved = np.abs(np.cumsum(card.sink_hist.ravel() - cpu.sink_hist.ravel())).sum()
        assert moved <= 1e-4 * cpu.sink_hist.sum(), moved
    else:
        np.testing.assert_array_equal(card.sink_hist, cpu.sink_hist)
    if cpu.timeseries is not None:
        for field in cpu.timeseries._ARRAY_FIELDS:
            left, right = getattr(card.timeseries, field), getattr(cpu.timeseries, field)
            assert (left is None) == (right is None), field
            if right is not None and np.asarray(right).dtype.kind == "i":
                np.testing.assert_array_equal(left, right, err_msg=field)


# The code of the library for several sources or sinks, or of the trace
# library, each model's launches take: (library, code, telemetry sites).
_CODE_OF_MODEL = {
    "multi-two-class": ("event_step_multi", "lean", False),
    "multi-two-class-telemetry": ("event_step_multi", "lean", True),
    "multi-two-class-chaos": ("event_step_multi", "chaos", False),
    "multi-superpose-faulted": ("event_step_multi", "chaos", False),
    "multi-two-class-defended": ("event_step_multi", "full", False),
    "trace-flash-regression": ("event_step_trace", "line", True),
    "trace-short-trace": ("event_step_trace", "line", False),
    "trace-trace-poisson": ("event_step_trace", "lean", False),
    "trace-trace-chaos": ("event_step_trace", "chaos", False),
    "trace-short-trace-chaos": ("event_step_trace", "chaos", False),
    "trace-trace-defended": ("event_step_trace", "full", False),
}


@pytest.mark.parametrize("name", sorted(_CODE_OF_MODEL))
def test_each_launch_takes_the_code_of_the_model_s_features(cuda, name):
    """run_ensemble on the card: every launch of a model with several
    sources or sinks (multi-), or with a traced source (trace-), takes
    the code its features need (event_step.launches_by_code, as
    csrc/event_step.cuh's hs_code picks it), and the run equals the CPU
    run on its integer totals."""
    kind, model_name = name.split("-", 1)
    model = (TRACE_MODELS if kind == "trace" else MULTI_MODELS)[model_name](tmodel)
    budget = _default_max_events(model, None)
    event_step.launches_by_code.clear()
    card = run_ensemble(model, n_replicas=64, seed=9, max_events=budget)
    by_code = dict(event_step.launches_by_code)
    launches = card.trace_stream_steps if kind == "trace" else 1
    assert by_code == {_CODE_OF_MODEL[name]: launches}
    cpu = run_ensemble(model, n_replicas=64, seed=9, device="cpu", max_events=budget)
    for field in ("simulated_events", "sink_count", "server_completed", "server_timed_out",
                  "server_retried", "network_lost", "server_budget_dropped"):
        assert getattr(card, field) == getattr(cpu, field), field


@pytest.mark.parametrize("lam,mu,R", [(8.0, 10.0, 4096), (7.0, 9.0, 1000)])
def test_mm1_scan_kernel_matches_plain_bit_for_bit(cuda, lam, mu, R):
    """The Lindley kernel against plain_mm1_scan on the card, 384
    customers after a warmup of 96: every per-replica sum bit for bit.
    R = 1000 leaves the last thread block part empty."""
    key = rng.PRNGKey(4, device=cuda)
    before = mm1_scan.mm1_scan.launches
    got = mm1_scan.mm1_scan(key, R, lam, mu, 384, 96)
    assert mm1_scan.mm1_scan.launches - before == 1
    want = mm1_scan.plain_mm1_scan(key, R, lam, mu, 384, 96)
    torch.cuda.synchronize()
    for label, g, w in zip(("sum_w", "sum_sq", "sum_s"), got, want):
        torch.testing.assert_close(g.view(torch.int32), w.view(torch.int32), rtol=0, atol=0,
                                   msg=label)
        assert bool((g > 0).all()), label


def test_run_mm1_ensemble_on_the_card_matches_the_cpu_run(cuda):
    """One kernel launch a call; the statistics within rel 1e-5 of the CPU
    run (the card's and the CPU's float32 log differ by an ulp on some
    draws)."""
    before = mm1_scan.mm1_scan.launches
    card = run_mm1_ensemble(8.0, 10.0, 2048, 512, seed=3)
    assert mm1_scan.mm1_scan.launches - before == 1
    cpu = run_mm1_ensemble(8.0, 10.0, 2048, 512, seed=3, device="cpu")
    assert card.device_name == torch.cuda.get_device_name(0)
    for field in ("mean_wait_s", "std_wait_s", "mean_sojourn_s"):
        np.testing.assert_allclose(getattr(card, field), getattr(cpu, field), rtol=1e-5,
                                   err_msg=field)


@pytest.mark.parametrize(
    "name", ["mm1", "router", "chaos-bench-chaos", "telemetry-mm1-all", "resilience-storm-defended"]
)
def test_segmented_launches_equal_the_one_launch_run(cuda, name):
    """A run's budget in CHECKPOINT_SEGMENTS launches, each reloading and
    writing back the rows it stages, against the one launch, at 512
    replicas: every leaf and the blocks each replica ran, bit for bit;
    then run_ensemble's segmented and resumed runs against its one-launch
    run, on every result field outside engine.RESUME_EXCLUDED_FIELDS."""
    model = MODELS[name]()
    compiled = _Compiled(model)
    n = 512
    params = {
        k: torch.from_numpy(v).to(cuda)
        for k, v in _resolve_params(model, compiled, n, None).items()
    }
    keys = rng.split(rng.PRNGKey(9, device=cuda), n)
    state = compiled.init_state(keys, params)
    segmented = {k: v.clone() for k, v in state.items()}
    budget = -(-_default_max_events(model, None) // compiled.macro)
    blocks = torch.zeros((n,), dtype=torch.int32, device=cuda)
    event_step.block_steps(compiled, state, keys, 0, budget, params, blocks)
    seg_blocks = torch.zeros_like(blocks)
    step = -(-budget // CHECKPOINT_SEGMENTS)
    before = event_step.block_step.launches
    for first in range(0, budget, step):
        event_step.block_steps(compiled, segmented, keys, first, min(step, budget - first),
                               params, seg_blocks)
    assert event_step.block_step.launches - before == -(-budget // step)
    torch.cuda.synchronize()
    for leaf in state:
        a, b = state[leaf], segmented[leaf]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=leaf)
    torch.testing.assert_close(blocks, seg_blocks, rtol=0, atol=0)

    max_events = _default_max_events(model, None)
    one = run_ensemble(model, n_replicas=n, seed=9, max_events=max_events)
    snapshots = []
    seg = run_ensemble(model, n_replicas=n, seed=9, max_events=max_events,
                       checkpoint_every_s=0.0, checkpoint_callback=snapshots.append)
    live = [s for s in snapshots if s.chunk_index < max(one.block_occupancy)]
    resumed = run_ensemble(model, n_replicas=n, seed=9, max_events=max_events,
                           resume_from=live[len(live) // 2])
    for result in (seg, resumed):
        assert result.engine_path == "scan+cuda"
        assert resume_mismatches(one, result) == []
    assert seg.blocks_total == one.blocks_total and 0 < resumed.blocks_total < one.blocks_total


@pytest.mark.parametrize("rule", ["degroot", "bounded_confidence", "voter"])
def test_opinion_rounds_on_the_card_match_the_cpu(cuda, rule):
    """A batch of 8 populations of 512 agents on a ring (float32 products
    in full precision on both sides): DeGroot and bounded confidence
    within rtol 1e-5 and atol 1e-6, the voter's picks equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n = 512
    weights = torch.zeros((n, n))
    for i in range(n):
        weights[(i + 1) % n, i] = 1.0
        weights[(i + 2) % n, i] = 0.5
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (8, n)).astype(np.float32))
    run = {
        "degroot": lambda d: opinion.degroot_rounds(x, weights, 0.4, 16, d),
        "bounded_confidence": lambda d: opinion.bounded_confidence_rounds(x, weights, 0.3, 0.5, 8, d),
        "voter": lambda d: opinion.voter_rounds(rng.PRNGKey(2), x, weights, 4, d),
    }[rule]
    card = run(cuda)
    assert card.device.type == "cuda"
    card = card.cpu()
    cpu = run("cpu")
    if rule == "voter":
        assert torch.equal(card, cpu)
    else:
        np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=1e-5, atol=1e-6)


def _trace_pages(compiled, base_page: int, device) -> tuple:
    """The resident pages base_page and base_page + 1 on ``device``, +inf
    padded past the trace's end."""
    P = compiled.trace_chunk_len
    out = []
    for page in (base_page, base_page + 1):
        times, tenants = np.full(P, np.inf, np.float32), np.zeros(P, np.int32)
        if page < compiled.trace_pages:
            times = compiled.trace_times[page * P : (page + 1) * P].copy()
            tenants = compiled.trace_tenants[page * P : (page + 1) * P].copy()
        out += [torch.from_numpy(times).to(device), torch.from_numpy(tenants).to(device)]
    return tuple(out)


@pytest.mark.parametrize("name", sorted(TRACE_MODELS))
def test_trace_branch_matches_plain_bit_for_bit(cuda, name):
    """Every stream step of a traced run at 256 replicas: the trace
    library's launch against plain_trace_steps on a copy of the state and
    the same pages, every leaf and the halted mask bit for bit, the window
    moved on as the engine moves it; lanes stall at its edge."""
    model = TRACE_MODELS[name](tmodel)
    compiled = _Compiled(model)
    n, P, macro = 256, compiled.trace_chunk_len, compiled.macro
    params = {k: torch.from_numpy(v).to(cuda) for k, v in _resolve_params(model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(13, device=cuda), n)
    state = compiled.init_state(keys, params)
    n_chunks = -(-_default_max_events(model, None) // macro)
    ti = compiled.trace_src
    base_page, steps = 0, 0
    while True:
        pages = _trace_pages(compiled, base_page, cuda)
        plain = {k: v.clone() for k, v in state.items()}
        plain_halted = event_step.plain_trace_steps(compiled, plain, keys, params, pages, base_page * P, n_chunks)
        before = event_step.trace_steps.launches
        halted = event_step.trace_steps(compiled, state, keys, params, pages, base_page * P, n_chunks)
        assert event_step.trace_steps.launches == before + 1
        torch.cuda.synchronize()
        steps += 1
        assert torch.equal(halted, plain_halted), f"step {steps}: halted"
        for leaf in plain:
            a, b = state[leaf], plain[leaf]
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f"step {steps}: {leaf}"
        reads = torch.isfinite(state["src_next"][:, ti]) & (state["trc_blocks"] < n_chunks) & ~halted
        if not bool(reads.any()):
            break
        cursor = state["trc_cursor"].to(torch.int64)
        assert bool((cursor[reads] + macro >= base_page * P + 2 * P).all())
        base_page = max(int(cursor[reads].min()) // P, base_page + 1)
    assert steps > 2


@pytest.mark.parametrize("name", sorted(TRACE_MODELS))
def test_traced_run_on_the_card_matches_the_cpu_run(cuda, name):
    """run_ensemble of a traced model on the card (one trace launch a
    stream step, its pages uploaded on a side stream) against the CPU
    run: every integer total, the tenants' arrivals, the paging counts
    and the integer window series equal."""
    model = TRACE_MODELS[name](tmodel)
    budget = _default_max_events(model, None)
    before = event_step.trace_steps.launches
    card = run_ensemble(model, n_replicas=256, seed=5, max_events=budget)
    launches = event_step.trace_steps.launches - before
    cpu = run_ensemble(model, n_replicas=256, seed=5, device="cpu", max_events=budget)
    assert card.engine_path == "scan+cuda" and card.kernel_decline == ""
    assert launches == card.trace_stream_steps == cpu.trace_stream_steps
    for field in (
        "simulated_events", "sink_count", "server_completed", "server_dropped", "transit_dropped",
        "server_timed_out", "server_retried", "blocks_total", "block_occupancy",
        "trace_tenant_arrivals", "trace_chunks_streamed", "trace_max_resident_chunks",
    ):
        assert getattr(card, field) == getattr(cpu, field), field
    np.testing.assert_array_equal(card.sink_hist, cpu.sink_hist)
    if cpu.timeseries is not None:
        for field in cpu.timeseries._ARRAY_FIELDS:
            left, right = getattr(card.timeseries, field), getattr(cpu.timeseries, field)
            assert (left is None) == (right is None), field
            if right is not None and np.asarray(right).dtype.kind == "i":
                np.testing.assert_array_equal(left, right, err_msg=field)


@pytest.mark.parametrize("name", ["flash-regression", "trace-poisson"])
def test_traced_run_resumed_mid_chunk_equals_the_run(cuda, name):
    """A snapshot taken with lanes frozen mid-page, resumed on the card:
    every field outside RESUME_EXCLUDED_FIELDS and the paging counts bit
    for bit; pages of 2,048 give the same bits too."""
    build = TRACE_MODELS[name]
    kw = dict(n_replicas=512, seed=9, max_events=_default_max_events(build(tmodel), None))
    snapshots = []
    one = run_ensemble(build(tmodel), **kw, checkpoint_every_s=0.0, checkpoint_callback=snapshots.append)
    P = build(tmodel).sources[build(tmodel).traced_source_index()].trace.chunk_len
    mid = [s for s in snapshots if (s.state["trc_cursor"].astype(np.int64) % P != 0).any()]
    resumed = run_ensemble(build(tmodel), **kw, resume_from=mid[len(mid) // 2])
    assert resume_mismatches(one, resumed, TRACE_PAGING_FIELDS) == []
    long = build(tmodel)
    long.sources[long.traced_source_index()].trace.chunk_len = 2048
    assert resume_mismatches(one, run_ensemble(long, **kw), TRACE_PAGING_FIELDS) == []


# -- the wide code and the replica mesh -----------------------------------------
def _wide_models() -> dict:
    import chip_smoke
    from test_torch_wide import _limiters

    return {
        "wide-fleet": lambda: chip_smoke.wide_fleet_model(EnsembleModel),
        "wide-chain": lambda: chip_smoke.wide_chain_model(EnsembleModel),
        "wide-draws": lambda: chip_smoke.wide_draws_model(EnsembleModel),
        "wide-tenants": lambda: chip_smoke.wide_tenants_model(EnsembleModel),
        "wide-quorum": lambda: chip_smoke.wide_quorum_model(EnsembleModel),
        "wide-limiters": lambda: _limiters(tmodel),
    }


WIDE_NAMES = ("wide-fleet", "wide-chain", "wide-draws", "wide-tenants", "wide-quorum", "wide-limiters")


@pytest.mark.parametrize("name", WIDE_NAMES)
def test_wide_kernel_matches_plain_bit_for_bit(cuda, name):
    """40 chained blocks at 512 replicas: the wide code (the 17-draw model
    the lean chaos code) drawing its own uniforms against the plain step
    on the torch-op draw of the same block, every leaf bit for bit."""
    model = _wide_models()[name]()
    compiled = _Compiled(model)
    n = 512
    params = {k: torch.from_numpy(v).to(cuda) for k, v in _resolve_params(model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(7, device=cuda), n)
    kstate = compiled.init_state(keys, params)
    pstate = {k: v.clone() for k, v in kstate.items()}
    halted = torch.empty((n,), dtype=torch.uint8, device=cuda)
    library = event_step.library_of(event_step.launch_args(compiled, kstate, keys, 0, params, halted))
    assert library == ("event_step" if name == "wide-draws" else "event_step_wide")
    for block in range(40):
        U = event_step.block_uniforms(compiled, keys, block)
        khalted = event_step.block_step(compiled, kstate, keys, block, params)
        phalted = event_step.plain_block_step(compiled, pstate, U, params)
        torch.testing.assert_close(khalted, phalted, rtol=0, atol=0)
        for leaf in pstate:
            a, b = kstate[leaf], pstate[leaf]
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"block {block}: {leaf}")
    assert int(kstate["srv_completed"].sum()) > 0


@pytest.mark.parametrize("name", ["wide-fleet", "wide-tenants", "wide-quorum", "wide-limiters"])
def test_wide_whole_run_equals_chained_one_block_launches(cuda, name):
    """The wide code's whole budget in one launch against chained
    one-block launches with every row in device memory, 512 replicas."""
    model = _wide_models()[name]()
    compiled = _Compiled(model)
    n = 512
    params = {k: torch.from_numpy(v).to(cuda) for k, v in _resolve_params(model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(3, device=cuda), n)
    one = compiled.init_state(keys, params)
    chained = {k: v.clone() for k, v in one.items()}
    n_chunks = -(-_default_max_events(model, None) // compiled.macro)
    blocks = torch.zeros((n,), dtype=torch.int32, device=cuda)
    halted = event_step.block_steps(compiled, one, keys, 0, n_chunks, params, blocks)
    chained_blocks, chained_halted = _chained_in_place(compiled, chained, keys, params, n_chunks)
    assert torch.equal(halted, chained_halted) and torch.equal(blocks, chained_blocks)
    for leaf in one:
        a, b = one[leaf], chained[leaf]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), leaf


def test_wide_traced_run_on_the_card_matches_the_cpu_run(cuda):
    from test_torch_wide import _traced_fleet

    model = _traced_fleet(tmodel)
    kw = dict(n_replicas=256, seed=5, max_events=4096)
    card = run_ensemble(model, **kw)
    cpu = run_ensemble(model, **kw, device="cpu")
    assert card.engine_path == "scan+cuda"
    for field in ("simulated_events", "sink_count", "server_completed", "server_dropped",
                  "blocks_total", "trace_tenant_arrivals", "trace_stream_steps"):
        assert getattr(card, field) == getattr(cpu, field), field


def _card_mesh(shards: int):
    from happysim_tpu_torch.mesh import replica_mesh

    return replica_mesh(["cuda:0"] * shards)


@pytest.mark.parametrize("name", ["wide-fleet", "telemetry-chaos-fanout", "consensus-quorum-defended"])
def test_run_ensemble_on_4_shards_of_the_card_equals_1(cuda, name):
    """One launch a shard on cuda:0 repeated 4 times, the same bits as one
    shard, every result field but the mesh's provenance."""
    model = _wide_models()[name]() if name in WIDE_NAMES else MODELS[name]()
    budget = _default_max_events(model, None)
    before = event_step.block_step.launches
    one = run_ensemble(model, n_replicas=1024, seed=2, max_events=budget, mesh=_card_mesh(1))
    assert event_step.block_step.launches - before == 1
    four = run_ensemble(model, n_replicas=1024, seed=2, max_events=budget, mesh=_card_mesh(4))
    assert event_step.block_step.launches - before == 5
    assert four.per_shard_replicas == 256 and four.mesh_devices == 4
    assert resume_mismatches(one, four, frozenset({"mesh_devices", "mesh_shape", "per_shard_replicas"})) == []


def test_run_mm1_ensemble_on_4_shards_of_the_card_equals_1(cuda):
    before = mm1_scan.mm1_scan.launches
    one = run_mm1_ensemble(8.0, 10.0, 4096, 512, mesh=_card_mesh(1))
    four = run_mm1_ensemble(8.0, 10.0, 4096, 512, mesh=_card_mesh(4))
    assert mm1_scan.mm1_scan.launches - before == 5
    for field in ("mean_wait_s", "std_wait_s", "mean_sojourn_s", "n_replicas"):
        assert getattr(one, field) == getattr(four, field), field
    # Each shard's lanes draw what they draw in the whole run.
    key = rng.PRNGKey(0, device=cuda)
    whole = mm1_scan.mm1_scan(key, 4096, 8.0, 10.0, 512, 128)
    part = mm1_scan.mm1_scan(key, 4096, 8.0, 10.0, 512, 128, 1024, 1024)
    for a, b in zip(whole, part):
        assert torch.equal(a[1024:2048], b)


# -- the partitioned executor ------------------------------------------------
def _partitioned(name: str, P: int, R: int, horizon_s: float, device):
    from happysim_tpu_torch import partitioned

    model = PARTITIONED_MODELS[name](tmodel, horizon_s)
    compiled = partitioned._PartitionCompiled(model, 8)
    state, params = partitioned.init_partitions(compiled, 0, P, R, 3, device)
    return compiled, state, params, partitioned.default_max_events_per_window(model, HOP_S)


def _same_bits(a: dict, b: dict, context: str) -> None:
    for leaf in sorted(b):
        x, y = a[leaf], b[leaf]
        if y.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{context}: {leaf}"


@pytest.mark.parametrize("name", sorted(PARTITIONED_MODELS))
def test_partitioned_windows_match_plain_bit_for_bit(cuda, name):
    """4 partitions of 256 replicas, 12 windows: each window launch and
    each barrier launch against plain_window_steps and plain_barrier on a
    copy, every leaf bit for bit; a budget of 2 events in every third
    window truncates some. Both wrappers share one prepared dict, as
    run_partitioned's window loop does, so the transit rows' occupancy
    bound is kept across the windows: after every launch it equals its
    recomputation from tr_time."""
    from happysim_tpu_torch import partitioned
    from happysim_tpu_torch.kernels import partition_barrier

    compiled, state, params, budget = _partitioned(name, 4, 256, 2.0, cuda)
    plain = {k: v.clone() for k, v in state.items()}
    prepared = {}
    for w in range(12):
        limit = partitioned.window_end(w, HOP_S)
        step_budget = 2 if w % 3 == 2 else budget
        event_step.window_steps(compiled, state, state["key"], params, limit, step_budget, prepared)
        event_step.plain_window_steps(compiled, plain, params, limit, step_budget)
        torch.cuda.synchronize()
        _same_bits(state, plain, f"{name} window {w}")
        assert torch.equal(event_step.kept_bound(state), event_step.transit_bound(state)), w
        partition_barrier.barrier(compiled, state, 4, limit, prepared=prepared)
        partition_barrier.plain_barrier(compiled, plain, 4, limit)
        torch.cuda.synchronize()
        _same_bits(state, plain, f"{name} barrier {w}")
        assert torch.equal(event_step.kept_bound(state), event_step.transit_bound(state)), w
    assert int(plain["ob_sent"].sum()) > 0 and int(plain["truncated_windows"].sum()) > 0


@pytest.mark.parametrize("name", sorted(PARTITIONED_MODELS))
def test_partitioned_bound_is_the_state_s_whatever_the_dicts(cuda, name):
    """4 partitions of 256 replicas, 12 windows whose window launches
    share one prepared dict while the barrier runs with none, with a
    second dict, or with the window's, in turns: the occupancy bound is
    tied to tr_time, not to a dict, so every launch reads what the last
    one left; bit for bit against the plain loop after every launch, and
    the kept bound equal to its recomputation."""
    from happysim_tpu_torch import partitioned
    from happysim_tpu_torch.kernels import partition_barrier

    compiled, state, params, budget = _partitioned(name, 4, 256, 2.0, cuda)
    plain = {k: v.clone() for k, v in state.items()}
    window_prepared, other = {}, {}
    for w in range(12):
        limit = partitioned.window_end(w, HOP_S)
        event_step.window_steps(compiled, state, state["key"], params, limit, budget,
                                window_prepared)
        event_step.plain_window_steps(compiled, plain, params, limit, budget)
        torch.cuda.synchronize()
        _same_bits(state, plain, f"{name} window {w}")
        barrier_prepared = (None, other, window_prepared)[w % 3]
        partition_barrier.barrier(compiled, state, 4, limit, prepared=barrier_prepared)
        partition_barrier.plain_barrier(compiled, plain, 4, limit)
        torch.cuda.synchronize()
        _same_bits(state, plain, f"{name} barrier {w}")
        assert torch.equal(event_step.kept_bound(state), event_step.transit_bound(state)), w
    assert int(plain["ob_sent"].sum()) > 0


@pytest.mark.parametrize("name", sorted(PARTITIONED_MODELS))
def test_folded_ring_matches_plain_bit_for_bit(cuda, name):
    """4 partitions of 256 replicas on the card, 12 windows through the
    folded ring (each window's launch running the previous window's
    barrier first): after folded launch w every leaf but the outbox
    against the plain loop after window w, the window's outbox in the
    scratch slab of its parity against the plain outbox leaves, and after
    the flush every leaf against the plain loop after barrier 11, bit for
    bit; the kept occupancy bound equals its recomputation."""
    from happysim_tpu_torch import partitioned
    from happysim_tpu_torch.kernels import partition_barrier

    compiled, state, params, budget = _partitioned(name, 4, 256, 2.0, cuda)
    plain = {k: v.clone() for k, v in state.items()}
    prepared = {}
    ring = partition_barrier.folded_ring(compiled, state, state["key"], params, 4, budget, prepared)
    outbox = ("ob_arrival", "ob_created", "ob_ingress", "ob_len")
    for w in range(12):
        if w:
            partition_barrier.plain_barrier(compiled, plain, 4, partitioned.window_end(w - 1, HOP_S))
        ring.window(partitioned.window_end(w, HOP_S))
        event_step.plain_window_steps(compiled, plain, params, partitioned.window_end(w, HOP_S),
                                      budget)
        torch.cuda.synchronize()
        slab = dict(zip(outbox, ring.outboxes[ring.pending[1]]))
        _same_bits({**state, **slab}, plain, f"{name} folded window {w}")
        assert torch.equal(event_step.kept_bound(state), event_step.transit_bound(state)), w
    ring.flush()
    partition_barrier.plain_barrier(compiled, plain, 4, partitioned.window_end(11, HOP_S))
    torch.cuda.synchronize()
    _same_bits(state, plain, f"{name} flushed")
    assert int(plain["ob_sent"].sum()) > 0


@pytest.mark.parametrize("name", ["ring", "two-sink-ring"])
def test_partitioned_run_on_the_card_matches_the_plain_loop(cuda, name):
    """run_partitioned on 4 partitions of the card (one card holds the
    ring: one window launch a window, each with the previous window's
    barrier folded in, and one barrier launch for the last window) against
    the plain versions' window loop on the card, bit for bit on every
    total and mean."""
    from happysim_tpu_torch import partition_mesh, partitioned, run_partitioned
    from happysim_tpu_torch.kernels import partition_barrier

    compiled, state, params, budget = _partitioned(name, 4, 64, 1.5, cuda)
    n_windows = int(np.ceil(1.5 / HOP_S))
    for w in range(n_windows):
        limit = partitioned.window_end(w, HOP_S)
        event_step.plain_window_steps(compiled, state, params, limit, budget)
        partition_barrier.plain_barrier(compiled, state, 4, limit)
    host = {k: v.cpu().numpy().reshape((4, 64) + tuple(v.shape[1:])) for k, v in state.items()}
    event_step.window_steps.launches = partition_barrier.barrier.launches = 0
    got = run_partitioned(PARTITIONED_MODELS[name](tmodel, 1.5), window_s=HOP_S, n_replicas=64,
                          seed=3, outbox_capacity=8, mesh=partition_mesh([cuda] * 4))
    assert (event_step.window_steps.launches, partition_barrier.barrier.launches) == (n_windows, 1)
    want = partitioned.partitioned_result(compiled.model, compiled, host, 4, 64, n_windows, HOP_S,
                               got.wall_seconds, budget)
    for field in ("simulated_events", "sink_count", "sink_mean_latency_s", "server_completed",
                  "remote_sent", "remote_dropped", "transit_dropped", "truncated_windows"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.per_partition_sink_count, want.per_partition_sink_count)
