"""The event-step kernel's window cache (the trace branch's lean code with
the telemetry sites) and its reachability memo (the consensus code), on
the CPU: the header built as host C++ (tests/test_torch_threefry.py's
harness) twice, as the libraries build it and with -DHS_WINDOW_CACHE=0
-DHS_REACH_MEMO=0 (every telemetry cell booked in device memory, every
window scanned at every consult).

The two builds must agree bit for bit on every leaf, the blocks each
replica ran and the halted mask: the cache and the memo change where a
value is kept and when it is computed, never the arithmetic or its order.
The library's build must agree with the plain versions,
:func:`event_step.plain_trace_steps` and
:func:`event_step.plain_block_steps`: integer leaves exactly, float
leaves within rel 1e-5 (glibc's float32 logf differs from torch's CPU one
by an ulp on some inputs).

The traced models put arrivals on the windows' edges, book services and
queue depths that span several windows, deliver across a latency edge
into a later window, start before the warmup ends mid-window, count
several tenants, and page their traces in pages small enough that most
launches end mid-window and the next stream step resumes there. The
consensus models put arrivals exactly on a cut's start and end, overlap
two windows of one group, end a drop-mode member's fault between two
arrivals, flap a group through 24 short cuts, and run with the defenses
and on the code for several sources; each runs as one launch and as
one-block launches, most of which start inside a cut.
"""

import ctypes
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import rng  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.engine import _resolve_params  # noqa: E402
from happysim_tpu_torch.kernels import event_step, support  # noqa: E402
from happysim_tpu_torch.kernels.build import CSRC  # noqa: E402
from happysim_tpu_torch.traces import TraceSpec, zipf_tenant_trace  # noqa: E402
from test_torch_threefry import _RUN, _SHIMS, _compiler  # noqa: E402

# (MAXV, GRAPH, EXT, CHAOS, TEL, RES, CON, MULTI, TRC) of the codes held
# here: the trace library's lean code with the telemetry sites at one
# and two servers, and the consensus library's codes (with and without
# the telemetry sites, with the defenses) and the multi library's code
# with every site.
_INSTANTIATIONS = {
    "line_tel_1": (1, "true", "true", "false", "true", "false", "false", "false", "true"),
    "line_tel_2": (2, "true", "true", "false", "true", "false", "false", "false", "true"),
    "consensus": (4, "true", "true", "true", "true", "false", "true", "false", "false"),
    "consensus_plain": (4, "true", "true", "true", "false", "false", "true", "false", "false"),
    "consensus_resilience": (4, "true", "true", "true", "true", "true", "true", "false", "false"),
    "multi": (4, "true", "true", "true", "true", "true", "true", "true", "false"),
}

# One count a pair 200,000 times, the window's half on every `every`-th:
# both halves pass 0xFFFF and go to their cells on the way.
_PAIRS = r"""
extern "C" void pair_count(int n, int every, int* window, int* launch) {
  uint32_t word = 0u;
  const HsRow<uint32_t> row{&word, 1};
  for (int i = 0; i < n; ++i) pair_add(row, 0, i % every == 0, window, launch);
  pairs_flush(row, 1, window);
  *launch += (int)(word >> 16);
}
"""


def _build(directory, defines=()) -> ctypes.CDLL:
    (directory / "cuda_runtime.h").write_text("")
    body = [_SHIMS, _PAIRS] + [
        _RUN.format(name=name, maxv=maxv, flags=", ".join(flags))
        for name, (maxv, *flags) in _INSTANTIATIONS.items()
    ]
    source = directory / "host.cpp"
    source.write_text("".join(body))
    lib_path = directory / "libhost.so"
    subprocess.run(
        [_compiler(), "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         *[f"-D{d}" for d in defines], f"-I{directory}", f"-I{CSRC}", "-o", str(lib_path),
         str(source)],
        check=True, capture_output=True, timeout=600,
    )
    lib = ctypes.CDLL(str(lib_path))
    for name in _INSTANTIATIONS:
        getattr(lib, f"run_{name}").argtypes = [ctypes.POINTER(event_step._Args), ctypes.c_int]
        getattr(lib, f"run_{name}").restype = ctypes.c_int
    lib.pair_count.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
    return lib


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """(the library's build, the build without the cache and the memo)."""
    return (
        _build(tmp_path_factory.mktemp("caches_on")),
        _build(tmp_path_factory.mktemp("caches_off"), ("HS_WINDOW_CACHE=0", "HS_REACH_MEMO=0")),
    )


def _same_bits(got: dict, want: dict, context: str) -> None:
    for leaf in sorted(want):
        a, b = got[leaf], want[leaf]
        if b.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{context}: {leaf}"


def _near_plain(got: dict, plain: dict, context: str) -> None:
    for leaf in sorted(plain):
        a, b = got[leaf], plain[leaf]
        if b.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, err_msg=f"{context}: {leaf}")
        else:
            assert torch.equal(a, b), f"{context}: {leaf}"


def _no_pairs(args) -> None:
    """The plan with the pairs' rows left out (counted in device memory)."""
    off = list(args.stage.off)
    for leaf in ("tenant_pairs", "hist_pairs"):
        off[support.STAGE_LEAVES.index(leaf)] = -1
    args.stage = event_step._Stage((ctypes.c_int * len(off))(*off), args.stage.words)


# -- the window cache ------------------------------------------------------

def edge_line(chunk_len: int = 8):
    """Arrivals on every edge of 0.5 s windows (and 180 more in [0, 6) s,
    three tenants) into a line of two servers: a two-slot 50 ms one, then
    a one-slot server of 0.7 s mean (its busy and depth integrals span
    windows), over a 0.6 s constant edge into the sink (a delivery booked
    one or two windows after its send); warmup 0.75 s (mid-window), every
    metric."""
    rs = np.random.default_rng(17)
    times = np.sort(np.concatenate([np.arange(12) * 0.5, rs.uniform(0.0, 6.0, 180)])).astype(np.float32)
    trace = TraceSpec(times=times, tenants=rs.integers(0, 3, times.size), n_tenants=3,
                      chunk_len=chunk_len)
    m = tmodel.EnsembleModel(horizon_s=8.0, warmup_s=0.75, macro_block=8)
    src = m.trace_arrivals(trace)
    a = m.server(concurrency=2, service_mean=0.05, queue_capacity=8)
    b = m.server(service_mean=0.7, queue_capacity=8)
    m.connect(src, a)
    m.connect(a, b)
    m.connect(b, m.sink(), latency_s=0.6, latency_kind="constant")
    m.telemetry(window_s=0.5)
    return m


def spanning(chunk_len: int = 4):
    """A one-slot server of 1.3 s mean service fed 4 arrivals a second for
    6 s (a queue of up to 32): every busy interval and most depth
    intervals span several 0.5 s windows; pages of four arrivals, every
    metric."""
    times = (np.arange(24) * 0.25 + 0.125).astype(np.float32)
    trace = TraceSpec(times=times, tenants=np.zeros(24, np.int32), chunk_len=chunk_len)
    m = tmodel.EnsembleModel(horizon_s=12.0, macro_block=4)
    srv = m.server(service_mean=1.3, queue_capacity=32)
    m.connect(m.trace_arrivals(trace), srv)
    m.connect(srv, m.sink())
    m.telemetry(window_s=0.5)
    return m


def tenants(chunk_len: int = 8):
    """Five Zipf(1.1) tenants at 60/s over 4 s into a two-slot server (20
    ms, queue 8) -> sink, 0.25 s windows of every metric."""
    trace = zipf_tenant_trace(60.0, 5, 1.1, 4.0, seed=3, chunk_len=chunk_len)
    m = tmodel.EnsembleModel(horizon_s=4.5, macro_block=16)
    srv = m.server(concurrency=2, service_mean=0.02, queue_capacity=8)
    m.connect(m.trace_arrivals(trace), srv)
    m.connect(srv, m.sink())
    m.telemetry(window_s=0.25)
    return m


_TRACED = {"edge-line": (edge_line, "line_tel_2"), "spanning": (spanning, "line_tel_1"),
           "tenants": (tenants, "line_tel_1")}


def _pages(compiled, base_page: int) -> tuple:
    P = compiled.trace_chunk_len
    out = []
    for page in (base_page, base_page + 1):
        times, tenant = np.full(P, np.inf, np.float32), np.zeros(P, np.int32)
        if page < compiled.trace_pages:
            times = compiled.trace_times[page * P : (page + 1) * P].copy()
            tenant = compiled.trace_tenants[page * P : (page + 1) * P].copy()
        out += [torch.from_numpy(times), torch.from_numpy(tenant)]
    return tuple(out)


@pytest.mark.parametrize("name", sorted(_TRACED))
def test_window_cache_matches_memory_and_plain_trace_steps(builds, name):
    """16 replicas through every stream step of a run: the library's build
    with the pairs planned, the same with them left out, and the build
    without the cache, against each other bit for bit and against
    plain_trace_steps; the window moves on as the engine moves it."""
    build_model, instantiation = _TRACED[name]
    model = build_model()
    compiled = TCompiled(model)
    n, macro, P, ti = 16, compiled.macro, compiled.trace_chunk_len, compiled.trace_src
    n_chunks = -(-4096 // macro)
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(7), n)
    plain = compiled.init_state(keys, params)
    states = [{k: v.clone() for k, v in plain.items()} for _ in range(3)]
    base_page, steps, mid_window = 0, 0, 0
    inv = np.float32(1.0) / np.float32(model.telemetry_spec.window_s)
    while True:
        pages = _pages(compiled, base_page)
        halted = []
        for (lib, pairs), state in zip(((builds[0], True), (builds[0], False), (builds[1], True)),
                                       states):
            out = torch.empty((n,), dtype=torch.uint8)
            args = event_step.trace_launch_args(compiled, state, keys, params, pages, base_page * P,
                                                n_chunks, out)
            assert event_step.window_cached(args)
            planned = [args.stage.off[support.STAGE_LEAVES.index(k)] for k in ("tenant_pairs", "hist_pairs")]
            assert min(planned) >= 0, "the pairs' rows fit the tile at 16 replicas"
            if not pairs:
                _no_pairs(args)
            assert getattr(lib, f"run_{instantiation}")(ctypes.byref(args), 4) == 0
            halted.append(out.bool())
        plain_halted = event_step.plain_trace_steps(compiled, plain, keys, params, pages,
                                                    base_page * P, n_chunks)
        steps += 1
        for state, out in zip(states[1:], halted[1:]):
            _same_bits(state, states[0], f"{name} step {steps}")
            assert torch.equal(out, halted[0])
        _near_plain(states[0], plain, f"{name} step {steps}")
        assert torch.equal(halted[0], plain_halted)
        windows = (plain["t"].numpy() * inv).astype(np.int64)
        mid_window += int((plain["t"].numpy() > windows / inv).sum())
        reads = (torch.isfinite(plain["src_next"][:, ti]) & (plain["trc_blocks"] < n_chunks)
                 & ~plain_halted)
        if not bool(reads.any()):
            break
        base_page = max(int(plain["trc_cursor"].to(torch.int64)[reads].min()) // P, base_page + 1)
    assert steps > 3 and mid_window > 0
    # The windows sum to the whole run: every delivery and arrival booked.
    assert torch.equal(plain["tel_sink_count"].sum(dim=1), plain["sink_count"])
    assert torch.equal(plain["tel_trc_arrivals"].sum(dim=1), plain["trc_arrivals"])
    assert torch.equal(plain["tel_sink_hist"].sum(dim=1), plain["sink_hist"])


def test_window_pairs_never_wrap(builds):
    """A counter pair counted 200,000 times, its window's half every time
    or every third time: both halves reach their cells whole."""
    for every in (1, 3):
        window, launch = ctypes.c_int(0), ctypes.c_int(0)
        builds[0].pair_count(200_000, every, ctypes.byref(window), ctypes.byref(launch))
        assert (window.value, launch.value) == (-(-200_000 // every), 200_000)


# -- the reachability memo -------------------------------------------------

def _quorum_line(mod, cuts, fault=None, defended=False, second_source=False, delay=False,
                 cut=(1, 2)):
    """A constant 4/s source round-robin over three servers (arrivals at
    multiples of 0.25 s, no edge latency), 80 ms service, queue 8, three
    retries after a 0.1 s backoff; the servers of `cut` cut over `cuts` (a
    delay-mode group of server 1 over [1.1, 1.6) besides, with `delay`);
    server 0 faulted (drop mode) over `fault`; a write quorum of 2 of 3;
    the defenses, or a second source, where asked; 0.5 s windows."""
    m = mod.EnsembleModel(horizon_s=4.0, macro_block=4, transit_capacity=8)
    src = m.source(rate=4.0, kind="constant")
    spec = {} if fault is None else {"fault": mod.FaultSpec(windows=fault)}
    servers = [
        m.server(service_mean=0.08, queue_capacity=8, max_retries=3, retry_backoff_s=0.1,
                 **(spec if v == 0 else {}))
        for v in range(3)
    ]
    router = m.router(policy="round_robin")
    snk = m.sink()
    m.connect(src, router)
    if second_source:
        m.connect(m.source(rate=3.0), router)
        snk2 = m.sink()
    for v, server in enumerate(servers):
        m.connect(router, server)
        m.connect(server, snk2 if second_source and v == 2 else snk)
    m.telemetry(window_s=0.5)
    m.network_partition(group=[servers[v] for v in cut], windows=cuts)
    if delay:
        m.network_partition(group=[servers[1]], windows=((1.1, 1.6),), mode="delay", delay_s=0.3)
    m.quorum(servers, write=2, read=2)
    if defended:
        m.circuit_breaker(failure_threshold=3, window_s=0.5, cooldown_s=0.5, half_open_probes=1)
        m.retry_budget(ratio=0.1, min_per_s=0.5, burst=2.0)
    return m


# 24 cuts of 0.1 s, 0.125 s apart from 0.5 s: the memo scanned at every edge.
_FLAPS = tuple((0.5 + 0.125 * k, 0.6 + 0.125 * k) for k in range(24))

_MEMO = {
    # Arrivals at 1.0, 1.5, 2.25 and 2.5 s: exactly at the cuts' starts and ends.
    "cut-edges": (lambda: _quorum_line(tmodel, ((1.0, 1.5), (2.25, 2.5))), "consensus"),
    "overlapping-cuts": (lambda: _quorum_line(tmodel, ((1.0, 2.0), (1.5, 2.5))), "consensus"),
    # Server 2 cut over [1, 2) and server 0 dark over [1.1, 1.37), the
    # quorum lost while both last: the fault ends between the arrivals at
    # 1.25 and 1.5 s.
    "fault-between-arrivals": (
        lambda: _quorum_line(tmodel, ((1.0, 2.0),), fault=((1.1, 1.37),), cut=(2,)), "consensus"
    ),
    "flapping-cuts": (lambda: _quorum_line(tmodel, _FLAPS), "consensus"),
    "delay-group": (lambda: _quorum_line(tmodel, ((1.0, 1.5),), delay=True), "consensus"),
    "flapping-defended": (lambda: _quorum_line(tmodel, _FLAPS, defended=True), "consensus_resilience"),
    "flapping-untelemetered": (lambda: _untelemetered(_quorum_line(tmodel, _FLAPS)), "consensus_plain"),
    "flapping-two-sources": (
        lambda: _quorum_line(tmodel, _FLAPS, defended=True, second_source=True), "multi"
    ),
}


def _untelemetered(model):
    model.telemetry_spec = None
    return model


def _launches(lib, instantiation, compiled, state, keys, params, n, per_launch, total):
    """Blocks 0..total-1 in launches of `per_launch` blocks; returns (blocks
    each replica ran, the last halted mask)."""
    blocks = torch.zeros((n,), dtype=torch.int32)
    for first in range(0, total, per_launch):
        halted = torch.empty((n,), dtype=torch.uint8)
        args = event_step.launch_args(compiled, state, keys, first, params, halted,
                                      n_blocks=per_launch, blocks=blocks)
        assert getattr(lib, f"run_{instantiation}")(ctypes.byref(args), 4) == 0
    return blocks, halted.bool()


@pytest.mark.parametrize("per_launch", [32, 1])
@pytest.mark.parametrize("name", sorted(_MEMO))
def test_reach_memo_matches_scans_and_plain_block_steps(builds, name, per_launch):
    """16 replicas over blocks 0-31 (past every cut), in one launch or in
    one-block launches (most of which start inside a cut, the memo
    scanned afresh): the library's build against the build that scans at
    every consult bit for bit, and against plain_block_steps."""
    build_model, instantiation = _MEMO[name]
    model = build_model()
    compiled = TCompiled(model)
    assert compiled.has_quorum and compiled.has_partitions
    n, total = 16, 32
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(5), n)
    state = compiled.init_state(keys, params)
    copies = [{k: v.clone() for k, v in state.items()} for _ in builds]
    runs = [_launches(lib, instantiation, compiled, copy, keys, params, n, per_launch, total)
            for lib, copy in zip(builds, copies)]
    _same_bits(copies[0], copies[1], name)
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    plain_blocks = torch.zeros((n,), dtype=torch.int32)
    plain_halted = event_step.plain_block_steps(compiled, state, keys, 0, total, params, plain_blocks)
    _near_plain(copies[0], state, name)
    assert torch.equal(runs[0][0], plain_blocks) and torch.equal(runs[0][1], plain_halted)
    assert int(state["qrm_dropped"].sum()) > 0
    assert int(state["net_partitioned"].sum()) > 0
