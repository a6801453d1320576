"""The event-step kernel past the lean tables of its argument struct: the
five wide models of chip_smoke.py (a 32-server fleet, a 16-stage chain,
17 draws a step, 12 tenants, a 9-member quorum with 9 partition groups),
their plain step against the JAX engine's lax step block by block, the
launch bounds that remain, and the wide code (csrc/event_step_wide.cu)
built as host C++ against plain_block_step.

Block parity feeds both packages the same JAX-made state and uniform
blocks: integer leaves exactly, floats within rel 1e-5 plus 32 ulp of
the horizon (test_torch_event_step.py's tolerance).
"""

import ctypes
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu_torch import convert, rng  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.engine import _resolve_params  # noqa: E402
from happysim_tpu_torch.kernels import event_step, support  # noqa: E402
from happysim_tpu_torch.kernels.event_step import plain_block_step  # noqa: E402
from test_torch_event_step import (  # noqa: E402
    GRAPH_ULPS,
    _assert_leaves_match,
    _block_u,
    _jax_state,
    _lax_block,
)
from test_torch_multisource import params_of  # noqa: E402
from test_torch_threefry import _RUN, _SHIMS, CSRC, _compiler  # noqa: E402
from test_torch_trace_kernel import _assert_same, _window  # noqa: E402

# Each wide model at full width, with the lean tables it is past.
WIDE_MODELS = {
    "wide-fleet": (chip_smoke.wide_fleet_model, ["servers=32 > 8", "targets per router=32 > 8"]),
    "wide-chain": (chip_smoke.wide_chain_model, ["servers=16 > 8"]),
    "wide-draws": (chip_smoke.wide_draws_model, []),
    "wide-tenants": (chip_smoke.wide_tenants_model, ["sources=12 > 8"]),
    "wide-quorum": (
        chip_smoke.wide_quorum_model,
        ["servers=9 > 8", "targets per router=9 > 8", "partition groups=9 > 8"],
    ),
}
# The counts check_kernel_bounds no longer names.
LIFTED = (
    "servers", "sources", "routers", "targets", "hop", "limiters", "partition groups",
    "uniform draws",
)


def _limiters(mod):
    """Five sources, each through its own limiter into a chain of 10
    one-target routers, the last a round-robin over 10 servers behind
    exponential edges: past the limiters', the routers', the hops' and the
    servers' tables."""
    m = mod.EnsembleModel(horizon_s=4.0, macro_block=16)
    first = m.router(policy="random")
    for _ in range(5):
        limiter = m.limiter(refill_rate=3.0, capacity=4.0)
        m.connect(m.source(rate=4.0), limiter)
        m.connect(limiter, first)
    node = first
    for _ in range(9):
        hop = m.router(policy="random")
        m.connect(node, hop)
        node = hop
    last = m.router(policy="round_robin")
    m.connect(node, last)
    snk = m.sink()
    for _ in range(10):
        srv = m.server(service_mean=0.2, queue_capacity=8)
        m.connect(last, srv, latency_s=0.01, latency_kind="exponential")
        m.connect(srv, snk)
    return m


@pytest.mark.parametrize("name", sorted(WIDE_MODELS))
def test_wide_models_pass_the_launch_bounds(name):
    """Each wide model passes every launch bound; the lean tables it is
    past select the wide code, and no check names a lifted count."""
    build, reasons = WIDE_MODELS[name]
    compiled = TCompiled(build(tmodel.EnsembleModel))
    support.check_kernel_bounds(compiled, compiled.macro)
    assert support.wide_reasons(compiled) == reasons
    assert build(tmodel.EnsembleModel).kernel_supported() == (True, "")


def test_check_kernel_bounds_names_no_lifted_count(monkeypatch):
    """With every remaining bound lowered to 0 each check names its own
    bound, none of them a count the wide code lifted."""
    compiled = TCompiled(chip_smoke.wide_quorum_model(tmodel.EnsembleModel))
    names = [n for n in dir(support) if n.startswith("KERNEL_MAX_")]
    assert not [n for n in names if any(w.upper().replace(" ", "_") in n for w in LIFTED)]
    seen = set()
    for attr in names:
        with monkeypatch.context() as patch:
            patch.setattr(support, attr, -1)
            try:
                support.check_kernel_bounds(compiled, compiled.macro)
            except ValueError as err:
                seen.add(str(err).split(": ")[1].split("=")[0])
    assert seen and not [s for s in seen if any(w in s for w in LIFTED)]


@pytest.mark.parametrize("name", sorted(WIDE_MODELS))
def test_plain_step_matches_lax_block_scan(name):
    """16 replicas, 3 chained blocks of the same uniforms from JAX's
    state: every leaf after every block."""
    n = 16
    build, _reasons = WIDE_MODELS[name]
    jm, tm = build(jmodel.EnsembleModel), build(tmodel.EnsembleModel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    assert (tc.n_draws, tc.nS, tc.nV) == (jc.n_draws, jc.nS, jc.nV)
    params = params_of(jm, n)
    jstate = _jax_state(jc, params, n, seed=2)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(3):
        U = _block_u(keys, block, tc.macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(
            jstate, tstate, f"{name} lax block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    assert int(tstate["events"].min()) > 0


# -- the wide code, built for the host ----------------------------------------
_FLAGS = "true, true, true, true, true, true, true"
_HOST = {
    "wide": ("HS_WIDE", _FLAGS),
    "wide_trace": ("HS_WIDE", _FLAGS + ", true"),
    "chaos": ("2", "true, true, true"),
}


@pytest.fixture(scope="module")
def wide_host(tmp_path_factory):
    """The wide instantiations, with and without the trace (and the lean
    chaos one the 17-draw model runs), as host C++, each exported as
    run_<name>(args, threads)."""
    build = tmp_path_factory.mktemp("event_step_wide_host")
    (build / "cuda_runtime.h").write_text("")
    body = [_SHIMS] + [
        _RUN.format(name=name, maxv=maxv, flags=flags) for name, (maxv, flags) in _HOST.items()
    ]
    (build / "host.cpp").write_text("".join(body))
    lib_path = build / "libhost.so"
    subprocess.run(
        [_compiler(), "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{build}", f"-I{CSRC}", "-o", str(lib_path), str(build / "host.cpp")],
        check=True, capture_output=True, timeout=600,
    )
    lib = ctypes.CDLL(str(lib_path))
    for name in _HOST:
        getattr(lib, f"run_{name}").argtypes = [ctypes.POINTER(event_step._Args), ctypes.c_int]
        getattr(lib, f"run_{name}").restype = ctypes.c_int
    return lib


_HOST_MODELS = {
    "fleet": lambda: chip_smoke.wide_fleet_model(tmodel.EnsembleModel, servers=10, horizon_s=8.0),
    "chain": lambda: chip_smoke.wide_chain_model(tmodel.EnsembleModel, stages=9, horizon_s=8.0),
    "draws": lambda: chip_smoke.wide_draws_model(tmodel.EnsembleModel, horizon_s=8.0),
    "tenants": lambda: chip_smoke.wide_tenants_model(tmodel.EnsembleModel, horizon_s=4.0),
    "quorum": lambda: chip_smoke.wide_quorum_model(tmodel.EnsembleModel),
    "limiters": lambda: _limiters(tmodel),
}


@pytest.mark.parametrize("name", sorted(_HOST_MODELS))
def test_host_wide_code_matches_the_plain_step(wide_host, name):
    """24 replicas in blocks of 8 lanes, 8 blocks from the initial state,
    the launch through library_of's choice: the host build drawing its
    own uniforms against plain_block_step on the torch-op draw (integer
    leaves exactly; floats differ by host-libm ulps)."""
    model = _HOST_MODELS[name]()
    compiled = TCompiled(model)
    n = 24
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(5), n)
    kernel_state = compiled.init_state(keys, params)
    plain_state = {k: v.clone() for k, v in kernel_state.items()}
    for block in range(8):
        halted = torch.empty((n,), dtype=torch.uint8)
        args = event_step.launch_args(compiled, kernel_state, keys, block, params, halted)
        assert event_step.library_of(args) == ("event_step" if name == "draws" else "event_step_wide")
        run = wide_host.run_chaos if name == "draws" else wide_host.run_wide
        assert run(ctypes.byref(args), 8) == 0
        plain_halted = plain_block_step(
            compiled, plain_state, event_step.block_uniforms(compiled, keys, block), params
        )
        assert torch.equal(halted.bool(), plain_halted), f"block {block}: halted"
        for leaf in sorted(plain_state):
            got, want = kernel_state[leaf], plain_state[leaf]
            if want.is_floating_point():
                np.testing.assert_allclose(
                    got.numpy(), want.numpy(), rtol=1e-5, err_msg=f"{block} {leaf}"
                )
            else:
                assert torch.equal(got, want), f"{name} block {block}: {leaf}"
    assert int(plain_state["events"].min()) > 0


def test_wide_tables_hold_the_model():
    """The wide code's table buffer holds each server's, router's and
    group's row at the offsets its pointers take."""
    compiled = TCompiled(chip_smoke.wide_quorum_model(tmodel.EnsembleModel))
    args, tables = event_step._model_args(compiled)
    assert args.wide.on == 1 and args.wide.nT == 9
    assert list(tables.conc) == [1] * 9 and list(tables.qcap) == [16] * 9
    assert [list(row) for row in tables.prt_member] == np.eye(9, dtype=int).tolist()
    assert list(tables.qrm_member) == [1] * 9 and list(tables.touched) == [1] * 9
    assert [tables.rt_target[0][i].index for i in range(9)] == list(range(9))
    lean, none = event_step._model_args(TCompiled(chip_smoke.quorum_model(False)))
    assert none is None and lean.wide.on == 0 and lean.con.qrm_member == 0b111


def _traced_fleet(mod):
    """A flash crowd (20/s, 80/s over [1, 2) s, 4 s, pages of 32) into a
    round-robin router over 10 servers: a traced model past the servers'
    and targets' tables."""
    from happysim_tpu_torch import flash_crowd_trace

    m = mod.EnsembleModel(horizon_s=4.0, macro_block=16)
    router = m.router(policy="round_robin")
    m.connect(m.trace_arrivals(flash_crowd_trace(20.0, 80.0, 1.0, 2.0, 4.0, seed=3, chunk_len=32)),
              router)
    snk = m.sink()
    for _ in range(10):
        srv = m.server(service_mean=0.2, queue_capacity=8)
        m.connect(router, srv)
        m.connect(srv, snk)
    m.telemetry(window_s=1.0, metrics=("throughput", "rates"))
    return m


def test_host_wide_trace_code_matches_plain_trace_steps(wide_host):
    """24 replicas through every stream step of the traced fleet: the
    wide code with the trace branch against plain_trace_steps on the same
    pages, the window moved on as the engine moves it."""
    model = _traced_fleet(tmodel)
    compiled = TCompiled(model)
    n, macro, P = 24, compiled.macro, compiled.trace_chunk_len
    n_chunks = -(-4096 // macro)
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(11), n)
    kernel_state = compiled.init_state(keys, params)
    plain_state = {k: v.clone() for k, v in kernel_state.items()}
    ti = compiled.trace_src
    base_page, steps = 0, 0
    while True:
        pages = _window(compiled, base_page)
        halted = torch.empty((n,), dtype=torch.uint8)
        args = event_step.trace_launch_args(
            compiled, kernel_state, keys, params, pages, base_page * P, n_chunks, halted
        )
        assert event_step.library_of(args) == "event_step_wide"
        assert wide_host.run_wide_trace(ctypes.byref(args), 8) == 0
        plain_halted = event_step.plain_trace_steps(
            compiled, plain_state, keys, params, pages, base_page * P, n_chunks
        )
        steps += 1
        assert torch.equal(halted.bool(), plain_halted), f"step {steps}: halted"
        _assert_same(kernel_state, plain_state, f"traced fleet step {steps}")
        reads = (
            torch.isfinite(plain_state["src_next"][:, ti])
            & (plain_state["trc_blocks"] < n_chunks)
            & ~plain_halted
        )
        if not bool(reads.any()):
            break
        base_page = max(int(plain_state["trc_cursor"].to(torch.int64)[reads].min()) // P,
                        base_page + 1)
    assert steps > 2 and int(plain_state["trc_arrivals"].sum()) > 0
