"""The event-step kernel's trace branch built as host C++ (the harness of
test_torch_threefry.py), driven through a traced run's stream steps
against its plain version, :func:`event_step.plain_trace_steps`: the same
state, keys and resident pages go to both, step after step, and every
leaf and the halted mask must agree (integer leaves exactly, floats
within rel 1e-5: host libm against torch's CPU math). The models stall
lanes at the window's edge, read past the trace's end, stop the trace
early, spend their block budget, count several tenants, and run each
code of the trace library (event_step_trace.cu's `launch`, by
event_step.cuh's hs_code): the lean single-source code, the chaos-free
code for several sources or sinks and the MULTI chaos code without the
defenses' and the consensus tier's sites, each with and without
telemetry, and the whole MULTI chaos code (one traced source on the
chaos codes whose trace ends inside a launch among them, and a model
with several sources and a retry budget, which the launcher gives it)."""

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
from happysim_tpu_torch.kernels import event_step  # noqa: E402
from happysim_tpu_torch.kernels.build import CSRC  # noqa: E402
from test_torch_threefry import _RUN, _SHIMS, _compiler  # noqa: E402
from test_torch_trace_models import TRACE_MODELS  # noqa: E402

# (MAXV, GRAPH, EXT, CHAOS, TEL, RES, CON, MULTI, TRC) of the trace
# library's instantiations (csrc/event_step_trace.cu), and the code and
# telemetry sites its launcher picks for each (as the library's
# hs_event_step_code names it; None: the whole chaos code, which the
# launcher gives only a model with a defense or the consensus tier).
_INSTANTIATIONS = {
    "lean": (1, "true", "true", "false", "false", "false", "false", "false", "true"),
    "lean_tel": (1, "true", "true", "false", "true", "false", "false", "false", "true"),
    "multi_lean": (1, "true", "true", "false", "false", "false", "false", "true", "true"),
    "multi_lean_tel": (1, "true", "true", "false", "true", "false", "false", "true", "true"),
    "multi_chaos": (1, "true", "true", "true", "false", "false", "false", "true", "true"),
    "multi_chaos_tel": (1, "true", "true", "true", "true", "false", "false", "true", "true"),
    "multi": (1, "true", "true", "true", "true", "true", "true", "true", "true"),
}
_CODES = {
    "lean": ("line", False), "lean_tel": ("line", True),
    "multi_lean": ("lean", False), "multi_lean_tel": ("lean", True),
    "multi_chaos": ("chaos", False), "multi_chaos_tel": ("chaos", True),
    "multi": None,
}
# model -> (instantiation, event budget); "-budget" runs the model with a
# budget that runs out, "-telemetry" with 1 s windows of throughput and
# rates, "-full" on the whole chaos code.
_MODELS = {
    "flash-regression": ("lean_tel", 8192),
    "zipf-tenants": ("lean_tel", 2048),
    "short-trace": ("lean", 4096),
    "short-trace-budget": ("lean", 160),
    "trace-poisson": ("multi_lean", 4096),
    "trace-poisson-telemetry": ("multi_lean_tel", 4096),
    "trace-chaos": ("multi_chaos", 4096),
    "trace-chaos-telemetry": ("multi_chaos_tel", 4096),
    "short-trace-chaos": ("multi_chaos", 4096),
    "trace-chaos-full": ("multi", 4096),
    "short-trace-chaos-full": ("multi", 4096),
    "trace-defended": ("multi", 4096),
}


def _model(name: str):
    """The port's model of a _MODELS case."""
    base = name
    for suffix in ("-budget", "-telemetry", "-full"):
        base = base.removesuffix(suffix)
    model = TRACE_MODELS[base](tmodel)
    if name.endswith("-telemetry"):
        model.telemetry(window_s=1.0, metrics=("throughput", "rates"))
    return model


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The trace instantiations built for the host, each exported as
    run_<name>(args, threads)."""
    build = tmp_path_factory.mktemp("event_step_trace_host")
    (build / "cuda_runtime.h").write_text("")
    body = [_SHIMS, "HS_EVENT_STEP_CODE(true)\n"] + [
        _RUN.format(name=name, maxv=maxv, flags=", ".join(flags))
        for name, (maxv, *flags) in _INSTANTIATIONS.items()
    ]
    source = build / "host.cpp"
    source.write_text("".join(body))
    lib_path = build / "libhost.so"
    subprocess.run(
        [_compiler(), "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{build}", f"-I{CSRC}", "-o", str(lib_path), str(source)],
        check=True, capture_output=True, timeout=600,
    )
    lib = ctypes.CDLL(str(lib_path))
    for name in _INSTANTIATIONS:
        getattr(lib, f"run_{name}").argtypes = [ctypes.POINTER(event_step._Args), ctypes.c_int]
        getattr(lib, f"run_{name}").restype = ctypes.c_int
    lib.hs_event_step_code.argtypes = [ctypes.POINTER(event_step._Args)]
    lib.hs_event_step_code.restype = ctypes.c_char_p
    return lib


def _window(compiled, base_page: int) -> tuple:
    """The resident pages base_page and base_page + 1, +inf padded past
    the trace's end."""
    P = compiled.trace_chunk_len
    out = []
    for page in (base_page, base_page + 1):
        times = np.full(P, np.inf, np.float32)
        tenants = np.zeros(P, np.int32)
        if page < compiled.trace_pages:
            times = compiled.trace_times[page * P : (page + 1) * P].copy()
            tenants = compiled.trace_tenants[page * P : (page + 1) * P].copy()
        out += [torch.from_numpy(times), torch.from_numpy(tenants)]
    return tuple(out)


def _assert_same(kernel_state: dict, plain_state: dict, context: str) -> None:
    for leaf in sorted(plain_state):
        got, want = kernel_state[leaf], plain_state[leaf]
        if want.is_floating_point():
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-5, err_msg=f"{context}: {leaf}"
            )
        else:
            assert torch.equal(got, want), f"{context}: {leaf}"


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_host_trace_branch_matches_plain_trace_steps(host_kernel, name):
    """32 replicas through every stream step of a run: the host build of
    the trace branch, 16 lanes a thread block, against plain_trace_steps
    on the same pages, the window moved on by the plain state's least
    reading cursor as the engine moves it; the launcher picks the code
    the case names (but for the whole chaos code's cases, which run the
    chaos models on it; the model with a defense takes it)."""
    instantiation, max_events = _MODELS[name]
    model = _model(name)
    compiled = TCompiled(model)
    n, macro, P = 32, compiled.macro, compiled.trace_chunk_len
    n_chunks = -(-max_events // macro)
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(11), n)
    kernel_state = compiled.init_state(keys, params)
    plain_state = {k: v.clone() for k, v in kernel_state.items()}
    run = getattr(host_kernel, f"run_{instantiation}")
    ti = compiled.trace_src
    base_page, steps, stalled_seen = 0, 0, False
    while True:
        pages = _window(compiled, base_page)
        halted = torch.empty((n,), dtype=torch.uint8)
        draws = torch.zeros((n,), dtype=torch.int32)
        args = event_step.trace_launch_args(
            compiled, kernel_state, keys, params, pages, base_page * P, n_chunks, halted, draws
        )
        assert event_step.library_of(args) == "event_step_trace"
        if _CODES[instantiation] is not None:
            code, tel = _CODES[instantiation]
            assert (host_kernel.hs_event_step_code(ctypes.byref(args)).decode(),
                    bool(args.tel.nW)) == (code, tel)
        if name == "trace-defended":
            assert host_kernel.hs_event_step_code(ctypes.byref(args)) == b"full"
        assert run(ctypes.byref(args), 16) == 0
        plain_halted = event_step.plain_trace_steps(
            compiled, plain_state, keys, params, pages, base_page * P, n_chunks
        )
        steps += 1
        assert torch.equal(halted.bool(), plain_halted), f"step {steps}: halted"
        _assert_same(kernel_state, plain_state, f"{name} step {steps}")
        reads = (
            torch.isfinite(plain_state["src_next"][:, ti])
            & (plain_state["trc_blocks"] < n_chunks)
            & ~plain_halted
        )
        if not bool(reads.any()):
            break
        cursor = plain_state["trc_cursor"].to(torch.int64)
        # A lane still reading is stalled at the window's edge.
        assert bool((cursor[reads] + macro >= base_page * P + 2 * P).all())
        stalled_seen = True
        new_page = int(cursor[reads].min()) // P
        assert new_page > base_page
        base_page = new_page
    assert stalled_seen and steps > 2
    blocks = plain_state["trc_blocks"]
    if name.endswith("-budget"):
        assert bool((blocks == n_chunks).any()), "the budget never ran out"
    assert int(plain_state["events"].min()) > 0
    # Each lane counted one arrival, for some tenant, per trace fire.
    arrivals = plain_state["trc_arrivals"].sum(dim=1)
    assert bool((arrivals == plain_state["trc_cursor"].to(torch.int64)).all())
