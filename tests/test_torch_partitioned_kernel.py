"""The event-step kernel's partitioned instantiations and the window
barrier (csrc/partition_barrier.cu), built as host C++ (the harness of
test_torch_threefry.py) and driven through the windows of a partitioned
run against their plain versions, event_step.plain_window_steps and
partition_barrier.plain_barrier: the same state goes to both, window
after window (the kernel's window, then its barrier, against the plain
window, then the plain barrier), and every leaf must agree (integer
leaves exactly, floats within rel 1e-5: host libm against torch's CPU
math). Three partitions of eight replicas, on the lean graph code
without and with the family sampler and with the chaos branches, the
code for several sources and sinks and the wide code (a model past the
servers' table, and one past the remotes' table of eight)."""

import ctypes
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch.kernels import event_step, partition_barrier, support  # noqa: E402
from happysim_tpu_torch.kernels.build import CSRC  # noqa: E402
from happysim_tpu_torch.partitioned import (  # noqa: E402
    _PartitionCompiled,
    default_max_events_per_window,
    init_partitions,
    window_end,
)
from test_torch_partitioned_models import HOP_S, PARTITIONED_MODELS  # noqa: E402
from test_torch_threefry import _RUN, _SHIMS, _compiler  # noqa: E402

# (MAXV, GRAPH, EXT, CHAOS, TEL, RES, CON, MULTI, TRC, PRT) of the
# partitioned library's instantiations (csrc/event_step_partitioned.cu).
_INSTANTIATIONS = {
    "lean": (1, "true", "false", "false", "false", "false", "false", "false", "false", "true"),
    "lean_ext": (2, "true", "true", "false", "false", "false", "false", "false", "false", "true"),
    "chaos": (1, "true", "true", "true", "false", "false", "false", "false", "false", "true"),
    "multi": (2, "true", "true", "true", "false", "false", "false", "true", "false", "true"),
    "wide": (0, "true", "true", "true", "false", "false", "false", "true", "false", "true"),
}
_MODELS = {
    "ring": "lean",
    "relay": "lean_ext",
    "chaos-ring": "chaos",
    "two-sink-ring": "multi",
    "wide-ring": "wide",
    "nine-remote-ring": "wide",
}
_BARRIER = """
#include "partition_barrier.cu"
extern "C" void run_barrier(const BarrierArgs* a, int threads) {
  blockDim.x = threads;
  const long long lanes = (long long)a->P * a->R;
  for (long long first = 0; first < lanes; first += threads) {
    blockIdx.x = (unsigned)(first / threads);
    for (int lane = 0; lane < threads; ++lane) {
      threadIdx.x = lane;
      partition_barrier_kernel(*a);
    }
  }
}
"""
P, R, WINDOWS = 3, 8, 24


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The partitioned instantiations and the barrier built for the host,
    exported as run_<name>(args, threads) and run_barrier(args, threads)."""
    build = tmp_path_factory.mktemp("event_step_partitioned_host")
    (build / "cuda_runtime.h").write_text("")
    body = [_SHIMS] + [
        _RUN.format(name=name, maxv=maxv, flags=", ".join(flags))
        for name, (maxv, *flags) in _INSTANTIATIONS.items()
    ] + [_BARRIER]
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
    lib.run_barrier.argtypes = [ctypes.POINTER(partition_barrier._BarrierArgs), ctypes.c_int]
    lib.run_barrier.restype = None
    return lib


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
def test_host_window_and_barrier_match_the_plain_versions(host_kernel, name):
    """24 windows of three partitions of eight replicas: each window the
    host build of the partitioned instantiation (16 lanes a thread block),
    then the barrier (32 lanes a block), against the plain window and
    barrier on a copy; the default budget and one of 3 events, which
    truncates windows."""
    model = PARTITIONED_MODELS[name](tmodel)
    compiled = _PartitionCompiled(model, outbox_capacity=4)
    kernel_state, params = init_partitions(compiled, 0, P, R, seed=7, device="cpu")
    plain_state = {k: v.clone() for k, v in kernel_state.items()}
    run = getattr(host_kernel, f"run_{_MODELS[name]}")
    budget = default_max_events_per_window(model, HOP_S)
    sent = 0
    for w in range(WINDOWS):
        limit = window_end(w, HOP_S)
        step_budget = 3 if w % 5 == 4 else budget
        halted = torch.empty((P * R,), dtype=torch.uint8)
        args = event_step.window_launch_args(
            compiled, kernel_state, kernel_state["key"], params, limit, step_budget, halted
        )
        assert event_step.library_of(args) == "event_step_partitioned"
        assert bool(args.wide.on) == (_MODELS[name] == "wide")
        assert run(ctypes.byref(args), 16) == 0
        event_step.plain_window_steps(compiled, plain_state, params, limit, step_budget)
        _assert_same(kernel_state, plain_state, f"{name} window {w}")
        sent = max(sent, int(plain_state["ob_len"].max()))
        host_kernel.run_barrier(
            ctypes.byref(partition_barrier.barrier_args(compiled, kernel_state, P, limit)), 32
        )
        partition_barrier.plain_barrier(compiled, plain_state, P, limit)
        _assert_same(kernel_state, plain_state, f"{name} barrier {w}")
        assert int(plain_state["ob_len"].max()) == 0
        assert bool((plain_state["t"] >= torch.tensor(limit)).all())
    assert sent > 0 and int(plain_state["ob_sent"].sum()) > 0
    assert int(plain_state["truncated_windows"].sum()) > 0
    assert int(plain_state["events"].min()) > 0


def test_host_barrier_takes_an_inbox_slab(host_kernel):
    """A barrier whose partition 0 reads a slab (the neighbour device's
    or process's boundary outbox): the host build against the plain
    version, a full outbox among the slab's rows."""
    model = PARTITIONED_MODELS["ring"](tmodel)
    compiled = _PartitionCompiled(model, outbox_capacity=2)
    state, params = init_partitions(compiled, 0, 2, R, seed=3, device="cpu")
    budget = default_max_events_per_window(model, HOP_S)
    for w in range(6):
        event_step.plain_window_steps(compiled, state, params, window_end(w, HOP_S), budget)
    g = np.random.default_rng(0)
    slab = (
        torch.from_numpy(g.uniform(0.3, 0.4, (R, 2)).astype(np.float32)),
        torch.from_numpy(g.uniform(0.0, 0.3, (R, 2)).astype(np.float32)),
        torch.zeros((R, 2), dtype=torch.int32),
        torch.from_numpy(g.integers(0, 3, R).astype(np.int32)),
    )
    plain = {k: v.clone() for k, v in state.items()}
    limit = window_end(6, HOP_S)
    host_kernel.run_barrier(
        ctypes.byref(partition_barrier.barrier_args(compiled, state, 2, limit, slab)), 8
    )
    partition_barrier.plain_barrier(compiled, plain, 2, limit, slab)
    _assert_same(state, plain, "slab barrier")
    assert int(plain["ob_len"].sum()) == 0


def test_more_remotes_than_the_lean_table_take_the_wide_code():
    """The lean code's remote table holds 8 egress nodes; a model with more
    no longer raises: its window launch takes the wide code, whose device
    tables hold every remote's latency and ingress server, and the plain
    path runs it as before."""
    model = PARTITIONED_MODELS["ring"](tmodel)
    for i in range(8):
        model.remote(ingress=tmodel.NodeRef(tmodel.SERVER, 0), latency_s=HOP_S + 0.01 * i)
    compiled = _PartitionCompiled(model, outbox_capacity=4)
    assert support.wide_reasons(compiled) == ["remote egress nodes=9 > 8"]
    state, params = init_partitions(compiled, 0, 1, 2, seed=1, device="cpu")
    halted = torch.empty((2,), dtype=torch.uint8)
    args = event_step.window_launch_args(compiled, state, state["key"], params,
                                         window_end(0, HOP_S), 8, halted)
    assert event_step.library_of(args) == "event_step_partitioned"
    assert (args.wide.on, args.prt.nRm) == (1, 9)
    _args, tables = event_step._model_args(compiled)
    assert list(tables.rm_ingress) == [0] * 9
    want = np.float32([HOP_S] + [HOP_S + 0.01 * i for i in range(8)])
    np.testing.assert_array_equal(np.array(tables.rm_latency, np.float32), want)
    event_step.plain_window_steps(compiled, state, params, window_end(0, HOP_S), 8)
