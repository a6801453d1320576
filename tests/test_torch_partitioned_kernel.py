"""The event-step kernel's partitioned instantiations and the window
barrier (csrc/partition_barrier.cu), built as host C++ (the harness of
test_torch_threefry.py) and driven through the windows of a partitioned
run against their plain versions, event_step.plain_window_steps and
partition_barrier.plain_barrier: the same state goes to both, window
after window (the kernel's window, then its barrier, against the plain
window, then the plain barrier), and every leaf must agree (integer
leaves exactly, floats within rel 1e-5: host libm against torch's CPU
math). Three partitions of eight replicas, on the lean graph code
without and with the family sampler and with the chaos branches (and a
ring whose two transit registers a server fill), the code for several
sources and sinks and the wide code (a model past the servers' table,
and one past the remotes' table of eight). Both kernels share one
occupancy bound a transit row (event_step.occupancy_bound, tied to the
state's tr_time), kept across the windows as run_partitioned keeps it:
after every launch it must equal the bound recomputed from tr_time. The same windows with each barrier folded
into the next window's launch (partition_barrier.FoldedRing, as
run_partitioned runs a ring held by one card) match the plain loop too."""

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
    "full-row-ring": "lean",
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


def _host_window(host_kernel, name, compiled, state, params, w, budget, tr_hi):
    """Window ``w`` of ``state`` on the host build of ``name``'s
    instantiation (16 lanes a thread block), the bound ``tr_hi`` kept."""
    halted = torch.empty((state["t"].shape[0],), dtype=torch.uint8)
    args = event_step.window_launch_args(
        compiled, state, state["key"], params, window_end(w, HOP_S), budget, halted, tr_hi
    )
    assert event_step.library_of(args) == "event_step_partitioned"
    assert bool(args.wide.on) == (_MODELS[name] == "wide")
    assert getattr(host_kernel, f"run_{_MODELS[name]}")(ctypes.byref(args), 16) == 0


def _host_barrier(host_kernel, compiled, state, P_, w, tr_hi, inbox=None, threads=32):
    args = partition_barrier.barrier_args(compiled, state, P_, window_end(w, HOP_S), tr_hi, inbox)
    host_kernel.run_barrier(ctypes.byref(args), threads)


def _assert_bound(state: dict, tr_hi: torch.Tensor, context: str) -> None:
    assert torch.equal(tr_hi, event_step.transit_bound(state)), context


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_host_window_and_barrier_match_the_plain_versions(host_kernel, name):
    """24 windows of three partitions of eight replicas: each window the
    host build of the partitioned instantiation (16 lanes a thread block),
    then the barrier (32 lanes a block), against the plain window and
    barrier on a copy; the default budget and one of 3 events, which
    truncates windows. The occupancy bound, built once before the first
    window and kept for tr_time (event_step.occupancy_bound, which every
    launch reads), equals its recomputation after every launch."""
    model = PARTITIONED_MODELS[name](tmodel)
    compiled = _PartitionCompiled(model, outbox_capacity=4)
    kernel_state, params = init_partitions(compiled, 0, P, R, seed=7, device="cpu")
    plain_state = {k: v.clone() for k, v in kernel_state.items()}
    tr_hi = event_step.occupancy_bound(kernel_state)
    budget = default_max_events_per_window(model, HOP_S)
    sent = 0
    for w in range(WINDOWS):
        limit = window_end(w, HOP_S)
        step_budget = 3 if w % 5 == 4 else budget
        # Each launch reads the bound kept for tr_time, as the wrappers do.
        _host_window(host_kernel, name, compiled, kernel_state, params, w, step_budget,
                     event_step.occupancy_bound(kernel_state))
        event_step.plain_window_steps(compiled, plain_state, params, limit, step_budget)
        _assert_same(kernel_state, plain_state, f"{name} window {w}")
        _assert_bound(kernel_state, event_step.kept_bound(kernel_state), f"{name} window {w}")
        sent = max(sent, int(plain_state["ob_len"].max()))
        _host_barrier(host_kernel, compiled, kernel_state, P, w,
                      event_step.occupancy_bound(kernel_state))
        partition_barrier.plain_barrier(compiled, plain_state, P, limit)
        _assert_same(kernel_state, plain_state, f"{name} barrier {w}")
        _assert_bound(kernel_state, event_step.kept_bound(kernel_state), f"{name} barrier {w}")
        assert int(plain_state["ob_len"].max()) == 0
        assert bool((plain_state["t"] >= torch.tensor(limit)).all())
    assert sent > 0 and int(plain_state["ob_sent"].sum()) > 0
    assert int(plain_state["truncated_windows"].sum()) > 0
    assert int(plain_state["events"].min()) > 0
    assert event_step.kept_bound(kernel_state) is tr_hi and int(tr_hi.max()) > 0
    if name == "full-row-ring":  # the rows filled: full rows dropped jobs
        assert int(tr_hi.max()) == compiled.TR == 2
        assert int(plain_state["tr_dropped"].sum()) > 0


_OUTBOX = ("ob_arrival", "ob_created", "ob_ingress", "ob_len")


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_host_folded_ring_matches_the_plain_loop(host_kernel, name):
    """The windows with each barrier folded into the next window's launch
    (partition_barrier.FoldedRing, its launches on the host build): after
    folded launch w, every leaf but the outbox equals the plain loop's
    after window w, the window's outbox sits in the scratch slab of its
    parity and equals the plain loop's outbox leaves, and the state's own
    outbox leaves stay reset; the flush (a barrier launch) then gives the
    plain loop's state after barrier 23 on every leaf, and the kept bound
    equals its recomputation throughout."""
    model = PARTITIONED_MODELS[name](tmodel)
    compiled = _PartitionCompiled(model, outbox_capacity=4)
    kernel_state, params = init_partitions(compiled, 0, P, R, seed=7, device="cpu")
    plain_state = {k: v.clone() for k, v in kernel_state.items()}
    reset = {leaf: kernel_state[leaf].clone() for leaf in _OUTBOX}
    run = getattr(host_kernel, f"run_{_MODELS[name]}")
    budget = default_max_events_per_window(model, HOP_S)
    ring = partition_barrier.FoldedRing(compiled, kernel_state, kernel_state["key"], params, P,
                                        budget)
    bound = event_step.kept_bound(kernel_state)
    for w in range(WINDOWS):
        if w:
            partition_barrier.plain_barrier(compiled, plain_state, P, window_end(w - 1, HOP_S))
        args = ring.window_args(window_end(w, HOP_S))
        assert args.prt.fold == (1 if w else 0)
        assert args.prt.tr_hi == args.prt.bar.tr_hi == bound.data_ptr()
        assert run(ctypes.byref(args), 16) == 0
        event_step.plain_window_steps(compiled, plain_state, params, window_end(w, HOP_S), budget)
        slab = dict(zip(_OUTBOX, ring.outboxes[ring.pending[1]]))
        _assert_same({k: v for k, v in kernel_state.items() if k not in _OUTBOX},
                     {k: v for k, v in plain_state.items() if k not in _OUTBOX},
                     f"{name} folded window {w}")
        _assert_same(slab, {leaf: plain_state[leaf] for leaf in _OUTBOX}, f"{name} outbox {w}")
        _assert_same({leaf: kernel_state[leaf] for leaf in _OUTBOX}, reset, f"{name} leaves {w}")
        _assert_bound(kernel_state, bound, f"{name} folded window {w}")
    host_kernel.run_barrier(ctypes.byref(ring.flush_args()), 32)
    assert ring.flush_args() is None
    partition_barrier.plain_barrier(compiled, plain_state, P, window_end(WINDOWS - 1, HOP_S))
    _assert_same(kernel_state, plain_state, f"{name} flushed")
    _assert_bound(kernel_state, bound, f"{name} flushed")
    for slab in ring.outboxes:  # both scratch outboxes reset again
        _assert_same(dict(zip(_OUTBOX, slab)), reset, f"{name} scratch")
    assert int(plain_state["ob_sent"].sum()) > 0


def test_host_bound_falls_when_the_highest_slot_pops(host_kernel):
    """On the full-row ring, window by window: some row's bound falls
    after a window (its highest occupied slot popped, the free slots
    below it skipped), some rise at a barrier (a merged job parked at the
    bound), and a bound of 2 falls to 0 in one window where slot 0 was
    already free."""
    model = PARTITIONED_MODELS["full-row-ring"](tmodel)
    compiled = _PartitionCompiled(model, outbox_capacity=4)
    state, params = init_partitions(compiled, 0, P, R, seed=7, device="cpu")
    tr_hi = event_step.transit_bound(state)
    budget = default_max_events_per_window(model, HOP_S)
    fell = rose = two_to_zero = 0
    for w in range(WINDOWS):
        before = tr_hi.clone()
        _host_window(host_kernel, "full-row-ring", compiled, state, params, w, budget, tr_hi)
        _assert_bound(state, tr_hi, f"window {w}")
        fell += int((tr_hi < before).sum())
        two_to_zero += int(((before == 2) & (tr_hi == 0)).sum())
        before = tr_hi.clone()
        _host_barrier(host_kernel, compiled, state, P, w, tr_hi)
        _assert_bound(state, tr_hi, f"barrier {w}")
        rose += int((tr_hi > before).sum())
    assert fell > 0 and rose > 0 and two_to_zero > 0, (fell, rose, two_to_zero)


@pytest.mark.parametrize("name", ["full-row-ring", "chaos-ring", "nine-remote-ring"])
def test_host_resume_rebuilds_the_bound(host_kernel, name):
    """A snapshot at the barrier of window 9 (the state's leaves alone, as
    a PartitionedCheckpoint holds them: no bound among them) resumed into
    new tensors: the resumed tr_time gets a bound of its own, built from
    it, and windows 10-23 give the uninterrupted run's bits on every
    leaf."""
    model = PARTITIONED_MODELS[name](tmodel)
    compiled = _PartitionCompiled(model, outbox_capacity=4)
    state, params = init_partitions(compiled, 0, P, R, seed=7, device="cpu")
    budget = default_max_events_per_window(model, HOP_S)
    snapshot = None
    for w in range(WINDOWS):
        _host_window(host_kernel, name, compiled, state, params, w, budget,
                     event_step.occupancy_bound(state))
        _host_barrier(host_kernel, compiled, state, P, w, event_step.occupancy_bound(state))
        if w == 9:
            snapshot = {k: v.numpy().copy() for k, v in state.items()}
    assert "tr_hi" not in snapshot and set(snapshot) == set(state)
    resumed = {k: torch.from_numpy(v) for k, v in snapshot.items()}
    assert event_step.kept_bound(resumed) is None
    hi = event_step.occupancy_bound(resumed)
    assert hi is not event_step.kept_bound(state)
    assert torch.equal(hi, event_step.transit_bound(resumed))
    for w in range(10, WINDOWS):
        _host_window(host_kernel, name, compiled, resumed, params, w, budget,
                     event_step.occupancy_bound(resumed))
        _host_barrier(host_kernel, compiled, resumed, P, w, event_step.occupancy_bound(resumed))
    for leaf, value in state.items():
        assert torch.equal(resumed[leaf], value), leaf
    assert event_step.kept_bound(resumed) is hi
    _assert_bound(resumed, hi, name)


def test_occupancy_bound_rebuilds_after_a_torch_op_only():
    """occupancy_bound keeps its tensor while tr_time is the same tensor
    unchanged by torch ops (the kernels keep it then), rebuilds it in
    place when a torch op wrote tr_time, gives another tr_time tensor a
    bound of its own, and keeps no tr_time alive."""
    import weakref

    model = PARTITIONED_MODELS["full-row-ring"](tmodel)
    compiled = _PartitionCompiled(model, outbox_capacity=4)
    state, _params = init_partitions(compiled, 0, 1, 4, seed=1, device="cpu")
    assert event_step.kept_bound(state) is None
    hi = event_step.occupancy_bound(state)
    assert int(hi.sum()) == 0 and event_step.kept_bound(state) is hi
    hi.fill_(7)  # a stale value the kernels would keep: not rebuilt
    assert event_step.occupancy_bound(dict(state)) is hi and int(hi.max()) == 7
    state["tr_time"][2, 0, 1] = 0.5  # a torch op: rebuilt in place
    assert event_step.occupancy_bound(state) is hi and hi.tolist() == [[0], [0], [2], [0]]
    old = state["tr_time"]
    state["tr_time"] = old.clone()
    state["tr_time"][1, 0, 0] = 0.25
    fresh = event_step.occupancy_bound(state)
    assert fresh is not hi and fresh.tolist() == [[0], [1], [2], [0]]
    assert event_step.kept_bound({"tr_time": old}) is hi and hi.tolist() == [[0], [0], [2], [0]]
    gone = weakref.ref(old)
    del old
    assert gone() is None


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
    tr_hi = event_step.transit_bound(state)
    _host_barrier(host_kernel, compiled, state, 2, 6, tr_hi, slab, threads=8)
    partition_barrier.plain_barrier(compiled, plain, 2, limit, slab)
    _assert_same(state, plain, "slab barrier")
    _assert_bound(state, tr_hi, "slab barrier")
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
                                         window_end(0, HOP_S), 8, halted,
                                         event_step.transit_bound(state))
    assert event_step.library_of(args) == "event_step_partitioned"
    assert (args.wide.on, args.prt.nRm) == (1, 9)
    _args, tables = event_step._model_args(compiled)
    assert list(tables.rm_ingress) == [0] * 9
    want = np.float32([HOP_S] + [HOP_S + 0.01 * i for i in range(8)])
    np.testing.assert_array_equal(np.array(tables.rm_latency, np.float32), want)
    event_step.plain_window_steps(compiled, state, params, window_end(0, HOP_S), 8)
