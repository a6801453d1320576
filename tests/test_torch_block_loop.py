"""The event-step kernel's block loop and its shared-memory row tile, on
the CPU: the header built as host C++ (tests/test_torch_threefry.py's
harness), a launch running blocks ``first, ..., first + n - 1`` of every
replica until it halts, against :func:`event_step.plain_block_steps`; the
staged rows against the rows read in place; and the staging plan.

Tolerances: integer leaves, the blocks each replica ran and the halted
mask exactly; float leaves of the host build against the plain step
within rel 1e-5 (glibc's float32 logf, expf and powf differ from torch's
CPU ones by an ulp on some inputs); the host build against itself, staged
or not, bit for bit (the same arithmetic on the same host).
"""

import ctypes

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from happysim_tpu_torch import rng  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.engine import _resolve_params  # noqa: E402
from happysim_tpu_torch.kernels import event_step, support  # noqa: E402
from test_torch_threefry import _HOST_MODELS, build_host_kernel  # noqa: E402

# One model per instantiation of the harness: the M/M/1 line, the random
# fan-out, the chaos bench, the chaos fan-out with telemetry and the
# defended retry storm.
LOOP_MODELS = ("mm1", "fanout-random", "chaos-bench", "telemetry-chaos-fanout", "resilience-storm")
N = 32
FIRST = 3000
BLOCKS = 6


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp("block_loop_host"))


def _setup(name: str):
    """(instantiation, compiled, keys, params, state) at N replicas, the source swept
    over (0.02 .. 1) x its rate where the model allows, so that the slow
    replicas halt within a few blocks and the fast ones do not."""
    instantiation, build = _HOST_MODELS[name]
    model = build()
    model.macro_block = 8
    compiled = TCompiled(model)
    sweeps = None
    if not compiled.has_profile.any():
        rate = model.sources[0].rate
        sweeps = {"source_rate": np.linspace(0.02 * rate, rate, N).astype(np.float32)}
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, N, sweeps).items()}
    keys = rng.split(rng.PRNGKey(11), N)
    return instantiation, compiled, keys, params, compiled.init_state(keys, params)


def _host_loop(host_kernel, instantiation, compiled, state, keys, params, threads, plan=None):
    """One host launch of BLOCKS blocks from FIRST over ``state`` (in
    place) with ``threads`` lanes a block and the launch's own plan, or
    ``plan`` = (offsets, words); returns (blocks, halted, args)."""
    blocks = torch.zeros((N,), dtype=torch.int32)
    halted = torch.empty((N,), dtype=torch.uint8)
    args = event_step.launch_args(
        compiled, state, keys, FIRST, params, halted, n_blocks=BLOCKS, blocks=blocks
    )
    if plan is not None:
        offsets, words = plan
        args.stage = event_step._Stage((ctypes.c_int * len(offsets))(*offsets), words)
    assert getattr(host_kernel, f"run_{instantiation}")(ctypes.byref(args), threads) == 0
    return blocks, halted.bool(), args


def _assert_states(got: dict, want: dict, exact: bool) -> None:
    assert got.keys() == want.keys()
    for leaf in sorted(want):
        a, b = got[leaf], want[leaf]
        if b.is_floating_point() and not exact:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, err_msg=leaf)
        elif b.is_floating_point():
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), leaf
        else:
            assert torch.equal(a, b), leaf


@pytest.mark.parametrize("name", LOOP_MODELS)
def test_host_block_loop_matches_plain_block_steps(host_kernel, name):
    """One launch of six blocks against plain_block_steps: the same leaves,
    the same blocks run per replica, the same halted mask; some replicas
    halt inside the loop and some run every block (a replica whose first
    arrival lies past the horizon runs none)."""
    instantiation, compiled, keys, params, state = _setup(name)
    plain = {k: v.clone() for k, v in state.items()}
    blocks, halted, args = _host_loop(host_kernel, instantiation, compiled, state, keys, params, 1)
    assert (args.block, args.n_blocks) == (FIRST, BLOCKS) and args.blocks == blocks.data_ptr()
    plain_blocks = torch.zeros((N,), dtype=torch.int32)
    plain_halted = event_step.plain_block_steps(
        compiled, plain, keys, FIRST, BLOCKS, params, plain_blocks
    )
    _assert_states(state, plain, exact=False)
    assert torch.equal(blocks, plain_blocks)
    assert torch.equal(halted, plain_halted)
    assert bool(((blocks > 0) & (blocks < BLOCKS)).any()) and int(blocks.max()) == BLOCKS, blocks


@pytest.mark.parametrize("name", LOOP_MODELS)
def test_staged_rows_give_the_state_of_rows_in_place(host_kernel, name):
    """The host build with four lanes a block over one shared buffer,
    every stageable leaf in the tile and then only the plan's first leaves,
    against one lane a block with every row read in place: bit for bit,
    blocks and halted included."""
    instantiation, compiled, keys, params, state = _setup(name)
    rows = {
        leaf: int(np.prod(v.shape[1:])) for leaf, v in state.items() if leaf in support.STAGE_LEAVES
    }
    full = support.stage_plan(rows, 1 << 20)
    assert full[1] == sum(rows.values()) > 0
    tight = support.stage_plan(rows, 4 * (full[1] // 2))
    in_place = ([-1] * len(support.STAGE_LEAVES), 0)
    runs = []
    for threads, plan in ((1, in_place), (4, full), (4, tight)):
        copy = {k: v.clone() for k, v in state.items()}
        blocks, halted, _args = _host_loop(
            host_kernel, instantiation, compiled, copy, keys, params, threads, plan
        )
        runs.append((copy, blocks, halted))
    for copy, blocks, halted in runs[1:]:
        _assert_states(copy, runs[0][0], exact=True)
        assert torch.equal(blocks, runs[0][1]) and torch.equal(halted, runs[0][2])


# The consensus models through their cuts and the profiled sources (two
# rows of profile tables a thread block stages): a launch of the first
# 24 blocks from the initial state.
CUT_MODELS = (
    "consensus-quorum-undefended", "consensus-quorum-defended", "consensus-election-bully",
    "consensus-stochastic", "consensus-delay", "multi-profiled", "multi-two-class-telemetry",
)
CUT_BLOCKS = 24


@pytest.mark.parametrize("name", CUT_MODELS)
def test_host_launch_through_the_cuts_matches_plain_block_steps(host_kernel, name):
    """16 replicas, one launch of 24 blocks from block 0 (past the pinned
    cuts): against plain_block_steps, then with four lanes a block and
    every stageable row (the partition windows and the profile tables
    included) in shared memory, bit for bit against the rows read in
    place."""
    instantiation, build = _HOST_MODELS[name]
    compiled = TCompiled(build())
    n = 16
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(compiled.model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(5), n)
    state = compiled.init_state(keys, params)
    runs = []
    for threads, staged in ((1, False), (4, True)):
        copy = {k: v.clone() for k, v in state.items()}
        blocks = torch.zeros((n,), dtype=torch.int32)
        halted = torch.empty((n,), dtype=torch.uint8)
        args = event_step.launch_args(compiled, copy, keys, 0, params, halted, n_blocks=CUT_BLOCKS,
                                      blocks=blocks)
        rows = {leaf: int(np.prod(v.shape[1:])) for leaf, v in copy.items() if leaf in support.STAGE_LEAVES}
        offsets, words = support.stage_plan(rows, 1 << 20) if staged else ([-1] * len(support.STAGE_LEAVES), 0)
        args.stage = event_step._Stage((ctypes.c_int * len(offsets))(*offsets), words)
        assert getattr(host_kernel, f"run_{instantiation}")(ctypes.byref(args), threads) == 0
        runs.append((copy, blocks, halted.bool()))
    plain = {k: v.clone() for k, v in state.items()}
    plain_blocks = torch.zeros((n,), dtype=torch.int32)
    plain_halted = event_step.plain_block_steps(compiled, plain, keys, 0, CUT_BLOCKS, params, plain_blocks)
    _assert_states(runs[0][0], plain, exact=False)
    assert torch.equal(runs[0][1], plain_blocks) and torch.equal(runs[0][2], plain_halted)
    _assert_states(runs[1][0], runs[0][0], exact=True)
    assert torch.equal(runs[1][1], runs[0][1]) and torch.equal(runs[1][2], runs[0][2])
    if compiled.has_partitions:
        assert {"prt_start", "prt_end"} <= set(rows)
        assert int(plain["net_partitioned"].sum()) + int(plain.get("tr_dropped", plain["events"]).sum()) > 0
    if compiled.has_quorum:
        assert int(plain["qrm_dropped"].sum()) > 0


@pytest.mark.parametrize("name", ["mm1", "chaos-bench"])
def test_plain_block_steps_equal_chained_plain_block_step(name):
    """plain_block_steps from FIRST against BLOCKS calls of plain_block_step
    with the count the host loop kept (a replica counts a block iff it was
    live when the block began), none skipped."""
    _instantiation, compiled, keys, params, state = _setup(name)
    chained = {k: v.clone() for k, v in state.items()}
    blocks = torch.zeros((N,), dtype=torch.int32)
    halted = event_step.plain_block_steps(compiled, state, keys, FIRST, BLOCKS, params, blocks)
    counted = torch.zeros((N,), dtype=torch.int32)
    chained_halted = compiled.replica_halted(chained)
    for c in range(BLOCKS):
        counted += (~chained_halted).to(torch.int32)
        chained_halted = event_step.plain_block_step(
            compiled, chained, event_step.block_uniforms(compiled, keys, FIRST + c), params
        )
    _assert_states(state, chained, exact=True)
    assert torch.equal(blocks, counted) and torch.equal(halted, chained_halted)


def test_block_steps_on_the_cpu_run_the_plain_version():
    """block_steps on CPU tensors is plain_block_steps; an empty budget
    runs nothing."""
    _instantiation, compiled, keys, params, state = _setup("mm1")
    plain = {k: v.clone() for k, v in state.items()}
    blocks, plain_blocks = torch.zeros((N,), dtype=torch.int32), torch.zeros((N,), dtype=torch.int32)
    halted = event_step.block_steps(compiled, state, keys, 0, 3, params, blocks)
    plain_halted = event_step.plain_block_steps(compiled, plain, keys, 0, 3, params, plain_blocks)
    _assert_states(state, plain, exact=True)
    assert torch.equal(blocks, plain_blocks) and torch.equal(halted, plain_halted)
    assert int(blocks.sum()) > 0
    before = {k: v.clone() for k, v in state.items()}
    event_step.block_steps(compiled, state, keys, 3, 0, params, blocks)
    _assert_states(state, before, exact=True)


@pytest.mark.parametrize(
    "replicas, threads, tables, lane_bytes",
    [
        # 512 blocks of 128 lanes on 132 SMs: four a SM, 56 KB each.
        (65536, 128, 0, 448),
        (65536, 64, 0, 440),
        # The profile tables of a 512-point grid come out of the block's share.
        (65536, 128, 4096, 416),
        # One block: the most one block may take.
        (32, 128, 0, 227 * 1024 // 128),
        (1, 4, 0, 227 * 1024 // 4),
    ],
)
def test_stage_budget_keeps_one_wave(replicas, threads, tables, lane_bytes):
    assert support.stage_budget(replicas, tables, threads) == lane_bytes


def test_stage_plan_takes_the_leaves_in_order_while_they_fit():
    """The fan-out at 65,536 replicas: tr_time (256 B) and the slot rows
    (16 B each) fit 448 B a lane, tr_created (256 B) does not; a leaf the
    model has not got takes no room."""
    rows = {"tr_time": 64, "tr_created": 64, "srv_slot_done": 4, "srv_slot_created": 4}
    offsets, words = support.stage_plan(rows, 448)
    staged = dict(zip(support.STAGE_LEAVES, offsets))
    assert (staged["tr_time"], staged["tr_created"], staged["srv_slot_done"]) == (0, -1, 64)
    assert staged["srv_slot_created"] == 68 and words == 72
    assert staged["tr_attempt"] == staged["brk_fail_t"] == -1
    assert support.stage_plan(rows, 0) == ([-1] * len(support.STAGE_LEAVES), 0)


def test_launch_args_plan_the_tile_and_check_the_loop():
    """launch_args writes the plan for the replica count and the card, and
    checks the block range, the block count and the blocks tensor."""
    _instantiation, compiled, keys, params, state = _setup("fanout-random")
    halted = torch.empty((N,), dtype=torch.uint8)
    args = event_step.launch_args(compiled, state, keys, 0, params, halted)
    rows = {
        leaf: int(np.prod(state[leaf].shape[1:])) for leaf in support.STAGE_LEAVES if leaf in state
    }
    offsets, words = support.stage_plan(rows, support.stage_budget(N))
    assert list(args.stage.off) == offsets and args.stage.words == words > 0
    assert (args.n_blocks, args.blocks) == (1, None)
    blocks = torch.zeros((N,), dtype=torch.int32)
    again = event_step.launch_args(
        compiled, state, keys, (1 << 32) - 4, params, halted, n_blocks=4, blocks=blocks
    )
    assert (again.block, again.n_blocks, again.blocks) == ((1 << 32) - 4, 4, blocks.data_ptr())
    with pytest.raises(ValueError, match="uint32"):
        event_step.launch_args(compiled, state, keys, (1 << 32) - 4, params, halted, n_blocks=5)
    with pytest.raises(ValueError, match="blocks to run"):
        event_step.launch_args(compiled, state, keys, 0, params, halted, n_blocks=0)
    with pytest.raises(ValueError, match="blocks"):
        event_step.launch_args(compiled, state, keys, 0, params, halted, blocks=blocks.float())
    with pytest.raises(ValueError, match="shape"):
        event_step.launch_args(compiled, state, keys, 0, params, halted, blocks=blocks[:4])
