"""The window barrier of the partitioned executor: its wrapper, its build
and its plain torch-op version (counterpart of the barrier in
``happysim_tpu/tpu/partitioned.py``'s ``one_window``, a lax sequence after
each window's scan; no Pallas kernel).

:func:`barrier` runs one barrier over a device's ``P`` partitions of ``R``
replicas each, laid out partition-major in one state dict: for every lane
the close-out of the window's depth integral, the clock aligned to the
window's end, the ring predecessor's outbox merged into the transit
registers (JAX's ``merge_inbox``; on the card each row searched only up
to its occupancy bound, :func:`event_step.transit_bound`, which the kernel
keeps) and that outbox reset. Partition 0's
predecessor is the ``inbox`` slab where given (a copy of the neighbour
device's or process's boundary outbox), else this state's own last
partition. CUDA tensors launch the hand-written kernel in
``csrc/partition_barrier.cu`` (or raise); CPU tensors run
:func:`plain_barrier`, which is also its yardstick on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from happysim_tpu_torch.engine import INF, _fused, _f32
from happysim_tpu_torch.kernels import build, event_step

_loaded: dict = {}

# The argument struct (defined beside the window kernel's, which carries
# one when the barrier is folded into a window's launch).
_BarrierArgs = event_step._BarrierArgs
# The state leaf behind each pointer of the lanes' own rows.
_LEAVES = {
    "t": "t", "depth_int": "srv_depth_int", "q_len": "srv_q_len",
    "tr_time": "tr_time", "tr_created": "tr_created", "tr_attempt": "tr_attempt",
    "tr_dropped": "tr_dropped",
    "ob_arrival": "ob_arrival", "ob_created": "ob_created", "ob_ingress": "ob_ingress",
    "ob_len": "ob_len",
}


def load_library():
    """Build (first use) and load the barrier kernel's library."""
    if "lib" not in _loaded:
        lib = build.libraries()["partition_barrier"]
        lib.hs_partition_barrier.argtypes = [ctypes.POINTER(_BarrierArgs), ctypes.c_void_p]
        lib.hs_partition_barrier.restype = ctypes.c_int
        lib.hs_partition_barrier_args_size.argtypes = []
        lib.hs_partition_barrier_args_size.restype = ctypes.c_int
        if lib.hs_partition_barrier_args_size() != ctypes.sizeof(_BarrierArgs):
            raise RuntimeError("barrier library and wrapper disagree on the argument layout")
        _loaded["lib"] = lib
    return _loaded["lib"]


_OUTBOX_LEAVES = ("ob_arrival", "ob_created", "ob_ingress", "ob_len")


def own_slab(state: dict, P: int, outbox=None) -> tuple:
    """The last partition's outbox rows of ``state`` (views; of the slab
    ``outbox`` where given): partition 0's inbox when the ring closes on
    this device."""
    R = state["t"].shape[0] // P
    rows = outbox or tuple(state[leaf] for leaf in _OUTBOX_LEAVES)
    return tuple(x[(P - 1) * R:] for x in rows)


def plain_barrier(compiled, state: dict, P: int, window_end, inbox=None) -> None:
    """The torch-op barrier, in place, in JAX's order: the inboxes taken
    (partition p's from p - 1, partition 0's from ``inbox`` or this
    state's own last partition), the close-out of the depth integral
    (``depth + q_len * gap``, rounded once as XLA contracts it), the
    outbox reset, the clock aligned to ``window_end``, and JAX's
    ``merge_inbox``: entry ``i`` of each lane's inbox, for ``i`` below its
    length, into the ingress server's transit registers
    (``_Compiled._into_transit``)."""
    R = state["t"].shape[0] // P
    first = own_slab(state, P) if inbox is None else inbox
    leaves = ("ob_arrival", "ob_created", "ob_ingress", "ob_len")
    arrival, created, ingress, length = (
        torch.cat([f.to(state[leaf].device), state[leaf][: (P - 1) * R]])
        for f, leaf in zip(first, leaves)
    )
    dev = state["t"].device
    limit = _f32(window_end, dev)
    gap = torch.clamp_min(limit - torch.maximum(state["t"], _f32(compiled.warmup, dev)), 0.0)
    depth = state["srv_depth_int"]
    q_len = state["srv_q_len"].to(torch.float32)
    depth.copy_(_fused(depth, (q_len, gap[:, None].expand_as(q_len))))
    state["ob_arrival"].fill_(INF)
    state["ob_created"].zero_()
    state["ob_ingress"].zero_()
    state["ob_len"].zero_()
    state["t"].copy_(torch.maximum(state["t"], limit))
    nV_real = len(compiled.model.servers)
    for i in range(compiled.OB):
        live = i < length
        if not bool(live.any()):
            break
        for v in range(nV_real):
            compiled._into_transit(state, live & (ingress[:, i] == v), v, arrival[:, i], created[:, i])


def barrier_args(compiled, state: dict, P: int, window_end, tr_hi: torch.Tensor,
                 inbox=None, outbox=None) -> _BarrierArgs:
    """The kernel's argument struct for one barrier over ``state`` (``P``
    partitions, partition-major) and its transit rows' occupancy bounds
    ``tr_hi`` (:func:`event_step.transit_bound`, which the kernel keeps up
    to date), after checking every tensor it points at; raises on any
    mismatch. ``outbox``, a slab ``(arrival, created, ingress, length)``
    shaped as the outbox leaves, is the outbox the lanes merge and reset
    instead of the state's leaves (a folded ring's scratch)."""
    device = state["t"].device
    lanes = state["t"].shape[0]
    if P < 1 or lanes % P:
        raise ValueError(f"partition barrier: {lanes} lanes do not hold {P} partitions")
    R = lanes // P
    nV, TR, OB = compiled.nV, compiled.TR, compiled.OB
    shapes = {
        "t": ((lanes,), torch.float32), "srv_depth_int": ((lanes, nV), torch.float32),
        "srv_q_len": ((lanes, nV), torch.int32),
        "tr_time": ((lanes, nV, TR), torch.float32), "tr_created": ((lanes, nV, TR), torch.float32),
        "tr_dropped": ((lanes, nV), torch.int32),
        "ob_arrival": ((lanes, OB), torch.float32), "ob_created": ((lanes, OB), torch.float32),
        "ob_ingress": ((lanes, OB), torch.int32), "ob_len": ((lanes,), torch.int32),
    }
    if compiled.has_backoff:
        shapes["tr_attempt"] = ((lanes, nV, TR), torch.int32)
    args = _BarrierArgs()
    rows = dict(zip(_OUTBOX_LEAVES, outbox or ()))
    for field, leaf in _LEAVES.items():
        if leaf not in shapes:
            continue
        x = rows.get(leaf, state.get(leaf))
        _check(leaf, x, *shapes[leaf], device)
        setattr(args, field, x.data_ptr())
    _check("tr_hi", tr_hi, (lanes, nV), torch.int32, device)
    args.tr_hi = tr_hi.data_ptr()
    slab = own_slab(state, P, outbox) if inbox is None else inbox
    inbox_shapes = (((R, OB), torch.float32), ((R, OB), torch.float32), ((R, OB), torch.int32),
                    ((R,), torch.int32))
    for field, x, (shape, dtype) in zip(("in_arrival", "in_created", "in_ingress", "in_len"),
                                        slab, inbox_shapes):
        _check(field, x, shape, dtype, device)
        setattr(args, field, x.data_ptr())
    args.P, args.R, args.nV, args.TR, args.OB = P, R, nV, TR, OB
    args.window_end = float(np.float32(window_end))
    args.warmup = float(np.float32(compiled.warmup))
    return args


def _check(name: str, x, shape: tuple, dtype, device) -> None:
    if x is None:
        raise ValueError(f"partition barrier: {name} is missing")
    if x.device != device:
        raise ValueError(f"partition barrier: {name} is on {x.device}, not {device}")
    if x.dtype != dtype:
        raise ValueError(f"partition barrier: {name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"partition barrier: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"partition barrier: {name} is not contiguous")


def launch(args: _BarrierArgs, device) -> None:
    """Launch the barrier with ready arguments (:func:`barrier_args`) on
    torch's current stream of ``device``; raise on a launch error. Every
    launch adds one to ``barrier.launches``."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hs_partition_barrier(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"partition barrier launch failed: cudaError {rc}")
    barrier.launches += 1


def barrier(
    compiled, state: dict, P: int, window_end, inbox=None, prepared: dict | None = None
) -> None:
    """One window barrier over ``state`` (``P`` partitions of a device,
    partition-major), in place: CPU tensors run :func:`plain_barrier`;
    CUDA tensors make one launch of the kernel on torch's current stream,
    after the checks of :func:`barrier_args`. Nothing waits for the
    device.

    ``prepared``, a dict the caller keeps for one ``state`` whose tensors
    stay in place (it may share it with :func:`event_step.window_steps`),
    holds the checked arguments from the first call on
    (``prepared["barrier"]``: later calls on the same ``state`` change only
    the window's end). A call with an ``inbox`` slab (a new tensor each
    window) checks its arguments anew. The transit rows' occupancy bounds
    are those both kernels keep for ``state["tr_time"]``
    (:func:`event_step.occupancy_bound`), with or without a dict."""
    device = state["t"].device
    if device.type == "cpu":
        plain_barrier(compiled, state, P, window_end, inbox)
        return
    if device.type != "cuda":
        raise ValueError(f"partition barrier: unsupported device {device}")
    tr_hi = event_step.occupancy_bound(state)
    mine = None if prepared is None else prepared.setdefault("barrier", {})
    if mine is None or inbox is not None or mine.get("state") is not state:
        args = barrier_args(compiled, state, P, window_end, tr_hi, inbox)
        if mine is not None and inbox is None:
            mine.update(state=state, args=args)
    else:
        args = mine["args"]
        args.window_end = float(np.float32(window_end))
        args.tr_hi = tr_hi.data_ptr()
    launch(args, device)


#: Kernel launches since the count was last set to 0.
barrier.launches = 0


class FoldedRing:
    """One device's whole ring (no inbox from another device or process)
    run with each window's barrier folded into the next window's launch:
    lane (p, r) of window w's launch first runs its barrier of window w -
    1 (the close-out, the clock, the merge of lane (p - 1, r)'s outbox and
    that outbox's reset) and then its window, so a window costs one launch,
    not two. The outboxes alternate between two scratch slabs by the
    window's parity: a launch's windows write one while its barriers read
    and reset the other, which no lane of the launch writes. The state's
    own outbox leaves stay reset, and :meth:`flush` runs the last window's
    barrier as a barrier launch, so the state after it is the unfolded
    loop's, bit for bit, and a snapshot holds no trace of the scratch.

    The launch arguments are built and checked once: two window launches
    (one a parity, each carrying the barrier of the other parity's slab)
    and two flushes. :meth:`window_args` and :meth:`flush_args` return the
    next ready struct (the host tests run them on the host build);
    :meth:`window` and :meth:`flush` launch them."""

    def __init__(self, compiled, state: dict, keys: torch.Tensor, params: dict, P: int,
                 budget: int):
        lanes, OB = state["t"].shape[0], compiled.OB
        device = state["t"].device
        self.state, self.device, self.budget = state, device, budget
        self.outboxes = [
            (
                torch.full((lanes, OB), float("inf"), dtype=torch.float32, device=device),
                torch.zeros((lanes, OB), dtype=torch.float32, device=device),
                torch.zeros((lanes, OB), dtype=torch.int32, device=device),
                torch.zeros((lanes,), dtype=torch.int32, device=device),
            )
            for _parity in range(2)
        ]
        tr_hi = event_step.occupancy_bound(state)
        self.halted = torch.empty((lanes,), dtype=torch.uint8, device=device)
        self.windows, self.flushes = [], []
        for k in range(2):
            args = event_step.window_launch_args(
                compiled, state, keys, params, 0.0, budget, self.halted, tr_hi,
                outbox=self.outboxes[k],
            )
            args.prt.bar = barrier_args(compiled, state, P, 0.0, tr_hi, outbox=self.outboxes[1 - k])
            self.windows.append(args)
            self.flushes.append(barrier_args(compiled, state, P, 0.0, tr_hi, outbox=self.outboxes[k]))
        # The window whose barrier has not run: (its end, its parity).
        self.pending = None

    def window_args(self, limit):
        """The launch of the window ending at ``limit``, with the pending
        barrier folded in (none before the first window or after a
        flush); that window's barrier is then the pending one."""
        tr_hi = event_step.occupancy_bound(self.state).data_ptr()
        parity = 0 if self.pending is None else 1 - self.pending[1]
        args = self.windows[parity]
        args.prt.limit = float(np.float32(limit))
        args.prt.tr_hi = args.prt.bar.tr_hi = tr_hi
        args.prt.fold = 0 if self.pending is None else 1
        if self.pending is not None:
            args.prt.bar.window_end = float(np.float32(self.pending[0]))
        self.pending = (limit, parity)
        return args

    def flush_args(self):
        """The pending barrier as a barrier launch's arguments, or None
        when none is pending; none is after it."""
        if self.pending is None:
            return None
        limit, parity = self.pending
        args = self.flushes[parity]
        args.window_end = float(np.float32(limit))
        args.tr_hi = event_step.occupancy_bound(self.state).data_ptr()
        self.pending = None
        return args

    def window(self, limit) -> None:
        event_step.launch(self.window_args(limit), self.device)

    def flush(self) -> None:
        args = self.flush_args()
        if args is not None:
            launch(args, self.device)


def folded_ring(compiled, state: dict, keys: torch.Tensor, params: dict, P: int, budget: int,
                prepared: dict) -> FoldedRing:
    """The ``prepared`` dict's :class:`FoldedRing` of ``state`` (made on
    first use), for a CUDA ``state`` whose ``P`` partitions hold the whole
    ring."""
    ring = prepared.get("fold")
    if ring is None or ring.state is not state or ring.budget != budget:
        if state["t"].device.type != "cuda":
            raise ValueError(f"partition barrier: a folded ring runs on CUDA, not {state['t'].device}")
        ring = prepared["fold"] = FoldedRing(compiled, state, keys, params, P, budget)
    return ring
