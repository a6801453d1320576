"""The window barrier of the partitioned executor: its wrapper, its build
and its plain torch-op version (counterpart of the barrier in
``happysim_tpu/tpu/partitioned.py``'s ``one_window``, a lax sequence after
each window's scan; no Pallas kernel).

:func:`barrier` runs one barrier over a device's ``P`` partitions of ``R``
replicas each, laid out partition-major in one state dict: for every lane
the close-out of the window's depth integral, the clock aligned to the
window's end, the ring predecessor's outbox merged into the transit
registers (JAX's ``merge_inbox``) and that outbox reset. Partition 0's
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
from happysim_tpu_torch.kernels import build

_loaded: dict = {}

_POINTERS = (
    "t", "depth_int", "q_len", "tr_time", "tr_created", "tr_attempt", "tr_dropped",
    "ob_arrival", "ob_created", "ob_ingress", "ob_len",
    "in_arrival", "in_created", "in_ingress", "in_len",
)
# The state leaf behind each pointer of the lanes' own rows.
_LEAVES = {
    "t": "t", "depth_int": "srv_depth_int", "q_len": "srv_q_len",
    "tr_time": "tr_time", "tr_created": "tr_created", "tr_attempt": "tr_attempt",
    "tr_dropped": "tr_dropped",
    "ob_arrival": "ob_arrival", "ob_created": "ob_created", "ob_ingress": "ob_ingress",
    "ob_len": "ob_len",
}


class _BarrierArgs(ctypes.Structure):
    """Mirror of ``BarrierArgs`` in csrc/partition_barrier.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _POINTERS]
        + [(name, ctypes.c_int) for name in ("P", "R", "nV", "TR", "OB")]
        + [(name, ctypes.c_float) for name in ("window_end", "warmup")]
    )


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


def own_slab(state: dict, P: int) -> tuple:
    """The last partition's outbox rows of ``state`` (views): partition
    0's inbox when the ring closes on this device."""
    R = state["t"].shape[0] // P
    return tuple(state[leaf][(P - 1) * R:] for leaf in ("ob_arrival", "ob_created", "ob_ingress", "ob_len"))


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


def barrier_args(compiled, state: dict, P: int, window_end, inbox=None) -> _BarrierArgs:
    """The kernel's argument struct for one barrier over ``state`` (``P``
    partitions, partition-major), after checking every tensor it points
    at; raises on any mismatch."""
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
    for field, leaf in _LEAVES.items():
        if leaf not in shapes:
            continue
        _check(leaf, state.get(leaf), *shapes[leaf], device)
        setattr(args, field, state[leaf].data_ptr())
    slab = own_slab(state, P) if inbox is None else inbox
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
    stay in place, holds the checked arguments from the first call on:
    later calls on the same ``state`` change only the window's end. A
    call with an ``inbox`` slab (a new tensor each window) checks its
    arguments anew."""
    device = state["t"].device
    if device.type == "cpu":
        plain_barrier(compiled, state, P, window_end, inbox)
        return
    if device.type != "cuda":
        raise ValueError(f"partition barrier: unsupported device {device}")
    if prepared is None or inbox is not None or prepared.get("state") is not state:
        args = barrier_args(compiled, state, P, window_end, inbox)
        if prepared is not None and inbox is None:
            prepared.update(state=state, args=args)
    else:
        args = prepared["args"]
        args.window_end = float(np.float32(window_end))
    launch(args, device)


#: Kernel launches since the count was last set to 0.
barrier.launches = 0
