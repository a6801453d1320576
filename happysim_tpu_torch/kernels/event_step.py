"""The macro-block event-step kernel: its wrapper, its build, and its plain
torch-op version (counterpart of ``happysim_tpu/tpu/kernels/event_step.py``,
whose ``build_block_step`` reaches the Pallas kernel).

:func:`block_step` advances every replica by one macro-block of
``U.shape[1]`` event steps, in place, and returns the per-replica halted
mask. For CUDA tensors it launches the hand-written kernel in
``csrc/event_step.cu`` (or raises); for CPU tensors it runs
:func:`plain_block_step`, the engine's torch-op step applied ``macro``
times, which is also the kernel's yardstick on the card.

The kernel is compiled on first use with ``nvcc`` from this package's
sources into ``build/`` at the repository root, bound through a plain C
launcher loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from happysim_tpu_torch.kernels import support

SOURCE = Path(__file__).resolve().parent / "csrc" / "event_step.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# No --use_fast_math, and no multiply-add contraction: the kernel must
# round exactly as the plain version's one-op-per-kernel torch step.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_MAX_NV = support.KERNEL_MAX_SERVERS
_loaded: dict = {}

# Struct fields holding state-leaf pointers, in EventStepArgs order,
# paired with the leaves they point at.
_LEAF_FIELDS = tuple(
    zip(
        (
            "t", "src_next", "events", "slot_done", "slot_created",
            "q_created", "q_enq", "q_head", "q_len", "started", "completed",
            "dropped", "wait_n", "busy_int", "depth_int", "wait_sum",
            "sink_count", "sink_sum", "sink_sq", "sink_hist",
        ),
        support.KERNEL_LEAVES,
    )
)


class _Args(ctypes.Structure):
    """Mirror of ``EventStepArgs`` in csrc/event_step.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name, _ in _LEAF_FIELDS]
        + [(name, ctypes.c_void_p) for name in ("halted", "U", "src_rate", "srv_mean")]
        + [
            (name, ctypes.c_int)
            for name in (
                "R", "nV", "C", "K", "macro", "n_draws",
                "src_down", "src_poisson", "u_gap", "u_svc1", "u_svc2",
            )
        ]
        + [(name, ctypes.c_float) for name in ("stop_after", "horizon", "warmup")]
        + [
            (name, ctypes.c_int * _MAX_NV)
            for name in ("srv_down", "svc_kind", "conc", "qcap")
        ]
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the event-step kernel cannot be built")


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/event_step.cu`` into ``build/`` unless a library for
    this exact source and flag set is already there. Returns the library
    path and the compiler's log (``-Xptxas -v``: registers and spills per
    instantiation; empty when the library was already built)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"event_step_{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, once per process."""
    if "lib" not in _loaded:
        path, _log = build_library()
        lib = ctypes.CDLL(str(path))
        lib.hs_event_step.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.hs_event_step.restype = ctypes.c_int
        lib.hs_event_step_max_servers.argtypes = []
        lib.hs_event_step_max_servers.restype = ctypes.c_int
        if lib.hs_event_step_max_servers() != _MAX_NV:
            raise RuntimeError("event-step library and wrapper disagree on the server bound")
        _loaded["lib"] = lib
    return _loaded["lib"]


def _expected_shapes(compiled, R: int, macro: int) -> dict:
    nS, nV, C, K, nK = compiled.nS, compiled.nV, compiled.C, compiled.K, compiled.nK
    per_server = (R, nV)
    return {
        "t": (R,), "src_next": (R, nS), "events": (R,),
        "srv_slot_done": (R, nV, C), "srv_slot_created": (R, nV, C),
        "srv_q_created": (R, nV, K), "srv_q_enq": (R, nV, K),
        "srv_q_head": per_server, "srv_q_len": per_server,
        "srv_started": per_server, "srv_completed": per_server,
        "srv_dropped": per_server, "srv_wait_n": per_server,
        "srv_busy_int": per_server, "srv_depth_int": per_server,
        "srv_wait_sum": per_server,
        "sink_count": (R, nK), "sink_sum": (R, nK), "sink_sq": (R, nK),
        "sink_hist": (R, nK, 80),
        "U": (R, macro, compiled.n_draws),
        "src_rate": (R, nS), "srv_mean": (R, nV),
    }


_INT_LEAVES = frozenset({
    "events", "srv_q_head", "srv_q_len", "srv_started", "srv_completed",
    "srv_dropped", "srv_wait_n", "sink_count", "sink_hist",
})


def _check(name: str, tensor: torch.Tensor, shape: tuple, device) -> None:
    dtype = torch.int32 if name in _INT_LEAVES else torch.float32
    if tensor.device != device:
        raise ValueError(f"event-step kernel: {name} is on {tensor.device}, not {device}")
    if tensor.dtype != dtype:
        raise ValueError(f"event-step kernel: {name} is {tensor.dtype}, expected {dtype}")
    if tuple(tensor.shape) != shape:
        raise ValueError(
            f"event-step kernel: {name} has shape {tuple(tensor.shape)}, expected {shape}"
        )
    if not tensor.is_contiguous():
        raise ValueError(f"event-step kernel: {name} is not contiguous")


def plain_block_step(compiled, state: dict, U: torch.Tensor, params: dict) -> torch.Tensor:
    """The plain torch-op version: ``compiled``'s one-event step applied
    ``U.shape[1]`` times, updating ``state`` in place. Returns the
    ``(R,)`` bool halted mask."""
    step = compiled.make_step()
    for k in range(U.shape[1]):
        step(state, params, U[:, k, :])
    return compiled.replica_halted(state)


def block_step(compiled, state: dict, U: torch.Tensor, params: dict) -> torch.Tensor:
    """Advance every replica by one macro-block, in place; returns the
    ``(R,)`` bool halted mask (True: next event past the horizon).

    ``U`` is the block's ``(R, macro, n_draws)`` float32 uniforms. CPU
    tensors run :func:`plain_block_step`; CUDA tensors launch the kernel
    on torch's current stream, after checking device, dtype, shape and
    contiguity, and raise on any mismatch or launch error.
    """
    device = state["t"].device
    if device.type == "cpu":
        return plain_block_step(compiled, state, U, params)
    if device.type != "cuda":
        raise ValueError(f"event-step kernel: unsupported device {device}")
    R, macro = U.shape[0], U.shape[1]
    support.check_kernel_bounds(compiled, macro)
    if compiled.nS != 1 or compiled.nK != 1:
        raise ValueError("event-step kernel: one source and one sink only")
    shapes = _expected_shapes(compiled, R, macro)
    tensors = {**{leaf: state[leaf] for _, leaf in _LEAF_FIELDS}, "U": U, **params}
    for name, shape in shapes.items():
        _check(name, tensors[name], shape, device)

    lib = load_library()
    halted = torch.empty((R,), dtype=torch.uint8, device=device)
    args = _Args()
    for field, leaf in _LEAF_FIELDS:
        setattr(args, field, state[leaf].data_ptr())
    args.halted = halted.data_ptr()
    args.U = U.data_ptr()
    args.src_rate = params["src_rate"].data_ptr()
    args.srv_mean = params["srv_mean"].data_ptr()
    args.R, args.nV, args.C, args.K = R, compiled.nV, compiled.C, compiled.K
    args.macro, args.n_draws = macro, compiled.n_draws
    args.src_down = compiled.src_down
    args.src_poisson = int(compiled.arrival_is_poisson[0])
    slot = lambda s: -1 if s is None else int(s)  # noqa: E731
    args.u_gap, args.u_svc1, args.u_svc2 = (
        slot(compiled.U_GAP), slot(compiled.U_SVC1), slot(compiled.U_SVC2)
    )
    args.stop_after = float(compiled.stop_after[0])
    args.horizon = compiled.horizon
    args.warmup = compiled.warmup
    for v in range(compiled.nV):
        args.srv_down[v] = int(compiled.srv_down[v])
        args.svc_kind[v] = int(compiled.service_kind[v])
        args.conc[v] = int(compiled.srv_concurrency[v])
        args.qcap[v] = int(compiled.queue_cap[v])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hs_event_step(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"event-step kernel launch failed: cudaError {rc}")
    block_step.launches += 1
    return halted.view(torch.bool)


#: Kernel launches since the count was last set to 0.
block_step.launches = 0
