"""The M/M/1 ensemble's Lindley scan (its wrapper, and its plain version).

:func:`mm1_scan` returns the per-replica ``(sum_w, sum_sq, sum_s)`` of
``happysim_tpu/tpu/mm1.py``'s ``_mm1_scan``: ``n_customers`` steps of the
Lindley recursion ``w = max(0, w + service - interarrival)`` for ``R``
replica lanes, summing the wait, its square and the service from customer
``warmup`` on. Step ``i`` draws ``uniform(fold_in(key, i), (2, R), 1e-12,
1.0)`` from the run's one key, so replica ``r`` reads elements ``r`` and
``R + r`` and its draws depend on ``R``, as in the JAX package. A shard
of a replica mesh runs its slab of the replicas (``first``, ``count``),
each with the draws it has in the whole run.

The float arithmetic follows XLA's compiled scan on the CPU: the divisions
by the static rates are products with their float32 reciprocals, and
``w + service``, the subtraction of the interarrival, the sum of squares
and the service sum are each one multiply-add (``numerics.fma_f32``).

For a CUDA key it launches the hand-written kernel in
``csrc/mm1_scan.cu``, one thread per replica, which draws with the
threefry of ``csrc/threefry.cuh``, or raises; for the CPU it runs
:func:`plain_mm1_scan`, the torch-op loop over customers, which is also
its yardstick on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from happysim_tpu_torch import rng
from happysim_tpu_torch.kernels import build
from happysim_tpu_torch.numerics import fma_f32

# The uniforms' range, as _mm1_scan draws them.
MINVAL, MAXVAL = 1e-12, 1.0

_loaded: dict = {}


def load_library():
    """Build (first use) and load the scan kernel's library."""
    if "lib" not in _loaded:
        lib = build.libraries()["mm1_scan"]
        lib.hs_mm1_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.hs_mm1_scan.restype = ctypes.c_int
        lib.hs_mm1_scan_threads.argtypes = []
        lib.hs_mm1_scan_threads.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]


def _reciprocal(rate: float) -> np.float32:
    """``float32(1 / float32(rate))``, the constant XLA folds ``/ rate`` into."""
    return np.float32(np.float32(1.0) / np.float32(rate))


def plain_mm1_scan(
    key: torch.Tensor, n_replicas: int, lam: float, mu: float, n_customers: int, warmup: int,
    first: int = 0, count=None,
) -> tuple:
    """The torch-op version: one loop step a customer, the draw by
    :func:`~happysim_tpu_torch.rng.uniform` on ``rng.fold_in(key, i)``,
    on the device of ``key`` (a ``(2,)`` uint32 key), for replicas
    ``first, ..., first + count - 1`` (default: all)."""
    dev = key.device
    count = n_replicas - first if count is None else count
    rows = slice(first, first + count)
    inv_lam = torch.tensor(_reciprocal(lam), device=dev)
    inv_mu = torch.tensor(_reciprocal(mu), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    w = torch.zeros((count,), dtype=torch.float32, device=dev)
    sum_w, sum_sq, sum_s = torch.zeros_like(w), torch.zeros_like(w), torch.zeros_like(w)
    for i in range(n_customers):
        u = rng.uniform(rng.fold_in(key, i), (2, n_replicas), minval=MINVAL, maxval=MAXVAL)
        interarrival, service = -torch.log(u[0, rows]), -torch.log(u[1, rows])
        w = torch.maximum(zero, fma_f32(-interarrival, inv_lam, fma_f32(service, inv_mu, w)))
        if i >= warmup:  # live: the dead steps add exact zeros
            sum_w = sum_w + w
            sum_sq = fma_f32(w, w, sum_sq)
            sum_s = fma_f32(service, inv_mu, sum_s)
    return sum_w, sum_sq, sum_s


def mm1_scan(
    key: torch.Tensor, n_replicas: int, lam: float, mu: float, n_customers: int, warmup: int,
    first: int = 0, count=None,
) -> tuple:
    """Per-replica ``(sum_w, sum_sq, sum_s)`` of replicas ``first, ...,
    first + count - 1`` of ``n_replicas`` (default: all), each
    ``(count,)`` float32, on the device of ``key``. A CPU key runs
    :func:`plain_mm1_scan`; a CUDA key launches the kernel on torch's
    current stream, and raises on a wrong key or a launch error. Every
    launch adds one to ``mm1_scan.launches``."""
    count = n_replicas - first if count is None else count
    if key.device.type == "cpu":
        return plain_mm1_scan(key, n_replicas, lam, mu, n_customers, warmup, first, count)
    if key.device.type != "cuda":
        raise ValueError(f"mm1 scan kernel: unsupported device {key.device}")
    if key.dtype != torch.uint32 or tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(
            f"mm1 scan kernel: key must be a contiguous (2,) uint32, got {key.dtype} {tuple(key.shape)}"
        )
    if (
        not 0 < 2 * n_replicas < 1 << 32 or n_customers < 0
        or first < 0 or count < 1 or first + count > n_replicas
    ):
        raise ValueError(
            f"mm1 scan kernel: replicas {first}..{first + count - 1} of {n_replicas}, "
            f"{n_customers} customers"
        )
    sums = [torch.empty((count,), dtype=torch.float32, device=key.device) for _ in range(3)]
    lo = np.float32(MINVAL)
    span = np.float32(np.float32(MAXVAL) - lo)
    lib = load_library()
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        rc = lib.hs_mm1_scan(
            key.data_ptr(), n_replicas, first, count, n_customers, warmup, float(lo), float(span),
            float(_reciprocal(lam)), float(_reciprocal(mu)),
            *(s.data_ptr() for s in sums), stream,
        )
    if rc != 0:
        raise RuntimeError(f"mm1 scan kernel launch failed: cudaError {rc}")
    mm1_scan.launches += 1
    return tuple(sums)


#: Kernel launches since the count was last set to 0.
mm1_scan.launches = 0
