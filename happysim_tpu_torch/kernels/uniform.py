"""The standalone draw kernel: per-replica uniforms, bit-identical to
``jax.random.uniform`` (its wrapper, and its plain version).

:func:`replica_uniform` returns ``uniform(fold_in(key_r, purpose), shape,
minval, maxval)`` for every replica key ``key_r`` of an ``(R, 2)`` uint32
key batch, as an ``(R, *shape)`` float32 tensor: the draws of the chain
closed form (``happysim_tpu/tpu/chain.py``'s ``replica_uniform``, a
``vmap`` of ``jax.random.uniform``). For CUDA keys it launches the
hand-written kernel in ``csrc/uniform.cu``, which shares its threefry with
the event-step kernel (``csrc/threefry.cuh``), or raises; for CPU keys it
runs :func:`plain_replica_uniform`, the torch-op threefry of
:mod:`happysim_tpu_torch.rng`, which is also its yardstick on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from happysim_tpu_torch import rng
from happysim_tpu_torch.kernels import build

_loaded: dict = {}


def load_library():
    """Build (first use) and load the draw kernel's library."""
    if "lib" not in _loaded:
        lib = build.libraries()["uniform"]
        lib.hs_uniform.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.hs_uniform.restype = ctypes.c_int
        lib.hs_uniform_threefry_ops.argtypes = []
        lib.hs_uniform_threefry_ops.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]


def plain_replica_uniform(keys, purpose: int, shape: tuple, minval=1e-12, maxval=1.0):
    """The torch-op version: ``rng.uniform(rng.fold_in(keys, purpose), ...)``."""
    return rng.uniform(rng.fold_in(keys, purpose), tuple(shape), minval=minval, maxval=maxval)


def replica_uniform(keys: torch.Tensor, purpose: int, shape: tuple, minval=1e-12, maxval=1.0):
    """``(R, *shape)`` float32 uniforms in ``[minval, maxval)``, row ``r``
    drawn from ``fold_in(keys[r], purpose)``. CPU keys run
    :func:`plain_replica_uniform`; CUDA keys launch the kernel on torch's
    current stream, and raise on a wrong key tensor or a launch error.
    Every launch adds one to ``replica_uniform.launches``."""
    if keys.device.type == "cpu":
        return plain_replica_uniform(keys, purpose, shape, minval, maxval)
    if keys.device.type != "cuda":
        raise ValueError(f"uniform kernel: unsupported device {keys.device}")
    if keys.dtype != torch.uint32 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"uniform kernel: keys must be (R, 2) uint32, got {keys.dtype} {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("uniform kernel: keys are not contiguous")
    R = keys.shape[0]
    n = int(np.prod(shape, dtype=np.int64))
    out = torch.empty((R, *shape), dtype=torch.float32, device=keys.device)
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    lib = load_library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.hs_uniform(
            keys.data_ptr(), R, n, int(purpose) & 0xFFFFFFFF, float(lo), float(span),
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"uniform kernel launch failed: cudaError {rc}")
    replica_uniform.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
replica_uniform.launches = 0
