"""Carry state and parameters across between the two packages.

The JAX package's per-replica state leaves and parameter arrays, fetched
as numpy arrays (``np.asarray`` of each leaf of a ``vmap``-ed
``init_state``, or of ``run_ensemble``'s parameter dict), become the
port's tensors with the same names, dtypes and shapes, and back. The
tests use this to feed both packages the same state.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(leaves: dict, device=None) -> dict:
    """``{name: np.ndarray}`` -> ``{name: Tensor}`` on ``device``
    (copies; dtypes kept, uint32 keys included)."""
    return {
        name: torch.from_numpy(np.array(value, copy=True)).to(device)
        for name, value in leaves.items()
    }


def state_to_numpy(state: dict) -> dict:
    """``{name: Tensor}`` -> ``{name: np.ndarray}`` on the host (copies:
    the arrays never alias a CPU state that is updated in place)."""
    return {name: value.detach().to("cpu", copy=True).numpy() for name, value in state.items()}


def params_from_numpy(params: dict, device=None) -> dict:
    """Per-replica ``src_rate`` / ``srv_mean`` arrays -> float32 tensors."""
    return {
        name: torch.from_numpy(np.ascontiguousarray(value, np.float32)).to(device)
        for name, value in params.items()
    }
