#!/usr/bin/env python3
"""Census of the float32 differences between XLA's CPU backend and torch
that the port's parity tests meet (ROADMAP C), on the CPU:

    JAX_PLATFORMS=cpu python3 tools/float_census.py

- ``log``: 2,000,000 uniforms of (0, 1) (numpy, seed 0), each package's
  float32 log against a correctly rounded one (float64 log rounded to
  float32);
- ``t + e * m``: 2,000,000 event times from JAX's own ``-log(u)`` of
  those uniforms, t in [0, 160) and m in [0.01, 1): the compiled
  ``jax.jit(lambda t, e, m: t + e * m)`` against a float64 multiply-add
  rounded once to float32, and against two float32 roundings.

Prints one JSON object of counts.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

N = 2_000_000


def main() -> None:
    draws = np.random.default_rng(0)
    u = draws.uniform(0.0, 1.0, N).astype(np.float32)
    u = np.where(u > 0.0, u, np.float32(1e-12))
    exact = np.log(u.astype(np.float64)).astype(np.float32)
    xla = np.asarray(jax.jit(jnp.log)(u))
    tch = torch.log(torch.from_numpy(u)).numpy()
    e = np.asarray(jax.jit(lambda x: -jnp.log(x))(u))
    t = draws.uniform(0.0, 160.0, N).astype(np.float32)
    m = draws.uniform(0.01, 1.0, N).astype(np.float32)
    fused = np.asarray(jax.jit(lambda t, e, m: t + e * m)(t, e, m))
    once = (t.astype(np.float64) + e.astype(np.float64) * m.astype(np.float64)).astype(np.float32)
    twice = t + e * m
    print(json.dumps({
        "uniforms": N,
        "xla_log_not_correctly_rounded": int((xla != exact).sum()),
        "torch_log_not_correctly_rounded": int((tch != exact).sum()),
        "xla_log_differs_from_torch": int((xla != tch).sum()),
        "jit_t_plus_e_m_differs_from_one_rounding": int((fused != once).sum()),
        "jit_t_plus_e_m_differs_from_two_roundings": int((fused != twice).sum()),
    }))


if __name__ == "__main__":
    main()
