"""threefry2x32 keys and uniforms in plain torch ops: the random stream a
replica of the simulation draws, as ``jax.random`` defines it.

A frozen copy of the stream's definition, so the reference derives every
key and uniform itself: ``PRNGKey(seed)``, ``split(key, n)`` for the
replica keys, ``fold_in(key, block)`` for a macro-block's key and
``uniform(key, shape, 1e-12, 1.0)`` for its rows (threefry2x32 with
``jax_threefry_partitionable`` on). uint32 words ride in int64 tensors,
masked after every add and shift.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """20 rounds of threefry2x32 on int64-carried uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _words(key: torch.Tensor):
    key = key.to(torch.int64)
    return key[..., 0], key[..., 1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The ``(2,)`` key of ``seed``: a seed that fits int32 has high word 0
    and its two's-complement bits low; a wider seed its two 32-bit words."""
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 31):
        words = (0, seed & MASK)
    else:
        words = ((seed >> 32) & MASK, seed & MASK)
    return torch.tensor(words, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``num`` keys: key ``i`` is threefry(key, (0, i)); ``(num, 2)`` int64."""
    k0, k1 = _words(key)
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    return torch.stack(threefry2x32(k0, k1, torch.zeros_like(counts), counts), dim=-1)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """Each key of the ``(R, 2)`` batch folded with the word ``data``."""
    k0, k1 = _words(keys)
    d = torch.full_like(k0, int(data) & MASK)
    return torch.stack(threefry2x32(k0, k1, torch.zeros_like(d), d), dim=-1)


def uniform(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``(R, *shape)`` float32 uniforms on [1e-12, 1): one threefry block a
    value (its two words xored), the top 23 bits as the mantissa of a
    float in [1, 2), minus one, plus 1e-12 rounded once (the span
    ``1 - 1e-12`` is 1.0 in float32), and at least 1e-12."""
    k0, k1 = _words(keys)
    n = int(np.prod(shape, dtype=np.int64))
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(counts), counts)
    bits = (b0 ^ b1).reshape((keys.shape[0],) + tuple(shape))
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(1e-12))
    return torch.clamp_min((floats.double() + lo).float(), lo)
