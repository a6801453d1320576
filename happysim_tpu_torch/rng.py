"""threefry2x32 keys and uniforms, bit-identical to ``jax.random``.

Counterpart of the ``jax.random`` calls the JAX engine makes
(``happysim_tpu/tpu/engine.py``: ``PRNGKey``/``split`` for the per-replica
keys, ``fold_in`` + ``uniform`` for every macro-block's draw, and the
initial-gap draw). It follows jax's default threefry implementation with
``jax_threefry_partitionable`` on, so the same seed gives the same bits on
either package.

uint32 arithmetic is carried in int64 tensors and masked with
``& 0xFFFFFFFF`` after every add and shift (torch's uint32 op coverage is
thin). Keys are ``(..., 2)`` uint32 tensors, as in JAX; everything runs as
torch ops on the device of its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block (20 rounds) on int64-carried uint32 words.

    All four arguments broadcast against each other; returns the two
    output words as int64 tensors with values in ``[0, 2**32)``.
    """
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(key: torch.Tensor):
    key = key.to(torch.int64)
    return key[..., 0], key[..., 1]


def _as_key(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    return torch.stack([w0, w1], dim=-1).to(torch.uint32)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a ``(2,)`` uint32 tensor.

    A seed that fits int32 is taken as JAX takes it with x64 off (high
    word 0, low word the two's-complement bits); a wider seed splits into
    its high and low 32-bit words, as JAX does with x64 on.
    """
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 31):
        words = (0, seed & _MASK)
    else:
        words = ((seed >> 32) & _MASK, seed & _MASK)
    return torch.tensor(words, dtype=torch.int64, device=device).to(torch.uint32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: key ``i`` is threefry(key, (0, i))."""
    k0, k1 = _words(key)
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    return _as_key(*threefry2x32(k0, k1, torch.zeros_like(counts), counts))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` for a key or a ``(..., 2)`` batch of keys.

    ``data`` is a uint32 value (an int, or an int tensor broadcasting
    against the key batch)."""
    k0, k1 = _words(key)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    return _as_key(*threefry2x32(k0, k1, torch.zeros_like(data), data))


def _bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element: ``(*key_batch, *shape)`` int64."""
    k0, k1 = _words(key)
    n = int(np.prod(shape, dtype=np.int64))
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    extra = (1,) * k0.dim()
    counts = counts.reshape(extra + (n,))
    b0, b1 = threefry2x32(
        k0[..., None], k1[..., None], torch.zeros_like(counts), counts
    )
    return (b0 ^ b1).reshape(tuple(k0.shape) + tuple(shape))


def uniform(
    key: torch.Tensor, shape: tuple, minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    ``key`` may carry leading batch axes (one key per row); the result is
    ``(*batch, *shape)`` float32. The mantissa trick and the
    ``max(minval, .)`` clamp follow ``jax._src.random._uniform`` op for
    op. XLA fuses ``floats * (maxval - minval) + minval`` into one
    multiply-add (one rounding); the float64 evaluation here gives the
    same float32 (the product is exact in float64). With the engine's
    ``(1e-12, 1.0)`` the span is 1.0 and every evaluation agrees.
    """
    bits = _bits(key, tuple(shape))
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    floats = (mant - 1.0).to(torch.float64)
    scaled = (floats * float(span) + float(lo)).to(torch.float32)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=mant.device)
    return torch.maximum(lo_t, scaled)
