"""Float32 numerics the event step shares with the JAX engine as XLA
computes them on the CPU: a multiply-add rounded once, Giles' erfinv and
``jnp.interp``.

XLA's CPU backend contracts ``c + a * b`` into one fused multiply-add
inside the erfinv polynomial, ``jnp.interp``'s lerp and the profile
extrapolation. :func:`fma_f32` reproduces that in float64 (the product
of two float32 values is exact there, so the sum is rounded once in
float64 and once to float32, which matched XLA on every input tried).
The CUDA kernel evaluates the same expressions in double, so kernel and
plain version stay bit-equal on the card.
"""

from __future__ import annotations

import numpy as np
import torch

# Giles' single-precision erfinv ("Approximating the erfinv function",
# GPU Computing Gems, 2011), as XLA expands chlo.erf_inv for float32:
# Horner coefficients, highest power first, for w < 5 and for w >= 5.
ERFINV_LOW = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
ERFINV_HIGH = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
# jnp.interp's "dx is zero" threshold for float32 grids.
INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c + a * b`` for float32 tensors, rounded as one multiply-add."""
    return (c.double() + a.double() * b.double()).float()


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Float32 inverse error function: ``w = -log1p(-x*x)``, a nine-term
    polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times ``x``;
    ``x = +-1`` gives ``+-inf``. ``torch.erfinv`` is another
    approximation and would not match the JAX engine."""
    w = -torch.log1p(x * -x)
    low = w < 5.0
    # sqrt rounded correctly, as XLA's and CUDA's sqrtf are (torch's
    # vectorised CPU sqrt is off by an ulp on some inputs).
    root = torch.sqrt(w.double()).float()
    shifted = torch.where(low, w - 2.5, root - 3.0)

    def coeff(k: int) -> torch.Tensor:
        pair = torch.tensor(
            [ERFINV_HIGH[k], ERFINV_LOW[k]], dtype=torch.float32, device=x.device
        )
        return pair[low.long()]

    p = coeff(0)
    for k in range(1, len(ERFINV_LOW)):
        p = fma_f32(p, shifted, coeff(k))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for float32 ``x`` of any shape and
    sorted ``(G,)`` grids: the right-side search clipped to [1, G-1], the
    lerp from the left point (the left value where the interval is empty),
    and ``fp[0]`` / ``fp[-1]`` outside the grid."""
    G = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, G - 1)
    x_lo, f_lo = xp[i - 1], fp[i - 1]
    df = fp[i] - f_lo
    dx = xp[i] - x_lo
    delta = x - x_lo
    flat = torch.abs(dx) <= INTERP_EPS
    slope = delta / torch.where(flat, torch.ones_like(dx), dx)
    f = torch.where(flat, f_lo, fma_f32(slope, df, f_lo))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
