"""Layout-invariant cross-replica reductions (counterpart of
``happysim_tpu/tpu/reduce.py``).

Every number ``run_ensemble`` reports is a sum over the replica axis.
Two properties have to hold, on one card or on many later:

1. **No int32 wrap.** Per-replica int32 counters summed over 65k+
   replicas pass 2**31. :func:`sum_i64_limbs` splits each value into four
   8-bit limbs and sums each limb column in int32, which is exact up to
   :data:`MAX_EXACT_REPLICAS` replicas; :func:`host_i64` weighs the four
   totals into int64 on the host.
2. **The same bits whatever the summation order.** Float addition does
   not associate, so :func:`sum_f32_fixed` quantises every value to fixed
   point against the exact column maximum (a power-of-two scale, so the
   multiply is exact) and limb-sums the integer quanta; :func:`host_f64`
   rescales. Splitting the replicas into shards and adding the shards'
   limb totals gives the bits of the one-shot sum.

The functions take and return torch tensors on any device and give the
JAX package's bits on the same arrays. Inputs to :func:`sum_f32_fixed`
must be non-negative, as every engine accumulator is.

Across the shards of a replica mesh (:mod:`happysim_tpu_torch.mesh`),
:func:`shard_sum_i64_limbs` adds each shard's limb totals, and
:func:`shard_sum_f32_fixed` first takes the column maximum over every
shard (a per-shard maximum would pick another scale, so other bits),
then quantises and limb-sums each shard: both give the bits of the
one-shot sum over all replicas. Across processes the shard totals meet
in ``torch.distributed.all_reduce`` (``MAX`` for the maximum, ``SUM``
for the limbs) on the process's own device.
"""

from __future__ import annotations

import numpy as np
import torch

#: Bits per limb in the int32-emulated int64 sum.
LIMB_BITS = 8
#: Limbs covering a non-negative int32 (4 x 8 = 32 bits >= 31).
N_LIMBS = 4
#: Replica-count bound for exactness: each 8-bit limb column sums to at
#: most (2**8 - 1) * R, which must stay under 2**31.
MAX_EXACT_REPLICAS = 1 << (31 - LIMB_BITS)

_LIMB_MASK = (1 << LIMB_BITS) - 1


def sum_i64_limbs(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Exact sum over ``axis`` of non-negative int32 values, as
    ``(N_LIMBS, ...)`` int32 limb totals (recombined by :func:`host_i64`)."""
    x = x.to(torch.int32)
    limbs = torch.stack(
        [(x >> (LIMB_BITS * i)) & _LIMB_MASK for i in range(N_LIMBS)]
    )
    return limbs.sum(dim=axis + 1, dtype=torch.int32)


def host_i64(limbs) -> np.ndarray:
    """Weigh :func:`sum_i64_limbs` totals into int64 on the host."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    limbs = np.asarray(limbs).astype(np.int64)
    out = np.zeros(limbs.shape[1:], np.int64)
    for i in range(N_LIMBS):
        out += limbs[i] << (LIMB_BITS * i)
    return out


def _pow2_scale(m: torch.Tensor) -> torch.Tensor:
    """Per-column scale ``2**(29 - floor(log2(m)))`` built from the float32
    exponent bits, so ``x * scale`` is exact; zero columns get scale 0."""
    m = m.to(torch.float32)
    bits = m.view(torch.int32)
    biased = (bits >> 23) & 0xFF
    s_biased = torch.clamp(283 - biased, 1, 254)
    scale = (s_biased << 23).to(torch.int32).view(torch.float32)
    return torch.where(m > 0, scale, torch.zeros_like(scale))


def sum_f32_fixed(x: torch.Tensor, axis: int = 0) -> dict:
    """Order-free sum of NON-NEGATIVE float32 values over ``axis``, as
    ``{"q": (N_LIMBS, ...) int32, "scale": (...) float32}``
    (recombined by :func:`host_f64`). Relative error is about
    ``2**-29`` for dense columns and at worst ``n / 2**30``."""
    x = x.to(torch.float32)
    if axis != 0:
        x = torch.movedim(x, axis, 0)
    m = torch.amax(x, dim=0)
    scale = _pow2_scale(m)
    q = torch.round(x * scale[None]).to(torch.int32)
    return {"q": sum_i64_limbs(q, axis=0), "scale": scale}


def host_f64(packed) -> np.ndarray:
    """Rescale a :func:`sum_f32_fixed` result into float64 on the host."""
    if not isinstance(packed, dict):
        return np.asarray(packed, np.float64)
    scale = packed["scale"]
    if isinstance(scale, torch.Tensor):
        scale = scale.cpu().numpy()
    scale = np.asarray(scale, np.float64)
    q = host_i64(packed["q"]).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(scale > 0, q / np.maximum(scale, 1e-300), 0.0)


def reduce_over_processes(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced in place over the processes of ``group`` by ``op``
    ("SUM" or "MAX"); ``x`` itself without a group."""
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=group)
    return x


def shard_sum_i64_limbs(xs, device, group=None) -> torch.Tensor:
    """:func:`sum_i64_limbs` over the replica axis of every shard's array
    in ``xs`` (this process's shards), on ``device``, and over the
    processes of ``group`` where given."""
    total = None
    for x in xs:
        part = sum_i64_limbs(x, axis=0).to(device)
        total = part if total is None else total + part
    return reduce_over_processes(total, "SUM", group)


def shard_max(xs, device, group=None) -> torch.Tensor:
    """The column maximum over the replica axis of every shard."""
    m = None
    for x in xs:
        part = torch.amax(x, dim=0).to(device)
        m = part if m is None else torch.maximum(m, part)
    return reduce_over_processes(m, "MAX", group)


def shard_sum_f32_fixed(xs, device, group=None) -> dict:
    """:func:`sum_f32_fixed` over the replica axis of every shard's array
    in ``xs``: the scale from the maximum over all shards, then each
    shard's quanta limb-summed on its device and added on ``device``."""
    xs = [x.to(torch.float32) for x in xs]
    scale = _pow2_scale(shard_max(xs, device, group))
    quanta = [torch.round(x * scale.to(x.device)[None]).to(torch.int32) for x in xs]
    return {"q": shard_sum_i64_limbs(quanta, device, group), "scale": scale}
