"""Opinion dynamics over a whole population as matrix products
(counterpart of ``happysim_tpu/tpu/opinion.py``).

- **DeGroot**: ``x' = s x + (1 - s) (W x / W 1)``, one product a round.
- **Bounded confidence** (Hegselmann-Krause): the same after masking the
  weights by ``|x_j - x_i| <= epsilon`` each round.
- **Voter model**: each agent adopts the opinion of one influencer drawn
  with probability proportional to the edge weight, by the Gumbel-max
  trick on the threefry uniforms of :mod:`~happysim_tpu_torch.rng`, as
  ``jax.random.categorical`` draws in its default ("low") mode.

Opinions are float32, ``(N,)`` for one population or ``(B, N)`` for a
batch of ``B`` populations on one graph (the batch axis is the
``jax.vmap`` the JAX package leaves to its caller). ``weights[i, j]`` is
how much agent ``i`` listens to agent ``j`` (0: no edge); the diagonal
should be zero, self-weight being explicit. The products are
``torch.matmul``, as the JAX package leaves them to XLA; no kernel of the
port is involved. Each round function runs on ``device``: the CUDA card
by default (raising where torch finds none), or the CPU for
``device="cpu"``; its inputs are moved there.
"""

from __future__ import annotations

import numpy as np
import torch

from happysim_tpu_torch import rng
from happysim_tpu_torch.engine import _resolve_device


def graph_weight_matrix(graph, names: list[str] | None = None) -> np.ndarray:
    """Dense listener-major float32 weight matrix of a social graph:
    ``out[i, j]`` is the weight of the edge ``j -> i`` (``j`` influences
    ``i``). ``graph`` is anything with the ``nodes`` and
    ``influence_weights(listener) -> {source: weight}`` of the JAX
    package's host ``SocialGraph``; ``names`` orders the agents (default:
    sorted node names)."""
    ordered = names if names is not None else sorted(graph.nodes)
    index = {n: i for i, n in enumerate(ordered)}
    out = np.zeros((len(ordered), len(ordered)), dtype=np.float32)
    for listener in ordered:
        for src, w in graph.influence_weights(listener).items():
            if src in index:
                out[index[listener], index[src]] = w
    return out


def _neighbor_mean(opinions: torch.Tensor, weights: torch.Tensor) -> tuple:
    """The row-normalised weighted mean of the neighbours' opinions (0
    where a row has no weight) and the mask of rows that have weight.
    ``weights`` is ``(N, N)``, or ``(B, N, N)`` for ``(B, N)`` opinions."""
    mass = weights.sum(dim=-1)
    total = torch.matmul(weights, opinions.unsqueeze(-1)).squeeze(-1)
    has = mass > 0
    one = torch.ones((), dtype=mass.dtype, device=mass.device)
    zero = torch.zeros((), dtype=total.dtype, device=total.device)
    return torch.where(has, total / torch.where(has, mass, one), zero), has


def _weights_f32(self_weight: float) -> tuple:
    """``s`` and ``1 - s`` as the float32 values the JAX package computes
    from its float32 ``self_weight``."""
    keep = np.float32(self_weight)
    return float(keep), float(np.float32(1.0) - keep)


def _on_device(device, entry: str, *tensors: torch.Tensor) -> list:
    """``tensors`` moved to the resolved ``device`` of ``entry``."""
    target = _resolve_device(device, entry)
    return [t.to(target) for t in tensors]


def degroot_rounds(
    opinions: torch.Tensor,
    weights: torch.Tensor,
    self_weight: float = 0.5,
    rounds: int = 1,
    device=None,
) -> torch.Tensor:
    """``rounds`` synchronous DeGroot updates: ``x_i' = s x_i + (1 - s)
    sum_j w_ij x_j / sum_j w_ij``; agents with no influencers keep their
    opinion."""
    keep, move = _weights_f32(self_weight)
    x, weights = _on_device(device, "degroot_rounds", opinions, weights)
    for _ in range(rounds):
        mean, has = _neighbor_mean(x, weights)
        x = torch.where(has, keep * x + move * mean, x)
    return x


def bounded_confidence_rounds(
    opinions: torch.Tensor,
    weights: torch.Tensor,
    epsilon: float = 0.3,
    self_weight: float = 0.5,
    rounds: int = 1,
    device=None,
) -> torch.Tensor:
    """Hegselmann-Krause: DeGroot rounds in which an edge counts only
    while the two opinions lie within ``epsilon`` of each other."""
    keep, move = _weights_f32(self_weight)
    epsilon = float(np.float32(epsilon))
    x, weights = _on_device(device, "bounded_confidence_rounds", opinions, weights)
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    for _ in range(rounds):
        gap = torch.abs(x.unsqueeze(-1) - x.unsqueeze(-2))
        near = torch.where(gap <= epsilon, weights, zero)
        mean, has = _neighbor_mean(x, near)
        x = torch.where(has, keep * x + move * mean, x)
    return x


def voter_rounds(
    key: torch.Tensor,
    opinions: torch.Tensor,
    weights: torch.Tensor,
    rounds: int = 1,
    device=None,
) -> torch.Tensor:
    """Voter model: each round every agent adopts the opinion of one
    influencer drawn in proportion to the edge weight; agents with no
    influencers keep theirs. ``key`` is a ``(2,)`` uint32 threefry key
    (``rng.PRNGKey``); round ``k`` draws with ``rng.split(key,
    rounds)[k]``, so the picks are ``jax.random.categorical``'s for the
    same key, and a batch of populations shares them."""
    key, x, weights = _on_device(device, "voter_rounds", key, opinions, weights)
    tiny = float(np.finfo(np.float32).tiny)
    neg_inf = torch.full((), -np.inf, dtype=torch.float32, device=weights.device)
    logits = torch.where(weights > 0, torch.log(torch.clamp_min(weights, 1e-30)), neg_inf)
    has = weights.sum(dim=-1) > 0
    n = weights.shape[-1]
    for round_key in rng.split(key, rounds):
        gumbel = -torch.log(-torch.log(rng.uniform(round_key, (n, n), minval=tiny, maxval=1.0)))
        picks = torch.argmax(gumbel + logits, dim=-1)
        x = torch.where(has, x[..., picks], x)
    return x
