"""The port's opinion dynamics (``happysim_tpu_torch.opinion``) against
the JAX package's ``happysim_tpu/tpu/opinion.py`` on the CPU, on the ring
graphs of tests/integration/test_tpu_opinion.py and on random graphs.

Tolerances: DeGroot and bounded confidence within rtol 1e-5 and atol
1e-6 (the JAX tests' own pair; XLA's CPU matrix-vector product sums in
another order than torch's and may fuse the update's multiply-add;
measured worst 8.9e-8 absolute, which is rel 2.9e-5 of an opinion near
0, hence the absolute term). The voter model's picks
are equal: both draw ``jax.random.categorical``'s Gumbel noise from the
same threefry uniforms, and no tested pick lies within an ulp of ``log``
of another. A batch of populations equals each population's own run
within rtol 1e-6 (the JAX test's vmap tolerance) and atol 1e-7: torch's
batched product sums in another order than its matrix-vector product,
which moves an opinion near 0 by a few 1e-9 (measured worst 6.5e-9).
"""

import random

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.components.behavior import (  # noqa: E402
    BoundedConfidenceModel,
    DeGrootModel,
    SocialGraph,
)
from happysim_tpu.tpu import opinion as jop  # noqa: E402
from happysim_tpu_torch import opinion as top  # noqa: E402
from happysim_tpu_torch import rng  # noqa: E402

CPU = "cpu"


def _ring_graph(n, weight=1.0):
    names = [f"a{i}" for i in range(n)]
    g = SocialGraph()
    for i in range(n):
        g.add_edge(names[i], names[(i + 1) % n], weight=weight)
        g.add_edge(names[i], names[(i + 2) % n], weight=0.5 * weight)
    return g, names


def _random_graph(n, p, seed):
    """Each ordered pair an edge with probability ``p``, weights in
    [0.1, 2), from a numpy seed."""
    draw = np.random.default_rng(seed)
    names = [f"a{i}" for i in range(n)]
    g = SocialGraph()
    for i in range(n):
        g.add_node(names[i])
        for j in range(n):
            if i != j and draw.random() < p:
                g.add_edge(names[i], names[j], weight=float(draw.uniform(0.1, 2.0)))
    return g, names


GRAPHS = {
    "ring16": lambda: _ring_graph(16),
    "ring64": lambda: _ring_graph(64, weight=0.7),
    "random48": lambda: _random_graph(48, 0.1, 1),
    "random96": lambda: _random_graph(96, 0.05, 2),
}


def _inputs(name, seed=2):
    graph, names = GRAPHS[name]()
    weights = jop.graph_weight_matrix(graph, names)
    opinions = np.random.default_rng(seed).uniform(-1.0, 1.0, len(names)).astype(np.float32)
    return weights, opinions


def _close(got, expected):
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_weight_matrix_matches_jax(name):
    graph, names = GRAPHS[name]()
    for order in (names, None):
        expected = jop.graph_weight_matrix(graph, order)
        got = top.graph_weight_matrix(graph, order)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, expected)


def test_graph_weight_matrix_is_listener_major():
    g = SocialGraph()
    g.add_edge("x", "y", weight=0.7)  # x influences y
    w = top.graph_weight_matrix(g, names=["x", "y"])
    assert w[1, 0] == pytest.approx(0.7) and w[0, 1] == 0.0


@pytest.mark.parametrize("rounds", [1, 20])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_degroot_matches_jax(name, rounds):
    weights, x = _inputs(name)
    expected = jop.degroot_rounds(jnp.asarray(x), jnp.asarray(weights), 0.4, rounds=rounds)
    _close(top.degroot_rounds(torch.from_numpy(x), torch.from_numpy(weights), 0.4, rounds, CPU), expected)


@pytest.mark.parametrize("epsilon", [0.3, 0.6])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bounded_confidence_matches_jax(name, epsilon):
    weights, x = _inputs(name)
    expected = jop.bounded_confidence_rounds(
        jnp.asarray(x), jnp.asarray(weights), epsilon, 0.5, rounds=8
    )
    got = top.bounded_confidence_rounds(
        torch.from_numpy(x), torch.from_numpy(weights), epsilon, 0.5, 8, CPU
    )
    _close(got, expected)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_voter_picks_match_jax(name, seed):
    weights, x = _inputs(name)
    expected = jop.voter_rounds(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(weights), 6)
    got = top.voter_rounds(rng.PRNGKey(seed), torch.from_numpy(x), torch.from_numpy(weights), 6, CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def _host_round(model, opinions, weights):
    """One synchronous round of the host executor's influence model."""
    draw = random.Random(0)
    out = []
    for i in range(len(opinions)):
        infl = [j for j in range(len(opinions)) if weights[i, j] > 0]
        out.append(model.compute_influence(
            opinions[i], [opinions[j] for j in infl], [float(weights[i, j]) for j in infl], draw
        ))
    return np.array(out, dtype=np.float32)


def test_degroot_and_bounded_confidence_match_the_host_models():
    weights, x = _inputs("ring16")
    host = x.copy()
    for _ in range(5):
        host = _host_round(DeGrootModel(self_weight=0.4), host, weights)
    got = top.degroot_rounds(torch.from_numpy(x), torch.from_numpy(weights), 0.4, 5, CPU)
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-5, atol=1e-6)
    host = x.copy()
    for _ in range(3):
        host = _host_round(BoundedConfidenceModel(epsilon=0.4, self_weight=0.5), host, weights)
    got = top.bounded_confidence_rounds(torch.from_numpy(x), torch.from_numpy(weights), 0.4, 0.5, 3, CPU)
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rule", ["degroot", "bounded_confidence", "voter"])
def test_batched_populations_match_each_population(rule):
    """A (B, N) batch against each row's (N,) run; the voter's batch
    shares the picks of its one key, as jax.vmap over the opinions does."""
    weights, _ = _inputs("random48")
    batch = np.random.default_rng(1).uniform(-1.0, 1.0, (8, weights.shape[0])).astype(np.float32)
    w = torch.from_numpy(weights)
    run = {
        "degroot": lambda x: top.degroot_rounds(x, w, 0.5, 4, CPU),
        "bounded_confidence": lambda x: top.bounded_confidence_rounds(x, w, 0.5, 0.5, 4, CPU),
        "voter": lambda x: top.voter_rounds(rng.PRNGKey(1), x, w, 3, CPU),
    }[rule]
    batched = run(torch.from_numpy(batch))
    assert batched.shape == batch.shape
    for row in (0, 3, 7):
        np.testing.assert_allclose(batched[row].numpy(), run(torch.from_numpy(batch[row])).numpy(),
                                   rtol=1e-6, atol=1e-7)
    if rule == "voter":
        expected = jax.vmap(
            lambda x: jop.voter_rounds(jax.random.PRNGKey(1), x, jnp.asarray(weights), 3)
        )(jnp.asarray(batch))
        np.testing.assert_array_equal(batched.numpy(), np.asarray(expected))


def test_degroot_reaches_consensus_and_isolated_agents_keep_opinions():
    weights, x = _inputs("ring16")
    final = top.degroot_rounds(torch.from_numpy(x), torch.from_numpy(weights), 0.5, 1000, CPU)
    assert float(final.max() - final.min()) < 1e-3
    alone = torch.tensor([0.1, -0.5, 0.9, 0.0])
    zeros = torch.zeros((4, 4))
    assert torch.equal(top.degroot_rounds(alone, zeros, 0.5, 3, CPU), alone)
    assert torch.equal(top.voter_rounds(rng.PRNGKey(1), alone, zeros, 4, CPU), alone)


def test_bounded_confidence_polarisation_persists():
    x = torch.tensor([-0.9, -0.8, 0.8, 0.9])
    weights = torch.ones((4, 4)) - torch.eye(4)
    out = top.bounded_confidence_rounds(x, weights, epsilon=0.3, rounds=50, device=CPU)
    assert float(out[0]) < -0.5 and float(out[3]) > 0.5


@pytest.mark.parametrize("rule", ["degroot_rounds", "bounded_confidence_rounds", "voter_rounds"])
def test_rounds_need_a_card_unless_asked_for_the_cpu(rule, monkeypatch):
    """With no device named each round function runs on the card and
    raises where torch finds none; it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, w = torch.zeros(4), torch.ones((4, 4))
    args = (rng.PRNGKey(0), x, w) if rule == "voter_rounds" else (x, w)
    with pytest.raises(RuntimeError, match=f"{rule} runs on a CUDA device"):
        getattr(top, rule)(*args)
    assert getattr(top, rule)(*args, device="cpu").device.type == "cpu"
