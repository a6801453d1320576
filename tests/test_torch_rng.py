"""The port's threefry2x32 draws are bit-equal to ``jax.random``.

JAX stays on the CPU; arrays cross between the packages as numpy.
Every comparison is exact: the port must reproduce the JAX stream bit
for bit (jax's default threefry, ``jax_threefry_partitionable`` on).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu_torch import rng  # noqa: E402

SEEDS = [0, 1, 42, 2**31 - 1, -1, -12345]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    expected = np.asarray(jax.random.PRNGKey(seed))
    got = _np(rng.PRNGKey(seed))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("num", [1, 2, 7, 256])
def test_split_matches(seed, num):
    expected = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = _np(rng.split(rng.PRNGKey(seed), num))
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("data", [0, 1, 80, 12345, 2**32 - 1])
def test_fold_in_matches_single_and_batched(data):
    keys_j = jax.random.split(jax.random.PRNGKey(3), 16)
    expected = np.stack(
        [np.asarray(jax.random.fold_in(k, np.uint32(data))) for k in keys_j]
    )
    keys_t = rng.split(rng.PRNGKey(3), 16)
    np.testing.assert_array_equal(_np(rng.fold_in(keys_t, data)), expected)
    np.testing.assert_array_equal(_np(rng.fold_in(keys_t[5], data)), expected[5])


@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 4), (32, 3), (7, 1, 2)])
@pytest.mark.parametrize(
    "bounds", [(0.0, 1.0), (1e-12, 1.0), (-2.0, 3.0)], ids=["unit", "engine", "wide"]
)
def test_uniform_matches(shape, bounds):
    lo, hi = bounds
    for seed in (0, 11):
        key_j = jax.random.PRNGKey(seed)
        expected = np.asarray(
            jax.random.uniform(key_j, shape, minval=lo, maxval=hi)
        )
        got = _np(rng.uniform(rng.PRNGKey(seed), shape, minval=lo, maxval=hi))
        assert got.dtype == np.float32 and got.shape == expected.shape
        np.testing.assert_array_equal(got.view(np.uint32), expected.view(np.uint32))


@pytest.mark.parametrize("block", [0, 1, 80])
@pytest.mark.parametrize("macro, n_draws", [(32, 3), (2, 3), (32, 7)])
def test_block_draw_matches(block, macro, n_draws):
    """The engine's per-block draw: uniform(fold_in(key_r, block),
    (macro, n_draws), 1e-12, 1) for every replica key."""
    keys_j = jax.random.split(jax.random.PRNGKey(5), 64)
    expected = np.asarray(
        jax.vmap(
            lambda k: jax.random.uniform(
                jax.random.fold_in(k, jnp.uint32(block)),
                (macro, n_draws),
                minval=1e-12,
                maxval=1.0,
            )
        )(keys_j)
    )
    keys_t = rng.split(rng.PRNGKey(5), 64)
    got = _np(
        rng.uniform(rng.fold_in(keys_t, block), (macro, n_draws), minval=1e-12, maxval=1.0)
    )
    assert got.shape == (64, macro, n_draws)
    np.testing.assert_array_equal(got.view(np.uint32), expected.view(np.uint32))


def test_initial_gap_draw_matches():
    """``_initial_gaps`` draws uniform(key_r, (nS,)) straight from each
    replica key."""
    keys_j = jax.random.split(jax.random.PRNGKey(9), 128)
    expected = np.asarray(
        jax.vmap(lambda k: jax.random.uniform(k, (1,), minval=1e-12, maxval=1.0))(keys_j)
    )
    got = _np(rng.uniform(rng.split(rng.PRNGKey(9), 128), (1,), minval=1e-12, maxval=1.0))
    np.testing.assert_array_equal(got.view(np.uint32), expected.view(np.uint32))
