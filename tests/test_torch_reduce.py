"""The port's limb reductions are bit-equal to ``happysim_tpu.tpu.reduce``,
and splitting the replicas into shards gives the same bits.

Every comparison is exact: the reductions are integer sums of values
that both packages compute exactly.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu import reduce as jreduce  # noqa: E402
from happysim_tpu_torch import reduce as treduce  # noqa: E402


def _ints(seed, shape, high):
    return np.random.default_rng(seed).integers(0, high, size=shape, dtype=np.int32)


def _floats(seed, shape):
    gen = np.random.default_rng(seed)
    x = (gen.exponential(0.5, size=shape) * gen.choice([1e-3, 1.0, 1e4], size=shape)).astype(
        np.float32
    )
    x[gen.random(size=shape) < 0.2] = 0.0  # sparse entries
    if x.ndim > 1:
        x[:, 0] = 0.0  # an all-zero column (scale 0)
    return x


def test_constants_match():
    assert treduce.MAX_EXACT_REPLICAS == jreduce.MAX_EXACT_REPLICAS
    assert treduce.N_LIMBS == jreduce.N_LIMBS and treduce.LIMB_BITS == jreduce.LIMB_BITS


@pytest.mark.parametrize(
    "shape, high", [((1,), 10), ((1000,), 2**31 - 1), ((257, 3), 2**20), ((64, 1, 80), 5000)]
)
def test_sum_i64_limbs_and_host_i64_match(shape, high):
    x = _ints(1, shape, high)
    expected = np.asarray(jreduce.sum_i64_limbs(jnp.asarray(x), axis=0))
    got = treduce.sum_i64_limbs(torch.from_numpy(x), axis=0).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(treduce.host_i64(got), jreduce.host_i64(expected))
    np.testing.assert_array_equal(treduce.host_i64(got), x.astype(np.int64).sum(axis=0))


@pytest.mark.parametrize("shape", [(1,), (513,), (300, 4), (64, 3, 2)])
def test_sum_f32_fixed_and_host_f64_match(shape):
    x = _floats(2, shape)
    exp = jreduce.sum_f32_fixed(jnp.asarray(x), axis=0)
    got = treduce.sum_f32_fixed(torch.from_numpy(x), axis=0)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(exp["q"]))
    np.testing.assert_array_equal(
        got["scale"].numpy().view(np.uint32), np.asarray(exp["scale"]).view(np.uint32)
    )
    host_t = treduce.host_f64(got)
    np.testing.assert_array_equal(host_t, jreduce.host_f64(exp))
    # Quantisation error stays at the documented level.
    np.testing.assert_allclose(host_t, x.astype(np.float64).sum(axis=0), rtol=x.shape[0] * 2.0**-29)


def test_sum_f32_fixed_nonzero_axis_matches():
    x = _floats(3, (5, 200))
    exp = jreduce.sum_f32_fixed(jnp.asarray(x), axis=1)
    got = treduce.sum_f32_fixed(torch.from_numpy(x), axis=1)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(exp["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(exp["scale"]))


def test_pow2_scale_matches_including_edges():
    # No subnormal maxima: XLA's CPU backend flushes them to zero (scale
    # 0) where torch keeps them (largest scale); no engine accumulator
    # has a subnormal column maximum.
    m = np.array(
        [0.0, 1.17549435e-38, 1e-20, 0.5, 1.0, 3.0, 1e20, 3.4e38], np.float32
    )
    exp = np.asarray(jreduce._pow2_scale(jnp.asarray(m)))
    got = treduce._pow2_scale(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), exp.view(np.uint32))


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_shard_split_gives_the_same_bits(n_shards):
    """Reducing replica shards separately and adding the shards' limb
    totals equals the one-shot reduction bit for bit (ints); for floats
    the shards quantise against the global max (the max of the shard
    maxima), as a sharded reduce does."""
    ints = torch.from_numpy(_ints(4, (1024, 3), 2**30))
    floats = torch.from_numpy(_floats(5, (1024, 3)))
    whole_i = treduce.sum_i64_limbs(ints)
    whole_f = treduce.sum_f32_fixed(floats)
    shard_i = sum(treduce.sum_i64_limbs(part) for part in ints.chunk(n_shards))
    torch.testing.assert_close(shard_i, whole_i, rtol=0, atol=0)

    scale = treduce._pow2_scale(
        torch.stack([part.amax(dim=0) for part in floats.chunk(n_shards)]).amax(dim=0)
    )
    shard_q = sum(
        treduce.sum_i64_limbs(torch.round(part * scale[None]).to(torch.int32))
        for part in floats.chunk(n_shards)
    )
    torch.testing.assert_close(scale, whole_f["scale"], rtol=0, atol=0)
    torch.testing.assert_close(shard_q, whole_f["q"], rtol=0, atol=0)
    np.testing.assert_array_equal(
        treduce.host_f64({"q": shard_q, "scale": scale}), treduce.host_f64(whole_f)
    )
