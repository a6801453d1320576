"""The port's plain event step against the JAX engine's, block by block.

Both packages start from the same JAX-made state (carried across with
``happysim_tpu_torch.convert``) and the same uniform block. The JAX side
runs as its own tests run it on the CPU: the Pallas kernel in interpret
mode, and the lax block scan of the same step closure.

Tolerances: integer leaves must be exactly equal. Float leaves allow
rel 1e-5, because XLA's CPU ``log`` differs from torch's by an ulp on
some inputs and XLA's CPU backend contracts multiply-adds that the torch
step rounds twice (both measured on this package's inputs).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu.tpu.kernels import build_block_step  # noqa: E402
from happysim_tpu.tpu.model import mm1_model as j_mm1  # noqa: E402
from happysim_tpu.tpu.model import pipeline_model as j_pipeline  # noqa: E402
from happysim_tpu_torch import convert, rng  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.kernels.event_step import block_step, plain_block_step  # noqa: E402
from happysim_tpu_torch.model import mm1_model as t_mm1  # noqa: E402
from happysim_tpu_torch.model import pipeline_model as t_pipeline  # noqa: E402

FLOAT_RTOL = 1e-5


def _params(model, n):
    return {
        "src_rate": np.full((n, 1), model.sources[0].rate, np.float32),
        "srv_mean": np.broadcast_to(
            np.asarray([s.service_mean_s for s in model.servers], np.float32),
            (n, len(model.servers)),
        ).copy(),
    }


def _jax_state(compiled, params, n, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    return jax.vmap(compiled.init_state)(keys, jparams)


def _block_u(keys, block, macro, n_draws):
    return jax.vmap(
        lambda k: jax.random.uniform(
            jax.random.fold_in(k, jnp.uint32(block)),
            (macro, n_draws),
            minval=1e-12,
            maxval=1.0,
        )
    )(keys)


def _assert_leaves_match(expected: dict, got: dict, context: str):
    assert set(expected) <= set(got), set(expected) - set(got)
    for name in sorted(expected):
        e = np.asarray(expected[name])
        g = got[name].cpu().numpy()
        assert g.dtype == e.dtype and g.shape == e.shape, (name, g.dtype, e.dtype)
        if np.issubdtype(e.dtype, np.floating):
            np.testing.assert_allclose(
                g, e, rtol=FLOAT_RTOL, atol=0, err_msg=f"{context}: {name}"
            )
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{context}: {name}")


@pytest.mark.parametrize(
    "build_j, build_t",
    [
        (lambda: j_mm1(8.0, 10.0, 20.0, warmup_s=5.0), lambda: t_mm1(8.0, 10.0, 20.0, warmup_s=5.0)),
        (
            lambda: j_pipeline(8.0, (0.05, 0.08, 0.06), 20.0, concurrency=2),
            lambda: t_pipeline(8.0, (0.05, 0.08, 0.06), 20.0, concurrency=2),
        ),
    ],
    ids=["mm1", "pipeline-c2"],
)
def test_init_state_matches_jax(build_j, build_t):
    jm, tm = build_j(), build_t()
    params = _params(jm, 32)
    expected = _jax_state(JCompiled(jm), params, 32, seed=4)
    compiled = TCompiled(tm)
    keys = rng.split(rng.PRNGKey(4), 32)
    got = compiled.init_state(keys, convert.params_from_numpy(params))
    assert set(got) == set(expected)
    _assert_leaves_match(expected, got, "init_state")


def test_plain_step_matches_pallas_interpret_kernel():
    """The JAX kernel as its own unit tier runs it: build_block_step in
    interpret mode, MACRO=2, 4 replicas, mm1_model(5, 9, 3, queue 8);
    two chained blocks."""
    macro, n = 2, 4
    jm = j_mm1(lam=5.0, mu=9.0, horizon_s=3.0, queue_capacity=8)
    tm = t_mm1(lam=5.0, mu=9.0, horizon_s=3.0, queue_capacity=8)
    jc, tc = JCompiled(jm), TCompiled(tm)
    assert tc.n_draws == jc.n_draws == 3
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=9)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    block_fn, _meta = build_block_step(jc, float(jm.horizon_s), macro, n, interpret=True)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(2):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = block_fn(jstate, U, jparams)
        block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(jstate, tstate, f"pallas block {block}")


def _lax_block(compiled, horizon):
    step = compiled.make_step(horizon, external_u=True)

    def one(state_row, u_rows, params_row):
        (out, _), _ = lax.scan(step, (state_row, params_row), u_rows)
        return out

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize(
    "build_j, build_t",
    [
        (lambda: j_mm1(8.0, 10.0, 20.0, warmup_s=5.0), lambda: t_mm1(8.0, 10.0, 20.0, warmup_s=5.0)),
        (
            lambda: j_pipeline(8.0, (0.05, 0.08, 0.06), 20.0),
            lambda: t_pipeline(8.0, (0.05, 0.08, 0.06), 20.0),
        ),
    ],
    ids=["mm1", "pipeline"],
)
def test_plain_step_matches_lax_block_scan(build_j, build_t):
    """MACRO=32 on 64 replicas: each package advances its own state
    through 8 chained blocks of the same uniforms; every leaf is compared
    after every block."""
    macro, n = 32, 64
    jm, tm = build_j(), build_t()
    jc, tc = JCompiled(jm), TCompiled(tm)
    assert tc.n_draws == jc.n_draws
    params = _params(jm, n)
    jstate = _jax_state(jc, params, n, seed=2)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(8):
        U = _block_u(keys, block, macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        halted = plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(jstate, tstate, f"lax block {block}")
        assert halted.dtype == torch.bool and halted.shape == (n,)
    # The blocks did real work: every replica served jobs.
    assert int(tstate["srv_completed"].min()) > 0


def test_state_round_trips_through_numpy():
    tm = t_pipeline(8.0, (0.05, 0.08), 5.0)
    compiled = TCompiled(tm)
    params = convert.params_from_numpy(_params(tm, 8))
    state = compiled.init_state(rng.split(rng.PRNGKey(0), 8), params)
    back = convert.state_from_numpy(convert.state_to_numpy(state))
    for name, value in state.items():
        assert back[name].dtype == value.dtype
        torch.testing.assert_close(back[name], value, rtol=0, atol=0)
