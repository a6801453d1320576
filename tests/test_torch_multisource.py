"""Several sources, several sinks, and nodes no source reaches: the port's
plan, state and plain step against the JAX engine's lax step, which is
where JAX runs these models (its kernel declines them); the whole runs
are test_torch_multisource_runs.py's.

Block parity feeds both packages the same JAX-made state and uniform
blocks: integer leaves exactly, floats within rel 1e-5 plus 32 ulp of
the horizon (test_torch_event_step.py's tolerance).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu.tpu.kernels import kernel_plan as j_kernel_plan  # noqa: E402
from happysim_tpu_torch import convert  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.kernels import support  # noqa: E402
from happysim_tpu_torch.kernels.event_step import plain_block_step  # noqa: E402
from test_torch_event_step import (  # noqa: E402
    GRAPH_ULPS,
    _assert_leaves_match,
    _block_u,
    _jax_state,
    _lax_block,
)
from test_torch_multisource_models import MULTI_MODELS, no_sink  # noqa: E402

N_REPLICAS = 64
INT_FIELDS = (
    "simulated_events", "sink_count", "server_completed", "server_dropped",
    "transit_dropped", "limiter_admitted", "limiter_dropped", "truncated_replicas",
    "blocks_total", "block_occupancy", "max_blocks",
)
FLOAT_FIELDS = (
    "sink_mean_latency_s", "server_mean_wait_s", "server_utilization",
    "server_mean_queue_len", "sink_p50_s", "sink_p99_s",
)


def params_of(model, n):
    """The model's own (R, nS) rates and (R, nV) service means."""
    return {
        "src_rate": np.broadcast_to(
            np.asarray([s.rate for s in model.sources], np.float32), (n, len(model.sources))
        ).copy(),
        "srv_mean": np.broadcast_to(
            np.asarray([s.service_mean_s for s in model.servers], np.float32),
            (n, len(model.servers)),
        ).copy(),
    }


@pytest.mark.parametrize("name", sorted(MULTI_MODELS))
def test_plan_carries_jax_decline_as_data(name):
    """JAX's kernel declines each model (its lax step runs it); the port's
    plan runs it on the kernel and records JAX's reason and the nodes no
    source reaches."""
    build = MULTI_MODELS[name]
    expected, reason = j_kernel_plan(build(jmodel))
    assert expected is None
    jax_reason = reason[reason.index("(") + 1 : reason.index("); the lax")]
    plan = support.kernel_plan(build(tmodel))
    assert plan["declined"] == jax_reason
    model = build(tmodel)
    several = len(model.sources) > 1 or len(model.sinks) > 1
    assert (plan["shape"] == "multi") == several
    if several:
        assert (plan["sources"], plan["sinks"]) == (len(model.sources), len(model.sinks))
    reached = set(plan["servers"]) | set(plan["unreached"]["servers"])
    assert reached == set(range(len(model.servers)))
    assert plan["chaos"] == model.chaos_features()


def test_plan_of_two_class_lists_the_spare_server_unreached():
    plan = support.kernel_plan(MULTI_MODELS["two-class"](tmodel))
    assert plan["servers"] == [2, 0, 1]
    assert plan["unreached"] == {"servers": [3], "routers": [], "limiters": []}
    assert support.kernel_plan(no_sink(tmodel))["shape"] == "graph"


@pytest.mark.parametrize("name", sorted(MULTI_MODELS))
def test_init_state_matches_jax(name):
    """The (R, nS) first gaps (profiled rows inverted from t = 0), the
    (R, nK) sink leaves and every other leaf, from the same keys."""
    build = MULTI_MODELS[name]
    jm, tm = build(jmodel), build(tmodel)
    params = params_of(jm, 16)
    expected = _jax_state(JCompiled(jm), params, 16, seed=4)
    got = TCompiled(tm).init_state(
        tengine.rng.split(tengine.rng.PRNGKey(4), 16), convert.params_from_numpy(params)
    )
    assert set(got) == set(expected)
    _assert_leaves_match(expected, got, "init_state")


@pytest.mark.parametrize("name", sorted(MULTI_MODELS))
def test_plain_step_matches_lax_block_scan(name):
    """MACRO = 32 on 64 replicas, 6 chained blocks of the same uniforms:
    every leaf after every block (integer leaves exactly; the sources'
    argmin takes the lowest index on a tie, as jnp.argmin does)."""
    n = N_REPLICAS
    build = MULTI_MODELS[name]
    jm, tm = build(jmodel), build(tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    assert (tc.n_draws, tc.nS, tc.nK) == (jc.n_draws, jc.nS, jc.nK)
    params = params_of(jm, n)
    jstate = _jax_state(jc, params, n, seed=2)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(6):
        U = _block_u(keys, block, tc.macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(
            jstate, tstate, f"{name} lax block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    assert int(tstate["events"].min()) > 0


@pytest.mark.parametrize("name", sorted(MULTI_MODELS))
def test_model_fingerprint_equals_jax(name):
    build = MULTI_MODELS[name]
    assert tengine.model_fingerprint(build(tmodel)) == jengine.model_fingerprint(build(jmodel))
