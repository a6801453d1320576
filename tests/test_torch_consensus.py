"""The consensus tier (network partitions, a write quorum, leader
election) against the JAX engine, which runs it on its lax step (its
kernel declines it): the partition table's draw and consult, the init
sweeps, the state, and the plain step block by block.

Integer leaves must be equal. The partition uniforms and pinned windows
are bit for bit; stochastic windows formed from JAX's own exponential
draws are bit for bit, through torch's ``log`` within rel 1e-6 (ROADMAP C,
the float32 ``log`` class). Sweeps over the same windows are bit for bit.
Block parity allows test_torch_event_step.py's float tolerance.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu.tpu.faults import PARTITION_KEY_SALT as J_PARTITION_KEY_SALT  # noqa: E402
from happysim_tpu.tpu.faults import PartitionTable as JPartitionTable  # noqa: E402
from happysim_tpu.tpu.kernels import kernel_plan as j_kernel_plan  # noqa: E402
from happysim_tpu_torch import convert, faults, rng  # noqa: E402
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
from test_torch_consensus_models import CONSENSUS_MODELS, delay_mode, quorum_loss  # noqa: E402
from test_torch_multisource import params_of  # noqa: E402


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", ["stochastic", "quorum-undefended", "delay"])
def test_partition_table_matches_jax(name, seed):
    """The tables' constants equal JAX's; the salted uniforms are JAX's bit
    for bit; the windows made from JAX's exponential draws equal its
    sample_state bit for bit, and the port's own within rel 1e-6 (its
    pinned rows and unfired candidates exactly)."""
    jm, tm = CONSENSUS_MODELS[name](jmodel), CONSENSUS_MODELS[name](tmodel)
    jt, tt = JPartitionTable(jm), faults.PartitionTable(tm)
    assert faults.PARTITION_KEY_SALT == J_PARTITION_KEY_SALT
    for attr in ("member", "stochastic", "rate", "mean_dur", "dur_const", "trigger_p",
                 "det_start", "det_end", "drop_mode", "delay_s", "touched"):
        np.testing.assert_array_equal(getattr(tt, attr), getattr(jt, attr), err_msg=attr)
    assert (tt.nP, tt.Wp, tt.has_delay) == (jt.nP, jt.Wp, jt.has_delay)
    n = 64
    jkeys = jax.random.split(jax.random.PRNGKey(seed), n)
    expected = {k: np.asarray(v) for k, v in jax.vmap(jt.sample_state)(jkeys).items()}
    tkeys = rng.split(rng.PRNGKey(seed), n)
    got = {k: v.numpy() for k, v in tt.sample_state(tkeys).items()}
    assert set(got) == set(expected) == {"prt_start", "prt_end"}
    if tt.stochastic.any():
        ju = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(
                jax.random.fold_in(jax.random.fold_in(k, J_PARTITION_KEY_SALT), 0),
                (tt.nP, tt.Wp, 3), minval=1e-12, maxval=1.0,
            )
        )(jkeys))
        u = tt.draw_uniforms(tkeys).numpy()
        np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
        log0, log1 = (np.asarray(jnp.log(jnp.asarray(ju[..., i]))) for i in range(2))
        gaps = torch.from_numpy(-log0) / torch.from_numpy(tt.rate)[:, None]
        durs = torch.where(
            torch.from_numpy(tt.dur_const)[:, None],
            torch.from_numpy(tt.mean_dur)[:, None].expand(-1, tt.Wp),
            torch.from_numpy(-log1) * torch.from_numpy(tt.mean_dur)[:, None],
        )
        start, end = faults.windows_from(gaps, durs)
        fired = ju[..., 2] < tt.trigger_p[:, None]
        stoch = tt.stochastic[:, None]
        np.testing.assert_array_equal(
            np.where(stoch, np.where(fired, start.numpy(), np.inf), tt.det_start), expected["prt_start"]
        )
        np.testing.assert_array_equal(
            np.where(stoch, np.where(fired, end.numpy(), np.inf), tt.det_end), expected["prt_end"]
        )
    for key in expected:
        np.testing.assert_array_equal(np.isinf(got[key]), np.isinf(expected[key]))
        np.testing.assert_allclose(got[key], expected[key], rtol=1e-6, err_msg=key)
        np.testing.assert_array_equal(got[key][:, ~tt.stochastic], expected[key][:, ~jt.stochastic])


def test_partition_consult_matches_jax():
    """Dark, drop and delay per server at times on, off and at the edges
    of the windows, against JAX's consult (drop wins over delay)."""
    jm, tm = delay_mode(jmodel), delay_mode(tmodel)
    jt, tt = JPartitionTable(jm), faults.PartitionTable(tm)
    times = np.asarray([0.0, 2.0, 2.5, 3.0, 3.99, 4.0, 5.0, 7.5, 8.0, 8.25, 8.5, 9.0, 11.0], np.float32)
    state = tt.sample_state(rng.split(rng.PRNGKey(0), len(times)))
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    for v in range(3):
        dark, drop, delay = tt.consult(state, v, torch.from_numpy(times))
        for i, t in enumerate(times):
            jd, jdrop, jdelay = jt.consult({k: x[i] for k, x in jstate.items()}, jnp.float32(t))
            assert (bool(dark[i]), bool(drop[i])) == (bool(jd[v]), bool(jdrop[v])), (v, t)
            assert float(delay[i]) == float(jdelay[v]), (v, t)


@pytest.mark.parametrize(
    "mutate",
    [
        lambda m, s: m.network_partition(group=[]),
        lambda m, s: m.network_partition(group=[s, s], windows=((1.0, 2.0),)),
        lambda m, s: m.network_partition(group=[s], windows=((1.0, 2.0),), mode="delay"),
        lambda m, s: m.network_partition(group=[s], windows=((1.0, 2.0),), delay_s=0.1),
        lambda m, s: m.network_partition(group=[s], rate=1.0),
        lambda m, s: m.network_partition(group=[s], rate=1.0, mean_duration_s=1.0, trigger_p=0.0),
        lambda m, s: m.network_partition(group=[s], windows=((2.0, 1.0),)),
        lambda m, s: m.quorum([s], write=2, read=1),
        lambda m, s: m.leader_election([s], heartbeat_s=1.0, timeout_s=0.5),
        lambda m, s: m.leader_election([s], heartbeat_s=0.1, timeout_s=0.5, strategy="raft"),
        lambda m, s: (m.quorum([s], write=1, read=1), m.validate()),
        lambda m, s: (m.leader_election([s], heartbeat_s=0.1, timeout_s=0.5), m.validate()),
        lambda m, s: (m.server(max_retries=2, retry_backoff_s=0.1), m.validate()),
    ],
)
def test_model_api_rejects_like_jax(mutate):
    """Each consensus rejection raises JAX's ValueError, message for
    message."""
    messages = []
    for mod in (jmodel, tmodel):
        m = mod.mm1_model(8.0, 10.0, 5.0)
        with pytest.raises(ValueError) as info:
            mutate(m, mod.NodeRef(mod.SERVER, 0))
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_quorum_membership_licenses_backoff_retries_like_jax():
    """A quorum member with a backoff and retries but no fault is a valid
    retry path (its quorum rejections retry), and a breaker may watch a
    model whose only failure site is the quorum, as in JAX."""
    for mod in (jmodel, tmodel):
        m = quorum_loss(mod, True)
        m.validate()
    assert TCompiled(quorum_loss(tmodel, False)).qrm_can_retry.tolist() == [True] * 3


@pytest.mark.parametrize("name", sorted(CONSENSUS_MODELS))
def test_features_plan_and_fingerprint_match_jax(name):
    """consensus_features and chaos_features name JAX's features; JAX's
    kernel declines the consensus tier by name while the port's plan runs
    it; the model fingerprints are equal; the detection delays are
    JAX's."""
    jm, tm = CONSENSUS_MODELS[name](jmodel), CONSENSUS_MODELS[name](tmodel)
    assert tm.consensus_features() == jm.consensus_features()
    assert tm.chaos_features() == jm.chaos_features()
    plan, reason = j_kernel_plan(jm)
    assert plan is None and "not fused in the kernel yet" in reason
    assert "declined" not in support.kernel_plan(tm)
    assert support.kernel_plan(tm)["chaos"] == jm.chaos_features()
    assert tengine.model_fingerprint(tm) == jengine.model_fingerprint(jm)
    if tm.leader_election_spec is not None:
        assert tm.leader_election_spec.detection_delay_s() == jm.leader_election_spec.detection_delay_s()
    jc, tc = JCompiled(jm), TCompiled(tm)
    for attr in ("has_partitions", "has_quorum", "has_leader", "has_fault_retries",
                 "has_attempts", "has_transit", "qrm_write", "ldr_delay", "n_draws"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    np.testing.assert_array_equal(tc.qrm_can_retry, jc.qrm_can_retry)
    if tc.has_telemetry:
        # JAX keeps tel_sink_count out of its list of summed keys.
        assert sorted(tc.tel_keys - {"tel_sink_count"}) == sorted(jc.tel_sum_keys)


@pytest.mark.parametrize("name", sorted(set(CONSENSUS_MODELS) - {"delay"}))
def test_sweeps_over_jax_windows_match_jax_bit_for_bit(name):
    """The port's sweeps run on JAX's own sampled windows: the quorum's dark
    time, the elections, the leaderless time and the window integrals
    equal JAX's init_state outputs bit for bit."""
    jm, tm = CONSENSUS_MODELS[name](jmodel), CONSENSUS_MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    n = 32
    jstate = _jax_state(jc, params_of(jm, n), n, seed=5)
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items() if k != "key"})
    got = tc._consensus_sweeps(tstate)
    assert set(got) == {k for k in jstate if k.startswith(("qrm_dark", "ldr_", "tel_qrm_dark", "tel_ldr"))}
    for key, value in got.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jstate[key]), err_msg=key)


@pytest.mark.parametrize("name", sorted(CONSENSUS_MODELS))
def test_init_state_matches_jax(name):
    """Every leaf JAX's init_state makes, and only those: the partition
    registers within the log class, every integer leaf exactly."""
    jm, tm = CONSENSUS_MODELS[name](jmodel), CONSENSUS_MODELS[name](tmodel)
    params = params_of(jm, 16)
    expected = _jax_state(JCompiled(jm), params, 16, seed=4)
    got = TCompiled(tm).init_state(rng.split(rng.PRNGKey(4), 16), convert.params_from_numpy(params))
    assert set(got) == set(expected)
    _assert_leaves_match(expected, got, "init_state")


@pytest.mark.parametrize("name", sorted(CONSENSUS_MODELS))
def test_plain_step_matches_lax_block_scan(name):
    """The model's macro-block on 32 replicas, chained blocks of the same
    uniforms from JAX's state through the cut windows (192 steps): every
    leaf after every block
    (integer leaves exactly: partition drops and delays, quorum
    rejections and their retries, the defenses)."""
    n = 32
    jm, tm = CONSENSUS_MODELS[name](jmodel), CONSENSUS_MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    params = params_of(jm, n)
    jstate = _jax_state(jc, params, n, seed=2)
    keys = jstate.pop("key")
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
    tparams = convert.params_from_numpy(params)
    run_block = _lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for block in range(192 // tc.macro):
        U = _block_u(keys, block, tc.macro, jc.n_draws)
        jstate = run_block(jstate, U, jparams)
        plain_block_step(tc, tstate, torch.from_numpy(np.array(U)), tparams)
        _assert_leaves_match(
            jstate, tstate, f"{name} lax block {block}",
            atol=GRAPH_ULPS * float(np.spacing(np.float32(jm.horizon_s))),
        )
    assert int(tstate["events"].min()) > 0
