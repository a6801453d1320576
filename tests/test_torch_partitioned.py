"""The partitioned executor's pieces against the JAX package's, on the CPU:
a window (JAX's ``_PartitionCompiled.make_step(windowed=True)`` scanned
``max_events_per_window`` steps) against ``plain_window_steps``, and the
barrier (JAX's one_window statements around its ``merge_inbox``) against
``plain_barrier``, from the same mid-run states; the model
API of remote egress nodes; the fingerprint of a model with remotes; and
each of JAX's refusals. The whole runs are test_torch_partitioned_runs.py's.

Tolerances: integer leaves exactly; float leaves within rel 1e-5 plus 32
ulp of the horizon (XLA's CPU ``log`` differs from torch's by an ulp on
some draws: ROADMAP C).
"""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import partitioned as jpart  # noqa: E402
from happysim_tpu_torch import convert  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import partitioned as tpart  # noqa: E402
from happysim_tpu_torch.kernels import event_step, partition_barrier  # noqa: E402
from test_torch_partitioned_models import HOP_S, PARTITIONED_MODELS, ring  # noqa: E402

P, R, OB = 3, 8, 4
SNAPSHOT_WINDOWS = (6, 17)
HORIZON_S = 1.0
# Models whose windows and barriers the JAX package's step can trace (the
# wide ring runs through the same step; its nine servers only cost time).
MODELS = ("ring", "chaos-ring", "two-sink-ring", "relay")


def _atol(horizon_s: float) -> float:
    return 32 * float(np.spacing(np.float32(horizon_s)))


def _assert_same(expected: dict, got: dict, context: str, horizon_s: float) -> None:
    assert set(expected) == set(got), set(expected) ^ set(got)
    for name in sorted(expected):
        e, g = np.asarray(expected[name]), got[name].cpu().numpy()
        assert g.dtype == e.dtype and g.shape == e.shape, (context, name, g.dtype, e.dtype)
        if np.issubdtype(e.dtype, np.floating):
            np.testing.assert_allclose(g, e, rtol=1e-5, atol=_atol(horizon_s),
                                       err_msg=f"{context}: {name}")
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"{context}: {name}")


@pytest.fixture(scope="module")
def snapshots():
    """Mid-run states of each model, 3 partitions of 8 replicas, from the
    port's run with a snapshot at every window barrier (the windows and
    barriers of whole runs are held against JAX's in
    test_torch_partitioned_runs.py): ``{model: {window: flat (P R, ...)
    state}}``."""
    mesh = tpart.partition_mesh(["cpu"] * P)
    out = {}
    for name in MODELS:
        snaps = []
        tpart.run_partitioned(
            PARTITIONED_MODELS[name](tmodel, HORIZON_S), window_s=HOP_S, mesh=mesh, n_replicas=R,
            seed=5, outbox_capacity=OB, checkpoint_every_windows=1,
            checkpoint_callback=snaps.append,
        )
        out[name] = {
            s.window_index: {k: v.reshape((P * R,) + v.shape[2:]) for k, v in s.state.items()}
            for s in snaps if s.window_index in SNAPSHOT_WINDOWS
        }
    return out


@functools.lru_cache(maxsize=None)
def _jax_window_fn(name: str):
    """JAX's window, compiled once per model: the windowed step taken
    ``budget`` times per lane (one_window's scan, here a loop whose
    length is an argument, so both budgets share a compile), then
    one_window's budget-exhaustion test; the window end is an argument."""
    jc = jpart._PartitionCompiled(PARTITIONED_MODELS[name](jmodel, HORIZON_S), OB)
    step = jc.make_step(windowed=True)

    def lane(s, p, limit, budget):
        truncated = s.pop("truncated_windows")
        s, _, _ = lax.fori_loop(0, budget, lambda i, c: step(c, i)[0], (s, p, limit))
        pending = jnp.min(jc.next_candidates(s))
        s["truncated_windows"] = truncated + (pending <= limit).astype(jnp.int32)
        return s

    return jax.jit(jax.vmap(lane, in_axes=(0, 0, None, None)))


@functools.lru_cache(maxsize=None)
def _jax_barrier_fn(name: str):
    """one_window's barrier statements around JAX's merge_inbox, per lane,
    compiled once per model: the depth integral closed out, the outbox
    reset, the clock aligned, then the inbox merged."""
    jc = jpart._PartitionCompiled(PARTITIONED_MODELS[name](jmodel, HORIZON_S), OB)

    def lane(s, arrival, created, ingress, length, window_end):
        gap = jnp.maximum(window_end - jnp.maximum(s["t"], jnp.float32(jc.warmup)), 0.0)
        s = {
            **s,
            "srv_depth_int": s["srv_depth_int"] + s["srv_q_len"].astype(jnp.float32) * gap,
            "ob_arrival": jnp.full((jc.OB,), jnp.inf),
            "ob_created": jnp.zeros((jc.OB,), jnp.float32),
            "ob_ingress": jnp.zeros((jc.OB,), jnp.int32),
            "ob_len": jnp.int32(0),
            "t": jnp.maximum(s["t"], window_end),
        }
        return jc.merge_inbox(s, arrival, created, ingress, length)

    return jax.jit(jax.vmap(lane, in_axes=(0, 0, 0, 0, 0, None)))


def _jax_window(name: str, state: dict, params: dict, limit, budget: int) -> dict:
    out = _jax_window_fn(name)(
        {k: jnp.asarray(v) for k, v in state.items()},
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.float32(limit), jnp.int32(budget),
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_barrier(name: str, state: dict, limit) -> dict:
    """The barrier with each partition's inbox its ring predecessor's
    outbox (ppermute's pairs (i, i + 1))."""
    def ring_in(x):
        return np.roll(x.reshape((P, R) + x.shape[1:]), 1, axis=0).reshape(x.shape)

    inbox = [jnp.asarray(ring_in(state[k])) for k in ("ob_arrival", "ob_created", "ob_ingress", "ob_len")]
    out = _jax_barrier_fn(name)({k: jnp.asarray(v) for k, v in state.items()}, *inbox,
                                jnp.float32(limit))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("window", SNAPSHOT_WINDOWS)
@pytest.mark.parametrize("name", MODELS)
def test_window_matches_jax_windowed_scan(snapshots, name, window):
    """From a run's state after barrier ``window - 1``: the window at
    the default budget, and at a budget of one event (which truncates
    the busier lanes), through JAX's windowed step and plain_window_steps."""
    state = snapshots[name][window]
    tm = PARTITIONED_MODELS[name](tmodel, HORIZON_S)
    tc = tpart._PartitionCompiled(tm, OB)
    host = tengine._resolve_params(tm, tc, P * R, None)
    limit = tpart.window_end(window, HOP_S)
    for budget in (tpart.default_max_events_per_window(tm, HOP_S), 1):
        want = _jax_window(name, state, host, limit, budget)
        got = convert.state_from_numpy(state)
        event_step.plain_window_steps(tc, got, convert.params_from_numpy(host), limit, budget)
        _assert_same(want, got, f"{name} window {window} budget {budget}", HORIZON_S)


@pytest.mark.parametrize("window", SNAPSHOT_WINDOWS)
@pytest.mark.parametrize("name", MODELS)
def test_barrier_matches_jax_merge_inbox(snapshots, name, window):
    """After a window from a run's state (jobs in every outbox, some
    full): JAX's barrier statements and merge_inbox against plain_barrier."""
    tm = PARTITIONED_MODELS[name](tmodel, HORIZON_S)
    tc = tpart._PartitionCompiled(tm, OB)
    host = tengine._resolve_params(tm, tc, P * R, None)
    limit = tpart.window_end(window, HOP_S)
    after = convert.state_from_numpy(snapshots[name][window])
    event_step.plain_window_steps(tc, after, convert.params_from_numpy(host), limit,
                                  tpart.default_max_events_per_window(tm, HOP_S))
    state = {k: v.numpy() for k, v in after.items()}
    assert int(state["ob_len"].sum()) > 0
    want = _jax_barrier(name, state, limit)
    got = convert.state_from_numpy(state)
    partition_barrier.plain_barrier(tc, got, P, limit)
    _assert_same(want, got, f"{name} barrier {window}", HORIZON_S)


def test_init_state_matches_jax():
    """The outbox leaves and every other leaf of a lane's initial state,
    keyed as run_partitioned keys partition p: split(fold_in(key, p), R)."""
    jm, tm = ring(jmodel), ring(tmodel)
    jc, tc = jpart._PartitionCompiled(jm, OB), tpart._PartitionCompiled(tm, OB)
    state, params = tpart.init_partitions(tc, 1, 2, R, seed=9, device="cpu")
    keys = np.concatenate([
        np.asarray(jax.random.split(jax.random.fold_in(jax.random.PRNGKey(9), p), R)) for p in (1, 2)
    ])
    np.testing.assert_array_equal(state["key"].numpy(), keys)
    want = jax.vmap(jc.init_state)(jnp.asarray(keys), {k: jnp.asarray(v.numpy()) for k, v in params.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    want["truncated_windows"] = np.zeros((2 * R,), np.int32)
    _assert_same(want, state, "init", 5.0)


@pytest.mark.parametrize("with_remote", [False, True])
@pytest.mark.parametrize("name", sorted(PARTITIONED_MODELS))
def test_fingerprint_matches_jax(name, with_remote):
    """model_fingerprint hashes model.remotes with JAX's RemoteSpec repr:
    equal digests with and without a remote."""
    jm, tm = PARTITIONED_MODELS[name](jmodel), PARTITIONED_MODELS[name](tmodel)
    if with_remote:
        for mod, m in ((jmodel, jm), (tmodel, tm)):
            m.remote(ingress=mod.NodeRef(mod.SERVER, 0), latency_s=0.125)
    else:
        jm.remotes.clear()
        tm.remotes.clear()
    assert tengine.model_fingerprint(tm) == jengine.model_fingerprint(jm)


# -- the model API of remote egress nodes ----------------------------------
def _bad_ingress(mod, m):
    m.remote(ingress=mod.NodeRef(mod.SINK, 0), latency_s=0.05)


def _zero_latency(mod, m):
    m.remote(ingress=mod.NodeRef(mod.SERVER, 0), latency_s=0.0)


def _edge_latency_into_remote(mod, m):
    m.connect(mod.NodeRef(mod.ROUTER, 0), mod.NodeRef(mod.REMOTE, 0), latency_s=0.01)


def _edge_from_remote(mod, m):
    m.connect(mod.NodeRef(mod.REMOTE, 0), mod.NodeRef(mod.SERVER, 0))


@pytest.mark.parametrize(
    "mutate", [_bad_ingress, _zero_latency, _edge_latency_into_remote, _edge_from_remote],
    ids=["ingress-not-a-server", "zero-latency", "edge-latency", "edge-from-remote"],
)
def test_builder_refusals_match_jax(mutate):
    messages = []
    for mod in (jmodel, tmodel):
        with pytest.raises(ValueError) as info:
            mutate(mod, ring(mod))
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def _server_and_remote(mod):
    m = ring(mod)
    m.connect(mod.NodeRef(mod.ROUTER, 0), mod.NodeRef(mod.SERVER, 0))
    return m


def _round_robin_remote(mod):
    m = ring(mod)
    m.routers[0].policy = "round_robin"
    return m


@pytest.mark.parametrize("build", [_server_and_remote, _round_robin_remote],
                         ids=["server-remote-mix", "round-robin"])
def test_validate_refusals_match_jax(build):
    messages = []
    for mod in (jmodel, tmodel):
        with pytest.raises(ValueError) as info:
            build(mod).validate(allow_remote=True)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_validate_refuses_remotes_outside_partitioned_mode():
    for mod in (jmodel, tmodel):
        with pytest.raises(ValueError, match="use run_partitioned"):
            ring(mod).validate()
    ring(tmodel).validate(allow_remote=True)


# -- run_partitioned's refusals --------------------------------------------
def _no_remote(mod):
    m = mod.EnsembleModel(horizon_s=5.0)
    m.connect(m.source(rate=1.0), m.sink())
    return m, {}


def _telemetry(mod):
    m = ring(mod)
    m.telemetry(window_s=0.5)
    return m, {}


def _resilience(mod):
    m = ring(mod)
    m.load_shed(policy="queue_depth", threshold=10)
    return m, {}


def _consensus(mod):
    m = ring(mod)
    m.network_partition(group=[mod.NodeRef(mod.SERVER, 0)], windows=((1.0, 2.0),))
    return m, {}


def _trace(mod):
    m = mod.EnsembleModel(horizon_s=5.0)
    srv = m.server(service_mean=0.05)
    m.connect(m.trace_arrivals(mod_traces(mod).diurnal_trace(5.0, 0.5, 2.0, 5.0, seed=1)), srv)
    router = m.router(policy="random")
    m.connect(srv, router)
    m.connect(router, m.sink())
    m.connect(router, m.remote(ingress=srv, latency_s=HOP_S))
    return m, {}


def mod_traces(mod):
    if mod is jmodel:
        from happysim_tpu.tpu import traces
    else:
        from happysim_tpu_torch import traces
    return traces


def _outbox_zero(mod):
    return ring(mod), {"outbox_capacity": 0}


def _wide_window(mod):
    return ring(mod), {"window_s": 2 * HOP_S}


def _mixed_loss(mod):
    m = mod.EnsembleModel(horizon_s=5.0)
    srv = m.server(service_mean=0.05)
    router = m.router(policy="random")
    m.connect(m.source(rate=5.0), srv)
    m.connect(srv, router)
    m.connect(router, m.sink(), loss_p=0.1)
    m.connect(router, m.remote(ingress=srv, latency_s=HOP_S))
    return m, {}


def _checkpoint_without_callback(mod):
    return ring(mod), {"checkpoint_every_windows": 4}


REFUSALS = {
    "no-remote": (_no_remote, "remote"),
    "telemetry": (_telemetry, "replica_mesh"),
    "resilience": (_resilience, "replica_mesh"),
    "consensus": (_consensus, "replica_mesh"),
    "trace": (_trace, "replica_mesh"),
    "outbox-capacity": (_outbox_zero, "outbox_capacity=0"),
    "window-past-latency": (_wide_window, "conservative-window"),
    "mixed-router-loss": (_mixed_loss, "per-target packet loss"),
    "checkpoint-without-callback": (_checkpoint_without_callback, "checkpoint_callback"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_raise_as_jax(name):
    """Each of JAX's refusals raises ValueError in both packages; the
    port's message names its own remedy."""
    build, match = REFUSALS[name]
    jm, jkw = build(jmodel)
    tm, tkw = build(tmodel)
    kw = {"window_s": HOP_S, "n_replicas": 2}
    with pytest.raises(ValueError):
        jpart.run_partitioned(jm, mesh=jpart.partition_mesh(jax.devices("cpu")[:2]), **{**kw, **jkw})
    with pytest.raises(ValueError, match=match) as info:
        tpart.run_partitioned(tm, mesh=tpart.partition_mesh(["cpu"] * 2), **{**kw, **tkw})
    assert "HS_TPU" not in str(info.value) and "VMEM" not in str(info.value)


def _limiter(mod):
    m = mod.EnsembleModel(horizon_s=1.0)
    src, srv = m.source(rate=5.0), m.server(service_mean=0.05)
    lim = m.limiter(refill_rate=10.0, capacity=5.0)
    router = m.router(policy="random")
    m.connect(src, lim)
    m.connect(lim, srv)
    m.connect(srv, router)
    m.connect(router, m.sink())
    m.connect(router, m.remote(ingress=srv, latency_s=HOP_S))
    return m


def _nested(mod):
    m = mod.EnsembleModel(horizon_s=1.0)
    src, srv, other = m.source(rate=5.0), m.server(service_mean=0.05), m.server(service_mean=0.05)
    outer, inner = m.router(policy="random"), m.router(policy="random")
    m.connect(src, srv)
    m.connect(srv, outer)
    m.connect(outer, inner)
    m.connect(outer, other)
    m.connect(other, m.sink())
    m.connect(inner, mod.NodeRef(mod.SINK, 0))
    m.connect(inner, m.remote(ingress=srv, latency_s=HOP_S))
    return m


@pytest.mark.parametrize("build, match", [(_limiter, "limiters"), (_nested, "another router")],
                         ids=["limiter", "nested-remote-router"])
def test_port_refuses_what_jax_cannot_trace(build, match):
    """JAX's partitioned step raises TypeError through a limiter (its
    _deliver override drops the hop argument) and delivers a remote that a
    router reaches through another router as a local server arrival; the
    port refuses both by name (ROADMAP C)."""
    with pytest.raises(ValueError, match=match):
        tpart.run_partitioned(build(tmodel), window_s=HOP_S, mesh=tpart.partition_mesh(["cpu"]),
                              n_replicas=2)


def test_default_mesh_needs_a_card(monkeypatch):
    """With no device, run_partitioned takes the card; where torch finds
    none it raises naming itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="run_partitioned"):
        tpart.run_partitioned(ring(tmodel), window_s=HOP_S, n_replicas=2)
    with pytest.raises(RuntimeError, match="run_partitioned"):
        tpart.partition_mesh()
    mesh = tpart.partition_mesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.axis_names == (tpart.PARTITION_AXIS,) == (jpart.PARTITION_AXIS,)


def test_default_budget_matches_jax():
    for name, build in PARTITIONED_MODELS.items():
        m = build(tmodel)
        rate = sum(s.rate for s in m.sources)
        want = int(6.0 * max(rate * HOP_S, 1.0) * (1 + 2 * max(len(m.servers), 1))) + 32
        assert tpart.default_max_events_per_window(m, HOP_S) == want, name
