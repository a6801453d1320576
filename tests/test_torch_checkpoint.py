"""Checkpoint and resume of the port's ``run_ensemble`` (the JAX
package's tests/integration/test_tpu_checkpoint.py, carried across).

Within the port: a segmented run (every segment one ``block_steps``
call) equals the one-call run, and a run resumed from a mid-run snapshot
that went through ``save``/``load`` equals it too, bit for bit on every
result field outside ``engine.RESUME_EXCLUDED_FIELDS`` (the JAX test's
set less the fields the port's result lacks). Across the
packages: the model and parameter fingerprints are equal, and a snapshot
written by either package resumes in the other: integer totals equal,
float means within rel 1e-4 (the second-level parity of ROADMAP.md; XLA's
CPU ``log`` differs from torch's by an ulp on some draws).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import run_ensemble as j_run  # noqa: E402
from happysim_tpu.tpu.mesh import replica_mesh  # noqa: E402
from happysim_tpu_torch import EnsembleCheckpoint  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import run_ensemble as t_run  # noqa: E402
from happysim_tpu_torch.engine import RESUME_EXCLUDED_FIELDS, resume_mismatches  # noqa: E402
from happysim_tpu_torch.kernels import event_step  # noqa: E402
from test_torch_chaos_models import CHAOS_MODELS, bench_chaos  # noqa: E402
from test_torch_event_step import GRAPH_MODELS, SLICE_MODELS, fanout  # noqa: E402
from test_torch_resilience_models import RESILIENCE_MODELS, SWEPT  # noqa: E402
from test_torch_telemetry_models import TELEMETRY_MODELS  # noqa: E402


def assert_results_identical(a, b):
    """Every field outside the port's RESUME_EXCLUDED_FIELDS equal, bit
    for bit: a segmented or resumed run continued its twin exactly."""
    diff = resume_mismatches(a, b)
    assert not diff, {name: (getattr(a, name), getattr(b, name)) for name in diff}

def _mm1(mod):
    return mod.mm1_model(lam=8.0, mu=10.0, horizon_s=10.0, warmup_s=2.0)


# (model function, sweeps) for the within-port runs: the M/M/1 (its
# explicit budget keeps it off the chain form), with and without a swept
# service mean, the fan-out with transit, the chaos bench, a telemetry
# model and the breaker-protected cascade, at short horizons.
CASES = {
    "mm1": (_mm1, None),
    "mm1-swept": (_mm1, lambda n: {"service_mean": np.linspace(0.08, 0.11, n).astype(np.float32)}),
    "fanout": (lambda mod: fanout(mod, "random", horizon_s=10.0), None),
    "bench-chaos": (lambda mod: bench_chaos(mod, horizon_s=6.0), None),
    "telemetry-mm1": (TELEMETRY_MODELS["mm1-all"], None),
    "cascade": (RESILIENCE_MODELS["cascade"], None),
}
N_REPLICAS = 16


def _kwargs(build, sweeps):
    model = build(tmodel)
    kwargs = dict(
        n_replicas=N_REPLICAS,
        seed=3,
        device="cpu",
        max_events=tengine._default_max_events(model, None),
    )
    if sweeps is not None:  # the budget stays the unswept one
        kwargs["sweeps"] = sweeps(N_REPLICAS)
    return model, kwargs


@pytest.mark.parametrize("name", sorted(CASES))
def test_segmented_and_resumed_runs_equal_the_one_call_run(name, tmp_path):
    build, sweeps = CASES[name]
    model, kwargs = _kwargs(build, sweeps)
    baseline = t_run(model, **kwargs)
    snapshots = []
    segmented = t_run(model, **kwargs, checkpoint_every_s=0.0, checkpoint_callback=snapshots.append)
    assert segmented.engine_path == baseline.engine_path == "scan"
    assert_results_identical(baseline, segmented)
    # The segmented run counts every block the one-call run counts.
    assert segmented.blocks_total == baseline.blocks_total
    assert segmented.block_occupancy == baseline.block_occupancy
    assert snapshots and all(0 < s.chunk_index < s.n_chunks for s in snapshots)
    assert len(snapshots) == len({s.chunk_index for s in snapshots})

    # The middle of the snapshots taken while some replica was live.
    live = [s for s in snapshots if s.chunk_index < max(baseline.block_occupancy)]
    middle = live[len(live) // 2]
    path = str(tmp_path / "ensemble_ckpt")  # save/load add ".npz" alike
    middle.save(path)
    loaded = EnsembleCheckpoint.load(path)
    assert loaded.chunk_index == middle.chunk_index and loaded.mesh_devices == 1
    assert set(loaded.state) == set(middle.state)
    for leaf, value in middle.state.items():
        assert loaded.state[leaf].dtype == value.dtype, leaf
        np.testing.assert_array_equal(loaded.state[leaf], value, err_msg=leaf)
    resumed = t_run(model, **kwargs, resume_from=loaded)
    assert_results_identical(baseline, resumed)
    # A resumed run counts only its own blocks, and it still ran some.
    assert 0 < resumed.blocks_total < baseline.blocks_total


def test_resume_excluded_fields_are_the_jax_tests_set():
    """The port's excluded fields are the JAX checkpoint test's set, less
    the fields the port's result does not have; and every one of them is
    a field of the port's result."""
    path = Path(__file__).resolve().parent / "integration" / "test_tpu_checkpoint.py"
    spec = importlib.util.spec_from_file_location("_jax_checkpoint_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fields = {f.name for f in dataclasses.fields(tengine.EnsembleResult)}
    assert RESUME_EXCLUDED_FIELDS == module.EXCLUDED_FIELDS & fields
    assert RESUME_EXCLUDED_FIELDS <= fields


def test_each_segment_is_one_block_steps_call(monkeypatch):
    """ceil(n_chunks / CHECKPOINT_SEGMENTS) blocks a segment, each segment
    one block_steps call from its absolute first block; with an interval
    no snapshot falls due, and the segmented default call stays on the
    scan (the chain form would take it)."""
    calls = []
    steps = event_step.block_steps

    def counting(compiled, state, keys, first, n, params, blocks=None):
        calls.append((first, n))
        return steps(compiled, state, keys, first, n, params, blocks)

    monkeypatch.setattr(event_step, "block_steps", counting)
    model = _mm1(tmodel)
    snapshots = []
    result = t_run(
        model, n_replicas=8, seed=1, device="cpu",
        checkpoint_every_s=3600.0, checkpoint_callback=snapshots.append,
    )
    n_chunks = result.max_blocks
    seg = -(-n_chunks // tengine.CHECKPOINT_SEGMENTS)
    assert result.engine_path == "scan" and not snapshots
    assert calls == [(first, min(seg, n_chunks - first)) for first in range(0, n_chunks, seg)]


def _snapshot(model=None, **kwargs):
    model = model if model is not None else _mm1(tmodel)
    snapshots = []
    args = dict(n_replicas=8, seed=1, device="cpu", max_events=640)
    args.update(kwargs)
    t_run(model, **args, checkpoint_callback=snapshots.append)
    return snapshots[len(snapshots) // 2]


def _resume(snapshot, model=None, **kwargs):
    model = model if model is not None else _mm1(tmodel)
    args = dict(n_replicas=8, seed=1, device="cpu", max_events=640)
    args.update(kwargs)
    return t_run(model, **args, resume_from=snapshot)


def _telemetry_mm1(mod):
    m = _mm1(mod)
    m.telemetry(window_s=2.5)
    return m


def _macro33(mod):
    m = _mm1(mod)
    m.macro_block = 33  # 640 events: 20 blocks of 32 or of 33
    return m


def _with_state(snapshot, state):
    return dataclasses.replace(snapshot, state=state)


# Each rejection of _validate_resume, by the words of its message.
REJECTIONS = {
    "seed": (lambda s: s, dict(seed=2), "seed"),
    "n_replicas": (lambda s: s, dict(n_replicas=16), "n_replicas"),
    "max_events": (lambda s: s, dict(max_events=704), "max_events"),
    "n_chunks": (lambda s: s, dict(max_events=672), "n_chunks"),
    "model_fingerprint": (
        lambda s: s, dict(model=tmodel.mm1_model(8.0, 10.0, 12.0, warmup_s=2.0)), "model_fingerprint",
    ),
    "params_fingerprint": (
        lambda s: s, dict(sweeps={"service_mean": np.full(8, 0.09, np.float32)}), "params_fingerprint",
    ),
    "macro_block": (lambda s: s, dict(model=_macro33(tmodel)), "'macro_block'"),
    # Fingerprint unknown (""), so only the telemetry signature differs.
    "telemetry": (
        lambda s: dataclasses.replace(s, model_fingerprint=""),
        dict(model=_telemetry_mm1(tmodel)),
        "'telemetry'",
    ),
    "missing-leaf": (
        lambda s: _with_state(s, {k: v for k, v in s.state.items() if k != "srv_q_len"}),
        {},
        r"missing leaves \['srv_q_len'\]",
    ),
    "unknown-leaf": (
        lambda s: _with_state(s, {**s.state, "bogus": np.zeros(8, np.float32)}),
        {},
        "unknown leaf 'bogus'",
    ),
    "replica-axis": (
        lambda s: _with_state(s, {**s.state, "t": s.state["t"][:4]}),
        {},
        r"leaf 't' has shape \(4,\)",
    ),
}


@pytest.mark.parametrize("name", sorted(REJECTIONS))
def test_resume_rejects_a_mismatched_run(name):
    tamper, kwargs, message = REJECTIONS[name]
    snapshot = tamper(_snapshot())
    with pytest.raises(ValueError, match=message):
        _resume(snapshot, **kwargs)


def test_unknown_fingerprints_and_macro_block_are_skipped():
    """An empty fingerprint or macro_block 0 ("predates the field") is not
    checked, as in the JAX package; the run resumes."""
    snapshot = _snapshot()
    legacy = dataclasses.replace(snapshot, model_fingerprint="", params_fingerprint="", macro_block=0)
    assert_results_identical(_resume(snapshot), _resume(legacy))


def test_interval_without_callback_is_rejected():
    with pytest.raises(ValueError, match="checkpoint_callback"):
        t_run(_mm1(tmodel), n_replicas=8, device="cpu", checkpoint_every_s=1.0)


def _catalog():
    cases = {"mm1": lambda mod: mod.mm1_model(8, 10, 160, warmup_s=40)}
    for prefix, catalog in (
        ("chaos", CHAOS_MODELS), ("telemetry", TELEMETRY_MODELS),
        ("resilience", RESILIENCE_MODELS), ("graph", GRAPH_MODELS), ("slice", SLICE_MODELS),
    ):
        cases.update({f"{prefix}-{name}": build for name, build in catalog.items()})
    return cases


CATALOG = _catalog()


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_model_fingerprint_equals_jax(name):
    """The digest of every model of the port's test set equals the JAX
    package's: the specs repr alike, field for field."""
    build = CATALOG[name]
    assert tengine.model_fingerprint(build(tmodel)) == jengine.model_fingerprint(build(jmodel))


@pytest.mark.parametrize("sweeps", [None, "service_mean", "source_rate"])
def test_params_fingerprint_equals_jax(sweeps):
    model = RESILIENCE_MODELS["bench-defended"](tmodel)
    compiled = tengine._Compiled(model)
    values = {
        None: None,
        "service_mean": {"service_mean": np.linspace(0.03, 0.05, 32).astype(np.float32)},
        "source_rate": SWEPT["bench-defended"](32),
    }[sweeps]
    params = tengine._resolve_params(model, compiled, 32, values)
    # The JAX engine's broadcast, for the same model and sweeps.
    jparams = {"src_rate": params["src_rate"].copy(), "srv_mean": params["srv_mean"].copy()}
    assert tengine.params_fingerprint(params) == jengine.params_fingerprint(jparams)
    assert (tengine.params_fingerprint(params) == tengine.params_fingerprint(
        tengine._resolve_params(model, compiled, 32, None))) == (sweeps is None)


# Cross-package resume: the M/M/1 and the telemetry M/M/1 (the meta's
# telemetry signature), 32 replicas.
CROSS = {"mm1": _mm1, "telemetry-mm1": _telemetry_mm1}
INT_FIELDS = ("simulated_events", "sink_count", "server_completed", "server_dropped",
              "truncated_replicas")
FLOAT_FIELDS = ("sink_mean_latency_s", "server_mean_wait_s", "server_utilization",
                "server_mean_queue_len")


def _close(got, expected):
    for field in INT_FIELDS:
        assert getattr(got, field) == getattr(expected, field), field
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, field), getattr(expected, field), rtol=1e-4, err_msg=field
        )
    if expected.timeseries is not None:
        np.testing.assert_array_equal(got.timeseries.sink_count, expected.timeseries.sink_count)


@pytest.mark.parametrize("name", sorted(CROSS))
def test_jax_snapshot_resumes_in_the_port_and_back(name, tmp_path):
    build = CROSS[name]
    max_events = tengine._default_max_events(build(tmodel), None)
    mesh = replica_mesh(jax.devices("cpu")[:1])
    kwargs = dict(n_replicas=32, seed=3, max_events=max_events)
    j_snaps = []
    expected = j_run(
        build(jmodel), mesh=mesh, **kwargs, checkpoint_every_s=0.0, checkpoint_callback=j_snaps.append
    )
    j_snaps[len(j_snaps) // 3].save(str(tmp_path / "jax.npz"))
    from_jax = EnsembleCheckpoint.load(str(tmp_path / "jax.npz"))
    assert from_jax.mesh_devices == 1
    got = t_run(build(tmodel), device="cpu", **kwargs, resume_from=from_jax)
    _close(got, expected)
    assert got.blocks_total > 0

    t_snaps = []
    t_run(build(tmodel), device="cpu", **kwargs, checkpoint_every_s=0.0,
          checkpoint_callback=t_snaps.append)
    t_snaps[len(t_snaps) // 3].save(str(tmp_path / "port.npz"))
    back = j_run(
        build(jmodel), mesh=mesh, **kwargs,
        resume_from=jengine.EnsembleCheckpoint.load(str(tmp_path / "port.npz")),
    )
    _close(back, expected)
