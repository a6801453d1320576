"""Whole traced runs: the port's ``run_ensemble(device="cpu")`` against a
live ``run_ensemble`` of the JAX package (which runs traced models on its
lax step; its kernel declines them) on the configuration of
tests/regression/test_trace_regression.py (the flash crowd in pages of
32, 16 s, 8 replicas, seed 77, max_events 8,192): every integer total and ``trace_tenant_arrivals`` equal, the
window series of the trace's arrivals and every integer window series
equal, float means within rel 1e-4, the paging counts equal. Then the
port alone: pages of 32 and of 2,048 give the same bits but for the
paging counts, and a mid-chunk snapshot resumes to the uninterrupted
run; and across the packages: a JAX snapshot resumes in the port and a
port snapshot in JAX. The other traced models' whole runs are
test_torch_trace_model_runs.py's.
"""

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
from happysim_tpu_torch.engine import TRACE_PAGING_FIELDS, resume_mismatches  # noqa: E402
from test_torch_trace_models import TRACE_MODELS, flash_regression  # noqa: E402

RUN = dict(n_replicas=8, seed=77, max_events=8192)
INT_FIELDS = (
    "simulated_events", "sink_count", "server_completed", "server_dropped",
    "transit_dropped", "truncated_replicas",
    "server_timed_out", "server_retried", "blocks_total", "block_occupancy", "max_blocks",
    "trace", "trace_tenant_arrivals", "trace_chunks_streamed", "trace_chunk_len",
    "trace_n_chunks", "trace_max_resident_chunks", "trace_stream_steps",
)
FLOAT_FIELDS = (
    "sink_mean_latency_s", "server_mean_wait_s", "server_utilization",
    "server_mean_queue_len", "sink_p50_s", "sink_p99_s",
)


def _mesh():
    return replica_mesh(jax.devices("cpu")[:1])


def _assert_matches(got, expected, paging: bool = True) -> None:
    for field in INT_FIELDS:
        if paging or field not in TRACE_PAGING_FIELDS:
            assert getattr(got, field) == getattr(expected, field), field
    np.testing.assert_array_equal(got.sink_hist, expected.sink_hist)
    for field in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(got, field), getattr(expected, field), rtol=1e-4, err_msg=field
        )
    if expected.timeseries is None:
        assert got.timeseries is None
        return
    js, ts = expected.timeseries, got.timeseries
    np.testing.assert_array_equal(ts.trace_tenant_arrivals, js.trace_tenant_arrivals)
    for field in js._ARRAY_FIELDS:
        left, right = getattr(ts, field), getattr(js, field)
        assert (left is None) == (right is None), field
        if right is not None and np.issubdtype(np.asarray(right).dtype, np.integer):
            np.testing.assert_array_equal(left, right, err_msg=field)


@pytest.fixture(scope="module")
def jax_flash():
    """JAX's run of the regression configuration, snapshotted after every
    stream step: (result, snapshots)."""
    snaps = []
    result = j_run(
        flash_regression(jmodel), mesh=_mesh(), **RUN,
        checkpoint_every_s=0.0, checkpoint_callback=snaps.append,
    )
    return result, snaps


@pytest.fixture(scope="module")
def port_flash():
    """The port's run of the same, snapshotted after every stream step:
    (result, snapshots)."""
    snaps = []
    result = t_run(
        flash_regression(tmodel), device="cpu", **RUN,
        checkpoint_every_s=0.0, checkpoint_callback=snaps.append,
    )
    return result, snaps


def _mid_chunk(snaps, P: int = 32):
    """A snapshot two thirds of the way in with a lane frozen mid-page."""
    for snap in snaps[2 * len(snaps) // 3 :]:
        if (np.asarray(snap.state["trc_cursor"]).astype(np.int64) % P != 0).any():
            return snap
    raise AssertionError("no snapshot with a lane mid-page")


def test_flash_crowd_matches_jax(jax_flash, port_flash):
    """The regression configuration: every total, the tenants' arrivals,
    the window series and the paging counts equal to JAX's; every replica
    replays the whole trace."""
    expected, got = jax_flash[0], port_flash[0]
    assert expected.engine_path == "scan"
    assert got.engine_path == "scan" and got.kernel_decline == 'device="cpu"'
    _assert_matches(got, expected)
    trace = flash_regression(tmodel).sources[0].trace
    assert got.trace_tenant_arrivals == [RUN["n_replicas"] * trace.n_arrivals]
    assert got.trace_max_resident_chunks == 2 and got.trace_n_chunks == trace.n_chunks
    report, jax_report = got.engine_report()["trace"], expected.engine_report()["trace"]
    for key in ("enabled", "chunks_streamed", "chunk_len", "n_chunks", "max_resident_chunks",
                "stream_steps", "tenant_arrivals"):
        assert report[key] == jax_report[key], key
    assert len(port_flash[1]) == len(jax_flash[1])


def test_pages_of_another_length_give_the_same_bits(port_flash):
    """Pages of 2,048 (one stream step) against pages of 32: every field
    but the paging counts bit for bit; the fingerprints differ."""
    short = port_flash[0]
    long = t_run(flash_regression(tmodel, chunk_len=2048), device="cpu", **RUN)
    assert resume_mismatches(short, long, TRACE_PAGING_FIELDS) == []
    assert (long.trace_chunk_len, long.trace_n_chunks, long.trace_stream_steps) == (2048, 2, 1)
    assert short.trace_stream_steps > 32
    assert tengine.model_fingerprint(flash_regression(tmodel)) != tengine.model_fingerprint(
        flash_regression(tmodel, chunk_len=2048)
    )


def test_mid_chunk_snapshot_resumes_to_the_same_bits(port_flash, tmp_path):
    """A port snapshot with lanes frozen mid-page, through save and load,
    resumes to the uninterrupted run."""
    result, snaps = port_flash
    snap = _mid_chunk(snaps)
    assert 0 < snap.chunk_index < RUN["max_events"] // 16
    snap.save(str(tmp_path / "port.npz"))
    resumed = t_run(
        flash_regression(tmodel), device="cpu", **RUN,
        resume_from=EnsembleCheckpoint.load(str(tmp_path / "port.npz")),
    )
    assert resume_mismatches(result, resumed, TRACE_PAGING_FIELDS) == []
    assert resumed.trace_stream_steps < result.trace_stream_steps


def test_jax_snapshot_resumes_in_the_port(jax_flash, tmp_path):
    expected, snaps = jax_flash
    _mid_chunk(snaps).save(str(tmp_path / "jax.npz"))
    got = t_run(
        flash_regression(tmodel), device="cpu", **RUN,
        resume_from=EnsembleCheckpoint.load(str(tmp_path / "jax.npz")),
    )
    _assert_matches(got, expected, paging=False)


def test_port_snapshot_resumes_in_jax(jax_flash, port_flash, tmp_path):
    expected = jax_flash[0]
    _mid_chunk(port_flash[1]).save(str(tmp_path / "port.npz"))
    back = j_run(
        flash_regression(jmodel), mesh=_mesh(), **RUN,
        resume_from=jengine.EnsembleCheckpoint.load(str(tmp_path / "port.npz")),
    )
    _assert_matches(back, expected, paging=False)


def test_page_shorter_than_a_block_raises_as_jax():
    """chunk_len under macro_block could stall a lane with the window
    unable to cover one block: both packages refuse it with one message."""
    messages = []
    for mod, run, kw in ((jmodel, j_run, {"mesh": _mesh()}), (tmodel, t_run, {"device": "cpu"})):
        with pytest.raises(ValueError) as info:
            run(flash_regression(mod, chunk_len=8), n_replicas=2, seed=0, max_events=64, **kw)
        messages.append(str(info.value))
    assert messages[1] == messages[0] and "chunk_len=8" in messages[0]
