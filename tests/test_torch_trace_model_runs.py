"""Whole runs of the traced models of test_torch_trace_models.py other
than the regression configuration (test_torch_trace_runs.py's): the
port's ``run_ensemble(device="cpu")`` against a live ``run_ensemble`` of
the JAX package, which runs them on its lax step, at the default event
budget passed explicitly: every integer total, the tenants' arrivals and
the paging counts equal, every integer window series equal, float means
within rel 1e-4. The models count several tenants and stop early, read
past the trace's end, put a Poisson source beside the trace, run the
chaos code, and take the bench's two shapes.
"""

import pytest

pytest.importorskip("torch")

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu import run_ensemble as j_run  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import run_ensemble as t_run  # noqa: E402
from test_torch_trace_models import TRACE_MODELS  # noqa: E402
from test_torch_trace_runs import _assert_matches, _mesh  # noqa: E402


@pytest.mark.parametrize("name", sorted(set(TRACE_MODELS) - {"flash-regression"}))
def test_traced_models_match_jax(name):
    build = TRACE_MODELS[name]
    max_events = tengine._default_max_events(build(tmodel), None)
    assert max_events == jengine._default_max_events(build(jmodel), None)
    kwargs = dict(n_replicas=8, seed=3, max_events=max_events)
    expected = j_run(build(jmodel), mesh=_mesh(), **kwargs)
    got = t_run(build(tmodel), device="cpu", **kwargs)
    _assert_matches(got, expected)
    assert got.truncated_replicas == 0
    assert got.trace_tenant_arrivals == expected.trace_tenant_arrivals
