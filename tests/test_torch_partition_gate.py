"""run_ensemble's placement gate (engine._partition_gate) draws nothing:
it reads the leaf names of a one-replica template state, built without
the initial gaps' uniforms or the fault and partition schedules' draws,
so a run's set-up calls the torch-op uniform once (the gaps of its own
state) and the card's scan draws the rest in the kernel. The template's
leaves are the drawn state's, name for name and shape for shape."""

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from happysim_tpu_torch import engine, rng  # noqa: E402
from happysim_tpu_torch import mesh as mesh_lib  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from test_torch_chaos_models import CHAOS_MODELS  # noqa: E402
from test_torch_consensus_models import CONSENSUS_MODELS  # noqa: E402

_MODELS = {
    "mm1": lambda mod: mod.mm1_model(8.0, 10.0, 20.0, warmup_s=5.0),
    "stochastic-faults": CHAOS_MODELS["stochastic"],
    "correlated-outages": CHAOS_MODELS["correlated"],
    "stochastic-partitions": CONSENSUS_MODELS["stochastic"],
}


def _counting(monkeypatch) -> list:
    calls = []
    plain = rng.uniform
    monkeypatch.setattr(rng, "uniform", lambda *a, **k: calls.append(1) or plain(*a, **k))
    return calls


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_the_partition_gate_draws_no_uniform(name, monkeypatch):
    """The gate over a one-shard CPU mesh and a three-shard one calls
    rng.uniform 0 times; the drawing init_state calls it at least once
    (the counter sees the draws it must not make)."""
    model = _MODELS[name](tmodel)
    compiled = engine._Compiled(model)
    host_params = engine._resolve_params(model, compiled, 6, None)
    calls = _counting(monkeypatch)
    for mesh in (mesh_lib.ReplicaMesh((torch.device("cpu"),)), mesh_lib.replica_mesh(["cpu"] * 3)):
        engine._partition_gate(compiled, host_params, mesh)
    assert len(calls) == 0
    params = {k: torch.from_numpy(v[:1]) for k, v in host_params.items()}
    compiled.init_state(rng.split(rng.PRNGKey(0), 1), params)
    assert len(calls) >= 1


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_the_draw_free_template_has_the_drawn_state_leaves(name):
    """init_state(draw=False) builds every leaf of the drawn state, of the
    same shape and dtype."""
    model = _MODELS[name](tmodel)
    compiled = engine._Compiled(model)
    host_params = engine._resolve_params(model, compiled, 2, None)
    params = {k: torch.from_numpy(v) for k, v in host_params.items()}
    keys = rng.split(rng.PRNGKey(3), 2)
    drawn = compiled.init_state(keys, params)
    template = compiled.init_state(keys, params, draw=False)
    assert sorted(template) == sorted(drawn)
    for leaf, value in drawn.items():
        assert (template[leaf].shape, template[leaf].dtype) == (value.shape, value.dtype), leaf
