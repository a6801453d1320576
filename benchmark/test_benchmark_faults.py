"""A run of the harness, past its look for a card, with the timed path
broken underneath: ``correct`` has to come out false for each fault the
cells can have. On the CPU the program's event steps run in
``event_step.block_steps`` (its plain version there, the kernel's launch
on the card), which each fault wraps. The cells run on one device, so no
exchange between chips exists to leave out."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.conftest import CELLS, small


def _unchanged(original):
    def steps(compiled, state, keys, first, n, params, blocks=None):
        return compiled.replica_halted(state)

    return steps


def _half_the_batch(original):
    """Only the first half of the replicas is stepped; the rest keep their
    initial state and enter the reduce as they are."""

    def steps(compiled, state, keys, first, n, params, blocks=None):
        half = state["t"].shape[0] // 2
        part = {k: v[:half] for k, v in state.items()}
        sub = {k: v[:half] for k, v in params.items()}
        original(compiled, part, keys[:half], first, n, sub, None if blocks is None else blocks[:half])
        return compiled.replica_halted(state)

    return steps


def _one_answer_altered(original):
    """One replica's count at sink 0 raised by one where it is produced."""

    def steps(compiled, state, keys, first, n, params, blocks=None):
        halted = original(compiled, state, keys, first, n, params, blocks)
        state["sink_count"][0, 0] += 1
        return halted

    return steps


@pytest.mark.parametrize("config,traffic", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_the_batch, _one_answer_altered],
                         ids=["state unchanged", "half the batch", "an answer altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, config, traffic, fault):
    from happysim_tpu_torch.kernels import event_step

    spec = small(config, traffic, replicas=16, horizon_s=4.0, warmup_s=1.0)
    monkeypatch.setattr(event_step, "block_steps", fault(event_step.block_steps))
    out = run.run_cell(spec, 2**31 + 99, 0.0, False, device="cpu", note=lambda text: None)
    assert out["correct"] is False
    assert out["checked"]["counts_differing"] > 0


def test_the_sound_path_is_correct():
    spec = small("two-tenant", "chaos", replicas=16, horizon_s=4.0, warmup_s=1.0)
    out = run.run_cell(spec, 2**31 + 99, 0.0, False, device="cpu", note=lambda text: None)
    assert out["correct"] is True
    assert out["checked"] == {"counts_differing": 0, "stats_rel_gap": 0.0}
