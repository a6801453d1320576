"""The harness on the card: each cell's run, at 4,096 replicas over 20 s of
simulated time, through the CUDA kernel, agrees with the plain reference
on the card; the bfloat16 control there does not. Marked ``gpu``; they
skip without a card."""

from __future__ import annotations

import pytest

from benchmark import cells, compare, run
from benchmark.conftest import CELLS, small
from benchmark.reference import queueing

pytestmark = pytest.mark.gpu
SIZE = dict(replicas=4096, horizon_s=20.0, warmup_s=5.0)


@pytest.mark.parametrize("config,traffic", CELLS)
def test_a_run_on_the_card_is_correct(cuda, config, traffic):
    spec = small(config, traffic, **SIZE)
    out = run.run_cell(spec, 2**31 + 17, 0.0, False, note=lambda text: None)
    assert out["checked"] == {"counts_differing": 0, "stats_rel_gap": 0.0}
    assert out["correct"] is True
    assert out["memory_peak_bytes"] > 0


@pytest.mark.parametrize("config,traffic", CELLS)
def test_the_bfloat16_control_on_the_card_is_not_correct(cuda, config, traffic):
    import torch

    spec = small(config, traffic, **SIZE)
    seed = cells.call_seed(23, 0)
    exact = queueing.simulate(spec, seed, cuda)
    control = queueing.simulate(spec, seed, cuda, torch.bfloat16)
    assert not compare.verdict(compare.readings(control, exact, queueing.FIELDS))
