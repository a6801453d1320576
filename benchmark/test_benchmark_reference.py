"""The plain reference against the program's CPU path (the plain torch-op
step ``run_ensemble(device="cpu")`` runs), total for total, on every cell
at a small size; and the control, the reference in bfloat16, which the
comparison has to fail."""

from __future__ import annotations

import pytest
import torch

from benchmark import cells, compare
from benchmark.conftest import CELLS, small
from benchmark.reference import queueing


FIELDS = queueing.FIELDS


def _program(spec: dict, seed: int, device="cpu") -> dict:
    builder = cells.builder(spec)
    return compare.program_totals(builder.run(builder.build(spec), spec, seed, device), FIELDS)


@pytest.mark.parametrize("config,traffic", CELLS)
def test_reference_equals_the_program_on_the_cpu(config, traffic):
    spec = small(config, traffic)
    seed = cells.call_seed(2**31 + 5, 3)
    program = _program(spec, seed)
    reference = queueing.simulate(spec, seed, "cpu")
    values = compare.readings(program, reference, FIELDS)
    assert values == {"counts_differing": 0, "stats_rel_gap": 0.0}
    assert compare.verdict(values)
    # The cell's mechanisms ran: jobs reached every server, and the
    # two-tenant cell's client server retried jobs past their deadline.
    assert program["truncated_replicas"] == 0
    assert all(c > 0 for c in program["server_completed"])
    if config == "two-tenant":
        assert program["server_retried"][2] > 0
        assert program["server_retried"][:2] == [0, 0]


@pytest.mark.parametrize("field", FIELDS["float"])
@pytest.mark.parametrize("side", ["program", "reference"])
def test_a_nan_in_a_compared_statistic_is_not_correct(field, side):
    """A NaN on either side of one float statistic is an infinite gap, and
    the run is not correct, whatever the other fields read."""
    spec = small("two-tenant", "chaos", replicas=8, horizon_s=4.0, warmup_s=1.0)
    seed = cells.call_seed(2**31 + 41, 0)
    totals = {"program": _program(spec, seed), "reference": queueing.simulate(spec, seed, "cpu")}
    assert compare.verdict(compare.readings(totals["program"], totals["reference"], FIELDS))
    totals[side][field] = list(totals[side][field])
    totals[side][field][-1] = float("nan")
    values = compare.readings(totals["program"], totals["reference"], FIELDS)
    assert values == {"counts_differing": 0, "stats_rel_gap": float("inf")}
    assert not compare.verdict(values)


@pytest.mark.parametrize("config,traffic", CELLS)
def test_the_bfloat16_control_is_not_correct(config, traffic):
    spec = small(config, traffic)
    seed = cells.call_seed(7, 0)
    exact = queueing.simulate(spec, seed, "cpu")
    control = queueing.simulate(spec, seed, "cpu", torch.bfloat16)
    values = compare.readings(control, exact, FIELDS)
    assert values["counts_differing"] > 0
    assert not compare.verdict(values)


def test_the_stream_is_the_seed_s_alone():
    """The same seed gives the same ensemble; another seed another one."""
    spec = small("fanout-lb", "poisson32", replicas=8, horizon_s=4.0, warmup_s=1.0)
    a = queueing.simulate(spec, 11, "cpu")
    b = queueing.simulate(spec, 11, "cpu")
    c = queueing.simulate(spec, 12, "cpu")
    assert compare.readings(a, b, FIELDS)["counts_differing"] == 0
    assert compare.readings(a, c, FIELDS)["counts_differing"] > 0
