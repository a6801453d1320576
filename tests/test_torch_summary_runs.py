"""Whole runs of small models through both packages on the CPU, their
summaries compared (test_torch_summary_models.py says how): the M/M/1 on
the scan and on the chain form, the chaos bench, a limiter graph, the
two-tenant model and the bully election.
"""

import pytest

pytest.importorskip("torch")

from test_torch_summary_models import DEFENSE_RUNS, RUNS, check_summary_run  # noqa: E402


@pytest.mark.parametrize("name", sorted(set(RUNS) - set(DEFENSE_RUNS)))
def test_summary_of_a_whole_run_equals_jax_s(name):
    check_summary_run(name)
