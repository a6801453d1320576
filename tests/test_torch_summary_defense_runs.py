"""Whole runs of the defended and undefended retry storms and the
defended quorum through both packages on the CPU, their summaries
compared (test_torch_summary_models.py says how): the Resilience and
Consensus entities with their totals.
"""

import pytest

pytest.importorskip("torch")

from test_torch_summary_models import DEFENSE_RUNS, check_summary_run  # noqa: E402


@pytest.mark.parametrize("name", DEFENSE_RUNS)
def test_summary_of_a_whole_run_equals_jax_s(name):
    check_summary_run(name)
