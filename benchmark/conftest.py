"""Fixtures of the benchmark's own tests (``python3 -m pytest benchmark``):
the cells at a size a CPU run holds, and the card for the tests marked
``gpu``, which skip without one."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Every cell of BENCHMARK.json, as (configuration, traffic).
CELLS = tuple(
    (w["config"], w["traffic"])
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
)
SMALL = dict(replicas=64, horizon_s=8.0, warmup_s=2.0)


def small(config: str, traffic: str, **size) -> dict:
    """The cell at :data:`SMALL` (or ``size``)."""
    from benchmark import cells

    return cells.scaled(cells.resolve(config, traffic), **{**SMALL, **size})


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the event-step kernel has no CPU build)")
    return torch.device("cuda")
