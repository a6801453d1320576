"""The port and chip_smoke.py import neither JAX nor the JAX package, and
chip_smoke.py fails without a CUDA device.

Each check runs in a fresh interpreter, so nothing this test process has
imported (JAX included) can hide an import.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
import happysim_tpu_torch
import happysim_tpu_torch.engine, happysim_tpu_torch.convert, happysim_tpu_torch.rng
import happysim_tpu_torch.numerics, happysim_tpu_torch.faults, happysim_tpu_torch.telemetry
import happysim_tpu_torch.kernels.event_step, happysim_tpu_torch.kernels.support
import happysim_tpu_torch.chain, happysim_tpu_torch.kernels.uniform
import happysim_tpu_torch.mm1, happysim_tpu_torch.opinion, happysim_tpu_torch.kernels.mm1_scan
import happysim_tpu_torch.traces, happysim_tpu_torch.mesh, happysim_tpu_torch.reduce
import happysim_tpu_torch.partitioned, happysim_tpu_torch.kernels.partition_barrier
import happysim_tpu_torch.temporal, happysim_tpu_torch.summary, happysim_tpu_torch.data
import chip_smoke
from happysim_tpu_torch.kernels import build
# One library per source, the resilience, consensus, several-source,
# trace, wide and partitioned ones, the draw kernel, the M/M/1 scan and
# the partitioned executor's barrier included, each source present.
stems = [p.stem for p in build.SOURCES]
assert stems == [
    "event_step", "event_step_telemetry", "event_step_resilience", "event_step_consensus",
    "event_step_multi", "event_step_trace", "event_step_wide", "event_step_partitioned",
    "uniform", "mm1_scan", "partition_barrier",
], stems
assert all(p.exists() for p in build.SOURCES + build.HEADERS)
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
    or m == "happysim_tpu" or m.startswith("happysim_tpu.")
)
print(json.dumps(bad))
"""


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=str(REPO))],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_fails_without_a_card():
    """Run where torch finds no CUDA device, chip_smoke exits nonzero and
    prints no result line."""
    code = (
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"sys.argv = [{str(REPO / 'chip_smoke.py')!r}]\n"
        f"runpy.run_path({str(REPO / 'chip_smoke.py')!r}, run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script cannot import the port and exits nonzero."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, str(alone)],
        capture_output=True,
        text=True,
        cwd=tmp_path,
        timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
