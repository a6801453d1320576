"""The partition ring across two processes: each process joins a gloo
``torch.distributed`` group through ``distributed_initialize`` and runs
two of four partitions, the boundary outboxes crossing between them by
send and recv at every window barrier; the result, and a snapshot
resumed in the same processes, equal the one-process run on four
partitions of the CPU. The two processes are spawned with a timeout of
their own and always reaped.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import partition_mesh, run_partitioned  # noqa: E402
from test_torch_partitioned_models import HOP_S, PARTITIONED_MODELS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
KWARGS = dict(window_s=HOP_S, n_replicas=6, seed=4)
MODEL = "two-sink-ring"
HORIZON_S = 2.0

_WORKER = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch.distributed as dist
from happysim_tpu_torch import distributed_initialize, partition_mesh, run_partitioned
from happysim_tpu_torch import model as tmodel
from test_torch_partitioned_dist import HORIZON_S, KWARGS, MODEL, _summary
from test_torch_partitioned_models import PARTITIONED_MODELS
rank = int(sys.argv[1])
assert distributed_initialize("localhost:{port}", 2, rank) is True
mesh = partition_mesh(["cpu", "cpu"])
assert mesh.size == 4 and list(mesh.local_shards) == [2 * rank, 2 * rank + 1]
build = lambda: PARTITIONED_MODELS[MODEL](tmodel, HORIZON_S)
run = run_partitioned(build(), mesh=mesh, **KWARGS)
snaps = []
run_partitioned(build(), mesh=mesh, **KWARGS, checkpoint_every_windows=10,
                checkpoint_callback=snaps.append)
resumed = run_partitioned(build(), mesh=mesh, **KWARGS, resume_from=snaps[len(snaps) // 2])
out = {{"run": _summary(run), "resumed": _summary(resumed),
        "snapshot": [snaps[0].n_partitions, int(snaps[0].state["t"].shape[0])]}}
if rank == 0:
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
"""


def _summary(result) -> dict:
    """Every field but the wall and the rate, as JSON."""
    out = {
        f.name: getattr(result, f.name) for f in dataclasses.fields(result)
        if f.name not in ("wall_seconds", "events_per_second", "per_partition_sink_count")
    }
    out["per_partition_sink_count"] = result.per_partition_sink_count.tolist()
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_two_gloo_processes_equal_one_process(tmp_path):
    out = tmp_path / "rank0.json"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(root=str(ROOT), tests=str(ROOT / "tests"), port=_free_port()))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(script), str(rank), str(out)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    got = json.loads(out.read_text())
    want = _summary(run_partitioned(PARTITIONED_MODELS[MODEL](tmodel, HORIZON_S),
                                    mesh=partition_mesh(["cpu"] * 4), **KWARGS))
    assert got["run"] == want and got["resumed"] == want
    assert got["snapshot"] == [4, 4]
    assert want["remote_sent"] > 0
