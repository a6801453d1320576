"""A replica mesh across two processes: each process joins a gloo
``torch.distributed`` group through ``distributed_initialize`` and runs
its slab of two CPU shards, the reductions meeting in ``all_reduce``;
the results equal the one-process run on four shards. The two processes
are spawned with a timeout of their own and always reaped.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from happysim_tpu_torch import replica_mesh, run_ensemble, run_mm1_ensemble  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
KWARGS = dict(n_replicas=16, seed=11, max_events=480)

# Each process: join the group, run the model on a 4-shard mesh (2 shards
# a process), a checkpointed run with a snapshot, the chain form and the
# M/M/1 ensemble; rank 0 writes what the test compares.
_WORKER = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch.distributed as dist
from happysim_tpu_torch import distributed_initialize, replica_mesh, run_ensemble, run_mm1_ensemble
from happysim_tpu_torch import model as tmodel
from test_torch_mesh_dist import KWARGS, _model, _summary
rank = int(sys.argv[1])
assert distributed_initialize("localhost:{port}", 2, rank) is True
mesh = replica_mesh(["cpu", "cpu"])
assert mesh.size == 4 and list(mesh.local_shards) == [2 * rank, 2 * rank + 1]
scan = run_ensemble(_model(), **KWARGS, mesh=mesh)
snaps = []
run_ensemble(_model(), **KWARGS, mesh=mesh, checkpoint_every_s=0.0, checkpoint_callback=snaps.append)
resumed = run_ensemble(_model(), **KWARGS, mesh=mesh, resume_from=snaps[len(snaps) // 2])
chain = run_ensemble(tmodel.mm1_model(8.0, 10.0, 20.0, warmup_s=5.0), n_replicas=16, mesh=mesh)
mm1 = run_mm1_ensemble(8.0, 10.0, 16, 256, mesh=mesh)
out = {{
    "scan": _summary(scan), "resumed": _summary(resumed), "chain": _summary(chain),
    "mm1": [mm1.mean_wait_s, mm1.std_wait_s, mm1.mean_sojourn_s],
    "snapshot_replicas": int(snaps[0].state["t"].shape[0]),
}}
if rank == 0:
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
"""


def _model():
    model = tmodel.EnsembleModel(horizon_s=12.0, warmup_s=2.0)
    src = model.source(rate=8.0)
    srv = model.server(
        service_mean=0.1, queue_capacity=64, deadline_s=8.0, max_retries=1,
        fault=tmodel.FaultSpec(rate=0.05, mean_duration_s=0.5),
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    model.telemetry(window_s=0.75, metrics=("throughput", "utilization", "rates", "spread"))
    return model


def _summary(result) -> dict:
    """The fields the two runs must agree on, as JSON."""
    out = {
        name: getattr(result, name)
        for name in ("n_replicas", "simulated_events", "sink_count", "sink_mean_latency_s",
                     "server_completed", "server_mean_wait_s", "server_utilization",
                     "server_fault_dropped", "truncated_replicas", "engine_path")
    }
    out["sink_hist"] = result.sink_hist.tolist()
    if result.timeseries is not None:
        ts = result.timeseries
        out["series"] = [ts.sink_count.tolist(), ts.server_utilization.tolist(),
                         ts.replica_throughput_p10.tolist(), ts.server_fault_dropped.tolist()]
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

    mesh = replica_mesh(["cpu"] * 4)
    assert got["scan"] == _summary(run_ensemble(_model(), **KWARGS, mesh=mesh))
    assert got["resumed"] == got["scan"] and got["snapshot_replicas"] == 16
    chain = run_ensemble(tmodel.mm1_model(8.0, 10.0, 20.0, warmup_s=5.0), n_replicas=16, mesh=mesh)
    assert got["chain"] == _summary(chain) and got["chain"]["engine_path"] == "chain"
    mm1 = run_mm1_ensemble(8.0, 10.0, 16, 256, mesh=mesh)
    assert got["mm1"] == [mm1.mean_wait_s, mm1.std_wait_s, mm1.mean_sojourn_s]
