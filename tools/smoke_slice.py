#!/usr/bin/env python3
"""The newest phase of chip_smoke.py alone, for a quick check of a change
to the partitioned executor:

    python3 tools/smoke_slice.py      # on a machine with one NVIDIA GPU

Builds the libraries and prints each instantiation's registers and spills,
then runs chip_smoke's block checks (kernel against plain version, bit for
bit, at 65,536 replicas) on one model of each earlier instantiation, and
chip_smoke's partitioned phase (the window kernel and the barrier against
their plain versions window by window and over whole runs on three
models, a checkpointed ring run, the ring at 65,536 lanes through
run_partitioned with its gates, and each kernel's time a window). Any
failure raises.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from happysim_tpu_torch.kernels import build, event_step  # noqa: E402


def main() -> int:
    tag = f"[{c.card_label()}]"
    start = time.perf_counter()
    built = build.build_libraries()
    print(f"build {time.perf_counter() - start:.1f} s {tag}", flush=True)
    for stem, (_path, log) in built.items():
        for kernel, info in c.ptxas_summary(log).items():
            print(f"  ptxas {stem} {kernel}: {info}")
        if stem == "partition_barrier":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {stem}: {line.strip()}")
    event_step.load_library()
    start = time.perf_counter()
    for name, model, blocks, sweeps in (
        ("mm1", c.mm1_model(c.LAM, c.MU, c.HORIZON_S, warmup_s=c.WARMUP_S), [0, 1, 2, 3], None),
        ("profile", c.graph_model(ramp=True), [0, 1, 60], c.GRAPH_SWEEPS),
        ("chaos", c.chaos_model(), [0, 1, 2, 3], c.CHAOS_SWEEPS),
        ("telemetry", c.telemetry_model(), [0, 1, 2, 3], c.HETERO_SWEEPS),
        ("resilience-fanout", c.resilience_fanout_model(), [0, 1, 2, 3], None),
        ("two-class", c.two_class_model(), [0, 1, 2, 3], None),
        ("quorum-defended", c.quorum_model(True), [0, 1, 2, 3, 16], None),
        ("wide-fleet", c.wide_fleet_model(), [0, 1], None),
    ):
        c.check_blocks(name, model, blocks, sweeps)
    print(f"block checks {time.perf_counter() - start:.1f} s", flush=True)
    c.partitioned_phase(tag)
    print("slice ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
