#!/usr/bin/env python3
"""The new phases of chip_smoke.py alone, for a quick check of a change to
the kernel paths of several sources and sinks and of the consensus tier:

    python3 tools/smoke_slice.py      # on a machine with one NVIDIA GPU

Builds the libraries and prints each instantiation's registers and spills,
then runs chip_smoke's block checks (kernel against plain version, bit for
bit, at 65,536 replicas) on the superposed pair and its tie, the
two-tenant service with and without telemetry, both quorum arms through
their cut, the election storm and the stochastic cuts, and on one model
of each earlier instantiation; the whole-run checks of the two-tenant
service, the defended quorum arm and the phi-accrual election; the
main-path runs and gates of the several-source and consensus phases; and
the consensus sweeps' set-up time. Any failure raises.
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
    event_step.load_library()
    start = time.perf_counter()
    for name, model, blocks, sweeps in (
        ("superpose", c.superpose_model(), [0, 1, 2, 3, 80], None),
        ("superpose-tie", c.superpose_model("constant", (4.0, 4.0)), [0, 1, 2, 3, 80], None),
        ("two-class", c.two_class_model(), [0, 1, 2, 3, 100], None),
        ("two-class-telemetry", c.two_class_model(c.TWO_CLASS_WINDOW_S), [0, 1, 2, 3, 100], None),
        ("quorum-undefended", c.quorum_model(False), [0, 1, 2, 3, 16, 20], None),
        ("quorum-defended", c.quorum_model(True), [0, 1, 2, 3, 16, 20], None),
        ("election-bully", c.election_model("bully"), [0, 1, 2, 3], None),
        ("stochastic", c.stochastic_partition_model(), [0, 1, 2, 3], None),
        ("mm1", c.mm1_model(c.LAM, c.MU, c.HORIZON_S, warmup_s=c.WARMUP_S), [0, 1, 2, 3], None),
        ("profile", c.graph_model(ramp=True), [0, 1, 60], c.GRAPH_SWEEPS),
        ("chaos", c.chaos_model(), [0, 1, 2, 3], c.CHAOS_SWEEPS),
        ("telemetry", c.telemetry_model(), [0, 1, 2, 3], c.HETERO_SWEEPS),
        ("resilience-fanout", c.resilience_fanout_model(), [0, 1, 2, 3], None),
        ("spike", c.arrivals_model("spike"), [0, 1, 6], None),
    ):
        c.check_blocks(name, model, blocks, sweeps)
    print(f"block checks {time.perf_counter() - start:.1f} s", flush=True)
    c.check_whole_run("two-class", c.two_class_model())
    c.check_whole_run("quorum-defended", c.quorum_model(True), max_events=c.QUORUM_MAX_EVENTS)
    c.check_whole_run("election-phi", c.election_model("phi_accrual"), max_events=c.ELECTION_MAX_EVENTS)
    c.multi_main_path(tag)
    c.consensus_main_path(tag)
    for name, model in (("quorum", c.quorum_model(True)), ("election", c.election_model("bully")),
                        ("stochastic", c.stochastic_partition_model())):
        print(f"sweep {name}: {c.sweep_ms(model):.2f} ms {tag}")
    print("slice ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
