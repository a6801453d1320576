#!/usr/bin/env python3
"""The newest checks of chip_smoke.py alone, for a quick check of a
change to the event-step kernel's MULTI, trace, consensus and wide codes:

    python3 tools/smoke_slice.py      # on a machine with one NVIDIA GPU
    python3 tools/smoke_slice.py --partitioned    # the build and the partitioned phase alone
    python3 tools/smoke_slice.py --surface        # the build and the result surface alone

Builds the libraries and prints each instantiation's registers and spills,
then runs chip_smoke's block checks (kernel against plain version, bit for
bit, at 65,536 replicas) on one model of each earlier instantiation, on
every consensus model (the quorum's two arms, the flapping cuts, the
bully election, the stochastic cuts, and the defended quorum with a
second source of tools/ab_models.py on the code for several sources) and on
every code for several sources or sinks (chaos-free, with telemetry,
with chaos and neither the defenses nor the consensus tier, with and
without telemetry, with a defense) and of the wide code (chaos-free on the fleet, the chain and
the tenants, the chaos code on the quorum), its stream checks of the
trace library's codes against plain_trace_steps (the flash crowd alone,
every stream step, the diurnal trace, the flash crowd beside a Poisson
source, beside it with a deadline and a retry at its
server, and with a retry budget besides), and the whole runs of two-class, two-class-chaos, its defended
arm, wide-fleet, the defended quorum and the flapping cuts in one launch
against chained one-block launches. ``--partitioned`` runs chip_smoke's
partitioned phase instead (the window kernel and the
barrier against their plain versions window by window on five models,
the nine-remote ring's wide code and a ring of full transit rows among
them, and over whole runs on four, a checkpointed ring run, the ring at
65,536 lanes through run_partitioned with its gates, and each kernel's
time a window). ``--surface`` runs chip_smoke's surface phase instead,
on main-path runs it makes itself: the summaries against the results'
fields, to_data() against series(), and the engine's profiler scopes
over a profiled M/M/1 scan and a profiled flash-crowd run. Any failure
raises.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import ab_models  # noqa: E402
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
    if "--partitioned" in sys.argv[1:]:
        c.partitioned_phase(tag)
        print("slice ok")
        return 0
    if "--surface" in sys.argv[1:]:
        c.surface_phase(tag, {})
        print("slice ok")
        return 0
    start = time.perf_counter()
    for name, model, blocks, sweeps in (
        ("mm1", c.mm1_model(c.LAM, c.MU, c.HORIZON_S, warmup_s=c.WARMUP_S), [0, 1, 2, 3], None),
        ("profile", c.graph_model(ramp=True), [0, 1, 60], c.GRAPH_SWEEPS),
        ("chaos", c.chaos_model(), [0, 1, 2, 3], c.CHAOS_SWEEPS),
        ("telemetry", c.telemetry_model(), [0, 1, 2, 3], c.HETERO_SWEEPS),
        ("resilience-fanout", c.resilience_fanout_model(), [0, 1, 2, 3], None),
        ("quorum-defended", c.quorum_model(True), [0, 1, 2, 3, 16, 20], None),
        ("quorum-undefended", c.quorum_model(False), [0, 1, 2, 3, 16, 20], None),
        ("flapping-cuts", c.flapping_cuts_model(), [0, 1, 2, 3, 8, 12, 16, 20], None),
        ("election-bully", c.election_model("bully"), [0, 1, 2, 3, 12], None),
        ("stochastic-partitions", c.stochastic_partition_model(), [0, 1, 2, 3, 8], None),
        ("quorum-multi", ab_models.quorum_two_sources(c), [0, 1, 2, 3, 16, 20], None),
        ("two-class", c.two_class_model(), [0, 1, 2, 3, 100], None),
        ("two-class-telemetry", c.two_class_model(c.TWO_CLASS_WINDOW_S), [0, 1, 2, 3, 100], None),
        ("superpose-tie", c.superpose_model("constant", (4.0, 4.0)), [0, 1, 2, 3, 80], None),
        ("two-class-chaos", c.two_class_model(chaos=True), [0, 1, 2, 3, 100], None),
        ("two-class-chaos-telemetry", c.two_class_model(c.TWO_CLASS_WINDOW_S, chaos=True),
         [0, 1, 2, 3, 100], None),
        ("two-class-defended", c.two_class_model(chaos=True, defended=True), [0, 1, 2, 3, 100],
         None),
        ("wide-fleet", c.wide_fleet_model(), [0, 1, 2, 3, 130], None),
        ("wide-chain", c.wide_chain_model(), [0, 1, 2, 3, 200], None),
        ("wide-tenants", c.wide_tenants_model(), [0, 1, 2, 3, 60], None),
        ("wide-quorum", c.wide_quorum_model(), [0, 1, 2, 3, 40], None),
    ):
        c.check_blocks(name, model, blocks, sweeps)
    print(f"block checks {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    c.check_trace_stream("trace-flash", c.trace_model("flash"))
    c.check_trace_stream("trace-diurnal", c.trace_model("diurnal"), every=8)
    c.check_trace_stream("trace-poisson", c.trace_model("flash", poisson_rate=50.0), every=8)
    c.check_trace_stream("trace-chaos", c.trace_model("flash", **c.TRACE_CHAOS), every=8)
    c.check_trace_stream("trace-defended", c.trace_model("flash", **c.TRACE_DEFENDED), every=8)
    print(f"stream checks {time.perf_counter() - start:.1f} s", flush=True)
    for name, model in (
        ("two-class", c.two_class_model()),
        ("two-class-chaos", c.two_class_model(chaos=True)),
        ("two-class-defended", c.two_class_model(chaos=True, defended=True)),
        ("wide-fleet", c.wide_fleet_model()),
    ):
        c.check_whole_run(name, model)
    for name, model in (("quorum-defended", c.quorum_model(True)),
                        ("flapping-cuts", c.flapping_cuts_model())):
        c.check_whole_run(name, model, max_events=c.QUORUM_MAX_EVENTS)
    print("slice ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
