#!/usr/bin/env python3
"""The event-step kernel's time per block in this checkout against
another (a parent commit), on one card in turns: other, this, this,
other; and the partitioned executor's two kernels a window.

    git archive <parent> | tar -x -C build/parent
    python3 tools/ab_parent.py --root build/parent
    python3 tools/ab_parent.py --root build/parent --partitioned   # the rings alone
    python3 tools/ab_parent.py --root build/variant --models two-class-chaos,trace-chaos
    python3 tools/ab_parent.py --root build/parent --walls      # the host walls alone

Each turn is a fresh process in its checkout's root, which builds that
checkout's libraries (kernels/build.py, into its own build/) and runs its
chip_smoke.time_blocks on the models below (three of them built by
tools/ab_models.py) at chip_smoke's full width:
the kernel's time per block in a 20-block launch, the plain version's
and the bound, for models both checkouts run; then, for the models of
RUNS, chip_smoke.check_whole_run's whole run in one launch (its device
time and blocks); then, for the partitioned rings of RINGS a checkout
defines, at 8 x 8,192 lanes, timed by this script's own code through
the checkout's two wrappers (event_step.window_steps and
partition_barrier.barrier, so both checkouts are measured the same way):
the window kernel's and the barrier's device time a window over windows
100-119 (CUDA events) as a window loop issues them and the device alone
(the windows queued behind a torch.cuda._sleep), with the gap between
launches, and where the checkout has partition_barrier.FoldedRing the
folded launch's the same two ways; then the ring's whole run, WALL_RUNS
times unfolded (a window and a barrier launch a window) and, where the
checkout folds, WALL_RUNS times folded, in turns, each from the set-up
state; and run_partitioned's wall; then, for the traced models of
TRACES (chip_smoke's flash crowd and diurnal trace alone, the flash
crowd beside a Poisson source, beside it with a deadline and a retry at
its server, and with a retry budget besides), built and timed by
this script's own code, the trace library's time per block in a
20-block launch; then, for TRACE_RUNS, the flash crowd's and the diurnal
trace's whole runs through run_ensemble at the main path's pages of 64
(chip_smoke.traced_run: every stream step's launch timed, their count,
the wall); then, for WALLS, after a warm-up, 2 x HOST_RUNS runs each of
the M/M/1 scan's run_ensemble wall at chip_smoke's full width (its scan
budget named) and the flash crowd's traced run's host ms (its wall less
its launches' CUDA-event ms), in turns with the profiler ranges the
checkout's engine opens and with torch.profiler.record_function emptied
(the ranges' own cost; the same code where the engine opens none), for
which the lines give each checkout's medians and ranges both ways and
the two checkouts' medians. Prints one line a model with the two
checkouts' mean
kernel ms and their ratio, one a traced model, one a whole run, a few a
ring, and the registers and spills ptxas reported for each
instantiation of each checkout (from the turn that built its
libraries), and writes chiprun_out/ab_parent.json. ``--partitioned``
times the rings alone; ``--walls`` the host walls alone; ``--models``
the models, whole runs and traced models of those labels alone (no ring),
and ``--out`` names the JSON file under chiprun_out/.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

# (label, chip_smoke expression building the model, sweeps' name or None)
MODELS = (
    ("mm1", "c.mm1_model(c.LAM, c.MU, c.HORIZON_S, warmup_s=c.WARMUP_S)", None),
    ("chain", "c.pipeline_model(8.0, (0.05, 0.08, 0.06), c.HORIZON_S)", None),
    ("router", "c.router_model('random', c.HORIZON_S, c.WARMUP_S)", None),
    ("graph", "c.graph_model()", "GRAPH_SWEEPS"),
    ("profile", "c.graph_model(ramp=True)", "GRAPH_SWEEPS"),
    ("chaos", "c.chaos_model()", "CHAOS_SWEEPS"),
    ("telemetry", "c.telemetry_model()", "HETERO_SWEEPS"),
    ("resilience", "c.resilience_bench_model(True)", "RES_SWEEPS"),
    ("two-class", "c.two_class_model()", None),
    ("two-class-telemetry", "c.two_class_model(c.TWO_CLASS_WINDOW_S)", None),
    ("two-class-chaos", "c.two_class_model(chaos=True)", None),
    # Its chaos arm at two front servers (four servers: the lean
    # instantiations' MAXV of 4; tools/ab_models.py).
    ("two-class-chaos-4", "ab_models.two_class_chaos_4(c)", None),
    # Its defended arm, built the same way in a checkout whose
    # two_class_model takes no `defended`.
    ("two-class-defended",
     "(lambda m: (m.retry_budget(ratio=0.0, min_per_s=0.2, burst=1.0), m)[1])"
     "(c.two_class_model(chaos=True))", None),
    # The defended quorum arm with a second source (the whole MULTI chaos
    # code with the consensus tier; tools/ab_models.py).
    ("quorum-multi", "ab_models.quorum_two_sources(c)", None),
    # The consensus code with one source and one sink: the quorum's two
    # arms, the bully election, the stochastic cuts and the flapping cuts
    # (tools/ab_models.py).
    ("quorum-defended", "c.quorum_model(True)", None),
    ("quorum-undefended", "c.quorum_model(False)", None),
    ("election-bully", "c.election_model('bully')", None),
    ("stochastic-partitions", "c.stochastic_partition_model()", None),
    ("flapping-cuts", "ab_models.flapping_cuts(c)", None),
    ("superpose", "c.superpose_model()", None),
    ("wide-fleet", "c.wide_fleet_model()", None),
    # The wide chaos code's consensus tier (nine groups).
    ("wide-quorum", "c.wide_quorum_model()", None),
)
# Models whose whole run (one launch of the main path's budget) is timed.
RUNS = ("two-class", "two-class-chaos", "wide-fleet")
# Traced models whose whole run at the main path's pages (chip_smoke's
# trace_model at TRACE_CHUNK_LEN) is timed, every stream step's launch by
# CUDA events: (label, chip_smoke's trace kind).
TRACE_RUNS = (("trace-flash run", "flash"), ("trace-diurnal run", "diurnal"))
# Traced models timed a block (the trace library), built by this
# script's own code in both checkouts: (label, the trace, a Poisson rate
# beside it, the server's deadline or None, a retry budget's arguments or
# None).
TRACES = (
    ("trace-flash", "flash", 0.0, None, None),
    ("trace-diurnal", "diurnal", 0.0, None, None),
    ("trace-poisson", "flash", 50.0, None, None),
    ("trace-chaos", "flash", 50.0, 0.01, None),
    ("trace-defended", "flash", 50.0, 0.01, {"ratio": 0.0, "min_per_s": 2.0, "burst": 2.0}),
)
# Host walls timed 2 x HOST_RUNS times a turn: (label, chip_smoke expression
# building the model, "scan" for run_ensemble's wall on the scan, "trace"
# for a traced run's wall less its launches' device time).
WALLS = (
    ("mm1-scan wall", "c.mm1_model(c.LAM, c.MU, c.HORIZON_S, warmup_s=c.WARMUP_S)", "scan"),
    ("trace-flash host", "c.trace_model('flash')", "trace"),
)
HOST_RUNS = 10
# Partitioned rings timed a window: (label, chip_smoke's builder).
RINGS = (
    ("ring", "partitioned_ring_model"),
    ("nine-remote-ring", "partitioned_nine_remote_model"),
    ("full-row-ring", "partitioned_full_row_model"),
)
# Cycles of the torch.cuda._sleep that holds the device while the timed
# windows are queued (about 20 ms at 1.98 GHz).
HOLD_CYCLES = 40_000_000
# Whole runs of a ring in each form a turn.
WALL_RUNS = 3

_TURN = """
import json, sys
sys.path.insert(0, ".")
sys.path.insert(1, %r)
import chip_smoke as c
import ab_models
from happysim_tpu_torch.kernels import build
ptxas = {}
for stem, (_path, log) in build.build_libraries().items():
    for kernel, info in c.ptxas_summary(log).items():
        ptxas[stem + " " + kernel] = info
out = {"ptxas": ptxas, "runs": {}, "rings": {}}
for label, expr, sweeps in %r:
    try:  # a model this checkout's chip_smoke cannot build is left out
        eval(expr)
    except (AttributeError, TypeError):
        continue
    t = c.time_blocks(eval(expr), label, getattr(c, sweeps) if sweeps else None)
    out[label] = {k: t[k] for k in ("kernel_ms", "plain_ms", "bound_ms")}
    if label in %r:
        w = c.check_whole_run(label, eval(expr), getattr(c, sweeps) if sweeps else None)
        out["runs"][label] = {k: w[k] for k in ("run_ms", "blocks", "bound_ms")}
import math, time, torch
ew, pb = c.event_step, c.partition_barrier
HOLD_CYCLES = %r

# Each window's launches with a CUDA event before the first and after
# each (behind a sleep that holds the device until all are queued where
# held): each launch's ms a window, the gap's, and the host's ms a window.
def marks_of(windows, launches, held):
    if held:
        torch.cuda._sleep(HOLD_CYCLES)
    marks, t0 = [], time.perf_counter()
    for w in windows:
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()
        for launch_one in launches(w):
            launch_one()
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
        marks.append(ev)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    n = len(marks)
    per = [sum(m[k].elapsed_time(m[k + 1]) for m in marks) / n for k in range(len(marks[0]) - 1)]
    gap = sum(x[-1].elapsed_time(y[0]) for x, y in zip(marks, marks[1:])) / (n - 1)
    return per, gap, host * 1e3 / n

def ring_times(model):
    compiled, state, params, budget = c.partitioned_setup(model, c.PART_R)
    initial = {k: v.clone() for k, v in state.items()}
    folds = hasattr(pb, "FoldedRing")

    def split(st, wp, bp):
        def launches(w):
            limit = c.window_end(w, c.PART_HOP_S)
            return (lambda: ew.window_steps(compiled, st, st["key"], params, limit, budget, wp),
                    lambda: pb.barrier(compiled, st, c.PART_P, limit, prepared=bp))
        return launches

    warm = split(state, {}, {})  # the loop's arguments checked here, as run_partitioned's
    for w in range(c.PART_WARM_WINDOWS):
        for launch_one in warm(w):
            launch_one()
    windows = range(c.PART_WARM_WINDOWS, c.PART_WARM_WINDOWS + c.PART_TIMED_WINDOWS)
    copies = {k: {leaf: v.clone() for leaf, v in state.items()}
              for k in ("held", "loop_fold", "held_fold")}
    r = {}
    for st in copies.values():  # the occupancy bound a checkout keeps, built before the clock
        if hasattr(ew, "occupancy_bound"):
            ew.occupancy_bound(st)
    for kind, held in (("loop", False), ("held", True)):
        launches = warm if kind == "loop" else split(copies[kind], {}, {})
        (r[kind + "_window_ms"], r[kind + "_barrier_ms"]), r[kind + "_gap_ms"], r[kind + "_host_ms"] = (
            marks_of(windows, launches, held))
        if folds:
            st = copies[kind + "_fold"]
            ring = pb.folded_ring(compiled, st, st["key"], params, c.PART_P, budget, {})
            (r[kind + "_fold_ms"],), r[kind + "_fold_gap_ms"], r[kind + "_fold_host_ms"] = marks_of(
                windows, lambda w, ring=ring: (lambda: ring.window(c.window_end(w, c.PART_HOP_S)),), held)
            ring.flush()
    n_windows = math.ceil(model.horizon_s / c.PART_HOP_S)
    r["walls_unfolded"], r["walls_folded"] = [], []
    for k in range(2 * %r):
        folded = folds and k %% 4 in (1, 2)
        if not folds and k %% 2:
            continue
        st = {leaf: v.clone() for leaf, v in initial.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if folded:
            ring = pb.folded_ring(compiled, st, st["key"], params, c.PART_P, budget, {})
            for w in range(n_windows):
                ring.window(c.window_end(w, c.PART_HOP_S))
            ring.flush()
        else:
            launches = split(st, {}, {})
            for w in range(n_windows):
                for launch_one in launches(w):
                    launch_one()
        torch.cuda.synchronize()
        r["walls_folded" if folded else "walls_unfolded"].append((time.perf_counter() - t0) * 1e3)
    r["wall_ms"] = c.run_partitioned(model, c.PART_HOP_S, mesh=c.card_partitions(),
                                     n_replicas=c.PART_R).wall_seconds * 1e3
    return r

for label, builder in %r:
    if hasattr(c, builder):
        out["rings"][label] = ring_times(getattr(c, builder)())

# The trace library's time a block: chip_smoke's flash crowd (pages of
# TRACE_LONG_CHUNK, so no lane stalls), with a Poisson source beside it
# and a deadline at its server, and a retry budget, from its first two
# blocks, a launch of 20 more blocks, twice, each on its own copy of the
# state.
def trace_block_ms(kind, rate, deadline, budget):
    model = c.EnsembleModel(horizon_s=c.TRACE_HORIZON_S, macro_block=16)
    retry = {} if deadline is None else {"deadline_s": deadline, "max_retries": 1}
    srv = model.server(concurrency=4, service_mean=0.004, queue_capacity=64, **retry)
    if rate:
        model.connect(model.source(rate=rate), srv)
    model.connect(model.trace_arrivals(c.bench_trace(kind, c.TRACE_LONG_CHUNK)), srv)
    model.connect(srv, model.sink())
    model.telemetry(window_s=c.TRACE_WINDOW_S, metrics=("throughput", "latency", "rates"))
    if budget is not None:
        model.retry_budget(**budget)
    compiled, keys, params, state = c.fresh_run(model)
    pages = c.trace_pages(compiled, 0)
    halted = torch.empty((c.REPLICAS,), dtype=torch.uint8, device="cuda")
    ew.trace_steps(compiled, state, keys, params, pages, 0, 2)
    states = [{k: v.clone() for k, v in state.items()} for _ in range(2)]
    args = [ew.trace_launch_args(compiled, st, keys, params, pages, 0, 2 + c.TIMED_BLOCKS, halted)
            for st in states]
    return c.launch_ms(args) / (2 * c.TIMED_BLOCKS)

out["traces"] = {label: trace_block_ms(*shape) for label, *shape in %r}

# The traced runs through run_ensemble at the main path's pages, after one
# at pages of TRACE_LONG_CHUNK (the process's first pays the pinned
# allocator's and the side stream's first use): each launch timed.
trace_runs = %r
if trace_runs:
    c.traced_run("warm-up", c.trace_model("flash", c.TRACE_LONG_CHUNK), "")
out["trace_runs"] = {}
for label, kind in trace_runs:
    result, launches, kernel_ms = c.traced_run(label, c.trace_model(kind), "")
    out["trace_runs"][label] = {"kernel_ms": kernel_ms, "launches": launches,
                                "wall_ms": result.wall_seconds * 1e3,
                                "blocks": max(result.block_occupancy)}

# Host walls: a warm-up run, then 2 x HOST_RUNS timed runs of each, in
# turns (on, off, off, on, ...) with the profiler ranges the checkout's
# engine opens and with torch.profiler.record_function replaced by an
# empty context (in a checkout without ranges the two are the same code).
import contextlib
real_range = torch.profiler.record_function

def no_range(name, args=None):
    return contextlib.nullcontext()

def host_ms(label, expr, kind):
    model = eval(expr)
    if kind == "scan":
        budget = c._default_max_events(model, None)
        return c.run_ensemble(model, n_replicas=c.REPLICAS, max_events=budget).wall_seconds * 1e3
    result, _launches, kernel_ms = c.traced_run(label, model, "")
    return result.wall_seconds * 1e3 - kernel_ms

out["walls"] = {}
for label, expr, kind in %r:
    host_ms(label, expr, kind)
    times = {"ranges": [], "no ranges": []}
    for k in range(2 * %r):
        off = k %% 4 in (1, 2)
        torch.profiler.record_function = no_range if off else real_range
        try:
            times["no ranges" if off else "ranges"].append(host_ms(label, expr, kind))
        finally:
            torch.profiler.record_function = real_range
    out["walls"][label] = times
print("AB " + json.dumps(out))
"""


def us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.3f} us"


def turn(root: Path, models: tuple, runs: tuple, traces: tuple, rings: tuple,
         trace_runs: tuple, walls: tuple) -> dict:
    done = subprocess.run(
        [sys.executable, "-c",
         _TURN % (str(Path(__file__).resolve().parent), models, runs, HOLD_CYCLES, WALL_RUNS, rings,
                  traces, trace_runs, walls, HOST_RUNS)],
        cwd=root, capture_output=True,
        text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{done.stderr[-4000:]}")
    line = next(x for x in done.stdout.splitlines() if x.startswith("AB "))
    return json.loads(line[3:])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True, help="the other checkout's root")
    parser.add_argument("--partitioned", action="store_true", help="time the rings alone")
    parser.add_argument("--walls", action="store_true", help="time the host walls alone")
    parser.add_argument("--models", default="", help="comma-separated labels to time alone")
    parser.add_argument("--out", default="ab_parent.json", help="the JSON file under chiprun_out/")
    options = parser.parse_args()
    other = Path(options.root).resolve()
    models, runs, traces, trace_runs = (
        ((), (), (), ()) if options.partitioned or options.walls
        else (MODELS, RUNS, TRACES, TRACE_RUNS)
    )
    rings = () if options.walls else RINGS
    host_walls = () if options.partitioned else WALLS
    if options.models:
        keep = set(options.models.split(","))
        models = tuple(m for m in models if m[0] in keep)
        runs = tuple(r for r in runs if r in keep)
        traces = tuple(t for t in traces if t[0] in keep)
        trace_runs = tuple(t for t in trace_runs if t[0] in keep)
        host_walls = tuple(w for w in host_walls if w[0] in keep)
        rings = ()
    here = Path(__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    turns = [(who, turn(root, models, runs, traces, rings, trace_runs, host_walls))
             for who, root in (("other", other), ("this", here), ("this", here), ("other", other))]
    report = {"card": card, "turns": turns}
    for label, *_rest in models:
        if not all(label in t for _w, t in turns):
            print(f"{label}: not built in both checkouts")
            continue
        mean = {
            who: sum(t[label]["kernel_ms"] for w, t in turns if w == who) / 2 for who in ("this", "other")
        }
        report[label] = mean
        print(
            f"{label}: kernel {mean['this']:.4f} ms/block here, {mean['other']:.4f} in the other "
            f"checkout ({mean['this'] / mean['other']:.3f}x) [{card}]"
        )
    for label, *_rest in traces:
        mean = {
            who: sum(t["traces"][label] for w, t in turns if w == who) / 2 for who in ("this", "other")
        }
        report[label] = mean
        print(
            f"{label}: kernel {mean['this']:.4f} ms/block here, {mean['other']:.4f} in the other "
            f"checkout ({mean['this'] / mean['other']:.3f}x) [{card}]"
        )
    for label, _kind in trace_runs:
        mean = {
            who: {key: sum(t["trace_runs"][label][key] for w, t in turns if w == who) / 2
                  for key in ("kernel_ms", "wall_ms")}
            for who in ("this", "other")
        }
        report[label] = mean
        this = turns[1][1]["trace_runs"][label]
        print(
            f"{label} at pages of 64: kernel {mean['this']['kernel_ms']:.3f} ms here "
            f"({this['launches']} launches, {this['blocks']} blocks; wall "
            f"{mean['this']['wall_ms']:.3f} ms), {mean['other']['kernel_ms']:.3f} in the other "
            f"checkout (wall {mean['other']['wall_ms']:.3f} ms) "
            f"({mean['this']['kernel_ms'] / mean['other']['kernel_ms']:.3f}x) [{card}]"
        )
    for label, *_rest in host_walls:
        times = {(who, form): [x for w, t in turns if w == who for x in t["walls"][label][form]]
                 for who in ("this", "other") for form in ("ranges", "no ranges")}
        report[label] = {f"{who}, {form}": xs for (who, form), xs in times.items()}
        median = {key: float(np.median(xs)) for key, xs in times.items()}
        for who in ("this", "other"):
            on, off = times[(who, "ranges")], times[(who, "no ranges")]
            print(
                f"{label} ({who} checkout): median {median[(who, 'ranges')]:.3f} ms as it is "
                f"(range {min(on):.3f}-{max(on):.3f}), {median[(who, 'no ranges')]:.3f} with "
                f"record_function emptied (range {min(off):.3f}-{max(off):.3f}), "
                f"{median[(who, 'ranges')] / median[(who, 'no ranges')]:.3f}x; {len(on)} runs "
                f"each [{card}]"
            )
        print(
            f"{label}: median {median[('this', 'ranges')]:.3f} ms here, "
            f"{median[('other', 'ranges')]:.3f} in the other checkout "
            f"({median[('this', 'ranges')] / median[('other', 'ranges')]:.3f}x), in turns [{card}]"
        )
    for label in runs:
        mean = {
            who: sum(t["runs"][label]["run_ms"] for w, t in turns if w == who) / 2
            for who in ("this", "other")
        }
        report[f"{label} run"] = mean
        blocks = turns[1][1]["runs"][label]["blocks"]
        print(
            f"{label} whole run: {mean['this']:.3f} ms here ({blocks} blocks), {mean['other']:.3f} "
            f"in the other checkout ({mean['this'] / mean['other']:.3f}x) [{card}]"
        )
    for label, _builder in rings:
        if not all(label in t["rings"] for _w, t in turns):
            continue
        rings = {who: [t["rings"][label] for w, t in turns if w == who] for who in ("this", "other")}

        def mean(who, key):
            values = [r[key] for r in rings[who] if key in r]
            return sum(values) / len(values) if values else None

        def walls(who, key):
            return [x for r in rings[who] for x in r[key]]

        report[f"{label} windows"] = {
            who: {key: mean(who, key) for key in rings[who][0] if not key.startswith("walls")}
            for who in ("this", "other")
        }
        for who in ("this", "other"):
            print(f"{label} ({who} checkout), a window: the device alone, window kernel "
                  f"{us(mean(who, 'held_window_ms'))}, barrier {us(mean(who, 'held_barrier_ms'))}, gap "
                  f"{us(mean(who, 'held_gap_ms'))}, folded launch {us(mean(who, 'held_fold_ms'))}; in the "
                  f"window loop, window kernel {us(mean(who, 'loop_window_ms'))}, barrier "
                  f"{us(mean(who, 'loop_barrier_ms'))}, gap {us(mean(who, 'loop_gap_ms'))}, folded launch "
                  f"{us(mean(who, 'loop_fold_ms'))}; the host issues a window in "
                  f"{us(mean(who, 'loop_host_ms'))} unfolded, {us(mean(who, 'loop_fold_host_ms'))} folded "
                  f"[{card}]")
            for form in ("unfolded", "folded"):
                runs_ms = walls(who, "walls_" + form)
                if runs_ms:
                    report[f"{label} walls {form} {who}"] = runs_ms
                    print(f"{label} ({who} checkout) whole runs {form}, in turns: "
                          + ", ".join(f"{x:.3f}" for x in runs_ms)
                          + f" ms (mean {sum(runs_ms) / len(runs_ms):.3f}, range {min(runs_ms):.3f}-"
                          f"{max(runs_ms):.3f}) [{card}]")
            print(f"{label} ({who} checkout): run_partitioned wall {mean(who, 'wall_ms'):.3f} ms [{card}]")
        ratios = ", ".join(
            f"{name} {mean('this', key) / mean('other', key):.3f}x"
            for name, key in (("window kernel the device alone", "held_window_ms"),
                              ("barrier the device alone", "held_barrier_ms"),
                              ("window kernel in the loop", "loop_window_ms"),
                              ("barrier in the loop", "loop_barrier_ms"),
                              ("run_partitioned wall", "wall_ms"))
        )
        print(f"{label}: this checkout over the other: {ratios} [{card}]")
    for who in ("other", "this"):
        built = {}
        for w, t in turns:
            if w == who:
                built.update(t["ptxas"])
        report[f"ptxas {who}"] = built
        for kernel, info in sorted(built.items()):
            print(f"ptxas {who} {kernel}: {info.get('registers')} registers, "
                  f"{info.get('spill_stores')} B spill stores, {info.get('spill_loads')} B spill loads")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / options.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
