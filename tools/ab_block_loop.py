#!/usr/bin/env python3
"""A/B timing of the event-step kernel's structure on one card, in one
process: a whole scan run at 65,536 replicas in four variants, in turns.

    python3 tools/ab_block_loop.py [--models fanout,chaos,profile] [--rounds N] [--tag NAME]

- ``per-block``: one block a launch, every row in device memory, 128
  lanes a block, driven by the host loop the engine had before the block
  loop moved into the kernel (a host sync per block for the early exit,
  the blocks count a torch op per block);
- ``loop``: the whole run in one launch, every row in device memory, 128
  lanes a block;
- ``loop+tile``: the whole run in one launch with the rows a step scans
  staged in shared memory, 128 lanes a block;
- ``loop+tile64``: the same with 64 lanes a block (the library as built);
- ``loop+tile64-uncapped``: loop+tile64 without the register cap of the
  instantiations of up to four servers without chaos
  (``HS_MIN_BLOCKS``).

Builds csrc/event_step.cu and event_step_resilience.cu the four ways
into build/ab/ (nvcc, sm_90a, the flags of kernels/build.py, plus
-DHS_STAGE_ROWS=0, -DHS_THREADS=128 or -DHS_REG_CAP=0: compile-time
variants, never a switch in the library), prints ptxas' registers and
spills of each, checks that every variant leaves the same state and the same
blocks per replica bit for bit, and times each run from the same initial
state on the fan-out, the chaos bench, the M/M/1, the pipeline, the
deadline rho sweep and bench_resilience's defended arm (and, on request,
the profile graph) at the budgets of
chip_smoke.py's main path, in turns (per-block, loop, loop+tile,
loop+tile64, loop+tile64-uncapped, then back, ``--rounds`` times). Times are CUDA events around the run (the host
loop's gaps included for per-block) and the host's wall clock; set-up and
the reduce are left out. Writes chiprun_out/ab_block_loop[_NAME].json.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from happysim_tpu_torch.engine import _default_max_events  # noqa: E402
from happysim_tpu_torch.kernels import build, event_step, support  # noqa: E402

OUT = build.BUILD_DIR / "ab"
SOURCES = ("event_step", "event_step_resilience")
BUILDS = {
    "global": ("-DHS_STAGE_ROWS=0", "-DHS_THREADS=128"), "tile": ("-DHS_THREADS=128",),
    "tile64": (), "tile64-uncapped": ("-DHS_REG_CAP=0",),
}
# variant: (library build, lanes a block, one launch for the run)
VARIANTS = {
    "per-block": ("global", 128, False),
    "loop": ("global", 128, True),
    "loop+tile": ("tile", 128, True),
    "loop+tile64": ("tile64", 64, True),
    "loop+tile64-uncapped": ("tile64-uncapped", 64, True),
}
# One round: every variant, then back.
ROUND = (*VARIANTS, *reversed(VARIANTS))


def compile_builds() -> dict:
    """{build: {source stem: library}}, every nvcc started at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, extra in BUILDS.items():
        for stem in SOURCES:
            out = OUT / f"{stem}_{name}.so"
            procs[name, stem] = (out, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, *extra, "-o", str(out), str(build.CSRC / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
    libs: dict = {name: {} for name in BUILDS}
    for (name, stem), (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(stderr)
        for kernel, info in smoke.ptxas_summary(stdout + stderr).items():
            print(
                f"  ptxas {name} {stem} event_step_kernel{kernel}: {info['registers']} registers, "
                f"{info['spill_stores']} B spill stores, {info['spill_loads']} B spill loads"
            )
        lib = ctypes.CDLL(str(out))
        lib.hs_event_step.argtypes = [ctypes.POINTER(event_step._Args), ctypes.c_void_p]
        lib.hs_event_step.restype = ctypes.c_int
        lib.hs_event_step_threads.restype = ctypes.c_int
        libs[name][stem] = lib
    return libs


def run_variant(libs: dict, variant: str, model, sweeps, budget) -> tuple:
    """(device ms, host ms, final state, blocks) of one scan run."""
    build_name, threads, one_launch = VARIANTS[variant]
    lib_set = libs[build_name]
    compiled, keys, params, state = smoke.fresh_run(model, sweeps)
    n = -(-budget // compiled.macro)
    R = smoke.REPLICAS
    blocks = torch.zeros((R,), dtype=torch.int32, device="cuda")
    halted = torch.empty((R,), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(args) -> None:
        lib = lib_set[event_step.library_of(args)]
        if lib.hs_event_step_threads() != threads:
            raise RuntimeError(f"{variant}: the library has {lib.hs_event_step_threads()} lanes a block")
        rc = lib.hs_event_step(ctypes.byref(args), stream)
        if rc != 0:
            raise RuntimeError(f"{variant}: launch failed: cudaError {rc}")

    def planned(args):
        if threads != support.KERNEL_THREADS:
            tables = 2 * args.prof_n * 4 if args.has_profile else 0
            rows = {
                leaf: math.prod(state[leaf].shape[1:])
                for leaf in support.STAGE_LEAVES if leaf in state
            }
            offsets, words = support.stage_plan(rows, support.stage_budget(R, tables, threads))
            args.stage = event_step._Stage((ctypes.c_int * len(offsets))(*offsets), words)
        return args

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wall = time.perf_counter()
    start.record()
    if one_launch:
        launch(planned(event_step.launch_args(
            compiled, state, keys, 0, params, halted, n_blocks=n, blocks=blocks
        )))
    else:
        live = ~compiled.replica_halted(state)
        for c in range(n):
            if not bool(live.any()):
                break
            blocks += live.to(torch.int32)
            launch(event_step.launch_args(compiled, state, keys, c, params, halted))
            live = halted == 0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - wall) * 1e3, state, blocks


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--models", default="fanout,chaos,mm1,chain,deadline,resilience")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--tag", default="")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_block_loop: torch finds no CUDA device", file=sys.stderr)
        return 2
    card = smoke.card_label()
    libs = compile_builds()
    models = {
        "fanout": (smoke.router_model("random", smoke.HORIZON_S, smoke.WARMUP_S), None, None),
        "chaos": (smoke.chaos_model(), smoke.CHAOS_SWEEPS, smoke.CHAOS_MAX_EVENTS),
        "mm1": (smoke.mm1_model(smoke.LAM, smoke.MU, smoke.HORIZON_S, warmup_s=smoke.WARMUP_S), None, None),
        "chain": (smoke.pipeline_model(8.0, (0.05, 0.08, 0.06), smoke.HORIZON_S), None, None),
        "deadline": (smoke.hetero_model(), smoke.HETERO_SWEEPS, None),
        "resilience": (smoke.resilience_bench_model(True), smoke.RES_SWEEPS, smoke.RES_MAX_EVENTS),
        "profile": (smoke.graph_model(ramp=True), smoke.GRAPH_SWEEPS, smoke.PROFILE_MAX_EVENTS),
    }
    results = {}
    for label in opts.models.split(","):
        model, sweeps, budget = models[label]
        budget = budget or _default_max_events(model, sweeps)
        run_variant(libs, "loop+tile", model, sweeps, budget)  # warm-up
        device = {name: [] for name in VARIANTS}
        host = {name: [] for name in VARIANTS}
        finals = {}
        for variant in ROUND * opts.rounds:
            ms, wall_ms, state, blocks = run_variant(libs, variant, model, sweeps, budget)
            device[variant].append(ms)
            host[variant].append(wall_ms)
            finals.setdefault(variant, (state, blocks))
        reference, ref_blocks = finals["per-block"]
        for variant, (state, blocks) in finals.items():
            smoke.require(torch.equal(blocks, ref_blocks), f"{label}: blocks differ in {variant}")
            for leaf, want in reference.items():
                got = state[leaf]
                if want.is_floating_point():
                    got, want = got.view(torch.int32), want.view(torch.int32)
                smoke.require(torch.equal(got, want), f"{label}: {leaf} differs in {variant}")
        mean = {name: sum(t) / len(t) for name, t in device.items()}
        results[label] = {"device_ms": device, "host_ms": host, "blocks": int(ref_blocks.max())}
        spread = {name: max(t) - min(t) for name, t in device.items()}
        print(
            f"{label} ({int(ref_blocks.max())} blocks): "
            + ", ".join(f"{name} {mean[name]:.3f} ms" for name in VARIANTS)
            + "; spread " + ", ".join(f"{name} {spread[name]:.3f}" for name in VARIANTS)
            + f" ms; loop / per-block {mean['loop'] / mean['per-block']:.3f}, loop+tile / loop "
            f"{mean['loop+tile'] / mean['loop']:.3f}, loop+tile64 / loop+tile "
            f"{mean['loop+tile64'] / mean['loop+tile']:.3f}, loop+tile64-uncapped / loop+tile64 "
            f"{mean['loop+tile64-uncapped'] / mean['loop+tile64']:.3f}; every variant equal bit for "
            f"bit [{card}]"
        )
        del finals, reference
        torch.cuda.empty_cache()
    Path("chiprun_out").mkdir(exist_ok=True)
    name = f"ab_block_loop{'_' + opts.tag if opts.tag else ''}.json"
    Path("chiprun_out", name).write_text(json.dumps({"card": card, **results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
