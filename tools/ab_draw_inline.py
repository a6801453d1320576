#!/usr/bin/env python3
"""A/B timing of the event-step kernel's draw: the threefry inlined at
every uniform read site (-DHS_DRAW_INLINE) against one called function
(-DHS_DRAW_CALL), and the default, which calls it in the chaos
instantiations but the 1-server one with telemetry and no defense and
inlines it elsewhere (event_step.cuh's draw_calls), on one card, in
one process.

    python3 tools/ab_draw_inline.py
    python3 tools/ab_draw_inline.py --models two-class-chaos,trace-chaos   # those alone

Builds csrc/event_step.cu, event_step_telemetry.cu,
event_step_resilience.cu, event_step_multi.cu and event_step_trace.cu
the three ways into build/ab/ (nvcc, sm_90a, the flags of
kernels/build.py), prints ptxas' registers and spills of each, checks
that every variant leaves the same state bit for bit, and times each
variant's kernel per block at 65,536 replicas on the main path's models
(mm1, chain, fanout, chaos, the deadline rho sweep, bench.py's telemetry
model, the chaos bench with its telemetry, bench_resilience's two arms;
the two-tenant service's chaos arm (at four front servers, and at two:
four servers in all, tools/ab_models.py) and its defended arm, each code of the library for
several sources or sinks with chaos; the flash crowd
beside a Poisson source, and beside it with a deadline and a retry, the
trace library's chaos-free and chaos MULTI codes, a launch of 20 blocks
with pages of 2,048 a block), in turns: default, inline, call, call,
inline, default. Writes chiprun_out/ab_draw_inline.json. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import ab_models  # noqa: E402
import chip_smoke as smoke  # noqa: E402
from happysim_tpu_torch.kernels import build, event_step  # noqa: E402

OUT = build.BUILD_DIR / "ab"
SOURCES = (
    "event_step", "event_step_telemetry", "event_step_resilience", "event_step_multi",
    "event_step_trace",
)
BLOCKS = 20


def compile_variant(name: str, extra: tuple) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in SOURCES:
        out = OUT / f"{stem}_{name}.so"
        procs[stem] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *extra, "-o", str(out), str(build.CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    libs = {}
    for stem, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(stderr)
        for line in (stdout + stderr).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name} {stem}: {line.strip()}")
        lib = ctypes.CDLL(str(out))
        lib.hs_event_step.argtypes = [ctypes.POINTER(event_step._Args), ctypes.c_void_p]
        lib.hs_event_step.restype = ctypes.c_int
        libs[stem] = lib
    return libs


def launcher(libs: dict):
    def launch(args) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        rc = libs[event_step.library_of(args)].hs_event_step(ctypes.byref(args), stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")
    return launch


def time_variant(model, sweeps, launch) -> tuple:
    compiled, keys, params, state = smoke.fresh_run(model, sweeps)
    halted = torch.empty((smoke.REPLICAS,), dtype=torch.uint8, device="cuda")
    if compiled.has_trace:
        # A stream step's launch of 2 blocks, then one of BLOCKS more,
        # from the first resident pages (no lane stalls: pages of 2,048).
        pages = smoke.trace_pages(compiled, 0)
        launch(event_step.trace_launch_args(compiled, state, keys, params, pages, 0, 2, halted))
        ready = event_step.trace_launch_args(compiled, state, keys, params, pages, 0, 2 + BLOCKS,
                                             halted)
        return smoke.elapsed_ms(lambda i: launch(ready), 1) / BLOCKS, state
    for b in range(2):
        launch(event_step.launch_args(compiled, state, keys, b, params, halted))
    ready = [event_step.launch_args(compiled, state, keys, b + 2, params, halted) for b in range(BLOCKS)]
    ms = smoke.elapsed_ms(lambda i: launch(ready[i]), BLOCKS)
    return ms, state


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_draw_inline: torch finds no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--models", default="", help="comma-separated labels to time alone")
    options = parser.parse_args()
    card = smoke.card_label()
    variants = {
        "default": launcher(compile_variant("default", ())),
        "inline": launcher(compile_variant("inline", ("-DHS_DRAW_INLINE",))),
        "call": launcher(compile_variant("call", ("-DHS_DRAW_CALL",))),
    }
    models = {
        "mm1": (smoke.mm1_model(smoke.LAM, smoke.MU, smoke.HORIZON_S, warmup_s=smoke.WARMUP_S), None),
        "chain": (smoke.pipeline_model(8.0, (0.05, 0.08, 0.06), smoke.HORIZON_S), None),
        "fanout": (smoke.router_model("random", smoke.HORIZON_S, smoke.WARMUP_S), None),
        "chaos": (smoke.chaos_model(), smoke.CHAOS_SWEEPS),
        "deadline": (smoke.hetero_model(), smoke.HETERO_SWEEPS),
        "telemetry": (smoke.telemetry_model(), smoke.HETERO_SWEEPS),
        "chaos-telemetry": (
            smoke.with_telemetry(smoke.chaos_model(), smoke.BENCH_HORIZON_S / smoke.TEL_WINDOWS),
            smoke.CHAOS_SWEEPS,
        ),
        "resilience-undefended": (smoke.resilience_bench_model(False), smoke.RES_SWEEPS),
        "resilience": (smoke.resilience_bench_model(True), smoke.RES_SWEEPS),
        "two-class-chaos": (smoke.two_class_model(chaos=True), None),
        "two-class-defended": (smoke.two_class_model(chaos=True, defended=True), None),
        "two-class-chaos-4": (ab_models.two_class_chaos_4(smoke), None),
        "trace-poisson": (smoke.trace_model("flash", smoke.TRACE_LONG_CHUNK, poisson_rate=50.0), None),
        "trace-chaos": (smoke.trace_model("flash", smoke.TRACE_LONG_CHUNK, **smoke.TRACE_CHAOS), None),
    }
    keep = options.models.split(",") if options.models else list(models)
    results = {}
    for label in keep:
        model, sweeps = models[label]
        times = {name: [] for name in variants}
        states = {}
        for variant in ("default", "inline", "call", "call", "inline", "default"):
            ms, state = time_variant(model, sweeps, variants[variant])
            times[variant].append(ms)
            states.setdefault(variant, state)
        torch.cuda.synchronize()
        for other in ("inline", "call"):
            for leaf in states["default"]:
                a, b = states["default"][leaf], states[other][leaf]
                if a.is_floating_point():
                    a, b = a.view(torch.int32), b.view(torch.int32)
                smoke.require(bool((a == b).all()), f"{label}: {leaf} differs in the {other} variant")
        results[label] = times
        mean = {name: sum(t) / len(t) for name, t in times.items()}
        print(
            f"{label}: default {mean['default']:.4f}, inline {mean['inline']:.4f}, call "
            f"{mean['call']:.4f} ms/block; call / inline {mean['call'] / mean['inline']:.3f} [{card}]"
        )
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/ab_draw_inline.json").write_text(json.dumps({"card": card, "ms": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
