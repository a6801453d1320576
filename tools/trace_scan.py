#!/usr/bin/env python3
"""A torch.profiler trace of run_ensemble's event scan on the card: device
busy and idle share over each run, kernel time by name, and what the host
does while the device idles.

    python3 tools/trace_scan.py [--root DIR] [--tag NAME]

Runs the scan (an explicit event budget, so the chain form stays out) of
the M/M/1, the random fan-out and the chaos bench at 65,536 replicas, the
models of chip_smoke.py, once untraced (its wall time) and once under
``torch.profiler.profile(activities=[CPU, CUDA])``. ``--root`` imports
happysim_tpu_torch and chip_smoke.py from another checkout (a parent
commit unpacked into a directory .gitignore lists), so two trees are
traced in one call on one card.

The engine's own profiler scopes (``engine.PROFILER_SCOPES``:
``hs.macro_block`` around each budget call, ``hs.kernel`` around the
kernel's launch inside it, ``hs.reduce`` around the reduce over
replicas) are read as they are: for each, its ranges, their host ms, and
the device ms of the work launched inside them (a kernel, copy or
memset whose launching call, matched by its correlation id, lies in a
range). A checkout whose engine has no scopes shows none. The host's
other phases are profiler spans the script wraps around the engine's
functions: set-up (``_resolve_params``, ``rng.split``, ``init_state``,
``replica_halted``), ``_blocks_reduce`` and ``_build_result``; and the
host's waits for the device (the runtime's synchronize calls and its
blocking copies, which hold the reduce's reads). For each phase and
scope, the device idle time that falls inside its spans; the rest is
"other" (the Python code and the small torch ops between them). The
device is busy where a kernel, copy or memset runs; the window is the
run_ensemble call.
nvidia-smi's clocks, power and temperature are read before and after each
run. Writes chiprun_out/trace_scan_<tag>.json and a Chrome trace per run
under chiprun_out/traces/. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host spans: the script's record_function spans (the profiler also draws
# each on the device's timeline, as "gpu_user_annotation"; those are not
# the host's) and the runtime calls in which the host waits for the device.
HOST_SPAN_CATS = ("user_annotation",)
WAIT_CALLS = (
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpyAsync",
)
SMI_QUERY = "name,power.limit,clocks.sm,clocks.mem,power.draw,temperature.gpu"
# The engine's scopes (engine.PROFILER_SCOPES, named here so that a
# checkout without them reads as one whose scopes are empty).
ENGINE_SCOPES = ("hs.macro_block", "hs.kernel", "hs.reduce")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def merge(intervals: list) -> list:
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def wrap(owner, name: str, span: str) -> None:
    """Replace ``owner.name`` by the same callable inside a profiler span."""
    import torch

    fn = getattr(owner, name)

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with torch.profiler.record_function(span):
            return fn(*args, **kwargs)

    setattr(owner, name, spanned)


def analyse(trace_path: Path) -> dict:
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [
        e for e in spans if e.get("name") == "hs.run_ensemble" and e.get("cat") in HOST_SPAN_CATS
    ]
    if not window:
        raise RuntimeError("no hs.run_ensemble span in the trace")
    w0, w1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    inside = [e for e in spans if e["ts"] >= w0 and e["ts"] + e["dur"] <= w1]
    device = [e for e in inside if e.get("cat") in DEVICE_CATS]
    busy = merge([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy_us = sum(hi - lo for lo, hi in busy)
    idle = []
    cursor = w0
    for lo, hi in busy:
        if lo > cursor:
            idle.append([cursor, lo])
        cursor = max(cursor, hi)
    if cursor < w1:
        idle.append([cursor, w1])
    by_kernel: dict = {}
    for e in device:
        key = e["name"][:120]
        n, total = by_kernel.get(key, (0, 0.0))
        by_kernel[key] = (n + 1, total + e["dur"])
    host = [e for e in inside if e.get("cat") in HOST_SPAN_CATS]
    waits = [e for e in inside if e.get("cat") == "cuda_runtime" and e.get("name") in WAIT_CALLS]
    calls = {
        e["args"]["correlation"]: e["ts"]
        for e in inside
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
    }
    scopes = {}
    for name in ENGINE_SCOPES:
        ranges = [(e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == name]
        launched = [
            (e["ts"], e["ts"] + e["dur"]) for e in device
            if any(lo <= calls.get(e.get("args", {}).get("correlation"), -1.0) <= hi
                   for lo, hi in ranges)
        ]
        own = merge(ranges)
        scopes[name] = {
            "ranges": len(ranges),
            "host_ms": sum(hi - lo for lo, hi in own) / 1e3,
            "device_ms": sum(hi - lo for lo, hi in merge(launched)) / 1e3,
            "device_idle_ms": overlap(own, idle) / 1e3,
        }
    phases = {}
    for label, events_of in (
        ("setup", [e for e in host if e["name"] == "hs.setup"]),
        ("wait", waits),
        ("blocks_reduce", [e for e in host if e["name"] == "hs.blocks_reduce"]),
        ("build_result", [e for e in host if e["name"] == "hs.build_result"]),
    ):
        own = merge([(e["ts"], e["ts"] + e["dur"]) for e in events_of])
        phases[label] = {
            "spans": len(own),
            "host_ms": sum(hi - lo for lo, hi in own) / 1e3,
            "device_idle_ms": overlap(own, idle) / 1e3,
        }
    named = merge([
        (e["ts"], e["ts"] + e["dur"])
        for e in host + waits
        if e["name"] != "hs.run_ensemble"
    ])
    idle_us = (w1 - w0) - busy_us
    runtime: dict = {}
    for e in inside:
        if e.get("cat") == "cuda_runtime":
            n, total = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (n + 1, total + e["dur"])
    return {
        "window_ms": (w1 - w0) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_ms": idle_us / 1e3,
        "device_idle_share": idle_us / (w1 - w0),
        "kernels": {k: {"count": n, "ms": t / 1e3} for k, (n, t) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])},
        "scopes": scopes,
        "host_phases": phases,
        "idle_outside_named_phases_ms": (idle_us - overlap(named, idle)) / 1e3,
        "cuda_runtime": {k: {"count": n, "ms": t / 1e3} for k, (n, t) in sorted(runtime.items(), key=lambda kv: -kv[1][1])},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--tag", default="tree")
    opts = parser.parse_args()
    sys.path.insert(0, str(Path(opts.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("trace_scan: torch finds no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from happysim_tpu_torch import engine, rng, run_ensemble

    wrap(engine, "_resolve_params", "hs.setup")
    wrap(rng, "split", "hs.setup")
    wrap(engine._Compiled, "init_state", "hs.setup")
    wrap(engine._Compiled, "replica_halted", "hs.setup")
    wrap(engine, "_blocks_reduce", "hs.blocks_reduce")
    wrap(engine, "_build_result", "hs.build_result")

    card = smoke.card_label()
    models = {
        "mm1": (smoke.mm1_model(smoke.LAM, smoke.MU, smoke.HORIZON_S, warmup_s=smoke.WARMUP_S), None, None),
        "fanout": (smoke.router_model("random", smoke.HORIZON_S, smoke.WARMUP_S), None, None),
        "chaos": (smoke.chaos_model(), smoke.CHAOS_SWEEPS, smoke.CHAOS_MAX_EVENTS),
    }
    out_dir = Path("chiprun_out")
    (out_dir / "traces").mkdir(parents=True, exist_ok=True)
    results = {"card": card, "root": opts.root, "runs": {}}
    for label, (model, sweeps, budget) in models.items():
        budget = budget or engine._default_max_events(model, sweeps)

        def run():
            with torch.profiler.record_function("hs.run_ensemble"):
                return run_ensemble(model, n_replicas=smoke.REPLICAS, sweeps=sweeps, max_events=budget)

        run()  # warm-up: the build, the load, the allocator
        plain = run()
        torch.cuda.synchronize()
        before = smi()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            traced = run()
            torch.cuda.synchronize()
        after = smi()
        path = out_dir / "traces" / f"{opts.tag}_{label}.json"
        prof.export_chrome_trace(str(path))
        info = analyse(path)
        info.update({
            "wall_ms_untraced": plain.wall_seconds * 1e3,
            "wall_ms_traced": traced.wall_seconds * 1e3,
            "blocks": int(max(plain.block_occupancy)),
            "events": plain.simulated_events,
            "launches_in_trace": info["kernels"] and sum(
                k["count"] for name, k in info["kernels"].items() if "event_step" in name
            ),
            "nvidia_smi_before": before,
            "nvidia_smi_after": after,
        })
        if info["device_busy_ms"] == 0.0:
            print(f"trace {opts.tag} {label}: the profiler shows no device time", file=sys.stderr)
        results["runs"][label] = info
        phases = ", ".join(
            f"{k} {v['host_ms']:.2f} ms host / {v['device_idle_ms']:.2f} ms idle"
            for k, v in info["host_phases"].items()
        )
        scopes = ", ".join(
            f"{k} x{v['ranges']} {v['host_ms']:.3f} ms host / {v['device_ms']:.3f} ms device"
            for k, v in info["scopes"].items()
        )
        top = list(info["kernels"].items())[:3]
        print(
            f"trace {opts.tag} {label}: wall {info['wall_ms_untraced']:.2f} ms untraced, "
            f"{info['window_ms']:.2f} ms traced; device busy {info['device_busy_ms']:.2f} ms, idle "
            f"{100 * info['device_idle_share']:.1f}%; scopes {scopes}; {phases}; idle elsewhere "
            f"{info['idle_outside_named_phases_ms']:.2f} ms; kernels "
            + "; ".join(f"{name[:60]} x{k['count']} {k['ms']:.2f} ms" for name, k in top)
            + f"; smi before [{before}] after [{after}] [{card}]"
        )
    (out_dir / f"trace_scan_{opts.tag}.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
