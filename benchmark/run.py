"""The benchmark of happysim_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's ensemble model from ``benchmark/configs/<config>.json``
and its traffic from ``benchmark/traffic/<traffic>.json``, by the builder
the configuration names (``benchmark/builders/``), warms up with one call
at the cell's shapes (which builds or loads the kernel libraries), then
makes the builder's call back to back for ``--seconds``, each call a
whole ensemble with its own seed drawn from ``--seed`` and ending in a
device sync. After the window one call drawn from the seed is simulated
again by the plain reference that the configuration names
(``benchmark/reference/``) and compared over the fields it names
(``benchmark/compare.py``).

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs the
window under ``torch.profiler`` and prints its per-layer metrics, each
read by ``benchmark/metrics/<metric>.py`` from the trace. The last line
of standard output is one JSON object; notes go to standard error, the
compared numbers last. Needs a CUDA card; exits non-zero with no result
without one, or when a JAX module is loaded.
"""

from __future__ import annotations

import os
import time

_MODULE_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "happysim_tpu")
TRACED_SECONDS = 5.0


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is,
    whole, one of :data:`FORBIDDEN`."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (from /proc), else since this
    module was first run."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return float(Path("/proc/uptime").read_text().split()[0]) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _MODULE_START


def _reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
        return out[0].strip() if out else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device=None, note=print) -> dict:
    """One run of a resolved cell (:func:`benchmark.cells.resolve`) on
    ``device`` (None: the CUDA card): set-up, the window, the check.
    Returns the pieces of the result line."""
    import torch

    from benchmark import cells, compare

    on_card = device is None
    builder, reference = cells.builder(spec), cells.reference(spec)
    model = builder.build(spec)

    def call(index: int):
        start = time.perf_counter()
        result = builder.run(model, spec, cells.call_seed(seed, index), device)
        if on_card:
            torch.cuda.synchronize()
        return result, time.perf_counter() - start

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    warm, warm_wall = call(-1)
    setup_s = process_age_s()
    note(f"set-up {setup_s:.3f} s (the warm-up call {warm_wall:.3f} s, its build "
         f"{warm.compile_seconds:.3f} s; engine path {warm.engine_path})")

    # With --trace 1 the profiler, started before the window, records the
    # calls that start in its first TRACED_SECONDS; the window's other
    # calls run as in an untraced run.
    calls, prof, traced_calls = [], None, 0
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    window_start = time.perf_counter()
    while not calls or time.perf_counter() - window_start < seconds:
        tracing = prof is not None and (
            not calls or time.perf_counter() - window_start < TRACED_SECONDS
        )
        if prof is not None and not tracing and not traced_calls:
            prof.stop()
            traced_calls = len(calls)
        span = torch.profiler.record_function("bench.call") if tracing else contextlib.nullcontext()
        with span:
            result, wall = call(len(calls))
        calls.append({
            "seed": cells.call_seed(seed, len(calls)), "wall_s": wall,
            "events": int(result.simulated_events),
            "truncated": int(result.truncated_replicas),
            "totals": compare.program_totals(result, reference.FIELDS),
        })
    window_s = time.perf_counter() - window_start
    if prof is not None and not traced_calls:
        prof.stop()
        traced_calls = len(calls)
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    del result, warm

    traced = None
    if trace:
        handle, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(handle)
        try:
            begin = time.perf_counter()
            prof.export_chrome_trace(path)
            from benchmark.trace import TracedWindow

            traced = TracedWindow.load(Path(path))
            note(f"trace of {len(traced.device)} device ops, {os.path.getsize(path)} bytes, "
                 f"written and read in {time.perf_counter() - begin:.3f} s")
        finally:
            os.unlink(path)
    walls = sorted(c["wall_s"] for c in calls)
    note(f"{len(calls)} calls in {window_s:.3f} s; call wall median {1e3 * walls[len(walls) // 2]:.3f} ms, "
         f"min {1e3 * walls[0]:.3f}, max {1e3 * walls[-1]:.3f}; {calls[0]['events']} events the first")

    # The check: one call of the window drawn from the seed, simulated
    # again by the plain reference on the same device once the program's
    # memory is read and freed.
    if on_card:
        torch.cuda.empty_cache()
    checked = random.Random(int(seed)).randrange(len(calls))
    begin = time.perf_counter()
    totals = reference.simulate(spec, calls[checked]["seed"], "cuda" if on_card else device)
    values = compare.readings(calls[checked]["totals"], totals, reference.FIELDS)
    note(f"reference of call {checked} (seed {calls[checked]['seed']}) in "
         f"{time.perf_counter() - begin:.3f} s")
    return {
        "calls": calls, "window_s": window_s, "setup_s": setup_s, "trace": traced,
        "memory_peak_bytes": memory_peak, "checked": values, "correct": compare.verdict(values),
        "traced_calls": calls[:traced_calls],
    }


def result_line(bench: dict, cell: dict, spec: dict, out: dict, trace: bool) -> dict:
    """The result's JSON object: the metrics of this cell and mode, read by
    their readers."""
    ctx = SimpleNamespace(
        spec=spec, calls=out["calls"], traced_calls=out["traced_calls"], window_s=out["window_s"],
        setup_s=out["setup_s"], trace=out["trace"],
    )
    group = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for metric in group:
        if not _applies(metric, cell["name"]):
            continue
        value = _reader(metric["name"])(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return metrics


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = parser.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))

    from benchmark import cells, roofline

    bench = cells.load_benchmark(CHECKOUT)
    cell = cells.workload(opts.workload, CHECKOUT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    spec = cells.resolve(cell["config"], cell["traffic"])
    note = lambda text: print(f"benchmark {opts.workload}: {text}", file=sys.stderr, flush=True)  # noqa: E731
    note(f"{spec['replicas']} replicas, horizon {spec['horizon_s']} s, max_events {spec['max_events']}")
    out = run_cell(spec, opts.seed, opts.seconds, bool(opts.trace), note=note)
    card = card_line()
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"benchmark: modules of the JAX package or JAX are loaded: {loaded}", file=sys.stderr)
        return 3
    metrics = result_line(bench, cell, spec, out, bool(opts.trace))
    failed = sum(1 for c in out["calls"] if c["truncated"])
    least, bound = roofline.least_seconds(spec, out["calls"][0]["totals"])
    note(f"peak device memory {out['memory_peak_bytes']} bytes (max_memory_allocated); "
         f"the event step's bound {bound} ({least * 1e3:.4f} ms the first call); card {card}")
    device = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"]),
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    line = {
        "correct": bool(out["correct"]), "attempted": len(out["calls"]), "failed": failed,
        "metrics": metrics, "device": device,
    }
    if out["trace"] is not None:
        t = out["trace"]
        device["busy_s"] = t.busy_us / 1e6
        device["window_s"] = t.window_us / 1e6
        gaps = sorted(t.idle_by_host_phase().items(), key=lambda kv: -kv[1])
        line["breakdown"] = {
            "device_ops": t.top_device_ops(10),
            "idle_gaps": [[label, seconds] for label, seconds in gaps[:10]],
        }
    from benchmark import compare

    # A reading that is not finite goes into the line as its repr, so the
    # line stays JSON that any parser reads.
    line["checked"] = {
        name: {"value": value if math.isfinite(value) else repr(value), "limit": compare.LIMITS[name]}
        for name, value in out["checked"].items()
    }
    for name, entry in line["checked"].items():
        print(f"checked {name} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
