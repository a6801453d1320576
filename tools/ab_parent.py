#!/usr/bin/env python3
"""The event-step kernel's time per block in this checkout against
another (a parent commit), on one card in turns: other, this, this,
other.

    git archive <parent> | tar -x -C build/parent
    python3 tools/ab_parent.py --root build/parent

Each turn is a fresh process in its checkout's root, which builds that
checkout's libraries (kernels/build.py, into its own build/) and runs its
chip_smoke.time_blocks on the models below at chip_smoke's full width:
the kernel's time per block in a 20-block launch, the plain version's
and the bound, for models both checkouts run; then, for the models of
RUNS, chip_smoke.check_whole_run's whole run in one launch (its device
time and blocks). Prints one line a model with the two checkouts' mean
kernel ms and their ratio, one a whole run, and the registers and
spills ptxas reported for each instantiation of each checkout (from the
turn that built its libraries), and writes chiprun_out/ab_parent.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

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
    ("superpose", "c.superpose_model()", None),
    ("wide-fleet", "c.wide_fleet_model()", None),
)
# Models whose whole run (one launch of the main path's budget) is timed.
RUNS = ("two-class", "wide-fleet")

_TURN = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as c
from happysim_tpu_torch.kernels import build
ptxas = {}
for stem, (_path, log) in build.build_libraries().items():
    for kernel, info in c.ptxas_summary(log).items():
        ptxas[stem + " " + kernel] = info
out = {"ptxas": ptxas, "runs": {}}
for label, expr, sweeps in %r:
    t = c.time_blocks(eval(expr), label, getattr(c, sweeps) if sweeps else None)
    out[label] = {k: t[k] for k in ("kernel_ms", "plain_ms", "bound_ms")}
    if label in %r:
        w = c.check_whole_run(label, eval(expr), getattr(c, sweeps) if sweeps else None)
        out["runs"][label] = {k: w[k] for k in ("run_ms", "blocks", "bound_ms")}
print("AB " + json.dumps(out))
"""


def turn(root: Path) -> dict:
    done = subprocess.run(
        [sys.executable, "-c", _TURN % (MODELS, RUNS)], cwd=root, capture_output=True, text=True
    )
    if done.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{done.stderr[-4000:]}")
    line = next(x for x in done.stdout.splitlines() if x.startswith("AB "))
    return json.loads(line[3:])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True, help="the other checkout's root")
    other = Path(parser.parse_args().root).resolve()
    here = Path(__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    turns = [("other", turn(other)), ("this", turn(here)), ("this", turn(here)), ("other", turn(other))]
    report = {"card": card, "turns": turns}
    for label, *_rest in MODELS:
        mean = {
            who: sum(t[label]["kernel_ms"] for w, t in turns if w == who) / 2 for who in ("this", "other")
        }
        report[label] = mean
        print(
            f"{label}: kernel {mean['this']:.4f} ms/block here, {mean['other']:.4f} in the other "
            f"checkout ({mean['this'] / mean['other']:.3f}x) [{card}]"
        )
    for label in RUNS:
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
    (out / "ab_parent.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
