"""The readings the limits of ``benchmark/compare.py`` are set from, at a
cell's own size on the card:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--program-seeds 4,5,...]

For each of ``--seeds``: the control, the plain reference computed in
bfloat16 (the precision below the configuration's float32) put in the
program's place, against the reference in float32; these are the upper
readings. For each of ``--program-seeds``: one call of the program
against the float32 reference; these are the lower readings, in one
process so that set-up is paid once. Prints one JSON line a reading and
writes them all to ``chiprun_out/control_<cell>.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--program-seeds", default="")
    opts = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import cells, compare

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.workload(opts.workload, ROOT)
    spec = cells.resolve(cell["config"], cell["traffic"])
    reference = cells.reference(spec)
    seeds = [int(s) for s in opts.seeds.split(",") if s]
    program_seeds = [int(s) for s in opts.program_seeds.split(",") if s]
    readings = []

    def report(kind: str, seed: int, values: dict, seconds: float) -> None:
        entry = {"kind": kind, "workload": opts.workload, "seed": seed, **values, "seconds": seconds}
        readings.append(entry)
        print(json.dumps(entry), flush=True)

    for seed in seeds:
        begin = time.perf_counter()
        exact = reference.simulate(spec, seed, "cuda")
        control = reference.simulate(spec, seed, "cuda", torch.bfloat16)
        values = compare.readings(control, exact, reference.FIELDS)
        report("control", seed, values, time.perf_counter() - begin)
    if program_seeds:
        builder = cells.builder(spec)
        model = builder.build(spec)
        for seed in program_seeds:
            begin = time.perf_counter()
            result = builder.run(model, spec, seed)
            program = compare.program_totals(result, reference.FIELDS)
            del result
            torch.cuda.empty_cache()
            exact = reference.simulate(spec, seed, "cuda")
            values = compare.readings(program, exact, reference.FIELDS)
            report("program", seed, values, time.perf_counter() - begin)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"control_{opts.workload}.json").write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
