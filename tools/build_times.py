#!/usr/bin/env python3
"""The nvcc build of the port's CUDA sources, timed source by source:

    python3 tools/build_times.py      # on a machine with nvcc and an NVIDIA GPU

First each source of kernels/build.py's SOURCES alone, one after the
other (its own compile time), then all of them started together as
build.build_libraries starts them, each process's finish time read by
polling (which one holds the parallel build back). Builds into a
temporary directory, so the repository's build/ is left as it is.
Prints one line a source and the host's CPU count, the card's name and
power limit, and writes chiprun_out/build_times.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from happysim_tpu_torch.kernels import build  # noqa: E402


def _command(source: Path, out: Path) -> list:
    return [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(source)]


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    solo, parallel = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for source in build.SOURCES:
            start = time.perf_counter()
            subprocess.run(_command(source, Path(tmp) / f"{source.stem}.so"), check=True,
                           capture_output=True)
            solo[source.stem] = time.perf_counter() - start
        start = time.perf_counter()
        running = {
            source.stem: subprocess.Popen(
                _command(source, Path(tmp) / f"{source.stem}.par.so"),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
            for source in build.SOURCES
        }
        while running:
            for stem, proc in list(running.items()):
                if proc.poll() is not None:
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc failed on {stem}")
                    parallel[stem] = time.perf_counter() - start
                    del running[stem]
            time.sleep(0.05)
        wall = time.perf_counter() - start
    for stem in solo:
        print(f"{stem}: alone {solo[stem]:.1f} s, done after {parallel[stem]:.1f} s of the "
              f"parallel build [{card}]")
    print(f"parallel build of {len(solo)} sources: {wall:.1f} s on {os.cpu_count()} CPUs; "
          f"alone one after the other: {sum(solo.values()):.1f} s [{card}]")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "build_times.json").write_text(json.dumps(
        {"card": card, "cpus": os.cpu_count(), "solo_s": solo, "parallel_done_s": parallel,
         "parallel_wall_s": wall}, indent=1,
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
