#!/usr/bin/env python3
"""The SASS op mix of the draw kernel (csrc/uniform.cu) and the Lindley
kernel (csrc/mm1_scan.cu), and their operations bounds counted by pipe.

    python3 tools/sass_mix.py        # on a machine with nvcc and cuobjdump

Builds the libraries (kernels/build.py), disassembles each kernel with
``cuobjdump -sass``, finds its hot loop (the innermost loop body, from a
backward branch's target to the branch, that holds the most threefry
rotates: ``SHF.L.W``, 20 a threefry2x32, so 20 a uniform of the draw
kernel and 40 a customer of the Lindley kernel), and counts that body's
instructions by the pipe they issue on. Per element (a uniform) or per customer, then
over the main path's shapes (65,536 x 1,514 uniforms; 65,536 x 4,096
customers), the least time each pipe needs on an H100 SXM (132 SMs at
the 1.98 GHz boost clock, CUDA's throughput table for compute capability
9.0): the integer ALU pipe (adds, logic, shifts, compares, selects) 64
lanes an SM a clock; the FMA pipe 128 for float adds and multiply-adds,
and 64 for the integer multiply-adds (IMAD) it also issues; MUFU 16;
FP64 64; and every instruction one issue slot of 32 lanes a clock in
each of the SM's four partitions (128 lanes). The bound is the largest.
Prints one line a kernel and writes chiprun_out/sass_mix.json, and each
kernel's listing to chiprun_out/sass_<kernel>.txt.
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from happysim_tpu_torch.kernels import build  # noqa: E402

SMS, CLOCK_HZ = 132, 1.98e9
# Lanes an SM a clock, by pipe (CUDA C++ Programming Guide, throughput of
# arithmetic instructions, compute capability 9.0).
RATES = {"alu": 64, "fma": 128, "imad": 64, "mufu": 16, "fp64": 64, "issue": 128}
ALU = {
    "IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "FSETP", "DSETP",
    "SEL", "FSEL", "LEA", "IMNMX", "VIMNMX", "FMNMX", "PRMT", "IABS", "PLOP3", "BMSK", "SGXT",
    "FLO", "POPC", "P2R", "R2P", "ICMP",
}
FMA = {"FFMA", "FADD", "FMUL", "FMUL32I", "FADD32I", "FFMA32I", "HFMA2", "HADD2", "HMUL2"}
FP64 = {"DFMA", "DADD", "DMUL", "F2F", "F2I", "I2F"}
# (kernel symbol, library stem, the hot loop's marker, markers a unit, units)
KERNELS = {
    "uniform": ("uniform_kernel", "uniform", "SHF.L.W", 20, 65536 * 1514),
    "mm1_scan": ("mm1_scan_kernel", "mm1_scan", "SHF.L.W", 40, 65536 * 4096),
}


def pipe_of(op: str) -> str:
    base = op.split(".")[0]
    if base == "IMAD":
        return "imad"
    if base in ALU:
        return "alu"
    if base in FMA:
        return "fma"
    if base == "MUFU":
        return "mufu"
    if base in FP64:
        return "fp64"
    return "other"


def functions(sass: str) -> dict:
    """{function name: [(address, opcode, branch target address or None)]};
    a branch names its target by a label (``.L_x_N``, at the address of
    the next instruction) or by its address."""
    out, name, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            name, labels, pending = found.group(1), {}, []
            out[name] = []
            continue
        if name is None:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        ins = re.search(
            r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line
        )
        if not ins:
            continue
        address = int(ins.group(1), 16)
        for label_name in pending:
            labels[label_name] = address
        pending = []
        target = re.search(r"(\.L_x_\d+)|\b0x([0-9a-f]+)\b", ins.group(4))
        out[name].append([address, ins.group(3), target.group(1) or int(target.group(2), 16)
                          if target else None])
    # Labels resolve once the whole listing is read.
    for body in out.values():
        for entry in body:
            if isinstance(entry[2], str):
                entry[2] = labels.get(entry[2])
    return out


def hot_loop(body: list, marker: str) -> list:
    """The opcodes of the innermost loop body (from a backward branch's
    target to the branch, with no other backward branch inside) holding
    the most ``marker`` instructions."""
    loops = [
        (target, i)
        for i, (address, op, target) in enumerate(body)
        if op.split(".")[0] == "BRA" and target is not None and target <= address
    ]
    best = None
    for target, i in loops:
        if any(target <= t and j < i for t, j in loops if (t, j) != (target, i)):
            continue  # holds an inner loop
        ops = [o for a, o, _t in body[: i + 1] if a >= target]
        count = sum(o.startswith(marker) for o in ops)
        if count and (best is None or count > best[0]):
            best = (count, ops)
    if best is None:
        raise RuntimeError(f"no loop holding {marker}")
    return best[1]


def main() -> int:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    built = build.build_libraries()
    report = {}
    for kernel, (symbol, stem, marker, per_unit, units) in KERNELS.items():
        sass = subprocess.run([cuobjdump, "-sass", str(built[stem][0])], capture_output=True,
                              text=True, check=True).stdout
        out = Path("chiprun_out")
        out.mkdir(exist_ok=True)
        (out / f"sass_{kernel}.txt").write_text(sass)
        body = next(v for k, v in functions(sass).items() if symbol in k)
        ops = hot_loop(body, marker)
        per_iteration = sum(op.startswith(marker) for op in ops) / per_unit
        mix = collections.Counter(pipe_of(op) for op in ops)
        per = {pipe: n / per_iteration for pipe, n in mix.items()}
        per["issue"] = len(ops) / per_iteration
        ms = {
            pipe: per.get(pipe, 0.0) * units / (RATES[pipe] * SMS * CLOCK_HZ) * 1e3
            for pipe in RATES
        }
        bound_pipe = max(ms, key=ms.get)
        report[kernel] = {
            "units_per_iteration": per_iteration, "per_unit": per, "ms_by_pipe": ms,
            "bound_ms": ms[bound_pipe], "bound_pipe": bound_pipe,
            "opcodes": dict(collections.Counter(ops).most_common()),
        }
        print(
            f"{kernel}: hot loop {len(ops)} instructions for {per_iteration:g} "
            f"{'uniforms' if kernel == 'uniform' else 'customers'}; a unit "
            + ", ".join(f"{pipe} {n:.1f}" for pipe, n in sorted(per.items()))
            + f"; bound {ms[bound_pipe]:.4f} ms by the {bound_pipe} pipe ("
            + ", ".join(f"{pipe} {t:.4f}" for pipe, t in ms.items()) + ")"
        )
    (Path("chiprun_out") / "sass_mix.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
