#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (happysim_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits nonzero):

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. the build: the event-step kernel compiled with nvcc for sm_90a from
   this checkout's sources, with ptxas' register and spill report;
3. block checks at full size: on a 65,536-replica M/M/1 (lambda=8, mu=10,
   horizon 160 s, warmup 40 s, macro_block 32) the kernel and its plain
   torch-op version advance identical copies of the state through the
   same uniform block, for blocks 0-3 and 78-81, and on the 3-stage
   pipeline (the "chain" shape) for blocks 0 and 40. Integer leaves must
   be equal and float leaves are expected bitwise equal; a float
   difference is printed and must stay within rel 1e-6;
4. timing: the kernel's, the plain version's and the threefry draw's
   time per block (CUDA events, after warm-up), beside the kernel's
   bound (bytes a block must move over 3.35 TB/s);
5. the main path: run_ensemble on the M/M/1 at 65,536 replicas on cuda,
   with every launch counter set to 0 just before and read just after;
   it must run through the kernel once per macro-block, truncate no
   replica, and land within 1% of the analytic mean wait rho/(mu-lam)
   = 0.4 s and mean sojourn 1/(mu-lam) = 0.5 s.

The last lines are the kernel table as one JSON object, nvidia-smi's name
and power limit, and {"ok": true, "device": {...}}. Every number printed
carries the card's name and power limit. Details also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from happysim_tpu_torch import mm1_model, pipeline_model, rng, run_ensemble
from happysim_tpu_torch.engine import _Compiled, _resolve_params, macro_block_len
from happysim_tpu_torch.kernels import event_step, support

REPLICAS = 65536
LAM, MU = 8.0, 10.0
HORIZON_S, WARMUP_S = 160.0, 40.0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 rate
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Float operations one event step needs per replica, counted low (a log,
# a multiply or divide and an add for the draw, a subtract and a max for
# the interval, a multiply-add per server for the depth integral), so the
# operations bound stays a lower bound.
OPS_PER_STEP_BASE = 5
OPS_PER_STEP_PER_SERVER = 2
FLOAT_RTOL = 1e-6
TIMED_BLOCKS = 20


class SmokeFailure(RuntimeError):
    pass


def require(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def fresh_run(model, seed: int = 0):
    """(compiled, keys, params, state) for REPLICAS replicas on cuda."""
    compiled = _Compiled(model)
    params = {
        k: torch.from_numpy(v).cuda()
        for k, v in _resolve_params(model, compiled, REPLICAS, None).items()
    }
    keys = rng.split(rng.PRNGKey(seed, device="cuda"), REPLICAS)
    return compiled, keys, params, compiled.init_state(keys, params)


def draw(compiled, keys, block: int, macro: int) -> torch.Tensor:
    return rng.uniform(
        rng.fold_in(keys, block), (macro, compiled.n_draws), minval=1e-12, maxval=1.0
    )


def compare_states(kernel: dict, plain: dict, label: str) -> float:
    """Every leaf equal (ints) or within FLOAT_RTOL (floats); returns the
    largest absolute float difference."""
    max_abs = 0.0
    for name in sorted(plain):
        a, b = kernel[name], plain[name]
        require(a.dtype == b.dtype and a.shape == b.shape, f"{label}: {name} layout differs")
        if not a.is_floating_point():
            differ = a != b
            if bool(differ.any()):
                first = int(differ.reshape(a.shape[0], -1).any(dim=1).nonzero()[0, 0])
                raise SmokeFailure(f"{label}: integer leaf {name} differs first at replica {first}")
            continue
        same_bits = a.view(torch.int32) == b.view(torch.int32)
        if bool(same_bits.all()):
            continue
        finite = torch.isfinite(b)
        require(bool((torch.isinf(a) == torch.isinf(b)).all()), f"{label}: {name} inf pattern differs")
        diff = torch.where(finite, (a - b).abs(), torch.zeros_like(a))
        first = int((~same_bits).reshape(a.shape[0], -1).any(dim=1).nonzero()[0, 0])
        rel = float((diff / b.abs().clamp_min(1e-30)).max())
        max_abs = max(max_abs, float(diff.max()))
        print(f"  {label}: float leaf {name} not bitwise equal (first at replica {first}, max rel {rel:.3e})")
        require(rel <= FLOAT_RTOL, f"{label}: {name} rel difference {rel} > {FLOAT_RTOL}")
    return max_abs


def check_blocks(name: str, model, compare_at: list[int]) -> float:
    """Advance one full-size ensemble with the kernel; at each block in
    ``compare_at`` also run the plain version on a copy and compare."""
    compiled, keys, params, state = fresh_run(model)
    macro = macro_block_len(model)
    max_abs = 0.0
    for block in range(max(compare_at) + 1):
        U = draw(compiled, keys, block, macro)
        if block in compare_at:
            plain_state = {k: v.clone() for k, v in state.items()}
            plain_halted = event_step.plain_block_step(compiled, plain_state, U, params)
            halted = event_step.block_step(compiled, state, U, params)
            torch.cuda.synchronize()
            err = compare_states(state, plain_state, f"{name} block {block}")
            require(bool((halted == plain_halted).all()), f"{name} block {block}: halted differs")
            live = int((~halted).sum())
            print(f"  {name} block {block}: kernel == plain on every leaf ({live} replicas live after)")
            max_abs = max(max_abs, err)
        else:
            event_step.block_step(compiled, state, U, params)
    torch.cuda.synchronize()
    return max_abs


def elapsed_ms(fn, n: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_blocks(model, label: str) -> dict:
    """Per-block times at full size, from the first blocks (every replica
    live), and the bound for the same blocks."""
    compiled, keys, params, state = fresh_run(model)
    macro = macro_block_len(model)
    blocks = [draw(compiled, keys, b, macro) for b in range(TIMED_BLOCKS + 2)]
    for b in range(2):  # warm-up
        event_step.block_step(compiled, state, blocks[b], params)
    plain_state = {k: v.clone() for k, v in state.items()}
    kernel_ms = elapsed_ms(
        lambda i: event_step.block_step(compiled, state, blocks[i + 2], params), TIMED_BLOCKS
    )
    event_step.plain_block_step(compiled, plain_state, blocks[2], params)  # warm-up
    plain_ms = elapsed_ms(
        lambda i: event_step.plain_block_step(compiled, plain_state, blocks[i + 3], params), 3
    )
    draw(compiled, keys, 0, macro)  # warm-up
    draw_ms = elapsed_ms(lambda i: draw(compiled, keys, i, macro), TIMED_BLOCKS)
    per_replica = support.replica_working_set_bytes(compiled, macro, state)
    bytes_per_block = REPLICAS * per_replica
    ops_per_block = REPLICAS * macro * (OPS_PER_STEP_BASE + OPS_PER_STEP_PER_SERVER * compiled.nV)
    bytes_ms = bytes_per_block / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops_per_block / PEAK_F32_OPS_PER_S * 1e3
    return {
        "model": label,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "draw_ms": draw_ms,
        "bytes_per_replica": per_replica,
        "bytes_per_block": bytes_per_block,
        "ops_per_block": ops_per_block,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    card = card_label()
    tag = f"[{card}]"
    print(f"device: {name}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    lib_path, log = event_step.build_library()
    build_s = time.perf_counter() - t0
    event_step.load_library()
    print(f"build: {lib_path.name} in {build_s:.1f} s (nvcc, sm_90a) {tag}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    mm1 = mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S)
    mm1.macro_block = 32
    chain = pipeline_model(rate=8.0, service_means=(0.05, 0.08, 0.06), horizon_s=HORIZON_S)
    print(f"block checks at {REPLICAS} replicas, macro_block 32:")
    max_abs = max(
        check_blocks("mm1", mm1, [0, 1, 2, 3, 78, 79, 80, 81]),
        check_blocks("chain", chain, [0, 40]),
    )

    timings = [time_blocks(mm1, "mm1"), time_blocks(chain, "chain")]
    for t in timings:
        print(
            f"timing {t['model']}: kernel {t['kernel_ms']:.4f} ms/block, plain "
            f"{t['plain_ms']:.3f} ms/block, threefry draw {t['draw_ms']:.4f} ms/block, "
            f"bound {t['bound_ms']:.4f} ms/block ({t['bound_by']}: "
            f"{t['bytes_per_block'] / 1e6:.1f} MB/block) {tag}"
        )

    # The main path, through the entry point a user calls.
    event_step.block_step.launches = 0
    result = run_ensemble(
        mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S), n_replicas=REPLICAS
    )
    launches = event_step.block_step.launches
    blocks_run = max(result.block_occupancy)
    rho = LAM / MU
    wait, sojourn = result.server_mean_wait_s[0], result.sink_mean_latency_s[0]
    wait_ref, sojourn_ref = rho / (MU - LAM), 1.0 / (MU - LAM)
    print(
        f"run_ensemble mm1 x{REPLICAS}: engine_path {result.engine_path}, shape "
        f"{result.kernel_shape}, {launches} kernel launches for {blocks_run} blocks, "
        f"{result.simulated_events} events in {result.wall_seconds:.3f} s = "
        f"{result.events_per_second:.4g} events/s {tag}"
    )
    print(
        f"  mean wait {wait:.6f} s (analytic {wait_ref}), mean sojourn {sojourn:.6f} s "
        f"(analytic {sojourn_ref}), truncated {result.truncated_replicas}"
    )
    require(result.engine_path == "scan+cuda", f"engine_path {result.engine_path}")
    require(result.kernel_shape == "mm1", f"kernel_shape {result.kernel_shape}")
    require(launches > 0 and launches == blocks_run, f"{launches} launches for {blocks_run} blocks")
    require(result.truncated_replicas == 0, f"{result.truncated_replicas} truncated replicas")
    require(abs(wait / wait_ref - 1.0) <= 0.01, f"mean wait {wait} not within 1% of {wait_ref}")
    require(
        abs(sojourn / sojourn_ref - 1.0) <= 0.01,
        f"mean sojourn {sojourn} not within 1% of {sojourn_ref}",
    )

    mm1_t = timings[0]
    kernels = {
        "kernels": [
            {
                "name": "event_step",
                "route": "cuda",
                "source": "happysim_tpu_torch/kernels/csrc/event_step.cu",
                "replaces": "happysim_tpu/tpu/kernels/event_step.py:312",
                "launches": launches,
                "max_abs_err": max_abs,
                "ms": mm1_t["kernel_ms"],
                "plain_ms": mm1_t["plain_ms"],
                "bound_ms": mm1_t["bound_ms"],
                "bound_by": mm1_t["bound_by"],
                "library_ms": None,
            }
        ]
    }
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(
            {
                "card": card,
                "device": name,
                "build_seconds": build_s,
                "timings": timings,
                "run_ensemble": {
                    **result.engine_report(),
                    "simulated_events": result.simulated_events,
                    "mean_wait_s": wait,
                    "mean_sojourn_s": sojourn,
                    "truncated_replicas": result.truncated_replicas,
                    "launches": launches,
                },
                **kernels,
            },
            indent=1,
        )
    )
    print(json.dumps(kernels))
    print(card)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
