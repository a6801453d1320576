#!/usr/bin/env python3
"""The trace library's lean code on one card: what its time goes to.

    python3 tools/trace_stalls.py      # on a machine with one NVIDIA GPU

Builds the libraries and prints the registers and spills ptxas reported
for the trace and consensus libraries' instantiations; then, for
chip_smoke's flash crowd and diurnal trace at 65,536 replicas:
- the kernel's time a block in a 20-block launch (pages of 2,048, so no
  lane stalls), with its telemetry spec (2 s windows of throughput,
  latency and rates) and without it, each twice on its own copy of the
  state; both in a 40-block launch (the difference gives a launch's
  fixed cost); without it, the tile's column padded by 81 words (the
  shared memory the window cache's pairs take from the L1 cache);
- the run's stream steps at pages of 64 (the engine's window moves:
  the least reading cursor's page), each launch timed with CUDA events,
  and from each lane's blocks before and after it, the share of the
  launch's lane-blocks that sit idle: a warp runs as long as its busiest
  lane, so a launch's lane-block slots are 32 x its warps' most blocks,
  and the idle share is 1 - (the blocks the lanes ran) / (those slots),
  split into lanes that left at the stall gate and lanes that halted or
  spent their budget.
Prints one line each and writes chiprun_out/trace_stalls.json.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from happysim_tpu_torch.kernels import build, event_step  # noqa: E402


def model_of(kind: str, chunk_len: int, telemetry: bool):
    """chip_smoke.trace_model's model, with or without its telemetry spec."""
    model = c.EnsembleModel(horizon_s=c.TRACE_HORIZON_S, macro_block=16)
    srv = model.server(concurrency=4, service_mean=0.004, queue_capacity=64)
    model.connect(model.trace_arrivals(c.bench_trace(kind, chunk_len)), srv)
    model.connect(srv, model.sink())
    if telemetry:
        model.telemetry(window_s=c.TRACE_WINDOW_S, metrics=("throughput", "latency", "rates"))
    return model


def block_ms(kind: str, telemetry: bool, blocks: int = c.TIMED_BLOCKS, pad: int = 0) -> float:
    """The time a block of a launch of ``blocks`` blocks after the first
    two, its tile's column ``pad`` words longer than the plan's (words no
    site touches: shared memory taken from the L1 cache, as a plan's
    longer column takes it)."""
    compiled, keys, params, state = c.fresh_run(model_of(kind, c.TRACE_LONG_CHUNK, telemetry))
    pages = c.trace_pages(compiled, 0)
    halted = torch.empty((c.REPLICAS,), dtype=torch.uint8, device="cuda")
    event_step.trace_steps(compiled, state, keys, params, pages, 0, 2)
    states = [{k: v.clone() for k, v in state.items()} for _ in range(2)]
    args = [event_step.trace_launch_args(compiled, st, keys, params, pages, 0, 2 + blocks, halted)
            for st in states]
    for a in args:
        a.stage.words += pad
    return c.launch_ms(args) / (2 * blocks)


def stream_idle(kind: str) -> dict:
    """The run's stream steps at pages of 64: each launch's device time
    and its lanes' idle share (see the module docstring)."""
    compiled, keys, params, state = c.fresh_run(model_of(kind, c.TRACE_CHUNK_LEN, True))
    P, macro, ti = compiled.trace_chunk_len, compiled.macro, compiled.trace_src
    n_chunks = -(-c.TRACE_MAX_EVENTS // macro)
    halted = torch.empty((c.REPLICAS,), dtype=torch.uint8, device="cuda")
    base_page, steps = 0, []
    while True:
        pages = c.trace_pages(compiled, base_page)
        before = state["trc_blocks"].clone()
        args = event_step.trace_launch_args(compiled, state, keys, params, pages, base_page * P,
                                            n_chunks, halted)
        ms = c.launch_ms([args])
        ran = (state["trc_blocks"] - before).to(torch.int64)
        cursor = state["trc_cursor"].to(torch.int64)
        live = ~halted.bool()
        reads = torch.isfinite(state["src_next"][:, ti]) & (state["trc_blocks"] < n_chunks) & live
        stalled = reads & (cursor + macro >= base_page * P + 2 * P)
        warp_max = ran.view(-1, 32).max(dim=1).values
        slots = 32 * int(warp_max.sum())
        idle = (warp_max.repeat_interleave(32) - ran)
        steps.append({
            "ms": ms, "lane_blocks": int(ran.sum()), "slots": slots,
            "idle_stalled": int(idle[stalled].sum()), "idle_other": int(idle[~stalled].sum()),
            "most_blocks": int(warp_max.max()), "least_warp_most": int(warp_max.min()),
        })
        if not bool(reads.any()):
            break
        base_page = max(int(cursor[reads].min()) // P, base_page + 1)
    slots = sum(s["slots"] for s in steps)
    return {
        "launches": len(steps), "kernel_ms": sum(s["ms"] for s in steps),
        "lane_blocks": sum(s["lane_blocks"] for s in steps), "slots": slots,
        "idle_share": 1 - sum(s["lane_blocks"] for s in steps) / slots,
        "idle_stalled_share": sum(s["idle_stalled"] for s in steps) / slots,
        "idle_other_share": sum(s["idle_other"] for s in steps) / slots,
        "steps": steps,
    }


def main() -> int:
    card = c.card_label()
    tag = f"[{card}]"
    out = {"card": card, "ptxas": {}}
    for stem, (_path, log) in build.build_libraries().items():
        if stem not in ("event_step_trace", "event_step_consensus"):
            continue
        for kernel, info in c.ptxas_summary(log).items():
            out["ptxas"][f"{stem} {kernel}"] = info
            print(f"ptxas {stem} {kernel}: {info['registers']} registers, {info['spill_stores']} B "
                  f"spill stores, {info['spill_loads']} B spill loads")
    event_step.load_library()
    for kind in ("flash", "diurnal"):
        on, off = block_ms(kind, True), block_ms(kind, False)
        idle = stream_idle(kind)
        out[kind] = {"block_ms_telemetry": on, "block_ms_no_telemetry": off, **idle}
        print(f"trace-{kind}: kernel {on:.4f} ms a block with its telemetry spec, {off:.4f} without "
              f"({on / off:.3f}x) {tag}")
        # A launch's fixed cost (its time a block at 40 blocks against 20),
        # and the L1 cache that the tile's longer column takes (the model
        # without telemetry, its column padded by the pairs' 81 words).
        long_on, long_off = block_ms(kind, True, 2 * c.TIMED_BLOCKS), block_ms(kind, False, 2 * c.TIMED_BLOCKS)
        padded = block_ms(kind, False, pad=81)
        fixed_on, fixed_off = 2 * c.TIMED_BLOCKS * (on - long_on), 2 * c.TIMED_BLOCKS * (off - long_off)
        out[kind].update(block_ms_telemetry_40=long_on, block_ms_no_telemetry_40=long_off,
                         launch_fixed_ms=fixed_on, launch_fixed_ms_no_telemetry=fixed_off,
                         block_ms_no_telemetry_padded=padded)
        print(f"trace-{kind}: in a {2 * c.TIMED_BLOCKS}-block launch {long_on:.4f} ms a block with "
              f"telemetry, {long_off:.4f} without (a launch's fixed cost {fixed_on:.4f} and "
              f"{fixed_off:.4f} ms); without, its column padded by 81 words, {padded:.4f} "
              f"({padded / off:.3f}x unpadded) {tag}")
        print(f"trace-{kind} run at pages of {c.TRACE_CHUNK_LEN}: {idle['launches']} launches, "
              f"{idle['kernel_ms']:.3f} ms; lane-blocks idle while their warp runs: "
              f"{100 * idle['idle_share']:.2f}% ({100 * idle['idle_stalled_share']:.2f}% at the stall "
              f"gate, {100 * idle['idle_other_share']:.2f}% halted or spent) {tag}")
    dest = Path("chiprun_out")
    dest.mkdir(exist_ok=True)
    (dest / "trace_stalls.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
