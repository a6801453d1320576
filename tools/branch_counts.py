#!/usr/bin/env python3
"""Per-branch event counts of chip_smoke.py's multi-tenant and wide runs:
which branch of the event step each event takes, counted from the plain
torch-op step on the CPU (a count of what the program does, not a time).

    python3 tools/branch_counts.py [--replicas 256] [model ...]

Each model (chip_smoke's two-class, two-class-telemetry, two-class-chaos,
superpose and wide-fleet by default) runs from its initial state, block
after block on the torch-op draw, until every replica halts. Before each
step the lanes' next-event candidates (sources, then the servers'
completions, then their transit arrivals, as the kernel's argmin orders
them) say which branch each live lane takes: a fire of source s, a
completion, or a transit arrival. Also counted at each event: the
servers whose queue holds a job (the depth integral's terms that change
a bit), and whether the event reaches a chaos site: a fire of a source
whose edge is lossy, or a completion or transit arrival at a server with
a chaos feature (a deadline, retries, a hedge, a brownout, a fault
schedule) or a lossy edge out of it. The deliveries into each sink
inside [warmup, horizon] (the ones the step books) are the run's sink
counts. Prints one JSON line a model: the counts a lane, the share of
the events each branch takes and of those reaching a chaos site, and
the mean nonempty queues an event.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from happysim_tpu_torch import rng  # noqa: E402
from happysim_tpu_torch.engine import _Compiled, _resolve_params  # noqa: E402
from happysim_tpu_torch.kernels import event_step  # noqa: E402

MODELS = {
    "two-class": lambda: c.two_class_model(),
    "two-class-telemetry": lambda: c.two_class_model(c.TWO_CLASS_WINDOW_S),
    "two-class-chaos": lambda: c.two_class_model(chaos=True),
    "superpose": lambda: c.superpose_model(),
    "wide-fleet": lambda: c.wide_fleet_model(),
}


def counts(model, replicas: int) -> dict:
    compiled = _Compiled(model)
    nS, nV = compiled.nS, compiled.nV
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, replicas, None).items()}
    keys = rng.split(rng.PRNGKey(0), replicas)
    state = compiled.init_state(keys, params)
    step = compiled.make_step()
    horizon = torch.tensor(compiled.horizon, dtype=torch.float32)
    fires = torch.zeros(nS, dtype=torch.int64)
    completions = transits = events = nonempty = chaotic = 0
    # The candidates (sources, completions, transit arrivals) whose event
    # reaches a chaos site.
    lossy_src = [s.latency.loss_p > 0.0 for s in model.sources]
    chaos_srv = [
        s.deadline_s is not None or s.max_retries > 0 or s.hedge_delay_s is not None
        or s.outage_start_s is not None or s.fault is not None or s.latency.loss_p > 0.0
        for s in model.servers
    ]
    chaos_site = torch.tensor(lossy_src + chaos_srv + chaos_srv)
    block = 0
    while not bool(compiled.replica_halted(state).all()):
        U = event_step.block_uniforms(compiled, keys, block)
        for k in range(compiled.macro):
            cands = compiled.next_candidates(state)
            tn, arg = torch.min(cands, dim=1)  # the first index on a tie
            live = torch.isfinite(tn) & (tn <= horizon)
            events += int(live.sum())
            fires += torch.bincount(arg[live & (arg < nS)], minlength=nS)[:nS]
            completions += int((live & (arg >= nS) & (arg < nS + nV)).sum())
            transits += int((live & (arg >= nS + nV)).sum())
            nonempty += int(((state["srv_q_len"] > 0).sum(dim=1) * live).sum())
            chaotic += int((live & chaos_site[arg.clamp(max=chaos_site.numel() - 1)]).sum())
            step(state, params, U[:, k, :])
        block += 1
    sinks = state["sink_count"].to(torch.int64).sum(dim=0)
    per_lane = {
        "events": events / replicas,
        "fires": (fires / replicas).tolist(),
        "completions": completions / replicas,
        "transit_arrivals": transits / replicas,
        "measured_sink_deliveries": (sinks / replicas).tolist(),
    }
    share = {
        "fires": (fires / events).tolist(),
        "completions": completions / events,
        "transit_arrivals": transits / events,
        "measured_sink_deliveries": (sinks / events).tolist(),
        "chaos_sites": chaotic / events,
    }
    return {
        "replicas": replicas, "blocks": block, "servers": nV, "per_lane": per_lane,
        "share_of_events": share, "nonempty_queues_per_event": nonempty / events,
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--replicas", type=int, default=256)
    parser.add_argument("models", nargs="*", default=list(MODELS))
    args = parser.parse_args()
    for name in args.models:
        print(json.dumps({"model": name, **counts(MODELS[name](), args.replicas)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
