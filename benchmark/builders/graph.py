"""The builder of a queueing-network cell: the configuration's graph of
sources, servers, routers and sinks as the program's ``EnsembleModel``
(:func:`build`), and one call of the program on it (:func:`run`)."""

from __future__ import annotations


def build(spec: dict):
    """The program's ``EnsembleModel`` of a graph cell, through its public
    API: sources, servers, routers and sinks, wired in the order of the
    configuration's edges."""
    from happysim_tpu_torch import EnsembleModel

    model = EnsembleModel(
        horizon_s=float(spec["horizon_s"]), warmup_s=float(spec["warmup_s"]),
        transit_capacity=int(spec["transit_capacity"]), macro_block=int(spec["macro_block"]),
    )
    nodes = {"source": [], "server": [], "router": [], "sink": []}
    for s in spec["sources"]:
        nodes["source"].append(model.source(rate=float(s["rate"]), kind=s.get("kind", "poisson")))
    for v in spec["servers"]:
        nodes["server"].append(model.server(
            concurrency=int(v["concurrency"]), service_mean=float(v["service_mean"]),
            queue_capacity=int(v["queue_capacity"]), deadline_s=v.get("deadline_s"),
            max_retries=int(v.get("max_retries", 0)),
        ))
    for r in spec["routers"]:
        nodes["router"].append(model.router(policy=r["policy"]))
    for _ in range(int(spec["sinks"])):
        nodes["sink"].append(model.sink())

    def node(text):
        kind, index = text.split(":")
        return nodes[kind][int(index)]

    for e in spec["edges"]:
        model.connect(
            node(e["from"]), node(e["to"]), latency_s=float(e.get("latency_s", 0.0)),
            latency_kind=e.get("latency_kind", "constant"), loss_p=float(e.get("loss_p", 0.0)),
        )
    return model


def run(model, spec: dict, seed: int, device=None):
    """One whole ensemble of the cell: ``run_ensemble`` over the cell's
    replicas, per-replica sweeps and event budget (which keeps it on the
    event scan), on ``device`` (None: the CUDA card)."""
    from happysim_tpu_torch import run_ensemble

    return run_ensemble(
        model, n_replicas=int(spec["replicas"]), seed=seed, max_events=spec["max_events"],
        sweeps=dict(spec["sweeps"]) or None, device=device,
    )
