"""Cells of the benchmark, found by name: ``BENCHMARK.json``'s workload
``<config>.<traffic>`` is the configuration file
``benchmark/configs/<config>.json`` under the traffic file
``benchmark/traffic/<traffic>.json``.

A configuration holds the deployment: the ensemble's size, horizon and
warmup, the graph (sources, servers, routers, sinks and the edges between
them, in the order they are wired) and the events a job may take. A
traffic file holds what arrives: each source's rate and kind, the
per-replica sweeps, and the losses on edges. :func:`resolve` merges the
two into one plain dict, which both the program and the plain reference
read, each found by the name the configuration gives it: the builder
(``benchmark/builders/<builder>.py``: ``build(spec)`` makes the model,
``run(model, spec, seed, device)`` makes one call of the program) and
the reference (``benchmark/reference/<reference>.py``: ``simulate(spec,
seed, device, dtype)`` gives an ensemble's totals, ``FIELDS`` names the
totals compared). A new entry point or a new compared field is a new
builder or reference file.
"""

from __future__ import annotations

import copy
import hashlib
import importlib
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED_BITS = 62


def load_benchmark(root: Path = ROOT.parent) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(name: str, root: Path = ROOT.parent) -> dict:
    """The ``workloads`` entry called ``name``."""
    for cell in load_benchmark(root)["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _sweep(rule: dict, n: int) -> np.ndarray:
    """A per-replica array from its rule: ``{"linspace": [lo, hi]}``."""
    (kind, args), = rule.items()
    if kind == "linspace":
        return np.linspace(float(args[0]), float(args[1]), n).astype(np.float32)
    raise ValueError(f"unknown sweep rule {kind!r}")


def resolve(config: str, traffic: str, bench_dir: Path = ROOT) -> dict:
    """The cell as one dict: the configuration with the traffic's sources,
    sweeps and edge losses applied, and ``max_events``, the per-replica
    event budget (:func:`_budget`)."""
    spec = copy.deepcopy(json.loads((bench_dir / "configs" / f"{config}.json").read_text()))
    mix = json.loads((bench_dir / "traffic" / f"{traffic}.json").read_text())
    if len(mix["sources"]) != len(spec["sources"]):
        raise ValueError(f"traffic {traffic!r} gives {len(mix['sources'])} sources for {config!r}")
    for source, arrivals in zip(spec["sources"], mix["sources"]):
        source.update(arrivals)
    for loss in mix.get("edge_loss", []):
        spec["edges"][int(loss["edge"])]["loss_p"] = float(loss["loss_p"])
    spec["sweeps"] = {
        key: _sweep(rule, int(spec["replicas"])) for key, rule in mix.get("sweeps", {}).items()
    }
    spec["max_events"] = _budget(spec)
    spec["config"], spec["traffic"] = config, traffic
    return spec


def _budget(spec: dict) -> int:
    """The per-replica event budget: ``events_per_job`` times the sum of
    the sources' peak rates times the horizon, plus 64."""
    peaks = [float(s["rate"]) for s in spec["sources"]]
    if "source_rate" in spec["sweeps"]:
        peaks = [float(spec["sweeps"]["source_rate"].max())] * len(peaks)
    return int(float(spec["events_per_job"]) * sum(peaks) * float(spec["horizon_s"])) + 64


def scaled(spec: dict, replicas: int, horizon_s: float, warmup_s: float) -> dict:
    """The same cell at another size (the CPU tests' small runs): the
    sweeps resampled over the new replicas, the budget over the new
    horizon."""
    out = copy.deepcopy(spec)
    out["replicas"], out["horizon_s"], out["warmup_s"] = replicas, horizon_s, warmup_s
    for key, values in spec["sweeps"].items():
        out["sweeps"][key] = np.linspace(values[0], values[-1], replicas).astype(np.float32)
    out["max_events"] = _budget(out)
    return out


def builder(spec: dict):
    """The builder the configuration names (``benchmark/builders/<builder>.py``)."""
    return importlib.import_module(f"benchmark.builders.{spec['builder']}")


def reference(spec: dict):
    """The plain reference the configuration names
    (``benchmark/reference/<reference>.py``)."""
    return importlib.import_module(f"benchmark.reference.{spec['reference']}")


def call_seed(seed: int, index: int) -> int:
    """The ensemble seed of the run's call ``index``: a hash of the run's
    seed and the index, below 2**62."""
    digest = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> (64 - SEED_BITS)
