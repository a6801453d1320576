"""BENCHMARK.json against the benchmark's rules: names, units and lengths;
every cell's files found by name; the import guard's whole-name test;
the roofline's counts free of the program's state layout; and a cell,
a traffic mix and a metric added by adding files alone."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import cells, roofline, run
from benchmark.conftest import ROOT, small

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_the_file_has_the_keys_and_limits():
    assert set(BENCH) == {
        "command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer",
    }
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check: 2 + 14 runs a cell for 24 cells within 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert BENCH["paths"] == ["benchmark"]
    assert all("/" not in w or w.startswith("benchmark/") for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_every_name_is_unique_and_every_metric_has_its_place():
    names = [e["name"] for e in METRICS]
    assert len(names) == len(set(names))
    assert {"setup_s", "events_per_s", "call_ms_p90"} <= {e["name"] for e in BENCH["end_to_end"]}
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    moves = {e["name"] for e in BENCH["end_to_end"]}
    for e in BENCH["per_layer"]:
        assert e["moves"] in moves and "bound" not in e
        if e["unit"] == "%" and "roofline" in e["name"]:
            assert e["name"].endswith("_roofline")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_s_files_are_found_by_name(cell):
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    config = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert config["file"] == f"benchmark/configs/{cell['config']}.json"
    assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
    spec = cells.resolve(cell["config"], cell["traffic"])
    assert (ROOT / "benchmark" / "builders" / f"{spec['builder']}.py").is_file()
    assert (ROOT / "benchmark" / "reference" / f"{spec['reference']}.py").is_file()
    assert callable(cells.builder(spec).build) and callable(cells.builder(spec).run)
    assert callable(cells.reference(spec).simulate)
    assert set(cells.reference(spec).FIELDS) == {"exact", "float"}
    for metric in METRICS:
        if "workloads" not in metric or cell["name"] in metric["workloads"]:
            assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()


def test_the_import_guard_compares_whole_top_level_names():
    assert run.forbidden_modules(["jax.numpy"]) == ["jax.numpy"]
    assert run.forbidden_modules(["jaxlib", "flax.linen", "happysim_tpu.tpu.engine"]) == [
        "flax.linen", "happysim_tpu.tpu.engine", "jaxlib",
    ]
    assert run.forbidden_modules(["happysim_tpu_torch.engine", "jaxtyping", "numpy"]) == []


def test_the_reference_imports_nothing_of_the_program():
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        import benchmark.reference.queueing, benchmark.compare, benchmark.roofline
        print(sorted({m.split('.')[0] for m in sys.modules}
                     & {'happysim_tpu_torch', 'happysim_tpu', 'jax', 'jaxlib', 'flax'}))
    """)
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_roofline_counts_ignore_the_program_s_layout():
    """The counts read the graph and the totals alone: the program's totals
    with its server rows in declared order, with those rows reversed (the
    router's targets kept in the same order, so the same simulation), and
    the reference's totals, from a state laid out its own way, give the
    same bytes and operations."""
    from benchmark import compare
    from benchmark.builders import graph
    from benchmark.reference import queueing

    spec = small("fanout-lb", "poisson32", replicas=16, horizon_s=4.0, warmup_s=1.0)
    flipped = dict(spec, edges=[
        {**e, **{end: f"server:{3 - int(e[end][7:])}" for end in ("from", "to")
                 if e[end].startswith("server:")}}
        for e in spec["edges"]
    ])
    totals = []
    for layout in (spec, flipped):
        result = graph.run(graph.build(layout), layout, 3, "cpu")
        totals.append(compare.program_totals(result, queueing.FIELDS))
    assert totals[1]["server_completed"] == totals[0]["server_completed"][::-1]
    totals.append(queueing.simulate(spec, 3, "cpu"))
    counts = {
        (roofline.call_bytes(layout), roofline.call_int_ops(layout, t))
        for layout, t in zip((spec, flipped, spec), totals)
    }
    assert len(counts) == 1
    # Every needed uniform: a gap, a service, and an edge's latency for the
    # jobs to the odd servers.
    done = totals[0]["server_completed"]
    uniforms = 2 * sum(done) + done[1] + done[3]
    assert counts.pop()[1] == (
        uniforms * roofline.OPS_PER_UNIFORM + totals[0]["blocks_total"] * roofline.OPS_PER_THREEFRY
    )


def test_a_cell_a_mix_and_a_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric, a builder (its own call of the program) and a
    reference (its own compared fields) as new files and new entries in
    BENCHMARK.json; the copy's harness runs the new cell on the CPU
    through the new builder, compares the new reference's fields and
    reports the new metric, with no file of the copy edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    config = json.loads((ROOT / "benchmark" / "configs" / "fanout-lb.json").read_text())
    config.update(name="fanout-three", servers=config["servers"][:3], builder="graph_counted",
                  reference="queueing_sinks")
    config["edges"] = [e for e in config["edges"] if "3" not in e["from"] + e["to"]]
    (tmp_path / "benchmark" / "configs" / "fanout-three.json").write_text(json.dumps(config))
    (tmp_path / "benchmark" / "traffic" / "poisson20.json").write_text(
        json.dumps({"sources": [{"rate": 20.0, "kind": "poisson"}]}))
    (tmp_path / "benchmark" / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx.calls)\n")
    (tmp_path / "benchmark" / "builders" / "graph_counted.py").write_text(textwrap.dedent("""
        from benchmark.builders import graph
        SEEDS = []
        build = graph.build
        def run(model, spec, seed, device=None):
            SEEDS.append(seed)
            return graph.run(model, spec, seed, device)
    """))
    (tmp_path / "benchmark" / "reference" / "queueing_sinks.py").write_text(textwrap.dedent("""
        from benchmark.reference import queueing
        FIELDS = {"exact": ("sink_count", "sink_hist"), "float": ("sink_mean_latency_s",)}
        simulate = queueing.simulate
    """))
    bench["configs"] = BENCH["configs"] + [dict(BENCH["configs"][0], name="fanout-three",
                                                file="benchmark/configs/fanout-three.json")]
    bench["workloads"] = BENCH["workloads"] + [dict(BENCH["workloads"][0], name="fanout-three.poisson20",
                                                    config="fanout-three", traffic="poisson20")]
    bench["end_to_end"] = BENCH["end_to_end"] + [
        {"name": "calls_in_window", "unit": "calls", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["fanout-three.poisson20"]},
    ]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent("""
        import sys
        sys.path[:0] = [sys.argv[1], sys.argv[2]]
        from pathlib import Path
        from benchmark import cells, run
        assert Path(run.__file__).resolve().is_relative_to(Path(sys.argv[1]).resolve())
        root = Path(sys.argv[1])
        bench = cells.load_benchmark(root)
        cell = cells.workload("fanout-three.poisson20", root)
        spec = cells.scaled(cells.resolve(cell["config"], cell["traffic"], root / "benchmark"),
                            replicas=8, horizon_s=4.0, warmup_s=1.0)
        out = run.run_cell(spec, 5, 0.0, False, device="cpu", note=lambda text: None)
        metrics = run.result_line(bench, cell, spec, out, False)
        from benchmark.builders import graph_counted
        print(out["correct"], sorted(metrics), len(spec["servers"]),
              len(graph_counted.SEEDS) == len(out["calls"]) + 1, sorted(out["calls"][0]["totals"]))
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-2] == (
        "True ['call_ms_p90', 'calls_in_window', 'events_per_s', 'setup_s'] 3 True "
        "['sink_count', 'sink_hist', 'sink_mean_latency_s']"
    )
