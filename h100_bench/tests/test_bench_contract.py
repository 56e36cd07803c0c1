"""BENCHMARK.json and the files it names: everything a cell, a traffic mix
and a per-layer metric needs is found by name, and the names, units and
bounds keep to the benchmark's contract."""
import importlib
import json
import re

import pytest

from h100_bench import cells, readers
from h100_bench.tests.tiny import workloads

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["h100_bench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", workloads())
def test_cell_loads_by_name(workload):
    cell = cells.load(workload)
    assert cell.chips == 1
    assert cell.shape["num_samples"] % cell.shape["batch"] == 0
    checks = cell.traffic["checks"]
    # Each check compares one number of each of its kinds, the worst or
    # the median (``check.numbers``).
    kinds = {"train": ("loss_gap", "change_gap"), "obs": ("obs_gap",),
             "plan": ("plan_mismatch",)}
    want = [k for c in checks for k in kinds[c]]
    assert sorted(n.removesuffix("_median") for n in cell.limits) == sorted(want)


@pytest.mark.parametrize("workload", workloads())
def test_every_metric_of_a_cell_has_a_reader(workload):
    reported = cells.per_layer_metrics(workload)
    assert reported, "every cell reports a per-layer metric"
    for m in reported:
        mod = importlib.import_module(f"h100_bench.metrics.{m['name']}")
        assert callable(mod.read)
    e2e = {m["name"] for m in cells.end_to_end_metrics(workload)}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("kernel", ["b1", "b6", "b7"])
def test_kernel_maps_load(kernel):
    kmap = readers.kernel_map(kernel)
    assert kmap["parts"] and all(p["kernels"] for p in kmap["parts"])


def test_names_units_bounds():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for c in BENCH["configs"]:
        cfg = cells.read_json(cells.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
