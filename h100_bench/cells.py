"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``limits/<cell>.json`` under this folder."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict      # configs/<config>.json
    traffic: dict     # traffic/<traffic>.json
    limits: dict      # limits/<cell>.json: {number: limit}

    @property
    def arch(self) -> dict:
        return self.config["arch"]

    @property
    def shape(self) -> dict:
        return self.config["train_shape"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load(workload: str) -> Cell:
    """The cell named ``workload`` in ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in benchmark()["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    return Cell(workload, w["chips"], read_json(HERE / "configs" / f"{w['config']}.json"),
                read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                read_json(HERE / "limits" / f"{workload}.json"))


def per_layer_metrics(workload: str) -> list[dict]:
    """The per-layer metrics ``workload`` reports: those that list it, and
    those that list no cells (every cell that reports the metric they
    move)."""
    bench = benchmark()
    e2e = {m["name"]: m.get("workloads") for m in bench["end_to_end"]}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if cells is None:
            moved = e2e.get(m["moves"])
            cells = [workload] if moved is None or workload in moved else []
        if workload in cells:
            out.append(m)
    return out


def end_to_end_metrics(workload: str) -> list[dict]:
    return [m for m in benchmark()["end_to_end"]
            if workload in m.get("workloads", [workload])]
