"""What a per-layer metric reader (``metrics/<name>.py``, a function
``read(ctx) -> float | None``) is given, and the arithmetic several of
them share.  ``None``: nothing to read, and the metric is left out.

``ctx`` fields: ``cell`` (``cells.Cell``), ``spans`` ({layer: [seconds a
call]} over the window's epochs: ``epoch``, ``plan``, ``engine``,
``refresh``), ``results`` ({layer: [what each call returned]}),
``epochs`` (the window's ``EpochStats``), ``activities`` (the traced
epoch's device activities, ``trace.Activity``), ``window_s`` and
``busy_s`` of the traced epoch.
"""
from __future__ import annotations

import dataclasses
import json
import re

from h100_bench import counts
from h100_bench.cells import HERE


@dataclasses.dataclass
class Context:
    cell: object
    spans: dict
    results: dict
    epochs: list
    activities: list
    window_s: float
    busy_s: float


def mean_ms(values) -> float | None:
    return 1e3 * sum(values) / len(values) if values else None


def steps(ctx: Context) -> list[int]:
    """Train steps each window epoch dispatched (the engine's rows)."""
    b = ctx.cell.shape["batch"]
    return [r.fwd_samples // b for r in ctx.results.get("engine", [])]


def kernel_map(name: str) -> dict:
    with open(HERE / "kernels" / f"{name}.json") as f:
        return json.load(f)


def _matches(kernel: str, activity: str) -> bool:
    return re.search(rf"(^|[\s:]){re.escape(kernel)}[<(]", activity) is not None


def work(ctx: Context, kind: str) -> tuple[float, float]:
    """(bytes, operations) of one call of a kernel part at the cell's
    shapes (``kernels/<name>.json``'s ``work``)."""
    arch, shape = ctx.cell.arch, ctx.cell.shape
    t = shape["batch"] * shape["seq_len"]
    if kind == "b1_forward":
        return counts.b1_forward(t, arch["vocab_size"])
    if kind == "b1_backward":
        return counts.b1_backward(t, arch["vocab_size"])
    if kind == "b6":
        s = arch["ssm"]
        di = s["expand"] * arch["d_model"]
        return counts.b6(shape["batch"], shape["seq_len"], di // s["head_dim"],
                         s["head_dim"], s["state_dim"], s["chunk"])
    if kind == "b7":
        return counts.b7(shape["batch"], shape["seq_len"], arch["num_heads"],
                         arch["num_kv_heads"], arch["head_dim"])
    raise KeyError(f"no work function {kind!r}")


def roofline(ctx: Context, name: str) -> float | None:
    """Share (%) of the roofline of kernel ``name`` over the traced epoch:
    the least time its calls need (``counts.bound_s``) over the device
    time of its kernels.  A part's calls are its activities, or those of
    its ``calls`` kernel where a call launches several.  None where none
    of them ran."""
    least, spent = 0.0, 0.0
    for part in kernel_map(name)["parts"]:
        acts = [a for a in ctx.activities
                if any(_matches(k, a.name) for k in part["kernels"])]
        if not acts:
            continue
        calls = (sum(_matches(part["calls"], a.name) for a in acts)
                 if "calls" in part else len(acts))
        least += calls * counts.bound_s(*work(ctx, part["work"]))
        spent += sum(a.us for a in acts) / 1e6
    return 100.0 * least / spent if spent > 0 else None
