"""Collective wire bytes and the three-term roofline.

Port of ``repro/launch/hlo_analysis.py``.  The reference scans the
compiled HLO for its collectives; PyTorch has no HLO, so the port records
the collectives a step issues as it runs (``record_collectives``: the
``torch.distributed`` calls of ``dist/sharding.py`` and the trainers,
under gloo, NCCL or the dry run's fake group alike), and
``collective_bytes`` applies the reference's rules to that record.  Each
call contributes its **wire bytes per participant** under ring
algorithms:

  all-reduce          2 x operand   (reduce-scatter + all-gather phases)
  all-gather          1 x result    (result = n x operand)
  reduce-scatter      1 x operand   (counting the result would understate
                                     the traffic n-fold)
  all-to-all          1 x operand
  collective-permute  1 x operand
  broadcast           1 x operand   (the trainers' replicas; no train step
                                     of the launcher issues one)

A record is one ``Collective`` per call: its kind (the reference's names),
the ``torch.distributed`` function, the operand and result bytes and
shapes, the group's size, and ``largest``, the bytes of the largest tensor
the call was handed (the figure ``chip_smoke.py`` reported before this
module existed, kept so that runs before and after compare).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: ``torch.distributed`` function -> (kind, operand arg, result arg): the
#: positions of the operand and result tensors among its arguments.
_FUNCTIONS = {
    "all_reduce": ("all-reduce", 0, 0),
    "all_gather_into_tensor": ("all-gather", 1, 0),
    "all_gather_single": ("all-gather", 1, 0),
    "reduce_scatter_tensor": ("reduce-scatter", 1, 0),
    "reduce_scatter_single": ("reduce-scatter", 1, 0),
    "all_to_all_single": ("all-to-all", 1, 0),
    "broadcast": ("broadcast", 0, 0),
}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective call as a step issued it."""

    kind: str                 # the reference's kind ("all-reduce", ...)
    op: str                   # the torch.distributed function
    operand_bytes: int
    result_bytes: int
    operand_shape: tuple
    result_shape: tuple
    dtype: str
    group_size: int
    largest: int              # bytes of the largest tensor of the call


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _arg(args: tuple, kw: dict, pos: int, names: tuple[str, ...]):
    if len(args) > pos:
        return args[pos]
    for n in names:
        if n in kw:
            return kw[n]
    return None


_ARG_NAMES = {0: ("tensor", "output", "output_tensor"),
              1: ("input", "input_tensor")}


@contextlib.contextmanager
def record_collectives() -> Iterator[list]:
    """Within the block, every call of a ``torch.distributed`` collective
    of ``_FUNCTIONS`` is appended, as a ``Collective``, to the list the
    block gets.  The functions are wrapped as module attributes, looked up
    at each call, so the recorder sees what ``dist/sharding.py`` and the
    trainers issue under any backend; calls that do not reach the
    module's attributes (a collective inside a captured CUDA graph's
    replay) are not seen."""
    record = []
    names = [n for n in _FUNCTIONS if hasattr(dist, n)]
    orig = {n: getattr(dist, n) for n in names}

    def wrap(name, fn):
        kind, ipos, opos = _FUNCTIONS[name]

        def recorded(*args, **kw):
            src = _arg(args, kw, ipos, _ARG_NAMES[ipos])
            out = _arg(args, kw, opos, _ARG_NAMES[opos])
            group = kw.get("group")
            tensors = [t for t in (*args, *kw.values())
                       if isinstance(t, torch.Tensor)]
            record.append(Collective(
                kind=kind, op=name, operand_bytes=_nbytes(src),
                result_bytes=_nbytes(out), operand_shape=tuple(src.shape),
                result_shape=tuple(out.shape), dtype=str(src.dtype),
                group_size=dist.get_world_size(group),
                largest=max(_nbytes(t) for t in tensors)))
            return fn(*args, **kw)
        return recorded
    for n in names:
        setattr(dist, n, wrap(n, orig[n]))
    try:
        yield record
    finally:
        for n in names:
            setattr(dist, n, orig[n])


def wire_bytes(c: Collective) -> int:
    """One call's wire bytes per participant (the module docstring's
    rules)."""
    if c.kind == "all-reduce":
        return 2 * c.operand_bytes
    if c.kind == "all-gather":
        return c.result_bytes
    return c.operand_bytes


def collective_bytes(record: list[Collective]) -> dict[str, int]:
    """Wire bytes per participating device, per collective kind, and the
    ``count`` of calls (the reference's keys; ``broadcast`` only where a
    call was one)."""
    out: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    for c in record:
        out[c.kind] = out.get(c.kind, 0) + wire_bytes(c)
        out["count"] += 1
    return out


def largest_bytes(record: list[Collective]) -> dict[str, int]:
    """The bytes of each call's largest tensor, summed by
    ``torch.distributed`` function (the figure of the runs before wire
    bytes were counted)."""
    out: dict[str, int] = {}
    for c in record:
        out[c.op] = out.get(c.op, 0) + c.largest
    return out


@dataclasses.dataclass
class Roofline:
    """Three-term roofline (seconds) for one step on one mesh.

    The denominators default to the H100's (``launch/mesh.py``): dense
    bf16 peak, HBM3 bandwidth and NVLink 4's aggregate a card, which
    already sums the card's links (the reference's ``ici_links`` factor,
    a TPU v5e figure, has no counterpart).  At (16, 16) the model axis
    spans two 8-card NVLink domains, whose links between hosts are slower
    than NVLink: the collective term is a lower bound there."""

    flops: float               # operations of the step (global)
    hbm_bytes: float           # analytic HBM bytes (global)
    coll_bytes: float          # collective wire bytes (per device)
    chips: int
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = NVLINK_BW          # the card's interconnect, all links

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time,
        }
