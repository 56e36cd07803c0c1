"""Data-parallel sharding over ``torch.distributed``: ``ParallelCtx``.

Port of the data axis of ``repro/dist/sharding.py``.  The reference's
context resolves logical axis names against a JAX mesh; the trainer's mesh
is always ``make_data_mesh``'s ``("data",)`` axis, so what the paper's main
path needs of it is the row layout of per-sample state and three helpers,
here over a ``torch.distributed`` process group:

- ``shard_rows``: this rank's contiguous rows of a global ``(N, ...)``
  tensor (``rows(n)`` gives the range: rank ``r`` of ``D`` owns ``[r N/D,
  (r + 1) N/D)``; ``check_rows`` refuses an N that does not divide, with
  the reference's message);
- ``gather_rows``: the rows of every rank back in rank order, the global
  tensor (an all-gather, O(N));
- ``replicate``: rank 0's values broadcast to every rank, in place.

``ParallelCtx()`` with no group is one process: every helper is the
identity, as the reference's ``ParallelCtx(mesh=None)``.

The collectives run with ``async_op=False`` on the calling stream's order:
under NCCL they are stream work, so a captured train step holds them.
gloo carries CPU tensors and, on the card, CUDA tensors too (its
all-gather, all-reduce and broadcast take them: the H100 run of
``chip_smoke.py`` uses them for two ranks on one card, which NCCL refuses),
but through host memory, waiting on the device: a gloo group cannot run
inside a CUDA graph (``Trainer._make_engine`` refuses that pairing).

Left for the pod-scale launcher (ROADMAP A.9): the ``"model"`` axis and the
logical-axis machinery (``spec``, ``cs``, ``tp``/``exp``/``seq_tp``,
``fsdp``, ``spec_tree_for``), which only ``launch/train.py`` and
``launch/dryrun.py`` reach in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

#: ``all_reduce`` ops by name.
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def _all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # ``all_gather_single`` is the newer name of ``all_gather_into_tensor``.
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """A ``("data",)`` axis over the ranks of ``group`` (None: one process,
    every helper the identity)."""

    group: Any = None

    @property
    def mesh(self):
        """The reference's name for what the context spans: the group."""
        return self.group

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def dp_size(self) -> int:
        return (dist.get_world_size(self.group) if self.group is not None
                else 1)

    @property
    def backend(self) -> str | None:
        return (str(dist.get_backend(self.group)) if self.group is not None
                else None)

    def check_rows(self, num_samples: int) -> None:
        """Refuse per-sample state that cannot row-shard (no-op off-mesh)."""
        if self.group is not None and num_samples % self.dp_size:
            raise ValueError(
                f"num_samples={num_samples} must be a multiple of the "
                f"data-parallel degree {self.dp_size} to row-shard "
                "SampleState")

    def rows(self, n: int) -> tuple[int, int]:
        """``[start, stop)`` of this rank's rows of an ``(n, ...)`` array."""
        self.check_rows(n)
        per = n // self.dp_size
        return self.rank * per, (self.rank + 1) * per

    def shard_rows(self, x):
        """This rank's rows of a global ``(N, ...)`` tensor or array (a
        view); ``x`` itself off-mesh."""
        if self.group is None:
            return x
        start, stop = self.rows(x.shape[0])
        return x[start:stop]

    # -- collectives ------------------------------------------------------

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(n, ...)`` rows, in rank order: the ``(D n, ...)``
        global tensor (``x`` itself off-mesh)."""
        if self.group is None:
            return x
        src = x.contiguous()
        out = torch.empty((self.dp_size * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _all_gather_into(out, src, self.group)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` over the ranks in place (``"sum"``, ``"min"`` or
        ``"max"``) and return it; ``x`` must be contiguous."""
        if self.group is not None:
            dist.all_reduce(x, op=_OPS[op], group=self.group)
        return x

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """Broadcast rank 0's ``x`` to every rank, in place."""
        if self.group is not None:
            dist.broadcast(x, src=dist.get_global_rank(self.group, 0),
                           group=self.group)
        return x

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)
