"""Sharding over ``torch.distributed``: ``ParallelCtx``.

Port of ``repro/dist/sharding.py``.  Model code names the dims of its
parameters and activations with *logical* axes (``"batch"``, ``"fsdp"``,
``"tp"``, ``"exp"``, ``"seq_tp"``); the context resolves them against the
mesh the launcher built (``launch/mesh.py::make_data_model_mesh``, a
``torch.distributed.device_mesh.DeviceMesh`` with named dims):

  - ``"batch"``   -> the data axes (``("data",)`` or ``("pod", "data")``)
  - ``"fsdp"``    -> the data axes, but only when ``ctx.fsdp`` (ZeRO-3
                     parameter sharding)
  - ``"tp"``      -> the ``"model"`` axis (tensor parallelism)
  - ``"exp"``     -> the ``"model"`` axis (expert parallelism)
  - ``"seq_tp"``  -> the ``"model"`` axis, only under sequence-parallel KV
  - ``None``      -> replicated

``dp_only`` folds ``"model"`` into the data axes.  A dim is sharded only
when its size divides over the mapped axes (``spec(..., dims=)``): GQA KV
heads that do not divide the model axis stay replicated.  A spec is a
plain tuple, one entry a dim: ``None``, an axis name or a tuple of names,
the reference's ``PartitionSpec`` entry for entry (``()`` with no mesh).

Where the reference's GSPMD partitions a global program, the port runs
each rank on its local shards (``local_shard``) and issues the collectives
itself, through the autograd functions below (each the identity where its
group has one rank, so a (1, 1) mesh computes what no mesh computes):

- ``tp_copy`` (identity forward, all-reduce of the gradient over
  ``"model"``): where a replicated tensor enters model-parallel compute;
- ``tp_reduce`` (all-reduce forward, identity backward): where
  model-parallel partial sums leave it;
- ``tp_gather`` (all-gather forward, the local slice of the gradient
  backward): a sharded tensor used whole in a region replicated over
  ``"model"`` (the logits before B1, the SSM's fused weights);
- ``fsdp_gather`` (all-gather forward over the data axes, the summed
  gradient scattered back backward): ZeRO-3's gather of a layer's shards
  at use, its gradient reduce-scattered;
- ``dp_sum`` (all-reduce forward over the data axes, identity backward):
  the global loss from each data rank's share;
- ``dp_sum_partials`` (all-reduce forward and backward over the data
  axes): partial sums of one value every data rank uses whole (the MoE's
  expert outputs from the resident d_ff shards, ``"partial"`` layout);
- ``tp_max`` (a MAX all-reduce over ``"model"``, no gradient): the
  sequence-parallel decode's running maximum.

Under NCCL the scatter is ``reduce_scatter_tensor``; under gloo, whose
reduce-scatter torch does not offer for CUDA tensors in every version,
an all-reduce and a slice.

Beyond logical specs the context keeps the row helpers of the
data-parallel trainer over the data group (``group``): ``shard_rows``,
``gather_rows``, ``all_reduce``, ``replicate``.  ``ParallelCtx(group=g)``
is the trainer's 1-D ``("data",)`` axis (no ``mesh``); ``ParallelCtx()``
is one process, every helper the identity, as the reference's
``ParallelCtx(mesh=None)``.

The collectives run with ``async_op=False`` on the calling stream's order:
under NCCL they are stream work, so a captured train step holds them.
gloo carries CPU tensors and, on the card, CUDA tensors too (through host
memory, waiting on the device: ``chip_smoke.py`` runs several gloo ranks
on one card, which NCCL refuses), and cannot run inside a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

#: ``all_reduce`` ops by name.
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}
_MODEL_AXIS = "model"
_DATA_AXES = ("pod", "data")


def _all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # ``all_gather_single`` is the newer name of ``all_gather_into_tensor``.
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim``, in rank
    order."""
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((size * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _all_gather_into(out, src, group)
    return out.movedim(0, dim)


def _scatter_sum_dim(g: torch.Tensor, dim: int, group, size: int,
                     rank: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of every rank's ``g``."""
    src = g.movedim(dim, 0)
    n = src.shape[0] // size
    if str(dist.get_backend(group)) == "nccl":
        out = torch.empty((n, *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src.contiguous(), group=group)
    else:
        src = src.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(src, group=group)
        # A copy: a view would keep the whole summed buffer alive as the
        # gradient's storage.
        out = src[rank * n:(rank + 1) * n].clone()
    return out.movedim(0, dim)


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _TPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.args = dim, group, size, rank
        return gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum_dim(g, *ctx.args), None, None, None, None


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Resolves logical axis names against a mesh (or none), and carries
    the data group's row helpers and the model axis' collectives.

    ``group`` is the data group (taken from ``mesh`` when only a mesh is
    given); ``mesh`` a ``DeviceMesh`` with named dims, or any object with
    ``axis_names`` and a ``shape`` mapping (a spec-only stand-in, no
    collectives)."""

    group: Any = None
    mesh: Any = None
    fsdp: bool = False
    seq_parallel_kv: bool = False
    remat: bool = False
    dp_only: bool = False              # fold "model" into the data axes
    remat_policy: str = "nothing"      # "nothing" | "dots"
    moe_fsdp_mode: str = "gather"      # "gather" (ZeRO-3) | "partial"

    def __post_init__(self):
        if self.group is None and self._live and self.dp_axes:
            object.__setattr__(self, "group", self.group_for(self.dp_axes))

    # -- mesh-derived views ----------------------------------------------

    @property
    def _live(self) -> bool:
        """A mesh with process groups (a ``DeviceMesh``), not a stand-in."""
        return self.mesh is not None and hasattr(self.mesh, "get_group")

    @property
    def axis_names(self) -> tuple[str, ...]:
        if self.mesh is None:
            return ()
        names = getattr(self.mesh, "mesh_dim_names", None)
        return tuple(names if names is not None else self.mesh.axis_names)

    def axis_size(self, name: str) -> int:
        if self._live:
            return self.mesh.size(self.axis_names.index(name))
        return self.mesh.shape[name]

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """Data-parallel axes in mesh order (pod-major)."""
        names = self.axis_names
        dp = tuple(a for a in names if a in _DATA_AXES)
        if self.dp_only and _MODEL_AXIS in names:
            dp = dp + (_MODEL_AXIS,)
        return dp

    @property
    def tp_axis(self) -> str | None:
        if self.dp_only or self.mesh is None:
            return None
        return _MODEL_AXIS if _MODEL_AXIS in self.axis_names else None

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp_axis) if self.tp_axis else 1

    @property
    def dp_size(self) -> int:
        if self.mesh is not None:
            return math.prod(self.axis_size(a) for a in self.dp_axes)
        return (dist.get_world_size(self.group) if self.group is not None
                else 1)

    @property
    def rank(self) -> int:
        """This process' rank in the data group."""
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def backend(self) -> str | None:
        return (str(dist.get_backend(self.group)) if self.group is not None
                else None)

    def group_for(self, axes: tuple[str, ...]):
        """The process group over ``axes`` of the mesh, ranks in row-major
        order of their coordinates on ``axes``."""
        names = self.axis_names
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        if axes == names and self.mesh.size() == dist.get_world_size():
            return dist.group.WORLD
        return self.mesh[axes]._flatten().get_group()

    @property
    def tp_group(self):
        return self.group_for((self.tp_axis,)) if self.tp_axis else None

    def coordinate(self, axes: tuple[str, ...]) -> int:
        """This rank's row-major coordinate over ``axes`` (0 off-mesh)."""
        if not axes or not self._live:
            return 0
        coord = self.mesh.get_coordinate()
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.mesh.size(i) + coord[i]
        return idx

    @property
    def tp_rank(self) -> int:
        return self.coordinate((self.tp_axis,)) if self.tp_axis else 0

    # -- logical resolution ----------------------------------------------

    def _axes_for(self, name: str | None) -> tuple[str, ...]:
        if name is None:
            return ()
        if name == "batch":
            return self.dp_axes
        if name == "fsdp":
            return self.dp_axes if self.fsdp else ()
        if name in ("tp", "exp"):
            return (self.tp_axis,) if self.tp_axis else ()
        if name == "seq_tp":
            return ((self.tp_axis,) if self.seq_parallel_kv and self.tp_axis
                    else ())
        raise ValueError(f"unknown logical axis {name!r}")

    def spec(self, *logical: str | None,
             dims: tuple[int, ...] | None = None) -> tuple:
        """The spec of one array given per-dim logical names.

        ``dims`` (the array shape) enables the divisibility guard: a dim
        whose size does not divide over the mapped mesh axes is replicated.
        """
        if self.mesh is None:
            return ()
        entries: list[Any] = []
        used: set[str] = set()
        for i, name in enumerate(logical):
            axes = tuple(a for a in self._axes_for(name) if a not in used)
            if axes and dims is not None:
                span = math.prod(self.axis_size(a) for a in axes)
                if dims[i] % span != 0:
                    axes = ()
            used.update(axes)
            if not axes:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(axes)
        return tuple(entries)

    def local_shape(self, spec: tuple, shape: tuple[int, ...]) -> tuple:
        """The shape of this rank's shard of a ``shape`` array."""
        out = list(shape)
        for dim, entry in enumerate(spec):
            out[dim] //= math.prod(self.axis_size(a)
                                   for a in entry_axes(entry))
        return tuple(out)

    def local_shard(self, x, spec: tuple):
        """This rank's block of a global tensor or array under ``spec`` (a
        view)."""
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if axes:
                n = x.shape[dim] // math.prod(self.axis_size(a) for a in axes)
                start = self.coordinate(axes) * n
                x = x[(slice(None),) * dim + (slice(start, start + n),)]
        return x

    # -- collectives of the model axis and the data axes ------------------

    def tp_copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; the gradient all-reduced over ``"model"``."""
        if self.tp_size == 1:
            return x
        return _TPCopy.apply(x, self.tp_group)

    def tp_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) over ``"model"``; identity backward."""
        if self.tp_size == 1:
            return x
        return _Reduce.apply(x, self.tp_group)

    @torch.no_grad()
    def tp_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over ``"model"`` (a new tensor; no
        gradient)."""
        if self.tp_size == 1:
            return x
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.tp_group)
        return out

    def tp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' ``x`` concatenated along ``dim``; backward the
        local slice of the gradient (the compute after it is replicated
        over ``"model"``)."""
        if self.tp_size == 1:
            return x
        return _TPGather.apply(x, dim % x.dim(), self.tp_group, self.tp_size,
                               self.tp_rank)

    def fsdp_gather(self, x: torch.Tensor, dim: int,
                    axes: tuple[str, ...]) -> torch.Tensor:
        """ZeRO-3: the shards over the data ``axes`` concatenated along
        ``dim``; backward the gradient summed over those ranks and
        scattered back to this rank's shard."""
        size = math.prod(self.axis_size(a) for a in axes)
        if size == 1:
            return x
        return _FSDPGather.apply(x, dim, self.group_for(axes), size,
                                 self.coordinate(axes))

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) over the data axes; identity backward."""
        if self.dp_size == 1:
            return x
        return _Reduce.apply(x, self.group)

    def dp_sum_partials(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) over the data axes, forward and backward: the
        data ranks' partial sums of one value each of them then uses whole,
        so each one's gradient is the sum of theirs."""
        if self.dp_size == 1:
            return x
        return _SumPartials.apply(x, self.group)

    def gather_fsdp_tree(self, tree: Any, specs: Any) -> Any:
        """``tree`` (local shards) with every dim sharded over the data axes
        gathered (``fsdp_gather``): the model-parallel local weights."""
        if isinstance(tree, dict):
            return {k: self.gather_fsdp_tree(v, specs[k])
                    for k, v in tree.items()}
        dp = set(self.dp_axes)
        for dim, entry in enumerate(specs):
            axes = entry_axes(entry)
            if axes and set(axes) <= dp:
                tree = self.fsdp_gather(tree, dim, axes)
        return tree

    # -- row sharding helpers (SampleState / per-sample arrays) ------------

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
        """Reduce ``x`` over the data ranks in place (``"sum"``, ``"min"``
        or ``"max"``) and return it; ``x`` must be contiguous."""
        if self.group is not None:
            dist.all_reduce(x, op=_OPS[op], group=self.group)
        return x

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """Broadcast data rank 0's ``x`` to every data rank, in place."""
        if self.group is not None:
            dist.broadcast(x, src=dist.get_global_rank(self.group, 0),
                           group=self.group)
        return x

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def map_specs(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts whose leaves are logical
    tuples, specs or tensors, with matching trees ``rest``.  A list in
    ``tree`` is a layer stack as per-layer trees: each takes the same
    subtrees of ``rest`` (one layer's specs)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, t, *rest) for t in tree]
    return fn(tree, *rest)


def spec_tree_for(logical: Any, ctx: ParallelCtx, abstract: Any = None) -> Any:
    """A tree of logical-axis tuples as a tree of specs.

    ``abstract`` (a matching tree of anything with ``.shape``: meta
    tensors) supplies the shapes for the divisibility guard; without it,
    specs are taken at face value."""
    if abstract is None:
        return map_specs(lambda lg: ctx.spec(*lg), logical)
    return map_specs(lambda lg, ab: ctx.spec(*lg, dims=tuple(ab.shape)),
                     logical, abstract)
