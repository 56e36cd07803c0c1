"""The data-parallel mesh over ``torch.distributed``.

Port of ``repro/launch/mesh.py``'s ``make_data_mesh`` and
``data_parallel_ctx``: the ``("data",)`` mesh the trainer runs under when
``TrainConfig.mesh_shape`` is set.  Here a mesh is the default process
group, one rank a device:

- ``make_data_mesh(n)`` validates the group (its world size must be
  ``n``), or, with no group yet and ``n == 1``, joins a group of one by
  itself under the backend it is given;
- ``spawn(fn, world_size, backend, device_type)`` runs ``fn(rank,
  world_size, *args)`` in ``world_size`` processes joined in one group, the
  counterpart of the reference's host-simulated devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count``).  The ranks meet
  through a ``FileStore`` in a temporary directory, so no port is taken
  and parallel test workers never collide.

The backend is always named: ``"nccl"`` for CUDA tensors (ranks on
distinct cards: NCCL refuses two ranks on one), ``"gloo"`` for CPU tensors
or for ranks sharing a card (gloo carries CUDA tensors itself, through
host memory, so ``dist/sharding.py`` stages nothing; such a group cannot
run inside a CUDA graph).  ``default_backend`` maps a device type to the
first.

The reference's TPU v5e roofline constants are not carried over: the
H100's come, measured, with the pod-scale launcher (ROADMAP A.9), as does
``make_production_mesh``.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.dist.sharding import ParallelCtx

BACKENDS = ("nccl", "gloo")
#: The backend a device type's tensors travel on by default.
_DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def default_backend(device: torch.device | str) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return _DEFAULT_BACKEND[torch.device(device).type]


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: must be one of {BACKENDS}")


def make_data_mesh(num_devices: int, backend: str | None = None):
    """The ``(num_devices,)`` data mesh: the default process group.

    With a group already joined, its world size must be ``num_devices``.
    With none, a mesh of one joins a group of one under ``backend``; a
    larger mesh needs its ranks launched first (``spawn``, or one process
    a card under ``torchrun``)."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if world != num_devices:
            raise RuntimeError(
                f"data mesh ({num_devices},) needs {num_devices} ranks, the "
                f"process group has {world}: launch {num_devices} ranks "
                "(repro_torch.launch.mesh.spawn, or torchrun) or set "
                f"mesh_shape=({world},)")
        return dist.group.WORLD
    if num_devices != 1:
        raise RuntimeError(
            f"data mesh ({num_devices},) needs {num_devices} ranks and no "
            "process group is initialised: launch the ranks with "
            "repro_torch.launch.mesh.spawn (or torchrun) and build the "
            "trainer in each")
    if backend is None:
        raise ValueError("make_data_mesh(1) joins a group of one itself: "
                         f"name its backend, one of {BACKENDS}")
    _check_backend(backend)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return dist.group.WORLD


def data_parallel_ctx(num_devices: int,
                      backend: str | None = None) -> ParallelCtx:
    """``ParallelCtx`` over ``make_data_mesh(num_devices, backend)``."""
    return ParallelCtx(group=make_data_mesh(num_devices, backend))


def rank_device(device_type: str, rank: int) -> torch.device:
    """A rank's device: ``cuda:(rank mod cards)`` (ranks beyond the card
    count share cards, which only gloo allows), or the CPU.  ``"cuda"``
    with no card visible raises."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device_type='cuda' but no CUDA "
                               "device is visible")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def _worker(rank: int, world_size: int, backend: str, device_type: str,
            store_path: str, result_dir: str, fn: Callable,
            args: tuple) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device_type, rank))
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size)
    try:
        out = fn(rank, world_size, *args)
        with open(os.path.join(result_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world_size: int, backend: str,
          device_type: str = "cpu", args: tuple = ()) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined in one process group under ``backend``; returns each rank's
    result (picklable), in rank order.  ``fn`` must be importable by name
    (a module-level function).  A rank that raises ends the others and
    re-raises here; every process is joined before this returns."""
    _check_backend(backend)
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("backend='nccl' carries CUDA tensors: "
                         "device_type='cuda'")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(world_size, backend, device_type,
                                os.path.join(tmp, "store"), tmp, fn, args),
                 nprocs=world_size, join=True)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
