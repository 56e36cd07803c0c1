"""Meshes over ``torch.distributed``.

Port of ``repro/launch/mesh.py``: ``make_data_mesh`` and
``data_parallel_ctx``, the ``("data",)`` mesh the trainer runs under when
``TrainConfig.mesh_shape`` is set (the default process group, one rank a
device), and the launcher's 2-D and 3-D meshes, ``DeviceMesh``es with
named dims over the default group:

- ``make_data_model_mesh(data, model, backend)``: a ``("data", "model")``
  mesh (``launch/train.py::build_ctx`` resolves a ``ParallelCtx`` on it);
- ``make_production_mesh(multi_pod=)``: the reference's (16, 16)
  ``("data", "model")`` pod and (2, 16, 16) ``("pod", "data", "model")``
  pair of pods.  It needs a group of 256 or 512 ranks; on one machine
  torch's fake process group holds one (``backend="fake"`` with
  ``torch.testing._internal.distributed.fake_pg.FakeStore``), in one
  process, for the specs and shapes a launcher derives from it.

The data mesh:

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

The roofline denominators are the H100's (``PEAK_FLOPS_BF16``,
``HBM_BW``, ``NVLINK_BW``), not the reference's TPU v5e ones.
"""
from __future__ import annotations

import math
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
    _join_one(backend)
    return dist.group.WORLD


def _join_one(backend: str | None) -> None:
    if backend is None:
        raise ValueError("a mesh of one joins a group of one itself: "
                         f"name its backend, one of {BACKENDS}")
    _check_backend(backend)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_data_model_mesh(data: int, model: int, backend: str | None = None):
    """The ``(data, model)`` mesh with dims ``("data", "model")`` over the
    default group (its world size must be ``data * model``; with no group
    yet, a (1, 1) mesh joins a group of one under ``backend``).  Rank r
    sits at (r // model, r % model): the model axis is the inner one.  The
    mesh's device type is "cuda" under NCCL, else "cpu" (gloo ranks may
    still compute on a card: the type moves no tensor)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = data * model
    if not dist.is_initialized():
        if world != 1:
            raise RuntimeError(
                f"mesh ({data}, {model}) needs {world} ranks and no process "
                "group is initialised: launch the ranks with "
                "repro_torch.launch.mesh.spawn (or torchrun)")
        _join_one(backend)
    elif dist.get_world_size() != world:
        raise RuntimeError(
            f"mesh ({data}, {model}) needs {world} ranks, the process group "
            f"has {dist.get_world_size()}")
    device_type = "cuda" if str(dist.get_backend()) == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's pod mesh: (16, 16) ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``, over the
    default group of 256 or 512 ranks (on one machine: the fake process
    group, see the module docstring)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {need} ranks, have "
            f"{have}: join one first (one process: backend='fake' with "
            "torch.testing._internal.distributed.fake_pg.FakeStore)")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


# The H100 SXM5 80 GB's datasheet figures (roofline denominators), the card
# the port runs on (``NVIDIA H100 80GB HBM3, 700.00 W``): dense bf16 tensor
# throughput, HBM3 bandwidth, and NVLink 4's aggregate bandwidth a card.
# ``chip_smoke.py`` prints its measured stream-copy rate beside HBM_BW.
PEAK_FLOPS_BF16 = 989e12      # per card
HBM_BW = 3.35e12               # bytes/s per card
NVLINK_BW = 900e9              # bytes/s per card, all links


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
