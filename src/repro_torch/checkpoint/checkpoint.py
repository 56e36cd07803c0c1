"""Fault-tolerant checkpointing: atomic, integrity-checked, async-capable.

The port's own copy of ``repro/checkpoint/checkpoint.py``'s write-ahead
protocol.  Layout: ``<dir>/step_<n>/`` holding one ``.npy`` per leaf and a
``manifest.json`` with the leaf paths, each leaf's CRC32 and dtype, and the
metadata.  A ``COMMITTED`` marker is written last, after fsync, so a crash
mid-save never leaves a checkpoint that ``latest_step`` would pick up.

- ``save`` retries an ``OSError`` with exponential backoff, each attempt in
  a clean tmp dir;
- ``save_async`` copies to host memory at once and writes on a thread; its
  ``AsyncSaveHandle.join()`` re-raises the thread's failure;
- ``restore_latest`` walks the committed steps newest first: a CRC or read
  failure quarantines the dir (``corrupt_<name>``) and falls back, a
  structure mismatch falls back without quarantine;
- ``gc`` keeps the newest ``keep``.

A tree is nested dicts (keys sorted), dataclasses (fields sorted, as a
``SampleState``) and lists over leaves: ``torch.Tensor``s (copied to the
host) or numpy arrays.  ``restore`` returns numpy arrays in the structure of
``like`` (a dataclass comes back as a dict of its fields); ``copy_into``
writes them into ``like``'s tensors in place, on their device, so that
whatever holds those tensors' addresses (a captured CUDA graph) reads the
restored values.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

logger = logging.getLogger("repro_torch.checkpoint")


def _items(tree):
    if isinstance(tree, dict):
        return sorted(tree.items())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sorted((f.name, getattr(tree, f.name))
                      for f in dataclasses.fields(tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in a fixed order: dict keys and dataclass
    fields sorted, list items in order; ``None`` has no leaves."""
    if tree is None:
        return []
    items = _items(tree)
    if items is None:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(flatten(v, f"{prefix}/{k}"))
    return out


def _unflatten(like: Any, leaves) -> Any:
    items = _items(like)
    if items is None:
        return next(leaves)
    if isinstance(like, (list, tuple)):
        return [_unflatten(v, leaves) for _, v in items]
    return {k: _unflatten(v, leaves) for k, v in items}


def to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


@torch.no_grad()
def copy_into(like: Any, tree: Any) -> None:
    """Copy ``tree``'s leaves (tensors or arrays) into the tensors (or
    numpy arrays) of ``like``, in place, path by path."""
    src = dict(flatten(tree))
    dst_leaves = flatten(like)
    if sorted(p for p, _ in dst_leaves) != sorted(src):
        raise ValueError(f"tree structure differs: {sorted(src)} vs "
                         f"{[p for p, _ in dst_leaves]}")
    for path, dst in dst_leaves:
        if isinstance(dst, torch.Tensor):
            dst.copy_(torch.as_tensor(src[path]))
        else:
            np.copyto(dst, src[path])


def _write_leaf(path: str, arr: np.ndarray) -> None:
    """One leaf's write, the unit of save I/O (and a fault-injection seam)."""
    np.save(path, arr)


def _write_dir(tmp: str, final: str, step: int, paths: list[str],
               arrays: list[np.ndarray], metadata: dict | None) -> None:
    """One attempt of the write-ahead commit protocol into ``tmp``."""
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "paths": paths, "num_leaves": len(arrays),
                "metadata": metadata or {}, "crc": [], "dtype": []}
    for i, arr in enumerate(arrays):
        manifest["crc"].append(zlib.crc32(np.ascontiguousarray(arr).tobytes()))
        manifest["dtype"].append(str(arr.dtype))
        _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def save(directory: str, step: int, tree: Any, metadata: dict | None = None,
         keep: int | None = 3, retries: int = 2,
         retry_backoff: float = 0.05, _sleep=time.sleep) -> str:
    """Atomically save ``tree`` for ``step``; returns the checkpoint's path.

    An ``OSError`` during the write is retried up to ``retries`` times,
    after ``retry_backoff * 2**attempt`` seconds, each attempt restarting
    the protocol in a clean tmp dir.  ``keep=None`` skips the trailing GC.
    """
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    flat = flatten(tree)
    # Device -> host once, outside the retry loop.
    paths = [p for p, _ in flat]
    arrays = [to_numpy(leaf) for _, leaf in flat]
    last_exc: OSError | None = None
    for attempt in range(retries + 1):
        try:
            _write_dir(tmp, final, step, paths, arrays, metadata)
            break
        except OSError as e:
            last_exc = e
            shutil.rmtree(tmp, ignore_errors=True)
            if attempt < retries:
                delay = retry_backoff * (2 ** attempt)
                logger.warning(
                    "checkpoint save step %d attempt %d/%d failed (%s): "
                    "retrying in %.2fs", step, attempt + 1, retries + 1, e,
                    delay)
                _sleep(delay)
    else:
        logger.error("checkpoint save step %d failed after %d attempts: %s",
                     step, retries + 1, last_exc)
        raise last_exc
    if keep:
        gc(directory, keep)
    return final


class AsyncSaveHandle:
    """A background save; ``join()``/``result()`` re-raise its failure."""

    def __init__(self, path: str, target, args):
        self.path = path
        self._exc: BaseException | None = None
        self._result: str | None = None

        def _run():
            try:
                self._result = target(*args)
            except BaseException as e:  # noqa: BLE001 (re-raised in join)
                self._exc = e

        self._thread = threading.Thread(target=_run)
        self._thread.start()

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def exception(self) -> BaseException | None:
        """Wait, and return (not raise) the thread's exception, if any."""
        self._thread.join()
        return self._exc

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)
        if self._exc is not None:
            raise self._exc

    def result(self, timeout: float | None = None) -> str:
        self.join(timeout)
        return self._result


def save_async(directory: str, step: int, tree: Any,
               metadata: dict | None = None,
               keep: int | None = 3) -> AsyncSaveHandle:
    """Copy ``tree`` to host memory now, write it on a thread."""
    snapshot = _unflatten(tree, iter([to_numpy(leaf).copy()
                                      for _, leaf in flatten(tree)]))
    return AsyncSaveHandle(_step_dir(directory, step), save,
                           (directory, step, snapshot, metadata, keep))


def _valid(path: str) -> bool:
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "COMMITTED"))
            and os.path.exists(os.path.join(path, "manifest.json")))


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name.split("_")[1]) for name in os.listdir(directory)
                  if name.startswith("step_") and not name.endswith(".tmp")
                  and _valid(os.path.join(directory, name)))


def latest_step(directory: str) -> int | None:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like: Any,
            check_integrity: bool = True) -> tuple[Any, dict]:
    """Read ``step`` in the structure of ``like``: (numpy tree, metadata).

    Raises ``FileNotFoundError`` (no committed dir), ``ValueError`` (leaf
    paths or shapes differ from ``like``'s) or ``IOError`` (a CRC mismatch,
    an unreadable leaf or manifest).
    """
    path = _step_dir(directory, step)
    if not _valid(path):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise IOError(f"corrupt manifest in {path}: {e}") from e
    flat = flatten(like)
    if manifest["paths"] != [p for p, _ in flat]:
        raise ValueError(
            f"checkpoint has leaves {manifest['paths']}, expected "
            f"{[p for p, _ in flat]}: structure mismatch")
    out = []
    for i, (leaf_path, ref) in enumerate(flat):
        try:
            arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        except (ValueError, EOFError, OSError) as e:
            # A truncated or garbled .npy: integrity, not structure.
            raise IOError(f"unreadable leaf {i} of {path}: {e}") from e
        if check_integrity:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != manifest["crc"][i]:
                raise IOError(f"CRC mismatch on leaf {i} of {path}: corrupt")
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"leaf {leaf_path} has shape {arr.shape}, "
                             f"expected {tuple(ref.shape)}")
        out.append(arr)
    return _unflatten(like, iter(out)), manifest["metadata"]


def _quarantine(directory: str, step: int) -> str | None:
    """Rename a corrupt ``step_<n>`` dir to ``corrupt_<...>``: out of
    ``latest_step``'s and ``gc``'s view, its bytes kept."""
    name = f"step_{step:010d}"
    src = os.path.join(directory, name)
    dst = os.path.join(directory, f"corrupt_{name}")
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(directory, f"corrupt_{name}.{n}")
    try:
        os.rename(src, dst)
    except OSError as e:  # pragma: no cover (best effort)
        logger.warning("could not quarantine %s: %s", src, e)
        return None
    return dst


def restore_latest(directory: str, like: Any,
                   fallback: bool = True) -> tuple[Any, dict, int] | None:
    """The newest good committed checkpoint: ``(tree, metadata, step)``.

    Integrity failures quarantine the dir and fall back to the previous
    committed step; structure mismatches fall back without quarantine.
    ``None`` when nothing is committed; the newest checkpoint's error when
    every one fails.  ``fallback=False`` restores only the newest.
    """
    first_exc: Exception | None = None
    for step in reversed(_committed_steps(directory)):
        try:
            tree, meta = restore(directory, step, like)
            return tree, meta, step
        except IOError as e:
            if not fallback:
                raise
            first_exc = first_exc or e
            dst = _quarantine(directory, step)
            logger.warning(
                "corrupt checkpoint step %d (%s)%s: falling back to the "
                "previous committed step", step, e,
                f"; quarantined to {dst}" if dst else "")
        except ValueError as e:
            if not fallback:
                raise
            first_exc = first_exc or e
            logger.warning(
                "checkpoint step %d structure mismatch (%s): falling back "
                "to the previous committed step", step, e)
    if first_exc is not None:
        raise first_exc
    return None


def gc(directory: str, keep: int = 3) -> None:
    """Drop all but the newest ``keep`` committed checkpoints."""
    names = sorted(n for n in os.listdir(directory) if n.startswith("step_")
                   and not n.endswith(".tmp"))
    for name in names[:-keep]:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
