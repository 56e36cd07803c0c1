"""Device resolution and the build of the hand-written CUDA kernels.

The JAX package picks between compiled Mosaic and Pallas interpret mode
through a probe (``repro/kernels/backend.py``).  The port has no such probe:

- every entry point takes ``device``; ``None`` means ``"cuda"``, and asking
  for CUDA on a machine without a CUDA device raises instead of carrying on
  on the CPU (``resolve_device``);
- a kernel wrapper chooses by the tensor it is given: a tensor on the CPU
  takes the kernel's plain PyTorch version, a CUDA tensor launches the
  kernel or raises.  Nothing falls back quietly.

The kernels are CUDA C++ under ``csrc/``, built by ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface and loaded with ``ctypes``.
The build runs at first use (never at import), one ``nvcc -c`` per source
started together, then one link; the ``.so`` lands in ``build/repro_torch/``
at the repository root, named by a hash of the sources and flags, so an
unchanged tree reuses it.  No ``--use_fast_math``: the histogram-select
kernel's bins must be bit-identical to the PyTorch formula.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``launch`` turns a non-zero code into an exception.  ``LAUNCHES`` counts the
kernel launches per wrapper, so a run can show which kernels it went through.

Inside ``crediting()`` (the dry run, ``launch/dryrun.py``) a wrapper
given meta tensors launches nothing and runs no plain version: it returns
outputs of the right shapes and credits its work by formula to
``META_WORK`` (``credit_meta``), the operations and bytes behind
``chip_smoke.py``'s bound of that kernel.  Outside it a meta tensor is
refused as any other tensor that is not on the CPU or a card.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: Repository root: src/repro_torch/kernels/backend.py -> four levels up.
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

#: Kernel launches per wrapper name (one per wrapper call that launched).
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


#: Work credited by wrappers that met meta tensors: ``(name, "ops")``,
#: ``(name, "bytes")`` and ``(name, "calls")``.
META_WORK: collections.Counter = collections.Counter()


_CREDITING = [False]


@contextlib.contextmanager
def crediting():
    """Within the block, wrappers given meta tensors credit their work
    (``on_meta``)."""
    before = _CREDITING[0]
    _CREDITING[0] = True
    try:
        yield
    finally:
        _CREDITING[0] = before


def on_meta(tensors) -> bool:
    """Whether the wrappers credit meta tensors (``crediting``) and every
    tensor of ``tensors`` (an iterable) is one."""
    return _CREDITING[0] and all(t.device.type == "meta" for t in tensors)


def credit_meta(name: str, ops: float, nbytes: float) -> None:
    """Credit one call of wrapper ``name`` on meta tensors with ``ops``
    operations and ``nbytes`` bytes of device memory traffic."""
    META_WORK[name, "ops"] += ops
    META_WORK[name, "bytes"] += nbytes
    META_WORK[name, "calls"] += 1


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> CUDA.  CUDA without a CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} asks for CUDA but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "kernels of repro_torch cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> None:
    failed = []
    for cmd, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{err.decode(errors='replace')}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed ``.so`` (no-op when present)."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
            objs.append(str(obj))
        _run(procs)
        so_tmp = Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(so_tmp)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE))])
        os.replace(so_tmp, out)       # atomic: a reader never sees half a file
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_I64P = ctypes.POINTER(ctypes.c_longlong)
#: C signatures: every device pointer and the stream are c_void_p, sizes and
#: the device index c_int, a scale or a fraction c_float, a 64-bit value or
#: an element stride c_longlong, an array of element strides a pointer to
#: int64.
#: Each entry sets the device, launches on the stream and returns
#: cudaGetLastError().
_SIGNATURES = {
    "lc_forward_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "lc_forward_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "lc_backward_f32": [_P, _P, _P, _P, _LL, _P, _I, _I, _I, _P],
    "lc_backward_bf16": [_P, _P, _P, _P, _LL, _P, _I, _I, _I, _P],
    "hs_histogram_select": [_P, _P, _P, _F, _F, _I, _P, _I, _P, _P, _I, _I, _P],
    "hs_range": [_P, _P, _P, _I, _P, _I, _I, _P],
    "hs_count": [_P, _P, _P, _P, _I, _I, _I, _P],
    "hs_walk": [_P, _P, _P, _P, _P, _F, _F, _I, _I, _P, _P, _P, _I, _I, _P],
    "rs_rank_select": [_P, _P, _I, _LL, _I, _P, _I, _P, _I, _I, _P],
    # Not a launch: the floats of B6's scratch (-1 if too large).
    "ssd_scan_scratch_floats": [_I] * 6,
    "ssd_scan_f32": [_P] * 9 + [_I] * 6 + [_I64P, _I, _P],
    "flash_attention_f32": [_P] * 4 + [_I] * 6 + [_F, _I64P, _I, _P],
    "flash_attention_bf16": [_P] * 4 + [_I] * 6 + [_F, _I64P, _I, _P],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


#: (entry, device) -> (C function, device index), resolved at first use.
_BOUND: dict = {}


def _bind(entry: str, device: torch.device) -> tuple:
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    bound = (getattr(library(), entry), index)
    if device.index is not None:         # "cuda" alone follows the current device
        _BOUND[entry, device] = bound
    return bound


def launch(entry: str, name: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` on ``device``'s current stream; count it under
    ``name``; raise on a non-zero ``cudaError_t``.  The C function and the
    device index are looked up once per (entry, device); the stream is read
    as a raw handle, with no ``torch.cuda.Stream`` made for it."""
    fn, index = _BOUND.get((entry, device)) or _bind(entry, device)
    code = fn(*args, index, torch._C._cuda_getCurrentRawStream(index))
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {name} ({entry}) failed to launch: cudaError {code}")
    LAUNCHES[name] += 1


def refuse_grad(name: str, tensors: dict[str, torch.Tensor]) -> None:
    """A kernel launch makes no autograd node: raise when grad mode is on
    and an input requires a gradient, which the launch would drop silently
    (the caller goes through the kernel's autograd Function in
    ``kernels/ops.py``, or runs under ``torch.no_grad()``)."""
    if torch.is_grad_enabled():
        needs = [k for k, t in tensors.items() if t.requires_grad]
        if needs:
            raise RuntimeError(
                f"{name}: {needs} require grad but the kernel launch has no "
                "backward; call it through kernels/ops.py (its autograd "
                "Function) or under torch.no_grad()")


def check_cuda(name: str, tensors: dict[str, torch.Tensor],
               contiguous: bool = True) -> torch.device:
    """The common device/contiguity checks of a kernel wrapper: every tensor
    on one CUDA device and (unless the kernel takes strides) contiguous.
    Returns that device."""
    dev = None
    for k, t in tensors.items():
        d = t.device
        dev = d if dev is None else dev
        if d != dev or d.type != "cuda":
            raise ValueError(
                f"{name}: inputs must all lie on one CUDA device (or all on "
                f"the CPU for the plain version); got "
                f"{ {k: str(t.device) for k, t in tensors.items()} }")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return dev
