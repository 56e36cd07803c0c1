"""PyTorch port, isolation and device rules.

- the port imports ``torch`` and numpy, never ``jax`` and nothing of the
  JAX package ``repro`` or of the reference's ``benchmarks`` — checked in a
  fresh interpreter that imports every ``repro_torch`` module (and
  ``chip_smoke``), and statically over the sources and the port's
  examples;
- ``device=None`` means CUDA: without a CUDA device every entry point
  raises instead of carrying on on the CPU;
- the kernel build raises, with a reason, when nvcc is missing, and never
  runs at import.
"""
from __future__ import annotations

import ast
import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import KakurenboSampler, make_strategy
from repro_torch.core.baseline import BaselineStrategy
from repro_torch.data import SyntheticClassification
from repro_torch.kernels import backend
from repro_torch.launch.serve import serve
from repro_torch.models import build_model, transformer
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.models.common import init_params
from repro_torch.models.ssm import ssm_init_cache
from repro_torch.train import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "assert {'repro_torch.launch.train', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.roofline_model',\n"
        "        'repro_torch.launch.dryrun',\n"
        "        'repro_torch.launch.hlo_analysis'} <= set(names), names\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax_or_repro():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("torch_*.py")))
    assert len(files) >= 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "jaxlib", "repro", "benchmarks"} & set(roots), (
                path, roots)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")


def test_default_device_is_cuda_and_raises_without_it():
    _no_cuda()
    ds = SyntheticClassification(num_samples=64, image_size=8, seed=0)
    model = CNN(CNNConfig(image_size=8, widths=(8,), hidden=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(TrainConfig(fused_scoring=True), model, None, ds,
                logits_fn=lambda m, b: m(b["images"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        KakurenboSampler(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        BaselineStrategy(64)
    for name in ("kakurenbo", "random", "forget", "iswr", "sb", "infobatch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_strategy(name, 64)
    cfg = get_arch("mamba2-130m").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("mamba2-130m", verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("smollm-135m", verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(transformer.param_defs(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        ssm_init_cache(2, cfg.ssm, 64)
    for arch in ("mamba2-130m", "smollm-135m"):
        with pytest.raises(RuntimeError, match="CUDA"):
            transformer.init_cache(get_arch(arch).reduced(), 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.params_from_jax({"embed": [[0.0]]})
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.resolve_device(None)
    assert backend.resolve_device("cpu") == torch.device("cpu")


def test_zoo_modules_default_to_cuda():
    """The model zoo's modules (configs, ``models/moe.py``, the hybrid and
    VLM paths) hold to the device rule too."""
    _no_cuda()
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import moe
    assert len(ARCHS) == 10 and moe.moe_ffn.__module__ == "repro_torch.models.moe"
    for arch in ("phi3.5-moe-42b-a6.6b", "hymba-1.5b", "llava-next-mistral-7b",
                 "qwen3-1.7b", "kimi-k2-1t-a32b"):
        cfg = get_arch(arch).reduced()
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve(arch, verbose=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            transformer.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_cache(get_arch("hymba-1.5b").reduced(), 2, 16,
                               ring=True)


def test_encdec_and_compression_default_to_cuda():
    """``models/encdec.py`` (seamless-m4t) and the compressing trainer hold
    to the device rule; ``dist/compression.py`` makes nothing of its own."""
    _no_cuda()
    from repro_torch.dist import compression
    from repro_torch.models import encdec
    arch = "seamless-m4t-large-v2"
    cfg = get_arch(arch).reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(arch, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        encdec.init_cache(cfg, 2, 16, 4)
    ef = compression.init_error_feedback([torch.ones(3)])
    assert ef[0].device.type == "cpu" and not ef[0].any()
    ds = SyntheticClassification(num_samples=16, image_size=8, seed=0)
    model = CNN(CNNConfig(image_size=8, widths=(4,), hidden=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(TrainConfig(grad_compression=True), model, None, ds,
                logits_fn=lambda m, b: m(b["images"]))


@pytest.mark.parametrize("section", ["table5", "table6", "fig2", "fig4",
                                     "driver"])
def test_paper_sections_default_to_cuda(section):
    """The paper's sections (``repro_torch.experiments``) and
    ``examples/torch_paper_reproduction.py`` run on CUDA without
    ``--device``, and raise without a card."""
    _no_cuda()
    if section == "driver":
        spec = importlib.util.spec_from_file_location(
            "torch_paper_reproduction",
            ROOT / "examples" / "torch_paper_reproduction.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(["--list-strategies"])
    else:
        mod = importlib.import_module(f"repro_torch.experiments.{section}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(backend.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        backend.build()
    assert not (tmp_path / "build").exists()


def test_library_path_names_the_sources():
    path = backend.library_path()
    assert path.parent == backend.BUILD_DIR
    assert path == backend.library_path()           # stable hash
    assert path.name.startswith("libkernels_") and path.suffix == ".so"
    assert {p.name for p in backend.CSRC.glob("*.cu")} == {
        "loss_confidence.cu", "threshold_select.cu", "rank_select.cu",
        "ssd_scan.cu", "flash_attention.cu"}


def test_registry_is_the_ports_own():
    from repro_torch.core import available_strategies
    assert available_strategies() == ["baseline", "forget", "gradmatch",
                                      "infobatch", "iswr", "kakurenbo",
                                      "random", "sb"]
    with pytest.raises(ValueError, match="unknown strategy"):
        make_strategy("craig", 10, device="cpu")
    # Without num_classes Grad-Match builds, and its error waits for the
    # first reselection's features, as the reference's does.
    gm = make_strategy("gradmatch", 10, device="cpu")

    def never():
        raise AssertionError("features asked for off a reselection epoch")

    gm.prepare(1, never)
    with pytest.raises(ValueError, match="num_classes"):
        gm.prepare(0, lambda: (np.zeros((10, 2)), np.zeros(10)))


def test_mesh_modules_without_a_group():
    """``dist/sharding.py`` and ``launch/mesh.py`` in one process: with no
    group every helper is the identity, a larger mesh refuses to start
    without its ranks, and the backend is always named."""
    from repro_torch.dist.sharding import ParallelCtx
    from repro_torch.launch import mesh
    ctx = ParallelCtx()
    x = torch.arange(6.0).reshape(3, 2)
    assert ctx.mesh is None and ctx.rank == 0 and ctx.dp_size == 1
    assert ctx.backend is None and ctx.rows(3) == (0, 3)
    assert ctx.shard_rows(x) is x and ctx.gather_rows(x) is x
    assert ctx.replicate(x) is x and ctx.all_reduce(x, "min") is x
    ctx.check_rows(7)
    ctx.barrier()
    assert mesh.default_backend("cpu") == "gloo"
    assert mesh.default_backend(torch.device("cuda", 0)) == "nccl"
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="spawn"):
            mesh.make_data_mesh(2)
        with pytest.raises(ValueError, match="backend"):
            mesh.make_data_mesh(1)
    with pytest.raises(ValueError, match="backend"):
        mesh.spawn(print, 2, "mpi")
    with pytest.raises(ValueError, match="device_type='cuda'"):
        mesh.spawn(print, 2, "nccl", "cpu")
    ds = SyntheticClassification(num_samples=64, image_size=8, seed=0)
    model = CNN(CNNConfig(image_size=8, widths=(8,), hidden=16))
    with pytest.raises(RuntimeError, match="spawn"):
        Trainer(TrainConfig(mesh_shape=(2,), grad_chunks=8,
                            fused_scoring=True), model, None, ds,
                logits_fn=lambda m, b: m(b["images"]), device="cpu")
