"""Nothing the benchmark runs loads JAX or the JAX package: a module is
judged by its whole top-level name, so the port (``repro_torch``) passes
and the JAX package (``repro``) does not; the reference imports nothing
of the program."""
import ast
import subprocess
import sys

import pytest

from h100_bench import run
from h100_bench.cells import HERE, ROOT


@pytest.mark.parametrize("name, refused", [
    ("repro_torch", False), ("repro_torch.train.trainer", False),
    ("reproduce", False), ("repro", True), ("repro.core.kakurenbo", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("jaxtyping", False)])
def test_whole_top_level_names(monkeypatch, name, refused):
    for m in [m for m in sys.modules
              if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert (run.forbidden_modules() != []) == refused


def test_harness_and_port_load_no_jax():
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
            "from h100_bench import run, session, check, calibrate\n"
            "import repro_torch.train, repro_torch.models\n"
            "print(run.forbidden_modules())").format(
                root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in {"__future__", "contextlib", "numpy",
                                       "torch"}, n
