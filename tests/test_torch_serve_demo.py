"""PyTorch port, ``examples/torch_serve_demo.py``: the counterpart of
``examples/serve_demo.py`` serves a reduced model on the CPU, cut to two
layers, and prints its prefill and decode lines."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_serve_demo_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_demo.py"),
         "--device", "cpu", "--layers", "2", "--gen-tokens", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "prefill" in out.stdout and "decode" in out.stdout, out.stdout
