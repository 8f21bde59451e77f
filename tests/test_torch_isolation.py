"""The PyTorch port stands without JAX: importing it (and chip_smoke.py)
loads no jax module, its sources import no JAX-backed module of the
reference package, and chip_smoke.py fails — printing no result — on a
host without a CUDA device (there is no CPU fallback)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "splslam_tpu_torch"


def _run(code_or_args, timeout=300):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "splslam_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke', 'splslam_tpu.io.synthetic']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_port_sources_import_no_jax_module():
    allowed = {"splslam_tpu.io.synthetic"}
    pat = re.compile(r"^\s*(?:import|from)\s+(jax\b|splslam_tpu\.[\w.]+)", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for p in files:
        for m in pat.findall(p.read_text()):
            assert m in allowed, f"{p.relative_to(ROOT)} imports {m}"


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    r = _run(["chip_smoke.py"], timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "cuda" in (r.stdout + r.stderr).lower()
