"""The PyTorch port stands without JAX: importing it (and chip_smoke.py,
bench_torch.py and the port's scripts, `scripts/port_*.py`) loads no jax
module, nor PyYAML or OpenCV (the YAML and image loaders and the viewer
import them where they read or draw), its sources (the benches in
`splslam_tpu_torch/bench/` among them), chip_smoke.py, bench_torch.py,
the port's scripts and the card's test file import nothing of the JAX
package, and chip_smoke.py fails — printing no result — on a host
without a CUDA device (there is no CPU fallback).

The port reads the bundled BoW vocabularies, `.npz` files in the JAX
package's `assets/` folder, by file path as data
(`splslam_tpu_torch/bow/vocabulary.py::default_vocab_path`): that is no
import, and the scan below holds it so."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "splslam_tpu_torch"
SCRIPTS = sorted((ROOT / "scripts").glob("port_*.py"))


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
    scripts = [str(p) for p in SCRIPTS]
    assert {"port_train_vocab.py", "port_gba_scaling.py"} <= {p.name for p in SCRIPTS}
    code = (
        "import importlib, importlib.util, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
        f"for m in {mods!r} + ['chip_smoke', 'bench_torch']:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'splslam_tpu' or m.startswith('splslam_tpu.')\n"
        "       or m.split('.')[0] in ('yaml', 'cv2')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_port_sources_import_no_jax_module():
    allowed = set()
    pat = re.compile(r"^\s*(?:import|from)\s+(jax\b|splslam_tpu\.[\w.]+)", re.M)
    files = (list(PORT.rglob("*.py")) + SCRIPTS
             + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
                ROOT / "tests" / "test_torch_gpu.py"])
    assert len(files) > 15
    # the relocalization and loop-detection slice is among the scanned files
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"splslam_tpu_torch/bow/vocabulary.py", "splslam_tpu_torch/slam/reloc.py",
            "splslam_tpu_torch/slam/loop_closing.py",
            "splslam_tpu_torch/optim/sim3.py"} <= names
    # the entry points: settings, dataset loaders and the drivers
    assert {"splslam_tpu_torch/io/config.py", "splslam_tpu_torch/io/datasets.py",
            "splslam_tpu_torch/examples/_common.py",
            "splslam_tpu_torch/examples/rgbd_tum.py",
            "splslam_tpu_torch/examples/stereo_mynt.py"} <= names
    # the last module slice: the prefetcher, the ROS grabbers, the viewer
    # and AR overlay, the mesh and sharded global BA, the entry points
    assert {"splslam_tpu_torch/io/native.py", "splslam_tpu_torch/ros/__init__.py",
            "splslam_tpu_torch/ros/nodes.py", "splslam_tpu_torch/viz/__init__.py",
            "splslam_tpu_torch/viz/draw.py", "splslam_tpu_torch/viz/viewer.py",
            "splslam_tpu_torch/viz/ar.py", "splslam_tpu_torch/parallel/__init__.py",
            "splslam_tpu_torch/parallel/mesh.py",
            "splslam_tpu_torch/parallel/gba_sharded.py",
            "splslam_tpu_torch/graft_entry.py"} <= names
    # the twins of the JAX package's scripts
    assert {"scripts/port_train_vocab.py", "scripts/port_gba_scaling.py"} <= names
    # the benches and their command
    assert {"bench_torch.py", "splslam_tpu_torch/bench/common.py",
            "splslam_tpu_torch/bench/stereo.py", "splslam_tpu_torch/bench/mapping.py",
            "splslam_tpu_torch/bench/mono.py",
            "splslam_tpu_torch/bench/components.py"} <= names
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


def test_vocabulary_is_read_by_path_not_imported():
    code = (
        "import sys\n"
        "from splslam_tpu_torch.bow import vocabulary as V\n"
        "v = V.load(V.default_vocab_path(), 'cpu')\n"
        "assert v.n_words == 10 ** 5, v.n_words\n"
        "bad = [m for m in sys.modules if m == 'splslam_tpu'\n"
        "       or m.startswith('splslam_tpu.') or m.split('.')[0] == 'jax']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
