"""Build a CUDA source of `csrc/` into a shared library with a plain C
interface and load it with ctypes (the port's kernels are bound so; see
`orb_kernel.py` and `segsum.py`).

The library is built at first use with nvcc for sm_90a into the
git-ignored `build/kernels/`, under a name keyed by a hash of the source
and the flags, so a changed source builds anew and an unchanged one
loads the file already there. A build goes to a temporary file first and
is renamed into place, so processes that build at once do not see each
other's half-written file. A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit under CUDA_HOME."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    return shutil.which("nvcc") or str(home / "bin" / "nvcc")


def build_library(source: Path, flags=NVCC_FLAGS):
    """(ctypes handle, library path, nvcc's stderr when this call built
    it, else "") for `source`."""
    code = source.read_bytes()
    key = hashlib.sha256(code + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{source.stem}-{key}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        r = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed with code {r.returncode}:\n{r.stderr}")
        log = r.stderr
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), so, log
