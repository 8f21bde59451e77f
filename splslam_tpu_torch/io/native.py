"""ctypes bindings for the native C++ dataset prefetcher (port of
splslam_tpu/io/native.py).

Disk reads and PNG/PGM decode run on a C++ pthread pool with a lookahead
ring buffer (`native/dataloader.cpp`, read by path as data), so frame
i+1.. decodes on the host while the card tracks frame i. The library is
built at first use with g++ into the git-ignored `build/native/`, named
by a hash of the source and the flags; a failed build raises with g++'s
stderr (there is no silent fallback to OpenCV).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "dataloader.cpp"
_BUILD_DIR = _ROOT / "build" / "native"
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
GXX_LIBS = ["-lz", "-lpthread"]

_LIB: ctypes.CDLL | None = None


def _load_lib() -> ctypes.CDLL:
    """Build (if needed) and load the prefetcher library; cached per
    process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    code = _SOURCE.read_bytes()
    key = hashlib.sha256(
        code + " ".join(GXX_FLAGS + GXX_LIBS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"splloader-{key}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *GXX_FLAGS, "-o", str(tmp),
               str(_SOURCE), *GXX_LIBS]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed with code {r.returncode}:\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.dl_get.restype = ctypes.c_int
    lib.dl_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
    ]
    lib.dl_close.restype = None
    lib.dl_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class PrefetchLoader:
    """Asynchronous grayscale image loader with native decode.

    Usage:
        with PrefetchLoader(paths, w, h) as dl:
            for i in range(len(paths)):
                img = dl[i]          # uint8 [h, w]; i+1.. already decoding

    A file the C decoder does not cover (`dl_get` < 0) is read by
    `io.datasets.imread_gray` and zero-padded or cropped to (h, w), as
    the reference loader does; a missing file raises."""

    def __init__(self, paths: list[str], width: int, height: int,
                 lookahead: int = 4, n_threads: int = 2):
        self.paths = list(paths)
        self.width = width
        self.height = height
        self._h = None
        self._lib = _load_lib()
        c_paths = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._h = self._lib.dl_open(c_paths, len(self.paths), width, height,
                                    lookahead, n_threads)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._h is None:
            raise ValueError("PrefetchLoader is closed")
        out = np.empty((self.height, self.width), np.uint8)
        rc = self._lib.dl_get(
            self._h, idx, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if rc >= 0:
            return out
        from splslam_tpu_torch.io.datasets import imread_gray

        img = imread_gray(self.paths[idx])
        if img.shape == (self.height, self.width):
            return img
        out = np.zeros((self.height, self.width), np.uint8)
        h = min(self.height, img.shape[0])
        w = min(self.width, img.shape[1])
        out[:h, :w] = img[:h, :w]
        return out

    def close(self):
        if self._h is not None:
            self._lib.dl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
