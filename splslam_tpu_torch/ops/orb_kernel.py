"""ORB orientation + descriptors for a batch of keypoints: the hand-written
Hopper kernel `csrc/orb_describe.cu`, its plain PyTorch version, and the
wrapper that picks between them by device.

Replaces the TPU kernel `splslam_tpu/ops/orb_pallas.py::extract_patches`
plus the XLA stage `describe_from_patches` that consumes its patches.
Inputs are the ones `extract_orb` builds for both paths: the packed
blurred pyramid (bf16 [R, Wp]) and each keypoint's 40x40 patch corner.
Outputs are `angle` f32 [N] and `desc` int32 [N, 8] (the bits of the
reference's uint32 words; bit j of word w is test 32w+j).

`orb_describe` launches the CUDA kernel for CUDA tensors and uses
`orb_describe_reference` only for CPU tensors; there is no fallback from
one to the other. `orb_describe.launches` counts kernel launches.

The kernel is built at first use with nvcc for sm_90a from the source in
this repository into `build/kernels/`, under a name keyed by a hash of
the source and flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from splslam_tpu_torch.ops.orb import make_pattern

PATCH = 40   # rotated BRIEF offsets reach +-19 px (pattern radius 13*sqrt2)
C = 19       # patch centre; equals the detector's EDGE_THRESHOLD border
R_C = 15     # IC-angle circle radius (reference HALF_PATCH_SIZE)
N_BINS = 30  # pattern rotation bins (ORB paper: 2*pi/30 increments)
N_WORDS = 8

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "orb_describe.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def pair_table() -> np.ndarray:
    """[N_BINS, 256, 2] uint16: flat 40x40-patch offsets (row*40 + col) of
    the two samples of every pair under each quantized rotation, rounded
    exactly as the reference's `_build_tables` rounds them (np.round of
    the float32 rotation)."""
    pat = make_pattern().astype(np.float32)
    x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    out = np.empty((N_BINS, 256, 2), np.uint16)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        ca, sa = np.float32(np.cos(th)), np.float32(np.sin(th))
        rx1 = np.round(ca * x1 - sa * y1).astype(np.int32) + C
        ry1 = np.round(sa * x1 + ca * y1).astype(np.int32) + C
        rx2 = np.round(ca * x2 - sa * y2).astype(np.int32) + C
        ry2 = np.round(sa * x2 + ca * y2).astype(np.int32) + C
        out[b, :, 0] = ry1 * PATCH + rx1
        out[b, :, 1] = ry2 * PATCH + rx2
    return out


def _moment_weights() -> tuple[np.ndarray, np.ndarray]:
    """(dx*w, dy*w) over the 40x40 patch, w = the r=15 circle mask."""
    d = (np.arange(PATCH) - C).astype(np.float32)
    w = (d[:, None] ** 2 + d[None, :] ** 2) <= float(R_C * R_C)
    return (d[None, :] * w).astype(np.float32), (d[:, None] * w).astype(np.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32 with the bits of uint32 words
    (bit j of word w is column 32w+j)."""
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(n, N_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _check_inputs(packed, corner_y, corner_x):
    if packed.dtype != torch.bfloat16 or packed.dim() != 2:
        raise ValueError(f"packed must be 2-D bf16, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if packed.shape[0] < PATCH or packed.shape[1] < PATCH:
        raise ValueError(f"packed {tuple(packed.shape)} smaller than a patch")
    for name, t in (("corner_y", corner_y), ("corner_x", corner_x)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != packed.device:
            raise ValueError(f"{name} on {t.device}, packed on {packed.device}")
    if corner_y.shape != corner_x.shape:
        raise ValueError("corner_y and corner_x differ in shape")


def orb_describe_reference(packed: torch.Tensor, corner_y: torch.Tensor,
                           corner_x: torch.Tensor):
    """Plain PyTorch version of the kernel: gather the 40x40 patches,
    IC-angle moments, angle, bin, pair lookup, bit pack. Corners are
    clamped into the buffer, as the kernel clamps them."""
    _check_inputs(packed, corner_y, corner_x)
    dev = packed.device
    R, Wp = packed.shape
    n = corner_y.shape[0]
    cy = corner_y.long().clamp(0, R - PATCH)
    cx = corner_x.long().clamp(0, Wp - PATCH)
    off = torch.arange(PATCH, device=dev)
    flat = ((cy[:, None, None] + off[None, :, None]) * Wp
            + cx[:, None, None] + off[None, None, :])
    p = packed.reshape(-1)[flat.reshape(-1)].float().reshape(n, PATCH * PATCH)
    wx, wy = (torch.from_numpy(w).to(dev).reshape(-1) for w in _moment_weights())
    m10 = (p * wx).sum(-1)
    m01 = (p * wy).sum(-1)
    ang = torch.atan2(m01, m10)
    bins = torch.remainder(torch.round(ang * (N_BINS / (2.0 * np.pi))).long(),
                           N_BINS)
    q = torch.clamp(torch.round(p) - 128.0, -128.0, 127.0)
    table = torch.from_numpy(pair_table().astype(np.int64)).to(dev)[bins]
    v1 = torch.gather(q, 1, table[:, :, 0])
    v2 = torch.gather(q, 1, table[:, :, 1])
    return ang, pack_bits(v1 < v2)


class _Library:
    """The loaded kernel library: ctypes handle, its file, nvcc's output
    when this process built it, and the devices holding the pair table."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str):
        self.lib = lib
        self.path = path
        self.log = log
        self.table_devices: set[int] = set()


_LIB: _Library | None = None


def _nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit under CUDA_HOME."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    return shutil.which("nvcc") or str(home / "bin" / "nvcc")


def build() -> _Library:
    """Build (if needed) and load the kernel library; cached per process.
    A failed build raises with nvcc's stderr."""
    global _LIB
    if _LIB is not None:
        return _LIB
    code = _SOURCE.read_bytes()
    key = hashlib.sha256(code + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"orb_describe-{key}.so"
    log = ""
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed with code {r.returncode}:\n{r.stderr}")
        log = r.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.orb_describe_upload_table.argtypes = [ctypes.c_void_p]
    lib.orb_describe_upload_table.restype = ctypes.c_int
    lib.orb_describe_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.orb_describe_launch.restype = ctypes.c_int
    lib.orb_describe_error_string.argtypes = [ctypes.c_int]
    lib.orb_describe_error_string.restype = ctypes.c_char_p
    _LIB = _Library(lib, so, log)
    return _LIB


def _raise_on(lib: _Library, code: int, what: str):
    if code != 0:
        msg = lib.lib.orb_describe_error_string(code).decode()
        raise RuntimeError(f"orb_describe {what} failed: CUDA error {code} ({msg})")


def _launch(packed, corner_y, corner_x):
    for t in (packed, corner_y, corner_x):
        if not t.is_contiguous():
            raise ValueError("orb_describe needs contiguous tensors")
    lib = build()
    dev = packed.device
    with torch.cuda.device(dev):
        if dev.index not in lib.table_devices:
            table = np.ascontiguousarray(pair_table())
            _raise_on(lib, lib.lib.orb_describe_upload_table(
                table.ctypes.data), "table upload")
            lib.table_devices.add(dev.index)
        n = corner_y.shape[0]
        angle = torch.empty((n,), dtype=torch.float32, device=dev)
        desc = torch.empty((n, N_WORDS), dtype=torch.int32, device=dev)
        code = lib.lib.orb_describe_launch(
            packed.data_ptr(), packed.shape[0], packed.shape[1],
            corner_y.data_ptr(), corner_x.data_ptr(), n,
            angle.data_ptr(), desc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(lib, code, "launch")
    if n:
        orb_describe.launches += 1
    return angle, desc


def orb_describe(packed: torch.Tensor, corner_y: torch.Tensor,
                 corner_x: torch.Tensor):
    """(angle f32 [N], desc int32 [N,8]) for keypoints with patch corners
    (corner_y, corner_x) in the packed bf16 pyramid. CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    _check_inputs(packed, corner_y, corner_x)
    if packed.device.type == "cuda":
        return _launch(packed, corner_y, corner_x)
    if packed.device.type == "cpu":
        return orb_describe_reference(packed, corner_y, corner_x)
    raise ValueError(f"orb_describe: unsupported device {packed.device}")


orb_describe.launches = 0
