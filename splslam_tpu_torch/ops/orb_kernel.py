"""ORB orientation + descriptors for the keypoints of one or two images:
the hand-written Hopper kernel `csrc/orb_describe.cu`, its plain PyTorch
version, and the wrapper that picks between them by device.

Replaces the TPU kernel `splslam_tpu/ops/orb_pallas.py::extract_patches`
plus the XLA stage `describe_from_patches` that consumes its patches,
together with the blur, packing and corner arithmetic that feed them in
`splslam_tpu/ops/orb.py::extract_orb`.

Inputs: B images (B = 1 or 2), each as its list of UNBLURRED float32
pyramid levels (`build_pyramid`), the detections `xy` f32 [B, N, 2] in
level coordinates with N = `spec.total_capacity` (slot k belongs to the
level whose budget range holds k), and the `PyramidSpec`. Outputs are
`angle` f32 [B, N] and `desc` int32 [B, N, 8] (the bits of the
reference's uint32 words; bit j of word w is test 32w+j), for every slot,
valid or not.

The spec is the plain version: blur each level (`gaussian_blur`), pack
the levels as the reference packs them (row-wise, width lane-padded, 8
zero rows, 256 zero columns, bf16), clamp each slot's 40x40 patch corner
into that buffer, then gather the patch, take the IC moments, the angle,
its bin, the 256 steered tests and pack the bits. The kernel computes
the same numbers without building the packed buffer.

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
import torch.nn.functional as F

from splslam_tpu_torch.ops.orb import make_pattern
from splslam_tpu_torch.ops.pyramid import BLUR_TAPS, PyramidSpec, gaussian_blur

PATCH = 40   # rotated BRIEF offsets reach +-19 px (pattern radius 13*sqrt2)
C = 19       # patch centre; equals the detector's EDGE_THRESHOLD border
R_C = 15     # IC-angle circle radius (reference HALF_PATCH_SIZE)
N_BINS = 30  # pattern rotation bins (ORB paper: 2*pi/30 increments)
N_WORDS = 8
PAD_ROWS = 8       # zero rows under the packed levels (reference packing)
PAD_COLS = 256     # zero columns right of the lane-padded width
MAX_IMAGES = 2     # the kernel's limits (csrc/orb_describe.cu kMaxImages,
MAX_LEVELS = 16    # kMaxLevels)

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


def _lane_pad(w: int) -> int:
    return -(-w // 128) * 128


def pack_pyramid(levels, spec: PyramidSpec):
    """The reference's packed blurred pyramid (`splslam_tpu/ops/orb.py`,
    `extract_orb`): levels blurred, stacked row-wise at the lane-padded
    width, 8 zero rows below, 256 zero columns right, bf16. Returns
    (packed [sum H + 8, Wp + 256], row_off: each level's first row)."""
    dev = levels[0].device
    Wp = _lane_pad(spec.sizes[0][1])
    rows, row_off, acc = [], [], 0
    for lv, img in enumerate(levels):
        H, W = spec.sizes[lv]
        rows.append(F.pad(gaussian_blur(img), (0, Wp - W)))
        row_off.append(acc)
        acc += H
    packed = torch.cat(
        rows + [torch.zeros((PAD_ROWS, Wp), dtype=torch.float32, device=dev)])
    return F.pad(packed, (0, PAD_COLS)).to(torch.bfloat16), row_off


def patch_corners(xy: torch.Tensor, spec: PyramidSpec, row_off):
    """int32 (corner_y, corner_x) of every slot's 40x40 patch in the
    packed buffer, clamped as the reference clamps them; slot k belongs
    to the level whose budget range holds k."""
    acc = sum(h for h, _ in spec.sizes)
    Wp = _lane_pad(spec.sizes[0][1])
    cys, cxs = [], []
    i0 = 0
    for lv, budget in enumerate(spec.budgets):
        if budget == 0:
            continue
        xi = xy[i0:i0 + budget].to(torch.int32)
        cys.append(torch.clamp(xi[:, 1] - C + row_off[lv], 0, acc - PATCH))
        cxs.append(torch.clamp(xi[:, 0] - C, 0, Wp - PATCH))
        i0 += budget
    return torch.cat(cys).contiguous(), torch.cat(cxs).contiguous()


def describe_packed(packed: torch.Tensor, corner_y: torch.Tensor,
                    corner_x: torch.Tensor):
    """Gather the 40x40 patches of the packed bf16 buffer, IC-angle
    moments, angle, bin, pair lookup, bit pack. Corners are clamped into
    the buffer. Returns (angle f32 [N], desc int32 [N, 8])."""
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


def _check_inputs(levels, xy, spec: PyramidSpec):
    if not isinstance(xy, torch.Tensor) or xy.dtype != torch.float32 \
            or xy.dim() != 3 or xy.shape[2] != 2:
        raise ValueError("xy must be a float32 [B, N, 2] tensor")
    if xy.shape[1] != spec.total_capacity:
        raise ValueError(f"xy has {xy.shape[1]} slots, the spec "
                         f"{spec.total_capacity}")
    if not 1 <= len(levels) <= MAX_IMAGES or len(levels) != xy.shape[0]:
        raise ValueError(f"{len(levels)} pyramids for xy of batch "
                         f"{xy.shape[0]}; 1 or 2 images are taken")
    for pyr in levels:
        if len(pyr) != spec.n_levels:
            raise ValueError(f"{len(pyr)} levels, the spec {spec.n_levels}")
        for lv, t in enumerate(pyr):
            if t.dtype != torch.float32 or tuple(t.shape) != tuple(spec.sizes[lv]):
                raise ValueError(f"level {lv} must be float32 "
                                 f"{tuple(spec.sizes[lv])}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if t.device != xy.device:
                raise ValueError(f"level {lv} on {t.device}, xy on {xy.device}")
    if sum(h for h, _ in spec.sizes) + PAD_ROWS < PATCH:
        raise ValueError(f"pyramid {spec.sizes} smaller than a patch")


def orb_describe_reference(levels, xy: torch.Tensor, spec: PyramidSpec):
    """Plain PyTorch version of the kernel: per image, `pack_pyramid`,
    `patch_corners`, `describe_packed`. Returns (angle f32 [B, N], desc
    int32 [B, N, 8])."""
    _check_inputs(levels, xy, spec)
    angs, descs = [], []
    for pyr, pts in zip(levels, xy):
        packed, row_off = pack_pyramid(pyr, spec)
        cy, cx = patch_corners(pts, spec, row_off)
        a, d = describe_packed(packed, cy, cx)
        angs.append(a)
        descs.append(d)
    return torch.stack(angs), torch.stack(descs)


class _Library:
    """The loaded kernel library: ctypes handle, its file, nvcc's output
    when this process built it, and each device's copy of the pair
    table."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str):
        self.lib = lib
        self.path = path
        self.log = log
        self.tables: dict[torch.device, torch.Tensor] = {}

    def table(self, dev: torch.device) -> torch.Tensor:
        """int32 [N_BINS * 256] on `dev`: sample 1's offset in the low 16
        bits of each pair's word, sample 2's in the high 16."""
        if dev not in self.tables:
            t = pair_table().astype(np.uint32)
            words = (t[..., 0] | (t[..., 1] << 16)).view(np.int32).reshape(-1)
            self.tables[dev] = torch.from_numpy(words.copy()).to(dev)
        return self.tables[dev]


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
    lib.orb_describe_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.orb_describe_launch.restype = ctypes.c_int
    lib.orb_describe_occupancy.argtypes = []
    lib.orb_describe_occupancy.restype = ctypes.c_int
    lib.orb_describe_error_string.argtypes = [ctypes.c_int]
    lib.orb_describe_error_string.restype = ctypes.c_char_p
    _LIB = _Library(lib, so, log)
    return _LIB


def _raise_on(lib: _Library, code: int, what: str):
    if code != 0:
        msg = lib.lib.orb_describe_error_string(code).decode()
        raise RuntimeError(f"orb_describe {what} failed: CUDA error {code} ({msg})")


def _launch(levels, xy: torch.Tensor, spec: PyramidSpec):
    if spec.n_levels > MAX_LEVELS:
        raise ValueError(f"the kernel takes at most {MAX_LEVELS} levels")
    if not xy.is_contiguous() or not all(t.is_contiguous()
                                         for pyr in levels for t in pyr):
        raise ValueError("orb_describe needs contiguous tensors")
    lib = build()
    dev = xy.device
    B, n = xy.shape[0], xy.shape[1]
    ptrs = np.array([t.data_ptr() for pyr in levels for t in pyr], np.uint64)
    dims = np.array(spec.sizes, np.int32).reshape(-1)      # H0, W0, H1, W1, ...
    budgets = np.array(spec.budgets, np.int32)
    taps = np.array(BLUR_TAPS, np.float32)
    with torch.cuda.device(dev):
        angle = torch.empty((B, n), dtype=torch.float32, device=dev)
        desc = torch.empty((B, n, N_WORDS), dtype=torch.int32, device=dev)
        if n == 0:
            return angle, desc
        code = lib.lib.orb_describe_launch(
            ptrs.ctypes.data, dims.ctypes.data, budgets.ctypes.data,
            spec.n_levels, taps.ctypes.data, B, n, xy.data_ptr(),
            lib.table(dev).data_ptr(), angle.data_ptr(), desc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(lib, code, "launch")
    orb_describe.launches += 1
    return angle, desc


def orb_describe(levels, xy: torch.Tensor, spec: PyramidSpec):
    """(angle f32 [B, N], desc int32 [B, N, 8]) for the slots `xy` f32
    [B, N, 2] (level coordinates) of B = 1 or 2 images, each given as its
    list of unblurred float32 pyramid levels. CUDA tensors launch the
    kernel (one launch for all B images); CPU tensors take the plain
    version."""
    _check_inputs(levels, xy, spec)
    if xy.device.type == "cuda":
        return _launch(levels, xy, spec)
    if xy.device.type == "cpu":
        return orb_describe_reference(levels, xy, spec)
    raise ValueError(f"orb_describe: unsupported device {xy.device}")


orb_describe.launches = 0
