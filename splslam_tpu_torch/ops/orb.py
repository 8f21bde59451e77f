"""Multi-level ORB extraction (port of splslam_tpu/ops/orb.py::extract_orb).

Detection (pyramid, dense FAST + NMS, grid top-k) runs per level in
plain PyTorch. Orientation and descriptors for all levels run in one
call of `ops.orb_kernel.orb_describe` over the packed blurred pyramid
(the CUDA kernel on a GPU, its plain version on the CPU). The packing
(levels stacked row-wise, bf16, 8 pad rows, 256 pad columns) and the
corner clamping are the reference's, so both implementations take
identical arguments.

`OrbFeatures` drops the reference's `bits` field: the +-1 bit planes
exist there only to feed TPU matrix-unit matmuls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from splslam_tpu_torch.ops.fast import fast_corners
from splslam_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid, gaussian_blur
from splslam_tpu_torch.ops.topk import grid_topk

HALF_PATCH = 15          # orientation patch radius (reference HALF_PATCH_SIZE)
EDGE_THRESHOLD = 19      # border excluded from detection (reference :47)
N_BITS = 256


def make_pattern(seed: int = 7) -> np.ndarray:
    """(256, 4) int8 test-pair pattern [x1,y1,x2,y2], Gaussian sigma=patch/5,
    clipped to the 31x31 patch. Fixed seed => reproducible descriptors."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, (2 * HALF_PATCH + 1) / 5.0, size=(N_BITS, 4))
    pts = np.clip(np.round(pts), -HALF_PATCH + 2, HALF_PATCH - 2)
    return pts.astype(np.int8)


class OrbFeatures(NamedTuple):
    """Fixed-capacity struct-of-arrays keypoint table (one frame)."""

    xy: torch.Tensor        # [N,2] f32, level-0 pixel coords [x, y]
    response: torch.Tensor  # [N] f32
    angle: torch.Tensor     # [N] f32 radians
    octave: torch.Tensor    # [N] int32
    sigma2: torch.Tensor    # [N] f32 scale^2 of the level (for chi2 gates)
    desc: torch.Tensor      # [N, 8] int32: the bits of 8 uint32 words
    valid: torch.Tensor     # [N] bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def _lane_pad(w: int) -> int:
    return -(-w // 128) * 128


def detect_and_pack(
    image: torch.Tensor,
    spec: PyramidSpec,
    threshold: float = 12.0,
    cell: int = 16,
    cell_k: int = 4,
):
    """Detection plus the descriptor kernel's inputs. Returns (det,
    packed, corner_y, corner_x): per-level (level, xy, response, valid)
    detections, the packed bf16 blurred pyramid and the int32 patch
    corners of all detections, in order."""
    from splslam_tpu_torch.ops.orb_kernel import C, PATCH

    dev = image.device
    levels = build_pyramid(image, spec)
    Wp = _lane_pad(spec.sizes[0][1])
    det = []
    blur_rows = []
    row_off = []
    acc = 0
    b = EDGE_THRESHOLD
    for lv, img in enumerate(levels):
        H, W = spec.sizes[lv]
        blur_rows.append(F.pad(gaussian_blur(img), (0, Wp - W)))
        row_off.append(acc)
        acc += H
        if spec.budgets[lv] == 0:
            continue
        score = fast_corners(img, threshold)
        inside = torch.zeros((H, W), dtype=torch.bool, device=dev)
        inside[b:H - b, b:W - b] = True
        score = torch.where(inside, score, 0.0)
        xy, resp, valid = grid_topk(score, spec.budgets[lv], cell=cell,
                                    cell_k=cell_k)
        det.append((lv, xy, resp, valid))
    packed = torch.cat(
        blur_rows + [torch.zeros((8, Wp), dtype=torch.float32, device=dev)]
    )
    packed = F.pad(packed, (0, 256)).to(torch.bfloat16)

    cys, cxs = [], []
    for (lv, xy, _, _) in det:
        xi = xy.to(torch.int32)
        cys.append(torch.clamp(xi[:, 1] - C + row_off[lv], 0, acc - PATCH))
        cxs.append(torch.clamp(xi[:, 0] - C, 0, Wp - PATCH))
    return det, packed, torch.cat(cys).contiguous(), torch.cat(cxs).contiguous()


def extract_orb(
    image: torch.Tensor,
    spec: PyramidSpec,
    threshold: float = 12.0,
    cell: int = 16,
    cell_k: int = 4,
) -> OrbFeatures:
    """Full multi-level ORB extraction for one grayscale image (H,W) f32."""
    from splslam_tpu_torch.ops.orb_kernel import orb_describe

    dev = image.device
    det, packed, corner_y, corner_x = detect_and_pack(image, spec, threshold,
                                                      cell, cell_k)
    ang, desc = orb_describe(packed, corner_y, corner_x)

    outs = []
    i0 = 0
    for (lv, xy, resp, valid) in det:
        budget = xy.shape[0]
        sl = slice(i0, i0 + budget)
        outs.append(OrbFeatures(
            xy=xy * spec.scales[lv],
            response=resp,
            angle=ang[sl],
            octave=torch.full((budget,), lv, dtype=torch.int32, device=dev),
            sigma2=torch.full((budget,), spec.sigma2[lv], dtype=torch.float32,
                              device=dev),
            desc=desc[sl],
            valid=valid,
        ))
        i0 += budget
    return OrbFeatures(*[torch.cat(xs, dim=0) for xs in zip(*outs)])
