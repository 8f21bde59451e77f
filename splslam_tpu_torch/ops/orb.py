"""Multi-level ORB extraction (port of splslam_tpu/ops/orb.py::extract_orb).

Detection (pyramid, dense FAST + NMS, grid top-k) runs per level in
plain PyTorch. Orientation and descriptors for all levels, of one image
or of both images of a stereo frame, run in one call of
`ops.orb_kernel.orb_describe` on the unblurred levels and the
detections (the CUDA kernel on a GPU, its plain version on the CPU; the
blur, the reference's packing and the corner clamping are part of that
call).

`OrbFeatures` drops the reference's `bits` field: the +-1 bit planes
exist there only to feed TPU matrix-unit matmuls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from splslam_tpu_torch.ops.fast import fast_corners, inside_mask
from splslam_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid
from splslam_tpu_torch.ops.topk import grid_topk
from splslam_tpu_torch.trace import Span, span

HALF_PATCH = 15          # orientation patch radius (reference HALF_PATCH_SIZE)
EDGE_THRESHOLD = 19      # border excluded from detection (reference :47)
N_BITS = 256
_DESCRIBE = Span("frame.orb.describe")


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


@span("frame.orb.detect")
def detect(
    image: torch.Tensor,
    spec: PyramidSpec,
    threshold: float = 12.0,
    cell: int = 16,
    cell_k: int = 4,
):
    """Detection for one image (H,W) f32. Returns (levels, det): the
    unblurred pyramid levels and, per level with a budget, (level, xy,
    response, valid) with xy in level coordinates; the concatenated xy
    are the descriptor stage's slots, in order."""
    dev = image.device
    levels = build_pyramid(image, spec)
    det = []
    b = EDGE_THRESHOLD
    for lv, img in enumerate(levels):
        if spec.budgets[lv] == 0:
            continue
        H, W = spec.sizes[lv]
        score = fast_corners(img, threshold)
        score = torch.where(inside_mask(H, W, b, dev), score, 0.0)
        xy, resp, valid = grid_topk(score, spec.budgets[lv], cell=cell,
                                    cell_k=cell_k)
        det.append((lv, xy, resp, valid))
    return levels, det


def _features(det, spec: PyramidSpec, ang: torch.Tensor,
              desc: torch.Tensor) -> OrbFeatures:
    dev = ang.device
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


@span("frame.orb")
def _extract_orb(images, spec: PyramidSpec, threshold: float, cell: int,
                 cell_k: int) -> list[OrbFeatures]:
    """ORB for one or two grayscale images (H,W) f32: detection per image,
    then orientation and descriptors of all of them in one
    `orb_describe` call (one kernel launch on a GPU)."""
    from splslam_tpu_torch.ops.orb_kernel import orb_describe

    found = [detect(im, spec, threshold, cell, cell_k) for im in images]
    xy = torch.stack([torch.cat([d[1] for d in det]) for _, det in found])
    with _DESCRIBE:
        ang, desc = orb_describe([levels for levels, _ in found], xy, spec)
        return [_features(det, spec, ang[b], desc[b])
                for b, (_, det) in enumerate(found)]


def extract_orb(
    image: torch.Tensor,
    spec: PyramidSpec,
    threshold: float = 12.0,
    cell: int = 16,
    cell_k: int = 4,
) -> OrbFeatures:
    """Full multi-level ORB extraction for one grayscale image (H,W) f32."""
    return _extract_orb([image], spec, threshold, cell, cell_k)[0]


def extract_orb_pair(left: torch.Tensor, right: torch.Tensor,
                     spec: PyramidSpec, threshold: float = 12.0,
                     cell: int = 16, cell_k: int = 4):
    """ORB for both images of a stereo frame, described in one call.
    Returns (left features, right features)."""
    return tuple(_extract_orb([left, right], spec, threshold, cell, cell_k))
