"""Stereo left-right keypoint matching with subpixel refinement (port of
splslam_tpu/ops/stereo.py).

  1. all-pairs Hamming distances, masked by epipolar row distance, octave
     compatibility and the [0, fx] disparity window;
  2. row-wise argmin;
  3. SSD refinement: an 11x11 window slid +-5 steps (in keypoint-octave
     scale units) over nearest-integer samples of the right image, with a
     parabola fit at the minimum (reference src/Frame.cc:966-1038);
  4. outlier rejection at 1.5*1.4*median SSD (reference :1041-1054).

`depth_from_rgbd` is the RGB-D counterpart: depth read from the
registered depth image, a virtual right coordinate from it.
`bilinear_sample` and `masked_median` are the module's public helpers.

The reference picks its samples with one-hot column matmuls over
128-wide row tiles (a TPU gather workaround). Here the same samples are
read with plain indexing: every column is clamped into the tile the
reference would have loaded, and pixels are read as bf16, as the
reference reads them.
"""

from __future__ import annotations

import torch

from splslam_tpu_torch.ops.match import (
    TH_HIGH,
    hamming,
    masked_distances,
    nn_match,
    octave_mask,
)
from splslam_tpu_torch.trace import span

_W = 5      # correlation half-window (11x11 patch, reference w=5)
_R = 5      # search half-range in scaled pixels (reference L=5)
_TILE, _STRIDE = 128, 32  # the reference's sample tiles (see module doc)


def bilinear_sample(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample image (H,W) at fractional coords xy (...,2) -> (...);
    coordinates are clamped to [0, W-1.001] x [0, H-1.001]."""
    H, W = image.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    flat = image.reshape(-1)
    base = (y0 * W + x0).long()
    return (flat[base] * (1 - fx) * (1 - fy) + flat[base + 1] * fx * (1 - fy)
            + flat[base + W] * (1 - fx) * fy + flat[base + W + 1] * fx * fy)


def masked_median(values: torch.Tensor, mask: torch.Tensor,
                  fill: float = float("inf")) -> torch.Tensor:
    """Median of values[mask] without a data-dependent shape."""
    n = torch.sum(mask)
    s = torch.sort(torch.where(mask, values, fill)).values
    # a 1-d index gathers on the device (a 0-dim one is read back)
    return s[torch.clamp(n // 2, 0, values.shape[0] - 1)[None]][0]


def _sample_cols(centers, s, offs, W: int):
    """Integer sample columns [N, C] of the reference's tiled pick: the
    nearest pixel to center + s*off, clamped to the image and then to the
    128-wide tile starting at 32*clip((round(center) - 36) // 32)."""
    nt = -(-W // _STRIDE)
    tj = torch.clamp(torch.div(torch.round(centers).to(torch.int32) - 36,
                               _STRIDE, rounding_mode="floor"), 0, nt - 1)
    t0 = (tj * _STRIDE)[:, None]
    idx = torch.clamp(torch.round(centers[:, None] + s[:, None] * offs[None, :]),
                      0, W - 1).to(torch.int32)
    return t0 + torch.clamp(idx - t0, 0, _TILE - 1)


@span("frame.stereo")
def stereo_match(featL, featR, imgL: torch.Tensor, imgR: torch.Tensor,
                 scales: torch.Tensor, bf: float, fx: float):
    """Match left ORB features to right, refine disparity, return depth.

    featL/featR: OrbFeatures (level-0 coords). scales: [n_levels] f32.
    Returns (u_right [N], depth [N]) with -1 where no valid stereo match
    (the reference's mvuRight/mvDepth convention)."""
    dev = imgL.device
    dist = hamming(featL.desc, featR.desc)
    sL = scales[featL.octave.long()]
    sR = scales[featR.octave.long()]
    row_r = 2.0 * torch.maximum(sL[:, None], sR[None, :])
    row_ok = torch.abs(featL.xy[:, 1:2] - featR.xy[None, :, 1]) <= row_r
    oct_ok = octave_mask(featL.octave, featR.octave, -1, 1)
    disp = featL.xy[:, 0:1] - featR.xy[None, :, 0]
    disp_ok = (disp > -3.0) & (disp < fx)

    d = masked_distances(dist, featL.valid, featR.valid,
                         row_ok & oct_ok & disp_ok)
    best, _ = nn_match(d, max_dist=TH_HIGH)
    matched = best >= 0
    bi = best.clamp(min=0).long()

    s = sL
    H, W = imgL.shape
    dy = torch.arange(-_W, _W + 1, dtype=torch.float32, device=dev)
    dxs = torch.arange(-_W - _R, _W + _R + 1, dtype=torch.float32, device=dev)
    cL = featL.xy
    uR0 = featR.xy[bi, 0]
    ry = torch.clamp(torch.round(cL[:, 1:2] + s[:, None] * dy[None, :])
                     .to(torch.int32), 0, H - 1).long()            # [N,11]
    colL = _sample_cols(cL[:, 0], s, dy, W).long()                # [N,11]
    colR = _sample_cols(uR0, s, dxs, W).long()                    # [N,21]
    bfL = imgL.to(torch.bfloat16).float()
    bfR = imgR.to(torch.bfloat16).float()
    patchL = bfL[ry[:, :, None], colL[:, None, :]]                # [N,11,11]
    strip = bfR[ry[:, :, None], colR[:, None, :]]                 # [N,11,21]

    # IC normalization: subtract the window center value (reference :989).
    patchL = patchL - patchL[:, _W, _W][:, None, None]
    wins = strip.unfold(2, 2 * _W + 1, 1).permute(0, 2, 1, 3)     # [N,11s,11r,11c]
    wins = wins - wins[:, :, _W, _W][:, :, None, None]
    ssd = torch.sum((wins - patchL[:, None]) ** 2, dim=(2, 3))    # [N,11]

    rows = torch.arange(ssd.shape[0], device=dev)
    best_s = torch.argmin(ssd, dim=1)
    bd = ssd[rows, best_s]
    interior = (best_s > 0) & (best_s < 2 * _R)
    bm1 = ssd[rows, torch.clamp(best_s - 1, min=0)]
    bp1 = ssd[rows, torch.clamp(best_s + 1, 0, 2 * _R)]
    denom = bm1 + bp1 - 2.0 * bd
    delta = torch.where(torch.abs(denom) > 1e-6,
                        (bm1 - bp1) / (2.0 * denom), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    shift = (best_s.float() - _R) + torch.where(interior, delta, 0.0)

    u_right = uR0 + s * shift
    disparity = cL[:, 0] - u_right
    ok = matched & (disparity > 0.01) & (disparity < fx)
    med = masked_median(bd, ok)
    ok = ok & (bd <= 1.5 * 1.4 * med)
    depth = torch.where(ok, bf / torch.clamp(disparity, min=1e-6), -1.0)
    u_right = torch.where(ok, u_right, -1.0)
    return u_right, depth


@span("frame.stereo")
def depth_from_rgbd(feat, depth_map: torch.Tensor, bf: float,
                    depth_factor: float = 1.0):
    """RGB-D variant (reference Frame::ComputeStereoFromRGBD): read the
    depth image at each keypoint (coordinates truncated, then clamped to
    the image), scale it by `depth_factor` and synthesize a virtual right
    coordinate. Returns (u_right [N], depth [N]), -1 where the depth is
    not positive or the slot is invalid."""
    xy = feat.xy.to(torch.int32)
    H, W = depth_map.shape
    idx = xy[:, 1].clamp(0, H - 1) * W + xy[:, 0].clamp(0, W - 1)
    d = depth_map.reshape(-1)[idx.long()] * depth_factor
    ok = feat.valid & (d > 0)
    u_right = torch.where(ok, feat.xy[:, 0] - bf / torch.clamp(d, min=1e-6), -1.0)
    return u_right, torch.where(ok, d, -1.0)
