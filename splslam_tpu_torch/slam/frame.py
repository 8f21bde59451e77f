"""Per-frame feature container and the stereo frame builder (port of
splslam_tpu/slam/frame.py, stereo subset)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops.lines import LineFeatures
from splslam_tpu_torch.ops.orb import OrbFeatures, extract_orb
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.ops.stereo import stereo_match

LINES_LATER = "line pipeline: later slice"


class FrameData(NamedTuple):
    """One frame's device-side state (points; the line table is empty)."""

    feat: OrbFeatures
    u_right: torch.Tensor  # [N] refined right-image x, -1 if no stereo match
    depth: torch.Tensor    # [N] stereo depth, -1 if unknown
    lines: LineFeatures    # capacity-1 empty table on this slice


def build_frame_stereo(
    img_left: torch.Tensor,
    img_right: torch.Tensor,
    cam: Camera,
    spec: PyramidSpec,
    line_capacity: int = 1,
) -> FrameData:
    """Stereo frame: ORB on both images + row-constrained stereo matching
    with subpixel disparity (reference Frame ctor src/Frame.cc:99-155).
    Points only: the reference keeps stereo point-only
    (src/Tracking.cc:321-323)."""
    if line_capacity > 1:
        raise NotImplementedError(LINES_LATER)
    feat_l = extract_orb(img_left, spec)
    feat_r = extract_orb(img_right, spec)
    scales = torch.tensor(spec.scales, dtype=torch.float32,
                          device=img_left.device)
    u_right, depth = stereo_match(feat_l, feat_r, img_left, img_right,
                                  scales, cam.bf, cam.fx)
    return FrameData(feat=feat_l, u_right=u_right, depth=depth,
                     lines=LineFeatures.empty(line_capacity, img_left.device))
