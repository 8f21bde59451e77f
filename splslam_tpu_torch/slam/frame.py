"""Per-frame feature container and the frame builders (port of
splslam_tpu/slam/frame.py: monocular, stereo and RGB-D)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from splslam_tpu_torch.geometry.camera import Camera, undistort_points
from splslam_tpu_torch.ops.lines import LineFeatures, extract_lines
from splslam_tpu_torch.ops.orb import OrbFeatures, extract_orb, extract_orb_pair
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.ops.stereo import depth_from_rgbd, stereo_match

# (backend, n_octaves, min_length) of the line detector: the reference's
# System.usingLsdFeature, Lineextractor.nLevels and min_line_length_ratio
LINE_CFG = ("grow", 2, 24.0)


class FrameData(NamedTuple):
    """One frame's device-side state (points; lines optional/empty)."""

    feat: OrbFeatures
    u_right: torch.Tensor  # [N] refined right-image x, -1 if no stereo match
    depth: torch.Tensor    # [N] stereo depth, -1 if unknown
    lines: LineFeatures    # fixed-capacity line table (all invalid if unused)

    @property
    def n(self) -> int:
        """The keypoint table's capacity."""
        return self.feat.capacity


def _lines(image: torch.Tensor, line_capacity: int, line_cfg: tuple) -> LineFeatures:
    return extract_lines(image, capacity=line_capacity, backend=line_cfg[0],
                         n_octaves=line_cfg[1], min_length=line_cfg[2])


def build_frame_mono(
    image: torch.Tensor,
    cam: Camera,
    spec: PyramidSpec,
    undistort: bool = False,
    with_lines: bool = False,
    line_capacity: int = 128,
    line_cfg: tuple = LINE_CFG,
) -> FrameData:
    """Monocular frame: ORB (one image, one kernel launch on a GPU) and,
    with `with_lines`, the line table (reference Frame ctor with the
    point and line extractors, src/Frame.cc:299-312). With `undistort`,
    keypoints and segment endpoints are undistorted."""
    feat = extract_orb(image, spec)
    if undistort:
        feat = feat._replace(xy=undistort_points(cam, feat.xy))
    n = feat.capacity
    if with_lines:
        lines = _lines(image, line_capacity, line_cfg)
        if undistort:
            p1 = undistort_points(cam, lines.seg[:, :2])
            p2 = undistort_points(cam, lines.seg[:, 2:4])
            lines = lines.with_segments(torch.cat([p1, p2], dim=-1))
    else:
        lines = LineFeatures.empty(line_capacity, image.device)
    minus1 = torch.full((n,), -1.0, device=image.device)
    return FrameData(feat=feat, u_right=minus1, depth=minus1.clone(), lines=lines)


def build_frame_stereo(
    img_left: torch.Tensor,
    img_right: torch.Tensor,
    cam: Camera,
    spec: PyramidSpec,
    scales: torch.Tensor,
    line_capacity: int = 8,
    line_cfg: tuple = LINE_CFG,
) -> FrameData:
    """Stereo frame: ORB on both images (described together, one kernel
    launch on a GPU) + row-constrained stereo matching with subpixel
    disparity (reference Frame ctor src/Frame.cc:99-155). The reference
    keeps stereo point-only (src/Tracking.cc:321-323); a line_capacity > 1
    extracts lines from the left image, as the default 8 (the JAX
    package's) does; `System` passes 1 when lines are off. `scales`: the
    pyramid's scale factors, already on the images' device (a host list
    copied here would make every frame wait for the card)."""
    feat_l, feat_r = extract_orb_pair(img_left, img_right, spec)
    u_right, depth = stereo_match(feat_l, feat_r, img_left, img_right,
                                  scales, cam.bf, cam.fx)
    lines = (_lines(img_left, line_capacity, line_cfg) if line_capacity > 1
             else LineFeatures.empty(line_capacity, img_left.device))
    return FrameData(feat=feat_l, u_right=u_right, depth=depth, lines=lines)


def build_frame_rgbd(
    image: torch.Tensor,
    depth_map: torch.Tensor,
    cam: Camera,
    spec: PyramidSpec,
    depth_factor: float = 1.0,
    line_capacity: int = 8,
    line_cfg: tuple = LINE_CFG,
) -> FrameData:
    """RGB-D frame (reference Frame ctor src/Frame.cc:157-210): ORB on the
    one image (one kernel launch on a GPU), the registered depth read at
    each keypoint, and lines when line_capacity > 1. Keypoints are not
    undistorted, as in the JAX package (ROADMAP C)."""
    feat = extract_orb(image, spec)
    u_right, depth = depth_from_rgbd(feat, depth_map, cam.bf, depth_factor)
    lines = (_lines(image, line_capacity, line_cfg) if line_capacity > 1
             else LineFeatures.empty(line_capacity, image.device))
    return FrameData(feat=feat, u_right=u_right, depth=depth, lines=lines)
