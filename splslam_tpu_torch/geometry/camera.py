"""Pinhole camera intrinsics (port of splslam_tpu/geometry/camera.py).

The port keeps the intrinsics as Python floats, each rounded to float32
at creation, so arithmetic against float32 tensors sees exactly the
values the reference stores as f32 scalars. `project` / `project_world`
are the pinhole projection (the pipeline works on undistorted
keypoints), `undistort_points` inverts the radial-tangential model for
monocular frames with distortion.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


class Camera(NamedTuple):
    """Intrinsics + distortion + stereo baseline (`bf` = baseline * fx)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    bf: float
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               bf=0.0, width=640, height=480) -> "Camera":
        return Camera(_f32(fx), _f32(fy), _f32(cx), _f32(cy), _f32(k1),
                      _f32(k2), _f32(p1), _f32(p2), _f32(k3), _f32(bf),
                      int(width), int(height))

    @property
    def K(self) -> torch.Tensor:
        """The 3x3 float32 intrinsic matrix (on the CPU)."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)

    @property
    def has_distortion(self) -> bool:
        """True, as in the JAX package: whether a frame is undistorted is
        decided by the caller's settings (`Settings.has_distortion`)."""
        return True


def project(cam: Camera, pts_cam: torch.Tensor):
    """Camera-frame 3D points (N,3) -> pixel coords (N,2), depth (N,).
    Pure pinhole (no distortion); depths within 1e-6 of 0 divide by 1e-6."""
    z = pts_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = cam.fx * pts_cam[..., 0] / z_safe + cam.cx
    v = cam.fy * pts_cam[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1), z


def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (N,2) + depth (N,) -> camera-frame 3D points (N,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def project_world(cam: Camera, Tcw: torch.Tensor, pts_w: torch.Tensor):
    """World points (N,3) through pose Tcw (4,4) -> (uv (N,2), depth (N,))."""
    return project(cam, pts_w @ Tcw[:3, :3].T + Tcw[:3, 3])


def in_image(cam: Camera, uv: torch.Tensor, border: float = 0.0) -> torch.Tensor:
    """Visibility mask of pixel coords (N,2): inside the image, `border`
    pixels clear of its edges."""
    return ((uv[..., 0] >= border) & (uv[..., 0] < cam.width - border)
            & (uv[..., 1] >= border) & (uv[..., 1] < cam.height - border))


def distort_normalized(cam: Camera, xy: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords (N,2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Camera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert the distortion model by a fixed number of fixed-point
    iterations (cv::undistortPoints analog). (N,2) -> (N,2) pixels."""
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    xy0 = torch.stack([x0, y0], dim=-1)
    xy = xy0
    for _ in range(iters):
        xy = xy - (distort_normalized(cam, xy) - xy0)
    return torch.stack([xy[..., 0] * cam.fx + cam.cx,
                        xy[..., 1] * cam.fy + cam.cy], dim=-1)
