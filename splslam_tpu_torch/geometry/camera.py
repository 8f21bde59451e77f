"""Pinhole camera intrinsics (port of splslam_tpu/geometry/camera.py).

The port keeps the intrinsics as Python floats, each rounded to float32
at creation, so arithmetic against float32 tensors sees exactly the
values the reference stores as f32 scalars. Distortion fields are kept;
the stereo slice works on undistorted keypoints and never reads them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
