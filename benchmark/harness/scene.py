"""The benchmark's synthetic scenes: textured planes with exact camera poses.

A frozen copy of `splslam_tpu_torch/io/synthetic.py` at commit ba65753
(`make_texture`, `make_grid_texture`, `PlaneScene`, the "forward" and
"oscillate" camera paths of `make_stereo_sequence`), and of the shuttle
of `splslam_tpu_torch/bench/stereo.py` at the same commit. The rendering arithmetic is unchanged. Extended so
that a configuration's published intrinsics (fx, fy, cx, cy, the stereo
baseline from bf / fx) place the camera, and so that the oscillation can
be made periodic in a whole number of frames, which a replayed loop
needs; so that a published radial-tangential distortion bends the image as
the camera would (`undistort_pixels`, the harness's own NumPy inverse of
the reference's model, never the port's); so that a frame can carry its
camera-frame depth; and with a texture-free plane. Imports numpy and
scipy only: the render pool's workers load it.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates

TEXTURE_SIZE = 2048
PX_PER_UNIT = 100.0
GRID_SPACING = 192
GRID_WIDTH = 8
Z_NEAR = 5.0
Z_FAR = 12.0


def make_texture(size: int = TEXTURE_SIZE, seed: int = 0, scale_px: int = 4) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = r.uniform(0, 1, size=(size // scale_px, size // scale_px))
    t = np.kron(t, np.ones((scale_px, scale_px)))
    t = gaussian_filter(t, 1.2)
    t = (t - t.min()) / (np.ptp(t) + 1e-9) * 255.0
    return t.astype(np.float32)


def make_grid_texture(size: int = TEXTURE_SIZE, seed: int = 0,
                      spacing: int = GRID_SPACING, width: int = GRID_WIDTH) -> np.ndarray:
    """Random blotches under solid dark grid strokes: straight edges for
    the line detector, corners for ORB."""
    t = make_texture(size, seed=seed)
    for i in range(0, size, spacing):
        t[i:i + width, :] = 15.0
        t[:, i:i + width] = 15.0
    return t.astype(np.float32)


def make_flat_texture(size: int = TEXTURE_SIZE, seed: int = 0) -> np.ndarray:
    """One grey level everywhere: nothing for a detector to find."""
    return np.full((size, size), 128.0, np.float32)


# a traffic mix's scene "texture", by name
TEXTURES = {"blobs": make_texture, "grid": make_grid_texture, "flat": make_flat_texture}

UNDISTORT_TOL_PX = 1e-3
UNDISTORT_MAX_ITERS = 100


def make_K(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


class PlaneScene:
    """Plane z = z0 textured with `texture` (1 world unit = `px_per_unit`
    texture pixels), and a second plane at z1 seen in the diagonal
    quadrants of the image that do not see the first."""

    def __init__(self, texture: np.ndarray, z0: float = Z_NEAR,
                 z1: float | None = Z_FAR, px_per_unit: float = PX_PER_UNIT):
        self.tex = texture
        self.z0 = z0
        self.z1 = z1
        self.ppu = px_per_unit
        self._rays: dict = {}      # the undistorted pixel grid of each camera

    def near_mask(self, K: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Which pixels see the near plane (z0)."""
        return (u < K[0, 2]) ^ (v < K[1, 2])

    def hit(self, K: np.ndarray, Twc: np.ndarray, u: np.ndarray, v: np.ndarray):
        """World points [P,3] that pixels (u, v) see from pose Twc, and the
        ray parameter t (the camera-frame depth)."""
        pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
        rays_w = (pix @ np.linalg.inv(K).T) @ Twc[:3, :3].T
        o = Twc[:3, 3]

        def plane(z_plane):
            dz = rays_w[:, 2]
            t = (z_plane - o[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
            return o[None] + rays_w * t[:, None], t

        p0, t0 = plane(self.z0)
        if self.z1 is None:
            return p0, t0
        sel = (t0 > 0) & self.near_mask(K, pix[:, 0], pix[:, 1])
        p1, t1 = plane(self.z1)
        return np.where(sel[:, None], p0, p1), np.where(sel, t0, t1)

    def render(self, K: np.ndarray, Twc: np.ndarray, height: int, width: int,
               dist: np.ndarray | None = None, depth: bool = False):
        """The image from pose Twc; with `dist` (k1, k2, p1, p2, k3) not all
        zero, each pixel sees along the ray of its undistorted position;
        with `depth`, (image, the camera-frame depth each pixel sees)."""
        us, vs = np.meshgrid(np.arange(width), np.arange(height))
        u, v = us.reshape(-1), vs.reshape(-1)
        if dist is not None and np.any(dist):
            key = (height, width, K.tobytes(), np.asarray(dist, np.float64).tobytes())
            if key not in self._rays:
                self._rays[key] = undistort_pixels(K, dist, u, v)
            u, v = self._rays[key]
        p, t = self.hit(K, Twc, u, v)
        tx = p[:, 0] * self.ppu + self.tex.shape[1] / 2
        ty = p[:, 1] * self.ppu + self.tex.shape[0] / 2
        img = map_coordinates(self.tex, [ty, tx], order=1, mode="wrap")
        img = img.reshape(height, width).astype(np.float32)
        return (img, t.reshape(height, width)) if depth else img


def distort(dist: np.ndarray, x: np.ndarray, y: np.ndarray):
    """The reference's radial-tangential model (OpenCV's; k1, k2, p1, p2,
    k3) on normalized coordinates."""
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return (x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
            y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)


def undistort_pixels(K: np.ndarray, dist: np.ndarray, u: np.ndarray, v: np.ndarray):
    """The undistorted pixel positions of distorted pixels (u, v): the
    model inverted by fixed-point iteration until it maps each back to
    within `UNDISTORT_TOL_PX`; raises where it does not converge."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xd, yd = (u - cx) / fx, (v - cy) / fy
    x, y = xd, yd
    for _ in range(UNDISTORT_MAX_ITERS):
        ex, ey = distort(dist, x, y)
        ex, ey = ex - xd, ey - yd
        if max(np.max(np.abs(ex)) * fx, np.max(np.abs(ey)) * fy) < UNDISTORT_TOL_PX:
            return x * fx + cx, y * fy + cy
        x, y = x - ex, y - ey
    raise ValueError(f"the undistortion did not converge to {UNDISTORT_TOL_PX} px in "
                     f"{UNDISTORT_MAX_ITERS} iterations")


def camera_path(motion: str, n_frames: int, osc_amp: float = 0.5,
                period: int | None = None) -> np.ndarray:
    """Camera-to-world poses [F,4,4]. "forward": 0.03 a frame along z and
    0.01 along x. "oscillate": the lateral sine of amplitude `osc_amp`
    with a peak speed of 0.04 a frame and a 0.01 vertical wobble; with
    `period`, both sines repeat every `period` frames (their rates are
    moved to the nearest that do), so the path replays without a jump."""
    w, w_y = 0.04 / osc_amp, 0.3
    if period:
        w = 2.0 * np.pi / period * max(1, round(w * period / (2.0 * np.pi)))
        w_y = 2.0 * np.pi / period * max(1, round(w_y * period / (2.0 * np.pi)))
    poses = []
    for i in range(n_frames):
        Twc = np.eye(4)
        if motion == "forward":
            Twc[2, 3] = 0.03 * i
            Twc[0, 3] = 0.01 * i
        elif motion == "oscillate":
            Twc[0, 3] = osc_amp * np.sin(w * i)
            Twc[1, 3] = 0.01 * np.sin(w_y * i)
        else:
            raise ValueError(f"unknown motion {motion!r}")
        poses.append(Twc)
    return np.stack(poses)


def right_pose(Twc: np.ndarray, baseline: float) -> np.ndarray:
    """The right camera of a rectified pair: `baseline` along the left
    camera's x axis."""
    Twc_r = Twc.copy()
    Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([baseline, 0, 0])
    return Twc_r


def shuttle(leg: np.ndarray) -> np.ndarray:
    """Indices of a leg played forward and back ([0..n-1, n-2..1]), so
    the camera stays inside the scene for any number of frames."""
    n = len(leg)
    return np.concatenate([np.arange(n), np.arange(n - 2, 0, -1)])

