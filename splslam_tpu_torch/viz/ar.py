"""Headless augmented-reality demo: plane detection + anchored virtual cube
(port of splslam_tpu/viz/ar.py).

Re-creates the reference's AR example (Examples/ROS/PL-SLAM/src/AR/
ViewerAR.cc, driven by ros_mono_ar.cc): `DetectPlane` RANSAC-fits a plane
to the currently tracked map points (ViewerAR.cc:408-501), a virtual cube
is anchored on that plane, and every subsequent frame draws the cube
through the live camera pose (DrawCube, ViewerAR.cc:319-345). The
reference renders through Pangolin/OpenGL; headless, the cube is
rasterized into the frame overlay with cv2 (same sink as viz/draw.py).

Usage:
    ar = ARState()
    ...track frames...
    ar.try_anchor(system)            # fit a plane to tracked map points
    out = render_ar_frame(system, image, ar)   # overlay incl. the cube
"""

from __future__ import annotations

import numpy as np

from splslam_tpu_torch.viz.draw import _host, render_current_frame


def detect_plane(xyz: np.ndarray, iters: int = 50, rng_seed: int = 0,
                 min_points: int = 50):
    """RANSAC plane fit over 3D points — the reference's best-effort
    dominant-plane criterion (ViewerAR::DetectPlane, ViewerAR.cc:
    408-530): 3-point hypotheses scored by the distance of the
    nth-smallest point (nth = max(0.2·N, 20)), keep the hypothesis that
    minimizes it, gate inliers at 1.4× that distance, refine by SVD.
    No absolute threshold: on a non-planar cloud this still anchors to
    the locally dominant planar patch, exactly as the AR demo does.

    Returns (normal [3], d) with |normal| = 1 and n·x + d ≈ 0 for plane
    points, or None for degenerate input (< min_points points — the
    reference requires 50 — or a collapsed cloud)."""
    pts = np.asarray(xyz, np.float64)
    if len(pts) < min_points:
        return None
    rng = np.random.default_rng(rng_seed)
    nth = max(int(0.2 * len(pts)), min(20, len(pts) - 1))
    best = None
    best_score = np.inf
    for _ in range(iters):
        i3 = rng.choice(len(pts), size=3, replace=False)
        a, b, c = pts[i3]
        n = np.cross(b - a, c - a)
        nn = np.linalg.norm(n)
        if nn < 1e-12:
            continue
        n = n / nn
        d = -float(n @ a)
        dist = np.abs(pts @ n + d)
        score = np.partition(dist, nth)[nth]
        if score < best_score:
            best_score = score
            best = (n, d, dist)
    if best is None:
        return None
    n, d, dist = best
    # Inliers at 1.4x the best nth distance (ViewerAR.cc:485-500), then
    # least-squares refine through the inlier centroid.
    inl = pts[dist < 1.4 * max(best_score, 1e-9)]
    if len(inl) < 3:
        return None
    cen = inl.mean(axis=0)
    u, s, vt = np.linalg.svd(inl - cen)
    n = vt[2]
    d = -float(n @ cen)
    return n / np.linalg.norm(n), d


class ARState:
    """Holds the detected plane + cube anchor (the reference keeps a
    vector<Plane*>; one anchor is enough for the headless demo)."""

    def __init__(self, cube_size: float = 0.2):
        self.cube_size = cube_size
        self.anchor: np.ndarray | None = None  # cube base center, world
        self.basis: np.ndarray | None = None   # [3,3] rows: x, y, normal

    def try_anchor(self, system) -> bool:
        """Fit a plane to the currently TRACKED map points (the reference
        passes the frame's vMPs, ros_mono_ar.cc) and anchor the cube at
        the inlier centroid. Returns True once anchored."""
        if self.anchor is not None:
            return True
        st = system.step
        if st is None:
            return False
        gid = _host(st.lm_gid)
        xyz = _host(st.lm_xyz)[gid >= 0]
        fit = detect_plane(xyz)
        if fit is None:
            return False
        n, d = fit
        dist = np.abs(xyz @ n + d)
        nth = max(int(0.2 * len(dist)), 3)
        th = 1.4 * max(float(np.partition(dist, nth)[nth]), 1e-9)
        pts = xyz[dist < th]
        cen = pts.mean(axis=0) if len(pts) else -d * n
        # Basis in the plane.
        x = np.cross(n, [0.0, 0.0, 1.0])
        if np.linalg.norm(x) < 1e-6:
            x = np.cross(n, [0.0, 1.0, 0.0])
        x = x / np.linalg.norm(x)
        y = np.cross(n, x)
        self.anchor = cen
        self.basis = np.stack([x, y, n])
        return True

    def cube_vertices(self) -> np.ndarray:
        """[8,3] world-space cube corners sitting on the plane."""
        assert self.anchor is not None
        s = 0.5 * self.cube_size
        out = []
        for k in (0.0, 2 * s):          # base on the plane, top above it
            for i in (-s, s):
                for j in (-s, s):
                    out.append(
                        self.anchor
                        + i * self.basis[0] + j * self.basis[1]
                        + k * self.basis[2]
                    )
        return np.asarray(out)


_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0),
          (4, 5), (5, 7), (7, 6), (6, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_ar_cube(img_bgr: np.ndarray, Tcw: np.ndarray, K: np.ndarray,
                 verts_w: np.ndarray) -> np.ndarray:
    """Project the cube's world vertices through Tcw and draw its wire
    edges (reference DrawCube uses a GL cube under Tpw, ViewerAR.cc:
    319-345). Edges with either endpoint behind the camera are culled."""
    import cv2

    pc = verts_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    uv = np.stack([
        K[0, 0] * pc[:, 0] / np.maximum(z, 1e-6) + K[0, 2],
        K[1, 1] * pc[:, 1] / np.maximum(z, 1e-6) + K[1, 2],
    ], axis=-1)
    out = img_bgr
    for i, j in _EDGES:
        if z[i] <= 1e-3 or z[j] <= 1e-3:
            continue
        cv2.line(out, (int(uv[i, 0]), int(uv[i, 1])),
                 (int(uv[j, 0]), int(uv[j, 1])), (255, 160, 0), 2)
    return out


def render_ar_frame(system, image: np.ndarray, ar: ARState) -> np.ndarray:
    """Frame overlay (viz.draw) + the anchored AR cube, if any."""
    out = render_current_frame(system, image)
    if ar.anchor is not None and system.step is not None:
        K = np.array([
            [system.settings.fx, 0.0, system.settings.cx],
            [0.0, system.settings.fy, system.settings.cy],
            [0.0, 0.0, 1.0],
        ])
        out = draw_ar_cube(out, system.last_Tcw_np, K, ar.cube_vertices())
    return out
