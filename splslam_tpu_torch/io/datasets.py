"""Dataset loaders for the reference's benchmark suites (port of
splslam_tpu/io/datasets.py).

Mirror the LoadImages functions of the reference drivers
(Examples/Monocular/mono_tum.cc:122-152, mono_kitti.cc, mono_euroc.cc,
Stereo/stereo_kitti.cc, stereo_euroc.cc rectification, RGB-D/rgbd_tum.cc
association). They return lists of paths and timestamps; images are read
by `imread_gray`. OpenCV is imported only where an image is read or a
rectification map built, so importing the port does not need it.
"""

from __future__ import annotations

import os

import numpy as np


def imread_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def imread_depth(path: str) -> np.ndarray:
    """A depth PNG as float32 in the sensor's units (TUM: uint16, scaled
    by the settings' DepthMapFactor)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def _read_list(seq_dir: str, fname: str):
    """`timestamp path` rows of a TUM list file, comments skipped."""
    out = []
    with open(os.path.join(seq_dir, fname)) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            t, p = line.split()[:2]
            out.append((float(t), os.path.join(seq_dir, p)))
    return out


# ----------------------------------------------------------------------
# TUM RGB-D
# ----------------------------------------------------------------------
def load_tum_mono(seq_dir: str):
    """rgb.txt -> ([rgb_paths], [timestamps]) (reference mono_tum.cc:122)."""
    rows = _read_list(seq_dir, "rgb.txt")
    return [p for _, p in rows], [t for t, _ in rows]


def load_tum_rgbd(seq_dir: str, max_dt: float = 0.02):
    """Associate rgb.txt and depth.txt by nearest timestamp (the standard
    associate.py pairing; the reference reads a pre-associated file).
    Returns (rgb_paths, depth_paths, timestamps)."""
    rgb = _read_list(seq_dir, "rgb.txt")
    depth = _read_list(seq_dir, "depth.txt")
    dts = np.array([t for t, _ in depth])
    rgb_p, dep_p, ts = [], [], []
    for t, p in rgb:
        i = int(np.argmin(np.abs(dts - t)))
        if abs(dts[i] - t) <= max_dt:
            rgb_p.append(p)
            dep_p.append(depth[i][1])
            ts.append(t)
    return rgb_p, dep_p, ts


# ----------------------------------------------------------------------
# KITTI odometry
# ----------------------------------------------------------------------
def load_kitti_stereo(seq_dir: str):
    """times.txt + image_0/ image_1/ (reference stereo_kitti.cc:LoadImages).
    Returns (left_paths, right_paths, timestamps)."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        ts = [float(x) for x in f.read().split()]
    left = [os.path.join(seq_dir, "image_0", f"{i:06d}.png") for i in range(len(ts))]
    right = [os.path.join(seq_dir, "image_1", f"{i:06d}.png") for i in range(len(ts))]
    return left, right, ts


def load_kitti_mono(seq_dir: str):
    left, _, ts = load_kitti_stereo(seq_dir)
    return left, ts


# ----------------------------------------------------------------------
# EuRoC MAV
# ----------------------------------------------------------------------
def load_euroc(seq_dir: str, ts_file: str | None = None):
    """mav0/cam0 (and cam1) with data.csv timestamps in ns (reference
    mono_euroc.cc / stereo_euroc.cc). Returns (cam0, cam1 or None, ts[s]).
    `ts_file` is accepted and ignored, as in the JAX package: the
    timestamps are cam0's data.csv."""
    cam0 = os.path.join(seq_dir, "mav0", "cam0", "data")
    cam1 = os.path.join(seq_dir, "mav0", "cam1", "data")
    csv = os.path.join(seq_dir, "mav0", "cam0", "data.csv")
    names, ts = [], []
    with open(csv) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.strip().split(",")
            if len(parts) < 2:
                continue
            names.append(parts[1])
            ts.append(float(parts[0]) * 1e-9)
    left = [os.path.join(cam0, n) for n in names]
    right = [os.path.join(cam1, n) for n in names] if os.path.isdir(cam1) else None
    return left, right, ts


def euroc_rectify_maps(raw: dict):
    """Stereo rectification maps from the LEFT.*/RIGHT.* K/D/R/P matrices of
    a reference EuRoC YAML (reference stereo_euroc.cc:65-110,
    cv::initUndistortRectifyMap). Returns (map_l, map_r), each (mx, my)
    for cv2.remap."""
    import cv2

    out = []
    for side in ("LEFT", "RIGHT"):
        K = raw[f"{side}.K"]
        D = raw[f"{side}.D"]
        R = raw[f"{side}.R"]
        P = raw[f"{side}.P"]
        h = int(raw[f"{side}.height"])
        w = int(raw[f"{side}.width"])
        out.append(cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], (w, h), cv2.CV_32F))
    return out[0], out[1]


def rectify(img: np.ndarray, maps) -> np.ndarray:
    import cv2

    return cv2.remap(img, maps[0], maps[1], cv2.INTER_LINEAR)
