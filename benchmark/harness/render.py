"""Render a cell's frames from its seed, in a pool of spawned processes.

The frames are 8-bit grayscale, as a camera delivers them, and an RGB-D
frame's depth is float32 in the sensor's units. Each worker
gets the texture once (its initializer) and renders whole frames with one
BLAS thread; the parent keeps the order. A KITTI-size pair takes 0.15 to
0.3 s of one core.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from harness import scene as S

_SCENE: S.PlaneScene | None = None
BLAS_THREADS = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")


def _init(texture: np.ndarray) -> None:
    global _SCENE
    _SCENE = S.PlaneScene(texture)


def _gray(img: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _render(job):
    K, poses, height, width, dist, depth_scale = job
    depth = None
    if depth_scale is None:
        first = _SCENE.render(K, poses[0], height, width, dist)
    else:
        first, t = _SCENE.render(K, poses[0], height, width, dist, depth=True)
        depth = (t * depth_scale).astype(np.float32)
    rest = [_SCENE.render(K, T, height, width, dist) for T in poses[1:]]
    return np.stack([_gray(i) for i in [first, *rest]]), depth


def render_frames(texture: np.ndarray, K: np.ndarray, poses: list, height: int,
                  width: int, dist: np.ndarray | None = None,
                  depth_scale: float | None = None):
    """(uint8 [F, V, H, W], float32 [F, H, W] or None): every view (V poses
    a frame: left, or left and right) of every frame, through the
    distortion `dist` (k1, k2, p1, p2, k3); with `depth_scale`, also the
    first view's camera-frame depth times `depth_scale`."""
    n = min(len(poses), os.cpu_count() or 1, 8)
    jobs = [(K, views, height, width, dist, depth_scale) for views in poses]
    if n <= 1:
        _init(texture)
        return _frames([_render(j) for j in jobs])
    # the workers read the BLAS thread counts when they import numpy; an
    # executor, not a Pool: a worker that dies raises here instead of
    # leaving the map waiting
    saved = {k: os.environ.get(k) for k in BLAS_THREADS}
    os.environ.update({k: "1" for k in BLAS_THREADS})
    try:
        with ProcessPoolExecutor(n, mp_context=mp.get_context("spawn"), initializer=_init,
                                 initargs=(texture,)) as pool:
            out = list(pool.map(_render, jobs, chunksize=max(1, len(jobs) // (4 * n))))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return _frames(out)


def _frames(out: list):
    images, depth = zip(*out)
    return np.stack(images), (None if depth[0] is None else np.stack(depth))
