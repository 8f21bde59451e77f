"""Image pyramid and descriptor blur (port of splslam_tpu/ops/pyramid.py).

`resize_bilinear` and `gaussian_blur` keep the reference's formulas and
order of float32 operations (rows then columns, `a*(1-f) + b*f`; taps
summed in order with float32 weights, zero padding), so keypoint sets
built on top of them agree exactly. The index tables are static numpy
constants, as in the reference; plain tensor indexing replaces its
TPU-layout workaround.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from splslam_tpu_torch.ops.consts import device_const


class PyramidSpec(NamedTuple):
    """Static pyramid geometry for one camera resolution."""

    n_levels: int
    scale_factor: float
    sizes: tuple  # ((H0,W0), (H1,W1), ...)
    scales: tuple  # (1.0, 1.2, 1.44, ...)
    sigma2: tuple  # scale^2 per level
    budgets: tuple  # features to keep per level (sums to >= n_features)

    @staticmethod
    def create(height: int, width: int, n_levels: int = 8,
               scale_factor: float = 1.2, n_features: int = 1000) -> "PyramidSpec":
        sizes, scales = [], []
        for lv in range(n_levels):
            s = scale_factor ** lv
            scales.append(s)
            sizes.append((int(round(height / s)), int(round(width / s))))
        # Geometric feature budget per level, factor 1/scale (reference:
        # src/ORBextractor.cc:410-470).
        inv = 1.0 / scale_factor
        ndesired = n_features * (1 - inv) / (1 - inv ** n_levels)
        budgets, acc = [], 0
        for lv in range(n_levels - 1):
            b = int(round(ndesired * inv ** lv))
            budgets.append(b)
            acc += b
        budgets.append(max(n_features - acc, 0))
        sigma2 = tuple(s * s for s in scales)
        return PyramidSpec(n_levels, scale_factor, tuple(sizes), tuple(scales),
                           sigma2, tuple(budgets))

    @property
    def total_capacity(self) -> int:
        return sum(self.budgets)


def _lerp_table(n_in: int, n_out: int, device):
    """(first source index [n_out] int64, weight of the second [n_out]
    f32) on `device`, sent there once per size pair."""
    def make():
        pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
        return i0, (pos - i0).astype(np.float32)
    return device_const(("lerp", n_in, n_out), device, make)


def resize_bilinear(image: torch.Tensor, hw_out: tuple[int, int]) -> torch.Tensor:
    """Separable bilinear resize, rows then columns (cv::resize
    INTER_LINEAR analog, reference src/ORBextractor.cc:1107)."""
    Hi, Wi = image.shape
    Ho, Wo = hw_out
    y0, fy = _lerp_table(Hi, Ho, image.device)
    fy = fy[:, None]
    tmp = image[y0] * (1 - fy) + image[y0 + 1] * fy
    x0, fx = _lerp_table(Wi, Wo, image.device)
    fx = fx[None, :]
    return tmp[:, x0] * (1 - fx) + tmp[:, x0 + 1] * fx


def build_pyramid(image: torch.Tensor, spec: PyramidSpec) -> list[torch.Tensor]:
    """Grayscale image (H,W) f32 -> per-level images, each resized from
    the previous level (as the reference does)."""
    levels = [image]
    cur = image
    for lv in range(1, spec.n_levels):
        cur = resize_bilinear(cur, spec.sizes[lv])
        levels.append(cur)
    return levels


def _blur_taps(sigma: float, radius: int) -> list[float]:
    k = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


# The descriptor blur's 7 float32 taps (sigma 2, radius 3); the ORB
# kernel takes them from here rather than computing its own.
BLUR_TAPS = tuple(_blur_taps(2.0, 3))


def gaussian_blur(image: torch.Tensor, sigma: float = 2.0,
                  radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur with zero padding (the reference blurs with
    7x7 sigma=2 before computing descriptors, src/ORBextractor.cc:1086).
    Taps are summed in order, starting from 0, as the reference's
    Python `sum` does."""
    k = _blur_taps(sigma, radius)
    H, W = image.shape
    p = F.pad(image, (0, 0, radius, radius))
    out = 0
    for i, w in enumerate(k):
        out = out + w * p[i:i + H]
    p = F.pad(out, (radius, radius, 0, 0))
    res = 0
    for i, w in enumerate(k):
        res = res + w * p[:, i:i + W]
    return res
