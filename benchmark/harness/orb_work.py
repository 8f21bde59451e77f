"""The work one call of the ORB description kernel needs, whatever
implements it, and the least time the H100 could take for it.

Rewritten from `chip_smoke.py::kernel_bound` (commit ba65753), which
counted the port's own layout (float32 levels, its pair table). Here:

- bytes: the image pyramid's pixels at the camera's 8 bits, each read
  once; two 16-bit coordinates a keypoint; one float32 angle and one
  256-bit descriptor a keypoint, each written once;
- operations (float32): the descriptor blur of every pyramid pixel once
  (a separable 7-tap filter: 7 multiplies and 7 adds a pass, two passes),
  and the two intensity moments over the radius-15 disc of each keypoint
  (a multiply and an add each); the 256 tests are comparisons.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s
of float32 outside the tensor cores, at the full 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
DISC_PIXELS = sum(1 for dy in range(-19, 21) for dx in range(-19, 21) if dx * dx + dy * dy <= 225)


def pyramid_pixels(height: int, width: int, n_levels: int, scale: float) -> int:
    return sum(int(round(height / scale ** lv)) * int(round(width / scale ** lv))
               for lv in range(n_levels))


def work(images: int, keypoints: float, pixels: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one call over `images` images of
    `pixels` pyramid pixels each, with `keypoints` keypoints in all."""
    nbytes = images * pixels + keypoints * (4 + 4 + 32)
    flops = images * pixels * 28 + keypoints * 4 * DISC_PIXELS
    return nbytes, flops


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
