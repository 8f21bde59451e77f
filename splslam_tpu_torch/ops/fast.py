"""Dense FAST-9/16 corner scoring + 3x3 NMS (port of splslam_tpu/ops/fast.py).

The score of every pixel is the classic FAST "V" measure computed from 16
shifted copies of the image (arc minima via circular rolls). The ring
arithmetic runs in bfloat16, as in the reference: the image is cast to
bf16 once, and each ring difference is rounded to bf16 (PyTorch rounds
every bf16 op; XLA on the CPU does the same here, checked by the parity
tests), so pyramid levels with fractional pixels give the same scores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (the standard FAST-16 ring, clockwise from
# 12 o'clock). (dy, dx) offsets.
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _arc_min(d: torch.Tensor) -> torch.Tensor:
    """FAST-9: max over start a of min(d[a], ..., d[a+8]) around the ring
    (log-step rolls)."""
    m = torch.minimum(d, torch.roll(d, -1, dims=0))      # runs of 2
    m = torch.minimum(m, torch.roll(d, -2, dims=0))      # runs of 3
    m4 = torch.minimum(m, torch.roll(m, -3, dims=0))     # runs of 6
    m8 = torch.minimum(m4, torch.roll(m, -6, dims=0))    # runs of 9
    return torch.amax(m8, dim=0)


def fast_score_map(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H,W) f32 image -> (H,W) f32 corner score map; a 3 px border is 0."""
    H, W = image.shape
    img16 = image.to(torch.bfloat16)
    padded = F.pad(img16, (3, 3, 3, 3))
    ring = torch.stack(
        [padded[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for (dy, dx) in _CIRCLE]
    )                               # [16,H,W] bf16
    d_bright = ring - img16[None]   # >t means ring pixel brighter by t
    d_dark = img16[None] - ring     # >t means ring pixel darker by t
    score = torch.maximum(_arc_min(d_bright), _arc_min(d_dark)).float()
    score = torch.where(score > threshold, score, 0.0)
    return torch.where(inside_mask(H, W, 3, image.device), score, 0.0)


def inside_mask(H: int, W: int, b: int, device) -> torch.Tensor:
    """(H,W) bool, True at least `b` px from every edge. Built by
    comparisons: writing a Python scalar into a CUDA tensor makes the host
    wait for the device."""
    ys = torch.arange(H, device=device)
    xs = torch.arange(W, device=device)
    return (((ys >= b) & (ys < H - b))[:, None]
            & ((xs >= b) & (xs < W - b))[None, :])


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression; keeps pixels equal to their window max."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh, score, 0.0)


def fast_corners(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST + NMS in one call: (H,W) -> (H,W) sparse score map."""
    return nms3(fast_score_map(image, threshold))
