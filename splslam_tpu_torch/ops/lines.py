"""Line-feature table (port of the `LineFeatures` container of
splslam_tpu/ops/lines.py). Only the container exists on this slice:
stereo tracking is points-only, so every line table has capacity 1 and
is empty. Line extraction and LBD descriptors are a later slice."""

from __future__ import annotations

from typing import NamedTuple

import torch

N_WORDS = 8


class LineFeatures(NamedTuple):
    """Fixed-capacity line table (one frame)."""

    seg: torch.Tensor       # [L,4] endpoints [sx,sy,ex,ey] (level-0 px)
    midpoint: torch.Tensor  # [L,2]
    angle: torch.Tensor     # [L] segment direction, radians
    length: torch.Tensor    # [L] 2D length in px
    response: torch.Tensor  # [L] mean gradient magnitude along the segment
    desc: torch.Tensor      # [L,8] int32 (bits of uint32 words)
    valid: torch.Tensor     # [L] bool
    octave: torch.Tensor    # [L] int32 detection pyramid level

    @property
    def capacity(self) -> int:
        return self.seg.shape[0]

    @staticmethod
    def empty(capacity: int, device) -> "LineFeatures":
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        return LineFeatures(
            seg=z(capacity, 4),
            midpoint=z(capacity, 2),
            angle=z(capacity),
            length=z(capacity),
            response=z(capacity),
            desc=torch.zeros((capacity, N_WORDS), dtype=torch.int32,
                             device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            octave=torch.zeros((capacity,), dtype=torch.int32, device=device),
        )
