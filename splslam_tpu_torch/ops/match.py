"""Descriptor matching as masked Hamming-distance matrices (port of
splslam_tpu/ops/match.py).

Descriptors are int32 [N, 8] carrying the bits of the reference's
uint32 words. All-pairs Hamming distance is one float32 matmul of +-1
bit planes unpacked from the packed words: H = (256 - dot) / 2, exact
in float32 (and in TF32, whose inputs +-1 are exact), identical to the
reference's `hamming_from_bits`.
"""

from __future__ import annotations

import math

import torch

TH_LOW = 50      # reference: src/ORBmatcher.cc:38
TH_HIGH = 100    # reference: src/ORBmatcher.cc:37
HISTO_BINS = 30  # reference: src/ORBmatcher.cc:39
BIG = 1 << 20
INT32_MAX = 2 ** 31 - 1


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[N,8] int32 packed descriptors -> [N,256] f32 +-1 bit planes."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], -1).float() * 2.0 - 1.0


def hamming(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance. [N1,8]x[N2,8] int32 -> [N1,N2] int32."""
    dot = unpack_pm1(d1) @ unpack_pm1(d2).T
    return ((256.0 - dot) * 0.5).to(torch.int32)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Exact per-word popcount of int32 words holding uint32 bits (torch
    has no popcount op). Each word is split into two 16-bit halves, each
    masked non-negative before the SWAR sum, so the arithmetic right
    shift of a negative int32 never leaks a sign bit and nothing can
    overflow."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


def masked_distances(
    dist: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor,
    extra_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply validity/extra masks: disallowed pairs get distance BIG."""
    ok = valid1[:, None] & valid2[None, :]
    if extra_mask is not None:
        ok = ok & extra_mask
    return torch.where(ok, dist, BIG)


def nn_match(
    dist: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float | None = None,
    mutual: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise nearest neighbour on a (masked) distance matrix.

    Returns (match_idx [N1] int32, -1 where unmatched; best_dist [N1]).
    Ties go to the first column, as with the reference's argmin."""
    best = torch.argmin(dist, dim=1)
    rows = torch.arange(dist.shape[0], device=dist.device)
    bestd = dist[rows, best]
    ok = bestd <= max_dist
    if ratio is not None:
        second = torch.topk(dist, 2, dim=1, largest=False).values[:, 1]
        ok = ok & (bestd.float() < ratio * second.float())
    if mutual:
        col_best = torch.argmin(dist, dim=0)
        ok = ok & (col_best[best] == rows)
    return torch.where(ok, best, -1).to(torch.int32), bestd


def window_mask(uv_pred: torch.Tensor, xy: torch.Tensor, radius) -> torch.Tensor:
    """[M,2] predictions vs [N,2] keypoints -> [M,N] bool, L-inf window.
    `radius` is a float or a per-row [M] tensor."""
    if isinstance(radius, torch.Tensor) and radius.dim() == 1:
        radius = radius[:, None]
    dx = torch.abs(uv_pred[:, 0:1] - xy[None, :, 0])
    dy = torch.abs(uv_pred[:, 1:2] - xy[None, :, 1])
    return (dx <= radius) & (dy <= radius)


def octave_mask(pred_octave: torch.Tensor, kp_octave: torch.Tensor,
                lo: int = 0, hi: int = 0) -> torch.Tensor:
    """[M] predicted level vs [N] keypoint octaves -> [M,N] bool,
    allowing kp_octave in [pred+lo, pred+hi]."""
    d = kp_octave[None, :] - pred_octave[:, None]
    return (d >= lo) & (d <= hi)


def float_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """jnp.mod for a positive float divisor: fmod, then shift negative
    remainders up by y (the reference's exact formula)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


def rotation_consistency(
    angle1: torch.Tensor, angle2: torch.Tensor, matches: torch.Tensor,
    period: float = 2.0 * math.pi,
) -> torch.Tensor:
    """Keep matches whose angle difference (mod `period`) falls in the 3
    most common of 30 histogram bins (reference
    ORBmatcher::ComputeThreeMaxima)."""
    ok = matches >= 0
    rot = float_mod(angle1 - angle2[matches.clamp(min=0).long()], period)
    bins = torch.clamp((rot * (HISTO_BINS / period)).to(torch.int32),
                       0, HISTO_BINS - 1).long()
    hist = torch.zeros((HISTO_BINS,), dtype=torch.int32, device=rot.device)
    hist.index_add_(0, bins, ok.to(torch.int32))
    top3 = torch.topk(hist, 3).values
    thr = torch.maximum(top3[2], (0.1 * top3[0].float()).to(torch.int32))
    good_bin = hist >= torch.clamp(thr, min=1)
    return torch.where(ok & good_bin[bins], matches, -1)


def rotation_consistency_lines(
    angle1: torch.Tensor, angle2: torch.Tensor, matches: torch.Tensor
) -> torch.Tensor:
    """`rotation_consistency` for undirected line angles: the differences
    are taken mod pi (reference Linematcher.cc:233)."""
    return rotation_consistency(angle1, angle2, matches, math.pi)
