"""Plain ORB: the reference the program's frame layer is held to.

Written for the benchmark from the function's definition, in plain
PyTorch on the CPU, one keypoint table per image. It imports nothing of
the program. What it computes, level by level:

1. the pyramid: level 0 is the 8-bit image; each further level is
   resized from the one before by separable bilinear interpolation (rows
   then columns, `a*(1-f) + b*f`, sample centres aligned as cv::resize
   INTER_LINEAR aligns them) to round(H / 1.2^l) x round(W / 1.2^l);
2. FAST-9 on the 16-pixel ring, its differences in bfloat16 (as the
   detector defines them), score = the larger of the brightest and the
   darkest arc of nine, kept above a threshold of 12, then a 3x3
   non-maximum suppression and a 19-pixel border;
3. per 16x16 cell the four best scores (ties to the lower index), then
   the level's feature budget of the best cells' picks (ties to the
   earlier pick); the budget per level is the geometric share of the
   configuration's feature count (factor 1 / 1.2);
4. the descriptor blur: a separable 7-tap Gaussian (sigma 2, taps
   rounded to float32), zero padded, rounded to bfloat16;
5. per keypoint the intensity-centroid angle over the radius-15 disc,
   its bin of 30, and 256 tests of the rotated pattern on the blurred
   patch rounded to 8 bits: bit j of word w is test 32w + j.

`dtype` is the precision of every arithmetic step (float32 as the
configuration states; bfloat16 for the control).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

FAST_THRESHOLD = 12.0
EDGE = 19
CELL = 16
CELL_K = 4
PATCH = 40
CENTRE = 19
RADIUS = 15
N_BINS = 30
HALF_PATCH = 15
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


class Keypoints(NamedTuple):
    """One image's valid keypoints, in level coordinates."""

    level: np.ndarray   # [n] int
    x: np.ndarray       # [n] int
    y: np.ndarray       # [n] int
    desc: np.ndarray    # [n, 8] uint32 words


def level_sizes(height: int, width: int, n_levels: int, scale: float):
    return [(int(round(height / scale ** lv)), int(round(width / scale ** lv)))
            for lv in range(n_levels)]


def level_budgets(n_features: int, n_levels: int, scale: float) -> list[int]:
    inv = 1.0 / scale
    per = n_features * (1 - inv) / (1 - inv ** n_levels)
    out = [int(round(per * inv ** lv)) for lv in range(n_levels - 1)]
    return out + [max(n_features - sum(out), 0)]


def pattern() -> np.ndarray:
    """The 256 test pairs [x1, y1, x2, y2]: Gaussian offsets (sigma 31/5)
    from a generator seeded 7, rounded and clipped to +-13."""
    rng = np.random.default_rng(7)
    pts = rng.normal(0.0, (2 * HALF_PATCH + 1) / 5.0, size=(256, 4))
    return np.clip(np.round(pts), -HALF_PATCH + 2, HALF_PATCH - 2).astype(np.float32)


def pair_offsets() -> np.ndarray:
    """[N_BINS, 256, 2] flat offsets in a 40x40 patch of each test's two
    samples under each rotation bin."""
    pat = pattern()
    x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    out = np.empty((N_BINS, 256, 2), np.int64)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        ca, sa = np.float32(np.cos(th)), np.float32(np.sin(th))
        out[b, :, 0] = ((np.round(sa * x1 + ca * y1).astype(np.int64) + CENTRE) * PATCH
                        + np.round(ca * x1 - sa * y1).astype(np.int64) + CENTRE)
        out[b, :, 1] = ((np.round(sa * x2 + ca * y2).astype(np.int64) + CENTRE) * PATCH
                        + np.round(ca * x2 - sa * y2).astype(np.int64) + CENTRE)
    return out


def _lerp(n_in: int, n_out: int):
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    return torch.from_numpy(i0), torch.from_numpy((pos - i0).astype(np.float32))


def resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    y0, fy = _lerp(img.shape[0], h)
    fy = fy.to(img.dtype)[:, None]
    tmp = img[y0] * (1 - fy) + img[y0 + 1] * fy
    x0, fx = _lerp(img.shape[1], w)
    fx = fx.to(img.dtype)[None, :]
    return tmp[:, x0] * (1 - fx) + tmp[:, x0 + 1] * fx


def fast_scores(img: torch.Tensor) -> torch.Tensor:
    """FAST-9 scores after suppression and the border, float32 [H, W]."""
    H, W = img.shape
    b = img.to(torch.bfloat16)
    p = F.pad(b, (3, 3, 3, 3))
    ring = torch.stack([p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for dy, dx in CIRCLE])
    arcs = (torch.arange(16)[:, None] + torch.arange(9)[None, :]) % 16

    def best_arc(d):
        return torch.stack([d[a].amin(dim=0) for a in arcs]).amax(dim=0)

    score = torch.maximum(best_arc(ring - b[None]), best_arc(b[None] - ring)).float()
    score = torch.where(score > FAST_THRESHOLD, score, 0.0)
    ys, xs = torch.arange(H)[:, None], torch.arange(W)[None, :]
    score = torch.where((ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3), score, 0.0)
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where(score >= neigh, score, 0.0)
    inside = (ys >= EDGE) & (ys < H - EDGE) & (xs >= EDGE) & (xs < W - EDGE)
    return torch.where(inside, score, 0.0)


def select(score: torch.Tensor, budget: int):
    """(x, y) int64 of the level's valid picks."""
    H, W = score.shape
    Hp, Wp = -(-H // CELL) * CELL, -(-W // CELL) * CELL
    ncy, ncx = Hp // CELL, Wp // CELL
    cells = (F.pad(score, (0, Wp - W, 0, Hp - H)).reshape(ncy, CELL, ncx, CELL)
             .permute(0, 2, 1, 3).reshape(ncy * ncx, CELL * CELL))
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :CELL_K], idx[:, :CELL_K]
    rows = torch.arange(ncy * ncx)[:, None]
    py = (rows // ncx) * CELL + idx // CELL
    px = (rows % ncx) * CELL + idx % CELL
    flat = vals.reshape(-1)
    order = torch.sort(-flat, stable=True).indices[:budget]
    keep = flat[order] > 0
    return px.reshape(-1)[order][keep], py.reshape(-1)[order][keep]


def blur(img: torch.Tensor) -> torch.Tensor:
    k = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
    taps = [float(v) for v in (k / k.sum()).astype(np.float32)]
    H, W = img.shape
    p = F.pad(img, (0, 0, 3, 3))
    out = torch.zeros_like(img)
    for i, w in enumerate(taps):
        out = out + w * p[i:i + H]
    p = F.pad(out, (3, 3, 0, 0))
    res = torch.zeros_like(img)
    for i, w in enumerate(taps):
        res = res + w * p[:, i:i + W]
    return res


def describe(blurred: torch.Tensor, x: torch.Tensor, y: torch.Tensor, dtype):
    """uint32 words [n, 8] of keypoints (x, y) on a blurred level."""
    n = x.shape[0]
    if n == 0:
        return np.zeros((0, 8), np.uint32)
    padded = F.pad(blurred.to(torch.bfloat16).float(), (PATCH, PATCH, PATCH, PATCH))
    off = torch.arange(PATCH)
    rows = (y - CENTRE + PATCH)[:, None, None] + off[None, :, None]
    cols = (x - CENTRE + PATCH)[:, None, None] + off[None, None, :]
    patch = padded[rows, cols].reshape(n, PATCH * PATCH)
    d = (np.arange(PATCH) - CENTRE).astype(np.float32)
    disc = (d[:, None] ** 2 + d[None, :] ** 2) <= float(RADIUS * RADIUS)
    wx = torch.from_numpy((d[None, :] * disc).astype(np.float32).reshape(-1)).to(dtype)
    wy = torch.from_numpy((d[:, None] * disc).astype(np.float32).reshape(-1)).to(dtype)
    p = patch.to(dtype)
    ang = torch.atan2((p * wy).sum(-1), (p * wx).sum(-1)).float()
    bins = torch.remainder(torch.round(ang * (N_BINS / (2.0 * np.pi))).long(), N_BINS)
    q = torch.clamp(torch.round(patch) - 128.0, -128.0, 127.0)
    pairs = torch.from_numpy(pair_offsets())[bins]
    bits = (torch.gather(q, 1, pairs[:, :, 0]) < torch.gather(q, 1, pairs[:, :, 1])).numpy()
    words = (bits.reshape(n, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return words.astype(np.uint32)


def extract(image: np.ndarray, n_features: int, n_levels: int, scale: float,
            dtype=torch.float32) -> Keypoints:
    """The keypoints of one 8-bit image [H, W]."""
    H, W = image.shape
    sizes = level_sizes(H, W, n_levels, scale)
    budgets = level_budgets(n_features, n_levels, scale)
    level = torch.from_numpy(np.ascontiguousarray(image)).to(dtype)
    out = []
    for lv in range(n_levels):
        if lv:
            level = resize(level, *sizes[lv])
        if budgets[lv] == 0:
            continue
        x, y = select(fast_scores(level), budgets[lv])
        desc = describe(blur(level), x, y, dtype)
        out.append((np.full(len(x), lv), x.numpy(), y.numpy(), desc))
    return Keypoints(*[np.concatenate(c) for c in zip(*out)])
