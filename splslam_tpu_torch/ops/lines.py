"""Line-segment detection and LBD-style descriptors (port of
splslam_tpu/ops/lines.py).

The detector is grid-seeded oriented growth:
  1. Sobel gradients (zero padded) -> edge magnitude and orientation.
  2. The strongest K_SEED pixels of each cell x cell block are seeds; the
     strongest SEED_CAP of them are kept, the border ring excluded.
  3. From each seed, march up to `max_steps` pixels both ways along the
     level-line direction, bilinearly sampling the magnitude and taking
     the nearest level-line angle; a step is alive while both agree
     (single dropouts bridged). The run ends at the first dead step.
  4. A second march from the first run's centre, a sub-pixel refit, the
     longest candidates per octave; two octaves (2x2 mean pool).
  5. Collinear runs are merged (two rounds), duplicates suppressed, the
     border ring dropped, the longest `capacity` kept.
  6. A final level-0 refit, a content-derived descriptor support, and a
     256-bit banded gradient descriptor (8 int32 words with the bits of
     the reference's uint32 words).

The reference gathers its bilinear corners from a packed 4-wide row table
(`_pack4`, a TPU gather layout); the values are the same as four plain
indexed reads, which is what the port does. The march is plain tensor
code, as it is plain XLA in the reference: every step of every seed is
one [seeds, steps] tensor op. Selections break ties toward the lower
index, as `lax.top_k` does (`ops/topk.py`).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from splslam_tpu_torch.ops.consts import device_const
from splslam_tpu_torch.ops.match import float_mod
from splslam_tpu_torch.ops.orb_kernel import pack_bits
from splslam_tpu_torch.ops.topk import argmax_topk, stable_top

N_WORDS = 8
SEED_CAP = 512          # strongest seeds marched per octave
MAX_STEPS = 64          # max half-length of a segment, pixels
LEVEL_SEED_CAP = (512, 512)   # per-octave march budgets (last repeats)
LEVEL_MAX_STEPS = (64, 64)
ANGLE_TOL = 0.35        # rad, level-line angle agreement
MAG_FRAC = 0.02         # min gradient magnitude as a fraction of max
CANON_BRIDGE = 10       # canonical-extent re-march gap tolerance, px
K_SEED = 2              # seed pixels per grid cell

N_BANDS = 8             # bands across the line support region
BAND_SAMPLES = 16       # samples along the line per band
BAND_WIDTH = 7.0        # support region half-width in px
LBD_SMOOTH = 2          # [1,2,1]/4 separable passes before sampling

PI = math.pi


class LineFeatures(NamedTuple):
    """Fixed-capacity line table (one frame)."""

    seg: torch.Tensor       # [L,4] endpoints [sx,sy,ex,ey] (level-0 px)
    midpoint: torch.Tensor  # [L,2]
    angle: torch.Tensor     # [L] segment direction, radians
    length: torch.Tensor    # [L] 2D length in px
    response: torch.Tensor  # [L] seed gradient magnitude
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

    def with_segments(self, seg: torch.Tensor) -> "LineFeatures":
        """Replace endpoints (e.g. after undistortion), refresh derived."""
        d = seg[:, 2:4] - seg[:, :2]
        return self._replace(seg=seg, midpoint=0.5 * (seg[:, :2] + seg[:, 2:4]),
                             angle=torch.atan2(d[:, 1], d[:, 0]),
                             length=_norm(d))


# ----------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------
@lru_cache(maxsize=None)
def _const_np(key: tuple) -> np.ndarray:
    kind, *args = key
    if kind == "linspace":
        # jnp.linspace's float32 formula: start*(1-s) + stop*s, s = i/div,
        # with the last entry exactly `stop`
        a, b, n = np.float32(args[0]), np.float32(args[1]), args[2]
        s = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
        return np.concatenate([a * (np.float32(1) - s) + b * s, [b]]).astype(np.float32)
    if kind == "lbd_pairs":
        pi_, pj_ = [], []
        for i in range(N_BANDS):
            for j in range(i + 1, N_BANDS):
                for s_ in range(8):
                    pi_.append(i * 8 + s_)
                    pj_.append(j * 8 + s_)
        for i in range(N_BANDS):
            pi_ += [i * 8 + 0, i * 8 + 2, i * 8 + 0, i * 8 + 2]
            pj_ += [i * 8 + 1, i * 8 + 3, i * 8 + 4, i * 8 + 6]
        return np.stack([pi_, pj_]).astype(np.int64)
    raise KeyError(kind)


def _const(key: tuple, device) -> torch.Tensor:
    """A small constant table, sent to each device once."""
    return device_const(("lines",) + key, device, lambda: _const_np(key))


def _linspace(a: float, b: float, n: int, device) -> torch.Tensor:
    return _const(("linspace", a, b, n), device)


def _norm(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as jnp.linalg.norm forms it."""
    return torch.sqrt(torch.sum(d * d, dim=-1))


def _clip_xy(p: torch.Tensor, W: int, H: int) -> torch.Tensor:
    return torch.stack([p[:, 0].clamp(0.0, W - 1.0),
                        p[:, 1].clamp(0.0, H - 1.0)], dim=-1)


def sobel_gradients(image: torch.Tensor):
    """(H,W) -> (gx, gy) via 3x3 Sobel with ZERO padding: the dark border
    makes the image boundary the strongest gradient, which lifts the
    global magnitude floor (mag_th = MAG_FRAC * max) above texture noise;
    the border-ring segments it creates are dropped later."""
    p = F.pad(image, (1, 1, 1, 1))
    sx = p[:, 2:] - p[:, :-2]            # [H+2, W] central dx
    sy = p[2:, :] - p[:-2, :]            # [H, W+2] central dy
    gx = sx[:-2] + 2.0 * sx[1:-1] + sx[2:]
    gy = sy[:, :-2] + 2.0 * sy[:, 1:-1] + sy[:, 2:]
    return gx, gy


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H,W] at (x, y) clipped into the image (the
    right/bottom neighbour always exists)."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = img.reshape(-1)
    base = y0.long() * W + x0.long()
    return (flat[base] * (1 - fx) * (1 - fy)
            + flat[base + 1] * fx * (1 - fy)
            + flat[base + W] * (1 - fx) * fy
            + flat[base + W + 1] * fx * fy)


def _angle_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Smallest difference between undirected line orientations (mod pi)."""
    d = float_mod(a - b, PI)
    return torch.minimum(d, PI - d)


def _smooth121(g: torch.Tensor) -> torch.Tensor:
    """One separable [1,2,1]/4 smoothing pass (edge-replicate pad)."""
    p = F.pad(g[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    h = 0.25 * (p[1:-1, :-2] + 2.0 * p[1:-1, 1:-1] + p[1:-1, 2:])
    p = F.pad(h[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return 0.25 * (p[:-2, 1:-1] + 2.0 * p[1:-1, 1:-1] + p[2:, 1:-1])


# ----------------------------------------------------------------------
# the march
# ----------------------------------------------------------------------
def _grow(seeds_xy, seed_angle, ang_map, mag, mag_th, direction: float,
          max_steps: int = MAX_STEPS, stride: float = 1.0, bridge: int = 1,
          angle_tol: float = ANGLE_TOL) -> torch.Tensor:
    """March from seeds along direction * (cos a, sin a); return run
    lengths [C] in pixels. A step is alive while the bilinear magnitude
    exceeds half the seed threshold and the nearest level-line angle
    agrees within angle_tol; a dead run of up to `bridge` samples with a
    live sample within `bridge` steps on both sides stays alive."""
    H, W = ang_map.shape
    dev = seeds_xy.device
    steps = torch.arange(1, max_steps + 1, dtype=torch.float32, device=dev) * stride
    dx = torch.cos(seed_angle)[:, None] * steps[None, :] * direction
    dy = torch.sin(seed_angle)[:, None] * steps[None, :] * direction
    xs = seeds_xy[:, 0:1] + dx
    ys = seeds_xy[:, 1:2] + dy
    m = _bilinear(mag, xs, ys)
    xi = torch.clamp(torch.round(xs), 0, W - 1).long()
    yi = torch.clamp(torch.round(ys), 0, H - 1).long()
    ang = ang_map.reshape(-1)[yi * W + xi]
    alive = (m > 0.5 * mag_th) & (_angle_diff(ang, seed_angle[:, None]) < angle_tol)
    before = alive
    after = alive
    for k in range(1, bridge + 1):
        pad = torch.zeros_like(alive[:, :k])
        one = torch.ones_like(alive[:, :k])
        before = before | torch.cat([one, alive[:, :-k]], 1)
        after = after | torch.cat([alive[:, k:], pad], 1)
    alive = alive | (before & after)
    run = torch.cumprod(alive.to(torch.int32), dim=1)
    return torch.sum(run, dim=1).to(torch.float32) * stride


def _grow_fb(seeds_xy, seed_angle, ang_map, mag, mag_th,
             max_steps: int = MAX_STEPS, stride: float = 1.0, bridge: int = 1,
             angle_tol: float = ANGLE_TOL):
    """Forward and backward runs [C] each, as one march over 2C lanes: the
    backward run is the forward run at seed_angle + pi (the angle gate is
    mod pi)."""
    C = seeds_xy.shape[0]
    s2 = torch.cat([seeds_xy, seeds_xy], dim=0)
    a2 = torch.cat([seed_angle, seed_angle + PI], dim=0)
    th = mag_th
    if th.dim() >= 1 and th.shape[0] == C:
        th = torch.cat([th, th], dim=0)
    run = _grow(s2, a2, ang_map, mag, th, +1.0, max_steps, stride, bridge,
                angle_tol)
    return run[:C], run[C:]


def _refine_direction(seeds_xy, seed_angle, gx, gy):
    """Level-line direction from the magnitude-weighted double-angle mean
    of the gradient over a +-3-step probe along the seed direction."""
    steps = torch.arange(-3, 4, dtype=torch.float32, device=seeds_xy.device)
    dx = torch.cos(seed_angle)[:, None] * steps[None, :]
    dy = torch.sin(seed_angle)[:, None] * steps[None, :]
    xs = seeds_xy[:, 0:1] + dx
    ys = seeds_xy[:, 1:2] + dy
    sgx = _bilinear(gx, xs, ys)
    sgy = _bilinear(gy, xs, ys)
    th = torch.atan2(sgy, sgx)
    w = torch.sqrt(sgx * sgx + sgy * sgy)
    c2 = torch.sum(w * torch.cos(2 * th), dim=1)
    s2 = torch.sum(w * torch.sin(2 * th), dim=1)
    return 0.5 * torch.atan2(s2, c2) + 0.5 * PI


def _refine_segment(p_start, p_end, mag, n_samp: int = 16, probe: int = 2):
    """Sub-pixel refinement: n_samp points along the segment move to the
    magnitude centroid of a +-probe px normal probe, then a weighted
    total-least-squares line fit; the endpoints are projected onto it."""
    dev = p_start.device
    t = _linspace(0.0, 1.0, n_samp, dev)
    px = p_start[:, 0, None] + (p_end[:, 0] - p_start[:, 0])[:, None] * t
    py = p_start[:, 1, None] + (p_end[:, 1] - p_start[:, 1])[:, None] * t
    d = p_end - p_start
    ln = torch.clamp(_norm(d), min=1e-6)
    nx = (-d[:, 1] / ln)[:, None, None]
    ny = (d[:, 0] / ln)[:, None, None]
    off = torch.arange(-probe, probe + 1, dtype=torch.float32, device=dev)[None, None, :]
    sx = px[:, :, None] + nx * off
    sy = py[:, :, None] + ny * off
    m = _bilinear(mag, sx, sy)                       # [C, n_samp, 2p+1]
    w = m / torch.clamp(torch.sum(m, dim=-1, keepdim=True), min=1e-6)
    sh = torch.sum(w * off, dim=-1)                  # [C, n_samp] normal shift
    cx = px + sh * nx[:, :, 0]
    cy = py + sh * ny[:, :, 0]
    wm = torch.sum(m, dim=-1)
    wsum = torch.clamp(torch.sum(wm, dim=-1, keepdim=True), min=1e-6)
    mx = torch.sum(wm * cx, dim=-1, keepdim=True) / wsum
    my = torch.sum(wm * cy, dim=-1, keepdim=True) / wsum
    ux = cx - mx
    uy = cy - my
    sxx = torch.sum(wm * ux * ux, dim=-1)
    syy = torch.sum(wm * uy * uy, dim=-1)
    sxy = torch.sum(wm * ux * uy, dim=-1)
    theta = 0.5 * torch.atan2(2 * sxy, sxx - syy)   # principal direction
    dvx = torch.cos(theta)
    dvy = torch.sin(theta)

    def proj(p):
        s = (p[:, 0] - mx[:, 0]) * dvx + (p[:, 1] - my[:, 0]) * dvy
        return torch.stack([mx[:, 0] + s * dvx, my[:, 0] + s * dvy], dim=-1)

    return proj(p_start), proj(p_end)


def _detect_level(image: torch.Tensor, cell: int, min_length: float,
                  backend: str = "grow", level_cap: int = 256, grads=None,
                  seed_cap: int | None = None, max_steps: int = MAX_STEPS):
    """One detection octave: seeds -> growth -> refinement. Returns
    (a [C,2], b [C,2], length [C], ok [C], cmax [C]) in this level's pixel
    coordinates. `backend` "grow" seeds from the raw per-cell gradient
    maxima (the LSD analog); "fld" from a non-maximum-suppressed edge map
    (the FLD analog, a Canny-lite)."""
    H, W = image.shape
    dev = image.device
    gx, gy = grads if grads is not None else sobel_gradients(image)
    mag = torch.sqrt(gx * gx + gy * gy)
    mag_th = torch.clamp(torch.max(mag) * MAG_FRAC, min=1e-3)

    seed_map = mag
    if backend == "fld":
        inv = 1.0 / torch.clamp(mag, min=1e-6)
        ux, uy = gx * inv, gy * inv
        ys_g, xs_g = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                    torch.arange(W, dtype=torch.float32, device=dev),
                                    indexing="ij")
        m1 = _bilinear(mag, xs_g + ux, ys_g + uy)
        m2 = _bilinear(mag, xs_g - ux, ys_g - uy)
        seed_map = torch.where((mag >= m1) & (mag >= m2), mag, 0.0)

    # seeds: the K_SEED strongest pixels of each cell
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    pm = F.pad(seed_map, (0, Wp - W, 0, Hp - H))
    ncy, ncx = Hp // cell, Wp // cell
    cells = pm.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell)
    cmaxs, idxs = argmax_topk(cells, K_SEED)
    cid = torch.arange(ncy * ncx, device=dev)[:, None]
    cy = ((cid // ncx) * cell + idxs // cell).reshape(-1)
    cx = ((cid % ncx) * cell + idxs % cell).reshape(-1)
    cmax = cmaxs.reshape(-1)
    seeds = torch.stack([cx, cy], dim=-1).to(torch.float32)
    # Border seeds only ever grow the zero-pad frame segments; keep them
    # out of the magnitude-ranked cap below.
    border = (cx < 3) | (cx >= W - 3) | (cy < 3) | (cy >= H - 3)
    seed_ok = (cmax > mag_th) & ~border

    seed_angle = torch.atan2(gy[cy, cx], gx[cy, cx]) + 0.5 * PI
    seed_angle = _refine_direction(seeds, seed_angle, gx, gy)

    cap = SEED_CAP if seed_cap is None else seed_cap
    if seeds.shape[0] > cap:
        _, si = stable_top(torch.where(seed_ok, cmax, -1.0), cap)
        seeds, cmax, seed_ok, seed_angle = seeds[si], cmax[si], seed_ok[si], seed_angle[si]

    # bidirectional growth, twice: the second march starts from the first
    # run's centre with the direction refit there
    ang_map = torch.atan2(gy, gx) + 0.5 * PI
    fwd, bwd = _grow_fb(seeds, seed_angle, ang_map, mag, mag_th, max_steps)
    dirv = torch.stack([torch.cos(seed_angle), torch.sin(seed_angle)], dim=-1)
    center = seeds + dirv * (0.5 * (fwd - bwd))[:, None]
    ang2 = _refine_direction(center, seed_angle, gx, gy)
    fwd, bwd = _grow_fb(center, ang2, ang_map, mag, mag_th, max_steps)
    dirv = torch.stack([torch.cos(ang2), torch.sin(ang2)], dim=-1)
    p_end = center + dirv * fwd[:, None]
    p_start = center - dirv * bwd[:, None]
    length = fwd + bwd
    ok = seed_ok & (length >= min_length)

    # the longest level_cap candidates go on to the refinement
    if length.shape[0] > level_cap:
        _, pi = stable_top(torch.where(ok, length, -1.0), level_cap)
        p_start, p_end = p_start[pi], p_end[pi]
        length, ok, cmax = length[pi], ok[pi], cmax[pi]

    p_start, p_end = _refine_segment(p_start, p_end, mag)
    length = _norm(p_end - p_start)

    # canonical orientation: flip by the dominant axis, with a tolerance
    # band for near-vertical lines
    d0 = p_end - p_start
    near_vert = torch.abs(d0[:, 0]) < 0.05 * torch.clamp(length, min=1.0)
    swap = torch.where(near_vert, d0[:, 1] < 0, d0[:, 0] < 0)
    a = torch.where(swap[:, None], p_end, p_start)
    b = torch.where(swap[:, None], p_start, p_end)
    return a, b, length, ok, cmax


def _canonical_support(a, b, gx, gy, W_img: int, H_img: int, min_length: float):
    """A final level-0 refit of every kept segment (its geometry), and the
    descriptor's support: the extent re-marched on the smoothed level-0
    field from both the refit and the pre-refit geometry with a per-line
    threshold, the longer of the two, falling back to the refit extent
    when the re-march collapses. Returns (a, b, a_d, b_d, use_c)."""
    dev = a.device
    mag0 = torch.sqrt(gx * gx + gy * gy)
    a0, b0 = a, b
    a, b = _refine_segment(a, b, mag0, n_samp=32, probe=3)

    gx_s = _smooth121(_smooth121(gx))
    gy_s = _smooth121(_smooth121(gy))
    mag_s = torch.sqrt(gx_s * gx_s + gy_s * gy_s)
    ang_map_s = torch.atan2(gy_s, gx_s) + 0.5 * PI
    ang_r = torch.atan2((b - a)[:, 1], (b - a)[:, 0])
    mid_r = 0.5 * (a + b)
    dirv = torch.stack([torch.cos(ang_r), torch.sin(ang_r)], dim=-1)
    t_on = _linspace(0.15, 0.85, 16, dev)

    def _span_inputs(p, q):
        """Midpoint, direction and the per-line continuation threshold
        (0.8 x the median smoothed magnitude along the line)."""
        ang = torch.atan2((q - p)[:, 1], (q - p)[:, 0])
        mid = 0.5 * (p + q)
        on_x = p[:, 0, None] + (q[:, 0] - p[:, 0])[:, None] * t_on[None, :]
        on_y = p[:, 1, None] + (q[:, 1] - p[:, 1])[:, None] * t_on[None, :]
        srt = torch.sort(_bilinear(mag_s, on_x, on_y), dim=-1).values
        m_ref = (srt[:, 7] + srt[:, 8]) * 0.5          # jnp.median of 16
        return mid, ang, (0.8 * m_ref)[:, None]

    # all four marches (fwd/bwd x refit/union geometry) as one
    mid1, ang1, th1 = _span_inputs(a, b)
    mid2, ang2, th2 = _span_inputs(a0, b0)
    C = a.shape[0]
    run = _grow(torch.cat([mid1, mid1, mid2, mid2], dim=0),
                torch.cat([ang1, ang1 + PI, ang2, ang2 + PI]),
                ang_map_s, mag_s, torch.cat([th1, th1, th2, th2], dim=0), +1.0,
                max_steps=192, stride=1.0, bridge=CANON_BRIDGE, angle_tol=0.55)
    fwd1, bwd1 = run[0:C], run[C:2 * C]
    fwd2, bwd2 = run[2 * C:3 * C], run[3 * C:4 * C]

    def _span(mid, ang, fwd, bwd):
        """(lo, hi) signed extent along the refit direction from mid_r."""
        off = torch.sum((mid - mid_r) * dirv, dim=-1)
        sgn = torch.sign(torch.sum(
            torch.stack([torch.cos(ang), torch.sin(ang)], -1) * dirv, dim=-1))
        sgn = torch.where(sgn == 0, 1.0, sgn)
        lo = off - torch.where(sgn > 0, bwd, fwd)
        hi = off + torch.where(sgn > 0, fwd, bwd)
        return lo, hi

    lo_r, hi_r = _span(mid1, ang1, fwd1, bwd1)
    lo_u, hi_u = _span(mid2, ang2, fwd2, bwd2)
    pick_u = (hi_u - lo_u) > (hi_r - lo_r)
    lo = torch.where(pick_u, lo_u, lo_r)
    hi = torch.where(pick_u, hi_u, hi_r)
    a_c = _clip_xy(mid_r + dirv * lo[:, None], W_img, H_img)
    b_c = _clip_xy(mid_r + dirv * hi[:, None], W_img, H_img)
    ln_c = _norm(b_c - a_c)
    ln_u = _norm(b - a)
    use_c = (ln_c >= 0.5 * min_length) & (ln_c >= 0.35 * ln_u)
    a_d = torch.where(use_c[:, None], a_c, a)
    b_d = torch.where(use_c[:, None], b_c, b)
    return a, b, a_d, b_d, use_c


def _collinear(a, b, length):
    """Pairwise collinear-overlap predicate [C,C] (angle within 0.1 rad,
    perpendicular offset < 4 px, spans within 4 px of touching), with the
    direction, midpoints and the along-axis projections."""
    mid = 0.5 * (a + b)
    ang = torch.atan2(b[:, 1] - a[:, 1], b[:, 0] - a[:, 0])
    dv = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    nv = torch.stack([-dv[:, 1], dv[:, 0]], dim=-1)
    dm = mid[None, :, :] - mid[:, None, :]                 # j rel. to i
    perp = torch.abs(torch.sum(dm * nv[:, None, :], dim=-1))
    along = torch.abs(torch.sum(dm * dv[:, None, :], dim=-1))
    half_span = 0.5 * (length[:, None] + length[None, :]) + 4.0
    same = ((_angle_diff(ang[:, None], ang[None, :]) < 0.1)
            & (perp < 4.0) & (along < half_span))
    return same, mid, dv


def extract_lines(image: torch.Tensor, capacity: int = 128, cell: int = 16,
                  min_length: float = 24.0, n_octaves: int = 2,
                  backend: str = "grow", base_octave: int = 0) -> LineFeatures:
    """Detect up to `capacity` line segments in a grayscale (H,W) float
    image (reference Lineextractor: per-octave detection, merge, top-K by
    length, LBD). `base_octave` = first level that is marched."""
    H, W = image.shape
    gx, gy = sobel_gradients(image)

    cand = []
    lv_img = image
    for lv in range(base_octave + n_octaves):
        if lv > 0:
            # 2x2 mean pool (odd sizes cropped)
            Hc = (lv_img.shape[0] // 2) * 2
            Wc = (lv_img.shape[1] // 2) * 2
            lv_img = lv_img[:Hc, :Wc].reshape(Hc // 2, 2, Wc // 2, 2).mean(dim=(1, 3))
        if lv < base_octave:
            continue
        s = 2.0 ** lv
        a, b, ln, ok, cm = _detect_level(
            lv_img, cell, max(min_length / s, 12.0), backend=backend,
            level_cap=max(192, 2 * capacity),
            grads=(gx, gy) if lv == 0 else None,
            seed_cap=LEVEL_SEED_CAP[min(lv, len(LEVEL_SEED_CAP) - 1)],
            max_steps=LEVEL_MAX_STEPS[min(lv, len(LEVEL_MAX_STEPS) - 1)],
        )
        cand.append((a * s, b * s, ln * s, ok, cm,
                     torch.full(ok.shape, lv, dtype=torch.int32, device=image.device)))
    a, b, length, ok, cmax, octv = (torch.cat(c) for c in zip(*cand))
    response = torch.where(ok, length * 0.0 + cmax, 0.0)

    # merge collinear overlapping runs into their union extent, twice
    for _ in range(2):
        same, mid, dv = _collinear(a, b, length)
        same = same & ok[:, None] & ok[None, :]
        ta = torch.sum((a[None, :, :] - mid[:, None, :]) * dv[:, None, :], -1)
        tb = torch.sum((b[None, :, :] - mid[:, None, :]) * dv[:, None, :], -1)
        tmin = torch.min(torch.where(same, torch.minimum(ta, tb), math.inf), dim=1).values
        tmax = torch.max(torch.where(same, torch.maximum(ta, tb), -math.inf), dim=1).values
        grew = ok & torch.isfinite(tmin) & torch.isfinite(tmax)
        a = torch.where(grew[:, None], mid + tmin[:, None] * dv, a)
        b = torch.where(grew[:, None], mid + tmax[:, None] * dv, b)
        a = _clip_xy(a, W, H)
        b = _clip_xy(b, W, H)
        length = _norm(b - a)
        ok = ok & (length >= 0.5 * min_length)
    # keep the longest of each collinear group (ties to the lower index)
    same, _, _ = _collinear(a, b, length)
    score = torch.where(ok, length, -1.0)
    idx = torch.arange(score.shape[0], device=image.device)
    better = (score[None, :] > score[:, None]) | (
        (score[None, :] == score[:, None]) & (idx[None, :] < idx[:, None]))
    ok = ok & ~torch.any(same & better & ok[None, :], dim=1)

    # drop the zero-pad border ring: both endpoints within 3 px of one edge
    margin = 3.0
    for k_ax, lim in ((0, W - 1.0), (1, H - 1.0)):
        on_low = (a[:, k_ax] < margin) & (b[:, k_ax] < margin)
        on_high = (a[:, k_ax] > lim - margin) & (b[:, k_ax] > lim - margin)
        ok = ok & ~on_low & ~on_high

    top_val, top_i = stable_top(torch.where(ok, length, -1.0), capacity)
    a = a[top_i]
    b = b[top_i]
    valid = top_val > 0

    a, b, a_d, b_d, _ = _canonical_support(a, b, gx, gy, W, H, min_length)
    d = b - a
    d_d = b_d - a_d
    desc = lbd_descriptor(image, gx, gy, torch.cat([a_d, b_d], dim=-1),
                          torch.atan2(d_d[:, 1], d_d[:, 0]), _norm(d_d))
    return LineFeatures(
        seg=torch.cat([a, b], dim=-1),
        midpoint=0.5 * (a + b),
        angle=torch.atan2(d[:, 1], d[:, 0]),
        length=torch.where(valid, _norm(d), 0.0),
        response=response[top_i],
        desc=desc,
        valid=valid,
        octave=torch.where(valid, octv[top_i], 0),
    )


def lbd_descriptor(image, gx, gy, seg, angle, length) -> torch.Tensor:
    """LBD-like 256-bit banded gradient descriptor for segments [L,4]:
    the smoothed gradient sampled on 8 bands x 16 columns along the line,
    rotated into the line frame, pooled per band into (mean+, mean-,
    std+, std-) of both components with each column weighted by the
    on-line magnitude; band-pair comparisons give 224 bits, same-band
    cross-statistic comparisons 32. [L,8] int32 words."""
    L = seg.shape[0]
    dev = seg.device
    for _ in range(LBD_SMOOTH):
        gx = _smooth121(gx)
        gy = _smooth121(gy)
    t = _linspace(0.05, 0.95, BAND_SAMPLES, dev)
    band_off = _linspace(-BAND_WIDTH, BAND_WIDTH, N_BANDS, dev)
    ca, sa = torch.cos(angle), torch.sin(angle)
    base_x = seg[:, 0, None] + (seg[:, 2] - seg[:, 0])[:, None] * t[None, :]
    base_y = seg[:, 1, None] + (seg[:, 3] - seg[:, 1])[:, None] * t[None, :]
    off_x = -sa[:, None] * band_off[None, :]
    off_y = ca[:, None] * band_off[None, :]
    xs = base_x[:, None, :] + off_x[:, :, None]
    ys = base_y[:, None, :] + off_y[:, :, None]
    sgx = _bilinear(gx, xs, ys)
    sgy = _bilinear(gy, xs, ys)
    g_par = ca[:, None, None] * sgx + sa[:, None, None] * sgy
    g_perp = -sa[:, None, None] * sgx + ca[:, None, None] * sgy

    # per-column support weight: the max magnitude over a +-1 px normal probe
    mags = []
    for probe in (-1.0, 0.0, 1.0):
        px = base_x - sa[:, None] * probe
        py = base_y + ca[:, None] * probe
        mgx = _bilinear(gx, px, py)
        mgy = _bilinear(gy, px, py)
        mags.append(mgx * mgx + mgy * mgy)
    w = torch.sqrt(torch.maximum(torch.maximum(mags[0], mags[1]), mags[2]))
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-6)
    w = w[:, None, :]                                # [L,1,S]

    def stats(g):
        pos = torch.clamp(g, min=0.0)
        neg = torch.clamp(-g, min=0.0)

        def wmean(x):
            return torch.sum(w * x, dim=-1)

        def wstd(x):
            m = wmean(x)
            return torch.sqrt(torch.clamp(wmean(x * x) - m * m, min=0.0))

        return torch.stack([wmean(pos), wmean(neg), wstd(pos), wstd(neg)], dim=-1)

    flat = torch.cat([stats(g_par), stats(g_perp)], dim=-1).reshape(L, N_BANDS * 8)
    pairs = _const(("lbd_pairs",), dev)
    return pack_bits(flat[:, pairs[0]] > flat[:, pairs[1]])
