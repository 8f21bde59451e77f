"""Synthetic textured-plane sequences with exact ground-truth poses.

Host-side test/benchmark utility (numpy): renders a camera moving in front
of one or two textured planes. The reference validates against TUM/KITTI
datasets (SURVEY §4); those aren't available in CI, so end-to-end tests
and benchmarks run on these sequences where ATE can be computed against
perfect ground truth.

This is the port's own copy of `splslam_tpu/io/synthetic.py` (numpy and
scipy only), kept line for line so that both packages run the same
sequences; `tests/test_torch_synthetic.py` holds the two equal. The port
imports nothing of the JAX package, this module included.
`make_loop_circuit` is tests/test_loop.py's scene, for the loop-closing
runs of the port's tests and smoke script.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates


def make_texture(size: int = 2048, seed: int = 0, scale_px: int = 4) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = r.uniform(0, 1, size=(size // scale_px, size // scale_px))
    t = np.kron(t, np.ones((scale_px, scale_px)))
    t = gaussian_filter(t, 1.2)
    t = (t - t.min()) / (np.ptp(t) + 1e-9) * 255.0
    return t.astype(np.float32)


def make_grid_texture(size: int = 2048, seed: int = 0,
                      spacing: int = 192, width: int = 8) -> np.ndarray:
    """Texture with strong straight grid lines over random blotches —
    exercises the LINE pipeline (point+line scenes like the reference's
    TUM structure-texture sequences)."""
    t = make_texture(size, seed=seed)
    # Solid dark grid strokes on top of full-contrast blobs: ORB keeps
    # its distinctive corners, the line detector gets strong straight
    # edges with uniform interior (LSD-friendly).
    for i in range(0, size, spacing):
        t[i:i + width, :] = 15.0
        t[:, i:i + width] = 15.0
    return t.astype(np.float32)


class PlaneScene:
    """World: plane z = z0 textured with `texture`; 1 world unit maps to
    `px_per_unit` texture pixels. Optionally a second plane at z1 covering
    the outer image region (depth variation exercises stereo + BA)."""

    def __init__(self, texture: np.ndarray, z0: float = 5.0,
                 z1: float | None = 12.0, px_per_unit: float = 100.0):
        self.tex = texture
        self.z0 = z0
        self.z1 = z1
        self.ppu = px_per_unit

    def render(self, K: np.ndarray, Twc: np.ndarray, height: int,
               width: int, with_depth: bool = False):
        """Render the view from camera-to-world pose Twc (4,4).

        with_depth=True additionally returns the per-pixel camera-frame
        depth map [H,W] (the ray parameter t IS z_cam because rays are
        unit-z in camera coordinates) — the ground-truth registered
        depth image an RGB-D sensor would deliver (reference
        Frame::ComputeStereoFromRGBD consumes exactly this,
        src/Frame.cc:1057-1079)."""
        us, vs = np.meshgrid(np.arange(width), np.arange(height))
        pix = np.stack([us, vs, np.ones_like(us)], axis=-1).reshape(-1, 3)
        rays_c = pix @ np.linalg.inv(K).T
        R = Twc[:3, :3]
        o = Twc[:3, 3]
        rays_w = rays_c @ R.T

        def plane_uv(z_plane, mask_extra=None):
            dz = rays_w[:, 2]
            t = (z_plane - o[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
            p = o[None] + rays_w * t[:, None]
            return p, t

        p0, t0 = plane_uv(self.z0)
        use0 = t0 > 0
        if self.z1 is not None:
            # quadrant depth pattern: diagonal quadrants see the near
            # plane, the others the far plane — the asymmetric depth
            # layout separates yaw from lateral translation (a fully
            # fronto-parallel scene is degenerate for that pair)
            cx, cy = K[0, 2], K[1, 2]
            near = (pix[:, 0] < cx) ^ (pix[:, 1] < cy)
            p1, t1 = plane_uv(self.z1)
            sel = use0 & near
            p = np.where(sel[:, None], p0, p1)
            t = np.where(sel, t0, t1)
        else:
            p, t = p0, t0
        tx = p[:, 0] * self.ppu + self.tex.shape[1] / 2
        ty = p[:, 1] * self.ppu + self.tex.shape[0] / 2
        img = map_coordinates(self.tex, [ty, tx], order=1, mode="wrap")
        img = img.reshape(height, width).astype(np.float32)
        if with_depth:
            depth = np.where(t > 0, t, 0.0).reshape(height, width)
            return img, depth.astype(np.float32)
        return img


class CorridorScene:
    """World: the inside of a textured box corridor along +z (side walls
    x = ±half_w, floor/ceiling y = ±half_h, back wall z = z_far). Unlike
    PlaneScene the visible depth varies continuously along the walls, so
    two-view geometry is genuinely non-planar: the fundamental/essential
    model must win the RH score (reference Initializer.cc:218-224) and
    BA sees a full depth range — the realistic (corridor/KITTI-street)
    case the planar scenes cannot exercise."""

    def __init__(self, texture: np.ndarray, half_w: float = 1.5,
                 half_h: float = 1.0, z_far: float = 8.0,
                 px_per_unit: float = 100.0):
        self.tex = texture
        self.hw = half_w
        self.hh = half_h
        self.zf = z_far
        self.ppu = px_per_unit

    def render(self, K: np.ndarray, Twc: np.ndarray, height: int,
               width: int, with_depth: bool = False):
        us, vs = np.meshgrid(np.arange(width), np.arange(height))
        pix = np.stack([us, vs, np.ones_like(us)], axis=-1).reshape(-1, 3)
        rays_w = (pix @ np.linalg.inv(K).T) @ Twc[:3, :3].T
        o = Twc[:3, 3]
        eps = 1e-9
        big = np.float64(np.inf)

        # Each surface: (t, texture-u, texture-v, texture offset) with
        # invalid rays masked to t=inf; the closest surface wins.
        def hit(axis, value, uax, vax, off):
            d = rays_w[:, axis]
            t = (value - o[axis]) / np.where(np.abs(d) < eps, eps, d)
            p = o[None] + rays_w * t[:, None]
            ok = t > 1e-6
            for ax, lim in ((0, self.hw), (1, self.hh)):
                if ax != axis:
                    ok &= np.abs(p[:, ax]) <= lim + 1e-6
            ok &= p[:, 2] <= self.zf + 1e-6
            return (np.where(ok, t, big), p[:, uax] + off[0],
                    p[:, vax] + off[1])

        surfaces = [
            hit(0, -self.hw, 2, 1, (0.0, 0.0)),     # left wall  (z,y)
            hit(0, +self.hw, 2, 1, (7.3, 3.1)),     # right wall
            hit(1, -self.hh, 2, 0, (2.9, 11.7)),    # ceiling    (z,x)
            hit(1, +self.hh, 2, 0, (13.4, 5.2)),    # floor
            hit(2, self.zf, 0, 1, (4.8, 8.6)),      # back wall  (x,y)
        ]
        ts = np.stack([s[0] for s in surfaces])      # [5,P]
        uu = np.stack([s[1] for s in surfaces])
        vv = np.stack([s[2] for s in surfaces])
        pick = ts.argmin(0)
        ar = np.arange(ts.shape[1])
        tx = uu[pick, ar] * self.ppu + self.tex.shape[1] / 2
        ty = vv[pick, ar] * self.ppu + self.tex.shape[0] / 2
        img = map_coordinates(self.tex, [ty, tx], order=1, mode="wrap")
        img = img.reshape(height, width).astype(np.float32)
        if with_depth:
            t = ts[pick, ar]
            depth = np.where(np.isfinite(t), t, 0.0).reshape(height, width)
            return img, depth.astype(np.float32)
        return img


def make_stereo_sequence(
    n_frames: int = 30,
    width: int = 320,
    height: int = 240,
    fx: float = 200.0,
    baseline: float = 0.12,
    seed: int = 0,
    motion: str = "lateral",
    texture: str = "blobs",
    scene: str = "planes",
    speed: float = 1.0,
    lighting_drift: float = 0.0,
    osc_amp: float = 0.8,
):
    """Returns (K, bf, list[(imgL, imgR)], gt_Twc [F,4,4]).

    motion="tour": a parity-grade trajectory for long-sequence ATE
    validation — lateral sweep out, a rotation-dominant 180-degree yaw
    turn over ~40 frames (near-zero translation, the case that breaks
    motion-model-only trackers), a sweep back over the SAME scene
    (revisit: exercises re-matching against old landmarks and loop
    closure), and a final settle. `lighting_drift` scales frame
    brightness by 1 +- drift * sin over the run (the reference's TUM
    sequences have exposure drift; descriptors must survive it)."""
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]], np.float32)
    tex = make_grid_texture(seed=seed) if texture == "grid" else make_texture(seed=seed)
    scene_obj = (CorridorScene(tex) if scene == "corridor"
                 else PlaneScene(tex))
    scene = scene_obj
    poses = []
    frames = []

    def _yaw(th):
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    if motion == "tour":
        # piecewise schedule in fractions of n_frames:
        # 0-40% lateral out, 40-55% yaw turn in place (rotation-dominant),
        # 55-95% travel back (now facing the scene after a 2*beta yaw,
        # moving -x), 95-100% settle.
        n1 = int(n_frames * 0.40)
        n2 = int(n_frames * 0.15)
        n3 = int(n_frames * 0.40)
        n4 = n_frames - n1 - n2 - n3
        beta = 0.35  # half-turn amplitude, rad (keeps the plane in view)
        x = 0.0
        sched = []
        for i in range(n1):
            x = 0.04 * speed * i
            sched.append((x, 0.01 * np.sin(i * 0.3), 0.0))
        x_end = x
        for j in range(n2):
            f = (j + 1) / n2
            sched.append((x_end + 0.01 * np.sin(np.pi * f), 0.0,
                          2.0 * beta * f))
        for j in range(n3):
            sched.append((x_end - 0.04 * speed * j, 0.01 * np.cos(j * 0.3),
                          2.0 * beta))
        x_back = sched[-1][0]
        for j in range(n4):
            sched.append((x_back, 0.0, 2.0 * beta * (1.0 - (j + 1) / n4)))
        for i, (tx, ty, yaw) in enumerate(sched):
            Twc = np.eye(4)
            Twc[:3, :3] = _yaw(yaw - beta)  # center the turn on the scene
            Twc[0, 3] = tx
            Twc[1, 3] = ty
            poses.append(Twc)
    else:
        for i in range(n_frames):
            Twc = np.eye(4)
            if motion == "lateral":
                Twc[0, 3] = 0.04 * speed * i
                Twc[1, 3] = 0.01 * np.sin(i * 0.3)
            elif motion == "oscillate":
                # Smooth closed lateral path: same peak velocity as
                # "lateral" (0.04*speed/frame) regardless of amplitude
                # (w = 0.04/osc_amp keeps A*w invariant), and the
                # turnaround is velocity-continuous — palindromic
                # shuttling of a one-way leg flips the velocity in a
                # single frame, which breaks constant-velocity motion
                # models (benchmarks need arbitrarily long in-scene
                # runs). `osc_amp` bounds the excursion: with no map
                # growth (local mapping off) the tracked set lives on
                # the INIT view's landmarks, and an excursion past the
                # init view's overlap starves it.
                Twc[0, 3] = osc_amp * np.sin(0.04 / osc_amp * speed * i)
                Twc[1, 3] = 0.01 * np.sin(i * 0.3)
            elif motion == "forward":
                Twc[2, 3] = 0.03 * speed * i
                Twc[0, 3] = 0.01 * speed * i
            else:  # arc
                th = 0.01 * i
                Twc[:3, :3] = _yaw(th)
                Twc[0, 3] = 0.05 * speed * i
            poses.append(Twc.copy())
    for i, Twc in enumerate(poses):
        gain = 1.0 + lighting_drift * np.sin(2.0 * np.pi * i / max(n_frames, 1))
        imgL = scene.render(K, Twc, height, width)
        Twc_r = Twc.copy()
        Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([baseline, 0, 0])
        imgR = scene.render(K, Twc_r, height, width)
        if lighting_drift:
            imgL = np.clip(imgL * gain, 0.0, 255.0)
            imgR = np.clip(imgR * gain, 0.0, 255.0)
        frames.append((imgL, imgR))
    return K, fx * baseline, frames, np.stack(poses)


def make_rgbd_sequence(
    n_frames: int = 30,
    width: int = 320,
    height: int = 240,
    fx: float = 200.0,
    baseline: float = 0.12,
    seed: int = 0,
    motion: str = "forward",
    texture: str = "blobs",
    scene: str = "planes",
    speed: float = 1.0,
    depth_dropout: float = 0.0,
    depth_noise: float = 0.0,
):
    """RGB-D counterpart of make_stereo_sequence: returns
    (K, bf, list[(img, depth)], gt_Twc). Depth is the registered
    camera-frame z map a TUM-style RGB-D sensor delivers (reference
    Examples/RGB-D/rgbd_tum.cc feeds exactly an (rgb, depth) pair per
    frame into System::TrackRGBD).

    depth_dropout: fraction of pixels whose depth reads 0 (invalid) —
    real structured-light sensors have holes at oblique/dark surfaces;
    the d>0 gate in depth_from_rgbd must leave those keypoints
    depth-less (mono-like), not corrupt them.
    depth_noise: multiplicative sigma of per-pixel Gaussian depth noise
    (Kinect-class error grows with distance; multiplicative is the
    standard model).

    `bf` is the VIRTUAL stereo baseline*fx the reference uses to
    synthesize right-coordinates from depth (Frame.cc:1057-1079 mbf);
    returned so Settings.bf matches the tracking-side expectation.
    """
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]],
                 np.float32)
    tex = (make_grid_texture(seed=seed) if texture == "grid"
           else make_texture(seed=seed))
    scene_obj = (CorridorScene(tex) if scene == "corridor"
                 else PlaneScene(tex))
    # Reuse make_stereo_sequence's trajectory schedules by regenerating
    # the exact same pose list (rendering is the expensive part; the
    # pose math is cheap enough to duplicate via the public call).
    _, _, _, gt = make_stereo_sequence(
        n_frames=n_frames, width=2, height=2, fx=fx, baseline=baseline,
        seed=seed, motion=motion, texture=texture, scene="planes",
        speed=speed)
    rng = np.random.default_rng(seed + 1)
    frames = []
    for Twc in gt:
        img, depth = scene_obj.render(K, Twc, height, width,
                                      with_depth=True)
        if depth_noise > 0.0:
            depth = depth * (1.0 + depth_noise
                             * rng.standard_normal(depth.shape))
            depth = np.maximum(depth, 0.0).astype(np.float32)
        if depth_dropout > 0.0:
            holes = rng.random(depth.shape) < depth_dropout
            depth = np.where(holes, 0.0, depth).astype(np.float32)
        frames.append((img, depth))
    return K, fx * baseline, frames, gt


def make_loop_circuit(n_long: int = 30, n_short: int = 14, step: float = 0.15,
                      width: int = 320, height: int = 240, fx: float = 200.0,
                      baseline: float = 0.12):
    """A rectangular circuit over a textured plane: right, down, left, up,
    then a re-traverse of the start of the first leg. The start is
    re-entered through fresh scenery, so the revisited keyframes are not
    covisible with the old ones and the revisit is a loop to detect (on a
    straight out-and-back they would be tracked as neighbours).
    Returns (K [3,3], bf, [(left, right), ...], gt Twc [F,4,4])."""
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]], np.float32)
    scene = PlaneScene(make_texture(seed=0), z0=2.0, z1=5.0)
    xy = []
    x = y = 0.0
    for n, dx, dy in ((n_long, step, 0), (n_short, 0, step), (n_long, -step, 0),
                      (n_short, 0, -step), (10, step, 0)):
        for _ in range(n):
            xy.append((x, y))
            x, y = x + dx, y + dy
    poses, frames = [], []
    for i, (px, py) in enumerate(xy):
        Twc = np.eye(4)
        Twc[0, 3] = px
        Twc[1, 3] = py + 0.01 * np.sin(i * 0.4)
        poses.append(Twc.copy())
        Twc_r = Twc.copy()
        Twc_r[0, 3] += baseline
        frames.append((scene.render(K, Twc, height, width),
                       scene.render(K, Twc_r, height, width)))
    return K, fx * baseline, frames, np.stack(poses)


def path_length(gt_Twc: np.ndarray) -> float:
    """Total traversed path length (sum of inter-frame translation norms)
    — the denominator of the reference's drift-percentage convention."""
    p = gt_Twc[:, :3, 3]
    return float(np.linalg.norm(np.diff(p, axis=0), axis=-1).sum())


def ate_rmse(est_Twc: np.ndarray, gt_Twc: np.ndarray, align: bool = True,
             align_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE of translation) after optional
    Horn/umeyama alignment — the reference's evaluation metric
    (report p.1: ATE-RMSE after Horn alignment). `align_scale` uses the
    similarity (Sim3) variant, required for monocular trajectories whose
    global scale is unobservable."""
    p_est = est_Twc[:, :3, 3]
    p_gt = gt_Twc[: len(p_est), :3, 3]
    if align and len(p_est) >= 3:
        mu_e = p_est.mean(0)
        mu_g = p_gt.mean(0)
        E = p_est - mu_e
        G = p_gt - mu_g
        U, sv, Vt = np.linalg.svd(E.T @ G)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = Vt.T @ S @ U.T
        if align_scale:
            var_e = np.sum(E * E)
            c = float(np.trace(np.diag(sv) @ S) / max(var_e, 1e-12))
        else:
            c = 1.0
        p_est = c * (R @ E.T).T + mu_g
        p_gt = G + mu_g
    return float(np.sqrt(np.mean(np.sum((p_est - p_gt) ** 2, axis=1))))
