"""A populated map built directly, with reference-like densities, no
tracking required (port of splslam_tpu/io/synth_map.py).

Stage timings depend on table sizes and observation density, not on how
the map was made, so a mapping benchmark can start from this map instead
of tracking a sequence first. The map is geometrically consistent: real
3D points and projections, noisy but Hamming-consistent descriptors, a
covisibility band like a forward KITTI run; host numpy, from
`np.random.default_rng(seed)` with the reference's draws in the
reference's order, then moved onto the device.

Densities mirror the reference's KITTI configuration: 2000 features a
keyframe (Examples/Stereo/KITTI00-02.yaml ORBextractor.nFeatures),
forward motion with a +-4-keyframe covisibility band, ~70% of features
bound to landmarks and a pool of unbound stereo features for the
triangulation / creation stages to consume."""

from __future__ import annotations

import numpy as np

from splslam_tpu_torch import convert
from splslam_tpu_torch.ops.lines import LineFeatures
from splslam_tpu_torch.ops.orb import OrbFeatures
from splslam_tpu_torch.slam.frame import FrameData
from splslam_tpu_torch.slam.map import MapState
from splslam_tpu_torch.slam.pipeline import StepState


def _pack_desc(bits: np.ndarray) -> np.ndarray:
    """[N,256] bits -> [N,8] uint32 words (bit i of word j is bit 32j + i)."""
    words = bits.reshape(-1, 8, 32).astype(np.uint32)
    return (words << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)


def _bits_pm1(desc_u32: np.ndarray) -> np.ndarray:
    """[N,8] uint32 -> [N,256] +-1 f32 bit planes (the reference frame's
    matmul cache, which the port's FrameData does not carry; kept as the
    numpy helper that builds it)."""
    b = (desc_u32[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return (b.reshape(desc_u32.shape[0], -1).astype(np.float32) * 2.0 - 1.0)


def make_synthetic_map(
    n_kfs: int = 12,
    n_feat: int = 2000,
    p_cap: int = 65536,
    k_cap: int = 256,
    q_cap: int = 256,
    l_cap: int = 8,
    width: int = 1241,
    height: int = 376,
    fx: float = 718.0,
    baseline: float = 0.54,
    kf_spacing: float = 0.8,
    bound_frac: float = 0.7,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    seed: int = 0,
    device="cuda",
):
    """Returns (MapState, FrameData next frame, tracking StepState
    seeded at the next pose, all on `device`, and Tcw_next [4,4] numpy).
    Forward-motion map: cameras at z = -k*spacing (world), landmarks in
    two depth bands ahead."""
    rng = np.random.default_rng(seed)
    fy, cx, cy = fx, width / 2.0, height / 2.0
    bf = fx * baseline

    # --- keyframe poses: forward motion (camera moves along +z in world,
    # i.e. world origin recedes), small lateral wobble ---
    Tcw = np.tile(np.eye(4, dtype=np.float32), (k_cap, 1, 1))
    centers = np.zeros((n_kfs + 1, 3), np.float32)
    for k in range(n_kfs + 1):
        centers[k] = (0.02 * np.sin(k), 0.01 * np.cos(k), kf_spacing * k)
    for k in range(n_kfs):
        Tcw[k, :3, 3] = -centers[k]  # R = I, t = -C

    # --- landmark cloud: enough points that each KF sees ~n_feat of a
    # sliding window; two depth bands for u_right/scale variety ---
    span = kf_spacing * n_kfs + 30.0
    n_cloud = int(n_feat * (n_kfs * 0.55 + 3))
    n_cloud = min(n_cloud, p_cap - 4096)
    depth_band = rng.choice([0, 1], n_cloud, p=[0.6, 0.4])
    z_w = rng.uniform(4.0, 12.0, n_cloud) + depth_band * rng.uniform(
        8.0, 22.0, n_cloud
    )
    # attach each point to a segment of the trajectory so visibility slides
    anchor = rng.uniform(-2.0, span - 28.0, n_cloud)
    z_world = anchor + z_w
    half_w = z_w * (width / 2.0) / fx * 0.95
    half_h = z_w * (height / 2.0) / fx * 0.95
    xyz = np.stack(
        [rng.uniform(-1, 1, n_cloud) * half_w,
         rng.uniform(-1, 1, n_cloud) * half_h,
         z_world], -1
    ).astype(np.float32)
    lm_desc_bits = rng.integers(0, 2, (n_cloud, 256)).astype(np.uint8)

    st = convert.map_state_to_numpy(MapState.empty(p_cap, q_cap, k_cap, n_feat,
                                                   l_cap, "cpu"))

    kf_xy = np.zeros((k_cap, n_feat, 2), np.float32)
    kf_oct = np.zeros((k_cap, n_feat), np.int32)
    kf_sig2 = np.ones((k_cap, n_feat), np.float32)
    kf_ang = np.zeros((k_cap, n_feat), np.float32)
    kf_desc = np.zeros((k_cap, n_feat, 8), np.uint32)
    kf_fval = np.zeros((k_cap, n_feat), bool)
    kf_ur = np.full((k_cap, n_feat), -1.0, np.float32)
    kf_depth = np.full((k_cap, n_feat), -1.0, np.float32)
    kf_lm = np.full((k_cap, n_feat), -1, np.int32)

    first_kf = np.full(n_cloud, -1, np.int32)
    n_obs = np.zeros(n_cloud, np.int32)
    used_as_lm = np.zeros(n_cloud, bool)

    def observe(k_pose, pts_idx, n_rows, rng):
        """Project cloud points into camera k_pose; return arrays for the
        first n_rows visible ones (sampled)."""
        C = centers[k_pose]
        pc = xyz[pts_idx] - C  # R = I
        z = pc[:, 2]
        u = fx * pc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * pc[:, 1] / np.maximum(z, 1e-6) + cy
        vis = (z > 2.0) & (z < 45.0) & (u >= 8) & (u < width - 8) \
            & (v >= 8) & (v < height - 8)
        cand = pts_idx[vis]
        rng.shuffle(cand)
        return cand[:n_rows]

    all_idx = np.arange(n_cloud)
    n_bound = int(n_feat * bound_frac)
    for k in range(n_kfs):
        sel = observe(k, all_idx, n_bound, rng)
        m = len(sel)
        C = centers[k]
        pc = xyz[sel] - C
        z = pc[:, 2]
        u = fx * pc[:, 0] / z + cx + rng.normal(0, 0.3, m)
        v = fy * pc[:, 1] / z + cy + rng.normal(0, 0.3, m)
        octv = np.clip(
            (np.log(45.0 / z) / np.log(scale_factor)).astype(np.int32),
            0, n_levels - 1,
        )
        # observation descriptor: landmark bits with a few flips
        ob = lm_desc_bits[sel].copy()
        flips = rng.integers(0, 256, (m, 6))
        for j in range(6):
            ob[np.arange(m), flips[:, j]] ^= 1
        kf_xy[k, :m] = np.stack([u, v], -1)
        kf_oct[k, :m] = octv
        kf_sig2[k, :m] = (scale_factor ** octv) ** 2
        kf_ang[k, :m] = rng.uniform(-np.pi, np.pi, m)
        kf_desc[k, :m] = _pack_desc(ob)
        kf_fval[k, :m] = True
        kf_depth[k, :m] = z
        kf_ur[k, :m] = u - bf / z
        kf_lm[k, :m] = sel
        new = first_kf[sel] < 0
        first_kf[sel[new]] = k
        n_obs[sel] += 2  # stereo observations count double
        used_as_lm[sel] |= True

        # UNBOUND stereo features (the creation stage's raw material):
        # fresh cloud points seen by this KF but not yet landmarks.
        free = observe(k, all_idx[~used_as_lm], n_feat - n_bound, rng)
        fm = len(free)
        if fm:
            pcf = xyz[free] - C
            zf = pcf[:, 2]
            uf = fx * pcf[:, 0] / zf + cx + rng.normal(0, 0.3, fm)
            vf = fy * pcf[:, 1] / zf + cy + rng.normal(0, 0.3, fm)
            of = np.clip(
                (np.log(45.0 / zf) / np.log(scale_factor)).astype(np.int32),
                0, n_levels - 1,
            )
            obf = lm_desc_bits[free].copy()
            r = slice(n_bound, n_bound + fm)
            kf_xy[k, r] = np.stack([uf, vf], -1)
            kf_oct[k, r] = of
            kf_sig2[k, r] = (scale_factor ** of) ** 2
            kf_desc[k, r] = _pack_desc(obf)
            kf_fval[k, r] = True
            kf_depth[k, r] = zf
            kf_ur[k, r] = uf - bf / zf

    # landmark table
    lm_ids = np.nonzero(used_as_lm)[0]
    # landmarks keep their cloud index as their table slot (cloud fits cap)
    pts_xyz = np.zeros((p_cap, 3), np.float32)
    pts_xyz[:n_cloud] = xyz
    pts_valid = np.zeros(p_cap, bool)
    pts_valid[lm_ids] = True
    pts_desc = np.zeros((p_cap, 8), np.uint32)
    pts_desc[:n_cloud] = _pack_desc(lm_desc_bits)
    normal = np.zeros((p_cap, 3), np.float32)
    ref_c = centers[np.clip(first_kf, 0, None)]
    view = xyz - ref_c
    dist = np.linalg.norm(view, axis=-1)
    normal[:n_cloud] = view / np.maximum(dist[:, None], 1e-9)
    oct0 = np.clip(
        (np.log(45.0 / np.maximum(dist, 1e-3)) / np.log(scale_factor))
        .astype(np.int32), 0, n_levels - 1,
    )
    dmax = dist * scale_factor ** oct0
    dmin = dmax / scale_factor ** (n_levels - 1)
    pts_dmin = np.zeros(p_cap, np.float32)
    pts_dmax = np.full(p_cap, 1e9, np.float32)
    pts_dmin[:n_cloud] = dmin
    pts_dmax[:n_cloud] = dmax
    pts_nobs = np.zeros(p_cap, np.int32)
    pts_nobs[:n_cloud] = n_obs
    pts_first = np.zeros(p_cap, np.int32)
    pts_first[:n_cloud] = np.clip(first_kf, 0, None)
    nv = np.zeros(p_cap, np.int32)
    nv[:n_cloud] = np.maximum(n_obs, 1) * 3
    nf = np.zeros(p_cap, np.int32)
    nf[:n_cloud] = np.maximum(n_obs, 1) * 3

    st = st._replace(
        pts=st.pts._replace(
            xyz=np.asarray(pts_xyz), desc=np.asarray(pts_desc),
            normal=np.asarray(normal), dmin=np.asarray(pts_dmin),
            dmax=np.asarray(pts_dmax), n_obs=np.asarray(pts_nobs),
            n_visible=np.asarray(nv), n_found=np.asarray(nf),
            first_kf=np.asarray(pts_first), valid=np.asarray(pts_valid),
        ),
        kfs=st.kfs._replace(
            Tcw=np.asarray(Tcw), xy=np.asarray(kf_xy),
            octave=np.asarray(kf_oct), sigma2=np.asarray(kf_sig2),
            angle=np.asarray(kf_ang), desc=np.asarray(kf_desc),
            fvalid=np.asarray(kf_fval), u_right=np.asarray(kf_ur),
            depth=np.asarray(kf_depth), lm_idx=np.asarray(kf_lm),
            valid=np.asarray(np.arange(k_cap) < n_kfs),
            frame_id=np.asarray(
                np.arange(k_cap, dtype=np.int32) * 4),
        ),
        n_pts=np.int32(n_cloud),
        n_kfs=np.int32(n_kfs),
    )

    # --- a NEXT frame one step past the last keyframe, ~80% of its
    # features bound to existing landmarks (tracking/KF-insertion input) --
    kn = n_kfs  # pose index n_kfs in centers
    sel = observe(kn, all_idx[used_as_lm], int(n_feat * 0.8), rng)
    m = len(sel)
    C = centers[kn]
    pc = xyz[sel] - C
    z = pc[:, 2]
    u = fx * pc[:, 0] / z + cx + rng.normal(0, 0.3, m)
    v = fy * pc[:, 1] / z + cy + rng.normal(0, 0.3, m)
    octv = np.clip(
        (np.log(45.0 / z) / np.log(scale_factor)).astype(np.int32),
        0, n_levels - 1,
    )
    ob = lm_desc_bits[sel].copy()
    f_xy = np.zeros((n_feat, 2), np.float32)
    f_oct = np.zeros((n_feat,), np.int32)
    f_sig2 = np.ones((n_feat,), np.float32)
    f_desc = np.zeros((n_feat, 8), np.uint32)
    f_val = np.zeros((n_feat,), bool)
    f_ur = np.full((n_feat,), -1.0, np.float32)
    f_depth = np.full((n_feat,), -1.0, np.float32)
    f_lm = np.full((n_feat,), -1, np.int32)
    f_xy[:m] = np.stack([u, v], -1)
    f_oct[:m] = octv
    f_sig2[:m] = (scale_factor ** octv) ** 2
    f_desc[:m] = _pack_desc(ob)
    f_val[:m] = True
    f_depth[:m] = z
    f_ur[:m] = u - bf / z
    f_lm[:m] = sel
    # unbound close features with depth: fresh creation material
    free = observe(kn, all_idx[~used_as_lm], n_feat - m, rng)
    fm = len(free)
    if fm:
        pcf = xyz[free] - C
        zf = pcf[:, 2]
        uf = fx * pcf[:, 0] / zf + cx
        vf = fy * pcf[:, 1] / zf + cy
        r = slice(m, m + fm)
        f_xy[r] = np.stack([uf, vf], -1)
        f_desc[r] = _pack_desc(lm_desc_bits[free])
        f_val[r] = True
        f_depth[r] = zf
        f_ur[r] = uf - bf / zf

    feat = OrbFeatures(
        xy=np.asarray(f_xy),
        response=np.zeros((n_feat,), np.float32),
        angle=np.zeros((n_feat,), np.float32),
        octave=np.asarray(f_oct),
        sigma2=np.asarray(f_sig2),
        desc=np.asarray(f_desc),
        valid=np.asarray(f_val),
    )
    frame = FrameData(
        feat=feat,
        u_right=np.asarray(f_ur),
        depth=np.asarray(f_depth),
        lines=convert.line_features_to_numpy(LineFeatures.empty(l_cap, "cpu")),
    )
    Tcw_next = np.eye(4, dtype=np.float32)
    Tcw_next[:3, 3] = -centers[kn]
    step = StepState(
        frame=frame,
        lm_gid=np.asarray(f_lm),
        lm_xyz=np.asarray(pts_xyz[np.clip(f_lm, 0, None)]),
        Tcw=np.asarray(Tcw_next),
        velocity=np.eye(4, dtype=np.float32),
        ll_gid=np.full((l_cap,), -1, np.int32),
        ll_xyz3=np.zeros((l_cap, 3, 3), np.float32),
        ll_len=np.zeros((l_cap,), np.float32),
    )
    return (convert.map_state_from_numpy(st, device),
            convert.frame_from_numpy(frame, device),
            convert.step_state_from_numpy(step, device), Tcw_next)
