"""Relocalization of the PyTorch port (`splslam_tpu_torch/slam/reloc.py`)
against the JAX package's on the same inputs.

A JAX System tracks 7 frames of the forward sequence (keyframes forced
every 2 frames), and its map plus two later frames (built by the JAX
frame builder) are carried to the port with `convert`. Each attempt runs
in both packages with the JAX package's minimal sets injected into the
port (its Gumbel top-k draw, recomputed here from the same key).

The line branch runs on a second input: a grid frame with its line
table against a candidate built from the rendered depth (`line_ref`),
with the JAX package's EPnL draws injected as well.

Tolerances: the frame's matches, lm_gid, ll_gid and inlier counts exact; the
relocalized pose within 1e-3 (the JAX attempt is one jitted program with
fused multiply-adds, the port runs op by op). PnP RANSAC alone: pose
within 1e-4 and counts equal, except that a point whose chi2 lies within
1e-4 of the 5.991 gate may flip (the test names such points; the gate is
not loosened). EPnL RANSAC alone and the 6-line DLT: pose within 1e-4,
counts and inlier masks equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.geometry.camera import Camera as JCam
from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.ops import match as JM
from splslam_tpu.slam import frame as JF
from splslam_tpu.slam import reloc as JR
from splslam_tpu.slam import system as JS
from splslam_tpu_torch import convert
from splslam_tpu_torch.geometry import se3 as TSE3
from splslam_tpu_torch.geometry.camera import Camera as TCam
from splslam_tpu_torch.slam import reloc as TR

W, H = 320, 240
N_PRE = 7
GATE = 5.991
POSE_ATOL = 1e-3
QUERY = 3          # the query frame of the line relocalization


class Ref:
    """The JAX map after N_PRE frames and frames built after it."""


@pytest.fixture(scope="module")
def ref():
    K, bf, frames, _ = make_stereo_sequence(n_frames=12, motion="forward",
                                            width=W, height=H)
    st = JS.Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=W, height=H, n_features=600,
        n_levels=4, th_depth=40.0, fps=10, max_points=8192, max_keyframes=64,
        local_window=1024, enable_local_mapping=False,
        enable_relocalization=False, force_kf_every=2,
    )
    js = JS.System(st, JS.Sensor.STEREO)
    for i, (l, r) in enumerate(frames[:N_PRE]):
        js.track_stereo(l, r, i * 0.1)
    js.drain()
    assert js.n_kfs >= 3
    r = Ref()
    r.n_kfs = js.n_kfs
    r.jcam = js.cam
    r.tcam = TCam.create(st.fx, st.fy, st.cx, st.cy, bf=st.bf, width=W, height=H)
    r.map = jax.device_get(js.map)
    r.frames = {i: jax.device_get(JF.build_frame_stereo(
        jnp.asarray(frames[i][0], jnp.float32),
        jnp.asarray(frames[i][1], jnp.float32), js.cam, js.spec,
        line_capacity=1)) for i in (7, 11)}
    return r


def _jax_samples(key, mask, n_hyp, m):
    """The JAX package's draw (splslam_tpu/slam/reloc.py:86-88)."""
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    g = jax.random.gumbel(key, (n_hyp, mask.shape[0])) + logits[None]
    return torch.from_numpy(np.array(jax.lax.top_k(g, m)[1]))


def _candidate(r, c, flip_p=0.0):
    """Candidate keyframe c's rows as numpy; descriptor bits flipped with
    probability flip_p (a weaker global match, so the staged projection
    search runs)."""
    kfs = r.map.kfs
    desc = np.array(kfs.desc[c])
    if flip_p:
        rng = np.random.default_rng(c)
        bits = rng.random((desc.shape[0], 256)) < flip_p
        desc ^= np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    lm = np.array(kfs.lm_idx[c])
    xyz = np.array(r.map.pts.xyz)[np.clip(lm, 0, None)]
    return desc, np.array(kfs.fvalid[c]), lm, xyz


def _jax_global_match(frame, desc, fvalid, lm):
    """splslam_tpu/slam/reloc.py:218-226, the column of each kf row."""
    dist = JM.hamming_mixed(frame.feat.bits, jnp.asarray(desc)).T
    dist = JM.masked_distances(dist, jnp.asarray(fvalid & (lm >= 0)),
                               frame.feat.valid)
    mt, _ = JM.nn_match(dist, max_dist=JM.TH_LOW, ratio=0.75, mutual=True)
    return np.asarray(mt)


@pytest.mark.parametrize("fi,c,flip_p", [(7, 0, 0.0), (11, 2, 0.0),
                                         (11, 0, 0.0), (7, 1, 0.15)])
def test_reloc_attempt_matches_jax_with_injected_samples(ref, fi, c, flip_p):
    jframe = jax.tree.map(jnp.asarray, ref.frames[fi])
    desc, fvalid, lm, xyz = _candidate(ref, c, flip_p)
    key = jax.random.PRNGKey(fi * 100 + c)
    L = ref.map.kfs.ll_idx.shape[1]
    Tj, nj, gidj, llj = JR.reloc_attempt(
        key, ref.jcam, jframe, jnp.asarray(desc), jnp.asarray(fvalid),
        jnp.asarray(lm), jnp.asarray(xyz), jnp.zeros((L, 8), jnp.uint32),
        jnp.full((L,), -1, jnp.int32), jnp.zeros((L, 3, 3)))
    tframe = convert.frame_from_numpy(ref.frames[fi], "cpu")
    td = [torch.from_numpy(np.array(a)) for a in (desc.view(np.int32), fvalid, lm, xyz)]
    # the frame's matches
    mt = _jax_global_match(jframe, desc, fvalid, lm)
    _, gid0, _ = TR.global_match(tframe, *td)
    want0 = np.full(tframe.feat.capacity, -1, np.int32)
    want0[mt[mt >= 0]] = lm[mt >= 0]
    np.testing.assert_array_equal(gid0.numpy(), want0)
    samples = _jax_samples(key, want0 >= 0, TR.N_HYP, 6)
    Tt, nt, gidt, llt = TR.reloc_attempt(ref.tcam, tframe, *td, samples=samples)
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(gidt.numpy(), np.asarray(gidj))
    np.testing.assert_array_equal(llt.numpy(), np.asarray(llj))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=POSE_ATOL)
    if flip_p:   # the staged search ran and raised the count
        assert int((want0 >= 0).sum()) < int(nt)


def _pnp_problem(seed, n=300, outlier_frac=0.3):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 4], [3, 2, 12], (n, 3)).astype(np.float32)
    xi = np.array([0.1, -0.05, 0.08, 0.04, -0.03, 0.05], np.float32)
    T = TSE3.se3_exp(torch.from_numpy(xi)).numpy()
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([500.0 * pc[:, 0] / pc[:, 2] + 320.0,
                   500.0 * pc[:, 1] / pc[:, 2] + 240.0], -1)
    uv += rng.normal(0, 0.7, uv.shape)
    bad = rng.choice(n, int(n * outlier_frac), replace=False)
    uv[bad] += rng.uniform(20, 60, (len(bad), 2))
    mask = rng.random(n) < 0.9
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    return T, uv.astype(np.float32), X, inv_s2, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_matches_jax_with_injected_samples(seed):
    _, uv, X, inv_s2, mask = _pnp_problem(seed)
    jcam = JCam.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0,
                       width=640, height=480)
    tcam = TCam.create(500.0, 500.0, 320.0, 240.0, bf=50.0, width=640, height=480)
    key = jax.random.PRNGKey(seed)
    Tj, nj, inlj = JR.pnp_ransac(key, jcam, *map(jnp.asarray, (uv, X, inv_s2, mask)))
    Tt, nt, inlt = TR.pnp_ransac(tcam, *map(torch.from_numpy, (uv, X, inv_s2, mask)),
                                 samples=_jax_samples(key, mask, 192, 6))
    Tj = np.asarray(Tj)
    np.testing.assert_allclose(Tt.numpy(), Tj, rtol=0, atol=1e-4)
    # chi2 of every point under the JAX pose: only points within 1e-4 of
    # the gate may be classified differently
    pc = X @ Tj[:3, :3].T + Tj[:3, 3]
    proj = 500.0 * pc[:, :2] / pc[:, 2:] + [320.0, 240.0]
    chi2 = ((proj - uv) ** 2).sum(-1) * inv_s2
    flipped = np.nonzero(inlt.numpy() != np.asarray(inlj))[0]
    near_gate = np.abs(chi2 - GATE) < 1e-4
    assert near_gate[flipped].all(), (flipped, chi2[flipped])
    assert abs(int(nt) - int(nj)) <= len(flipped)
    if not near_gate[mask].any():
        assert int(nt) == int(nj) and len(flipped) == 0


def test_reloc_scores_match_jax():
    rng = np.random.default_rng(5)
    K, S, Wd = 12, 40, 500
    ids = np.sort(rng.integers(0, Wd + 1, (K, S)), axis=1).astype(np.int32)
    vals = np.where(ids < Wd, rng.random((K, S)), 0).astype(np.float32)
    query = rng.random(Wd).astype(np.float32)
    query /= query.sum()
    valid = rng.random(K) < 0.8
    exclude = rng.random(K) < 0.3
    args = (ids, vals, valid, query, exclude)
    want = np.asarray(JR.reloc_scores(*map(jnp.asarray, args)))
    got = TR.reloc_scores(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got.numpy()[~valid | exclude] == -1.0).all()


def test_sample_minimal_sets():
    mask = torch.from_numpy(np.random.default_rng(0).random(50) < 0.5)
    gen = torch.Generator().manual_seed(7)
    s = TR.sample_minimal_sets(gen, mask, 64, 6)
    assert s.shape == (64, 6)
    assert mask[s].all()
    assert all(len(set(row.tolist())) == 6 for row in s)
    again = TR.sample_minimal_sets(torch.Generator().manual_seed(7), mask, 64, 6)
    torch.testing.assert_close(s, again, rtol=0, atol=0)
    few = torch.zeros(50, dtype=torch.bool)
    few[[3, 9]] = True
    s2 = TR.sample_minimal_sets(gen, few, 8, 6)
    assert all({3, 9} <= set(row.tolist()) for row in s2)


def test_proj_round_duplicate_columns_highest_row_wins(ref):
    """Two keyframe rows carrying the same descriptor and position but
    different landmark ids pick the same frame column in the (not
    mutual) projection search; the higher row's landmark is kept, as the
    reference's scatter keeps its last write."""
    tframe = convert.frame_from_numpy(ref.frames[7], "cpu")
    desc, fvalid, lm, xyz = _candidate(ref, 2)
    td = [torch.from_numpy(np.array(a)) for a in (desc.view(np.int32), fvalid, lm, xyz)]
    dist, gid0, xyz0 = TR.global_match(tframe, *td)
    T = torch.from_numpy(np.array(ref.map.kfs.Tcw[2]))
    free = torch.full_like(gid0, -1)
    _, gid, _ = TR.proj_round(ref.tcam, tframe, dist, *td[1:], T, free,
                              torch.zeros_like(xyz0), 10.0)
    rows = np.nonzero((gid.numpy() >= 0))[0]
    assert len(rows) > 20
    # duplicate keyframe row `a` into a higher row `b` that holds no
    # landmark, under a new landmark id
    b = int(np.nonzero(lm < 0)[0][-1])
    col = next(int(cl) for cl in rows
               if int(np.nonzero(lm == int(gid[cl]))[0][0]) < b)
    a = int(np.nonzero(lm == int(gid[col]))[0][0])
    desc2, fvalid2, lm2, xyz2 = desc.copy(), fvalid.copy(), lm.copy(), xyz.copy()
    desc2[b], fvalid2[b], lm2[b], xyz2[b] = desc[a], True, 8000, xyz[a]
    td2 = [torch.from_numpy(np.array(v))
           for v in (desc2.view(np.int32), fvalid2, lm2, xyz2)]
    dist2 = TR.global_match(tframe, *td2)[0]
    _, gid2, _ = TR.proj_round(ref.tcam, tframe, dist2, *td2[1:], T, free,
                               torch.zeros_like(xyz0), 10.0)
    assert int(gid2[col]) == 8000
    # every other column is as before
    others = np.arange(len(gid)) != col
    np.testing.assert_array_equal(gid2.numpy()[others], gid.numpy()[others])


# ----------------------------------------------------------------------
# The line branch: EPnL seed, line match, line rows in the pose solves.
# ----------------------------------------------------------------------
def _line_pose_problem(seed, n=40, outlier_frac=0.25):
    """A pose, map lines in front of it, their exact pixel-line
    coefficients and start/mid/end points; a share of the observations
    replaced by unrelated lines."""
    rng = np.random.default_rng(seed)
    xi = np.array([0.08, -0.04, 0.06, 0.05, -0.02, 0.04], np.float32)
    T = TSE3.se3_exp(torch.from_numpy(xi)).numpy()
    A = rng.uniform([-3, -2, 4], [3, 2, 10], (n, 3))
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = A + rng.uniform(0.8, 2.0, (n, 1)) * d
    xyz3 = np.stack([A, 0.5 * (A + B), B], axis=1).astype(np.float32)

    def proj(X):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([500.0 * pc[:, 0] / pc[:, 2] + 320.0,
                         500.0 * pc[:, 1] / pc[:, 2] + 240.0], -1)

    seg = np.concatenate([proj(A), proj(B)], axis=1)
    bad = rng.choice(n, int(n * outlier_frac), replace=False)
    seg[bad] = rng.uniform([0, 0, 0, 0], [640, 480, 640, 480], (len(bad), 4))
    from splslam_tpu_torch.optim.pose_gn import line_coefficients
    coef = line_coefficients(torch.from_numpy(seg.astype(np.float32))).numpy()
    mask = rng.random(n) < 0.95
    return T, coef, xyz3, mask


def _line_samples(key, mask, n_hyp=TR.N_HYP_LINES):
    """The JAX package's EPnL draw (splslam_tpu/slam/reloc.py:171-172)."""
    return _jax_samples(key, mask, n_hyp, 6)


def test_dlt_pose_from_lines_recovers_an_exact_pose():
    T, coef, xyz3, _ = _line_pose_problem(0, n=6, outlier_frac=0.0)
    tcam = TCam.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)
    c = torch.from_numpy(coef)
    lp = torch.stack([c[:, 0] * tcam.fx, c[:, 1] * tcam.fy,
                      c[:, 0] * tcam.cx + c[:, 1] * tcam.cy + c[:, 2]], dim=-1)
    ends = torch.from_numpy(xyz3[:, [0, 2]])
    Tt = TR._dlt_pose_from_lines(lp[None], ends[None])[0].numpy()
    np.testing.assert_allclose(Tt, T, atol=1e-4)
    Tj = np.asarray(JR._dlt_pose_from_lines(jnp.asarray(lp.numpy()),
                                            jnp.asarray(ends.numpy())))
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epnl_ransac_matches_jax_with_injected_samples(seed):
    T, coef, xyz3, mask = _line_pose_problem(seed)
    jcam = JCam.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
    tcam = TCam.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    Tj, nj, inlj = JR.epnl_ransac(key, jcam, *map(jnp.asarray, (coef, xyz3, mask)))
    Tt, nt, inlt = TR.epnl_ransac(tcam, *map(torch.from_numpy, (coef, xyz3, mask)),
                                  samples=_line_samples(key, mask))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-4)
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(inlt.numpy(), np.asarray(inlj))
    np.testing.assert_allclose(Tt.numpy(), T, atol=1e-3)
    assert int(nt) >= 0.6 * mask.sum()


@pytest.fixture(scope="module")
def line_ref():
    """Two frames of the grid scene with depth (RGB-D render, lateral
    motion), both with 64 line slots (the JAX frame builder): the query
    is frame QUERY; the candidate keyframe holds frame 0's keypoints,
    lifted to 3D with the true depth and pose, and the query's own line
    segments lifted the same way, with their descriptors (on the grid
    texture a global LBD match between two frames pairs mostly wrong
    lines, so the candidate's lines are the query's: every line match is
    right and the line seed has something to find)."""
    from splslam_tpu.io.synthetic import make_rgbd_sequence
    from splslam_tpu.slam.frame import build_frame_mono

    K, _, frames, gt = make_rgbd_sequence(n_frames=QUERY + 1, motion="lateral",
                                          width=W, height=H, texture="grid")
    st = JS.Settings(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                     cy=float(K[1, 2]), width=W, height=H, n_features=600, n_levels=4)
    js = JS.System(st, JS.Sensor.MONOCULAR)
    fr = {i: jax.device_get(build_frame_mono(jnp.asarray(frames[i][0], jnp.float32),
                                             js.cam, js.spec, with_lines=True,
                                             line_capacity=64)) for i in (0, QUERY)}

    def lift(uv, i):
        depth, Twc = frames[i][1], gt[i]
        u = np.clip(np.round(uv[:, 0]).astype(int), 0, W - 1)
        v = np.clip(np.round(uv[:, 1]).astype(int), 0, H - 1)
        z = depth[v, u]
        pc = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0] * z,
                       (uv[:, 1] - K[1, 2]) / K[1, 1] * z, z], -1)
        return (pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32), z > 0

    r = Ref()
    r.jcam = js.cam
    r.tcam = TCam.create(st.fx, st.fy, st.cx, st.cy, width=W, height=H)
    r.frame = fr[QUERY]
    r.Twc = gt[QUERY]
    f0 = fr[0]
    r.desc = np.array(f0.feat.desc)
    r.xyz, zok = lift(np.asarray(f0.feat.xy), 0)
    r.fvalid = np.asarray(f0.feat.valid) & zok
    r.lm = np.where(r.fvalid, np.arange(len(zok)), -1).astype(np.int32)
    seg = np.asarray(r.frame.lines.seg)
    s3, sok = lift(seg[:, :2], QUERY)
    e3, eok = lift(seg[:, 2:], QUERY)
    r.ldesc = np.array(r.frame.lines.desc)
    lok = np.asarray(r.frame.lines.valid) & sok & eok
    r.ll = np.where(lok, 100 + np.arange(len(lok)), -1).astype(np.int32)
    r.ll_xyz3 = np.stack([s3, 0.5 * (s3 + e3), e3], axis=1)
    return r


def _jax_line_match(frame, ldesc, ll):
    """splslam_tpu/slam/reloc.py:229-236: the frame column of each kf row."""
    d = JM.hamming_matrix(jnp.asarray(ldesc), frame.lines.desc)
    d = JM.masked_distances(d, jnp.asarray(ll >= 0), frame.lines.valid)
    mt, _ = JM.nn_match(d, max_dist=JM.TH_HIGH, mutual=True)
    return np.asarray(mt)


@pytest.mark.parametrize("n_points", [None, 8])
def test_reloc_attempt_with_lines_matches_jax(line_ref, n_points):
    """With every candidate point the point seed wins; with 8 (too few
    for it: n0 < 12 against >= 6 line inliers) the EPnL seed replaces it
    and the points re-enter under the line pose's loose gate. Line ids,
    point ids and counts exact, the pose within POSE_ATOL."""
    r = line_ref
    fvalid, lm = r.fvalid.copy(), r.lm.copy()
    if n_points is not None:
        keep = np.nonzero(fvalid)[0][::max(1, fvalid.sum() // n_points)][:n_points]
        fvalid[:] = False
        fvalid[keep] = True
        lm = np.where(fvalid, lm, -1)
    jframe = jax.tree.map(jnp.asarray, r.frame)
    key = jax.random.PRNGKey(3)
    Tj, nj, gidj, llj = JR.reloc_attempt(
        key, r.jcam, jframe, *map(jnp.asarray, (r.desc, fvalid, lm, r.xyz, r.ldesc,
                                                r.ll, r.ll_xyz3)))
    tframe = convert.frame_from_numpy(r.frame, "cpu")
    t = lambda a: torch.from_numpy(np.array(a))
    targs = [t(r.desc.view(np.int32)), t(fvalid), t(lm), t(r.xyz),
             t(r.ldesc.view(np.int32)), t(r.ll), t(r.ll_xyz3)]
    # the line match
    mt = _jax_line_match(jframe, r.ldesc, r.ll)
    ll_gid, _ = TR.line_match(tframe, *targs[4:])
    want = np.full(tframe.lines.capacity, -1, np.int32)
    want[mt[mt >= 0]] = r.ll[mt >= 0]
    np.testing.assert_array_equal(ll_gid.numpy(), want)
    assert (want >= 0).sum() >= 6
    _, gid0, _ = TR.global_match(tframe, *targs[:4])
    samples = _jax_samples(key, gid0.numpy() >= 0, TR.N_HYP, 6)
    lsamples = _line_samples(jax.random.fold_in(key, 1),
                             (want >= 0) & np.asarray(r.frame.lines.valid))
    Tt, nt, gidt, llt = TR.reloc_attempt(r.tcam, tframe, *targs, samples=samples,
                                         line_samples=lsamples)
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(gidt.numpy(), np.asarray(gidj))
    np.testing.assert_array_equal(llt.numpy(), np.asarray(llj))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=POSE_ATOL)
    # every candidate line is right: most come back as inliers, and the
    # pose is right also from the line seed (measured 6 and 8 mm)
    assert (llt.numpy() >= 0).sum() >= 15
    assert np.linalg.norm(np.linalg.inv(Tt.numpy())[:3, 3] - r.Twc[:3, 3]) < 0.03


def test_reloc_attempt_without_candidate_lines_is_the_point_attempt(ref):
    """A frame with a line table against a candidate that gives no lines
    (the arguments left out) runs the point attempt unchanged: the same
    result as the frame without lines, and no line associations."""
    tframe = convert.frame_from_numpy(ref.frames[7], "cpu")
    lines = type(tframe.lines)(*[torch.cat([x, x]) for x in tframe.lines])
    desc, fvalid, lm, xyz = _candidate(ref, 0)
    args = [torch.from_numpy(np.array(a)) for a in (desc.view(np.int32), fvalid, lm, xyz)]
    a = TR.reloc_attempt(ref.tcam, tframe._replace(lines=lines), *args,
                         generator=torch.Generator().manual_seed(1))
    b = TR.reloc_attempt(ref.tcam, tframe, *args,
                         generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert int(a[1]) == int(b[1]) >= 50
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    assert a[3].shape == (2,) and (a[3] == -1).all()
