"""Local mapping of the PyTorch port (`splslam_tpu_torch/slam/mapping_ops.py`)
against the JAX reference on identical state.

One JAX System run (320x240 forward sequence, keyframes forced every 4
frames, mapping on) is built once for the module; the map that enters
its LAST mapping step, and what that jitted step returned, are captured.
Each stage then runs on the same converted state in the port and in
op-by-op JAX (`jax.disable_jit`: jit's fused multiply-adds can move a
threshold decision, ROADMAP queue C), with the keyframe tables cut to the
step's k_bucket as the step does.

Tolerances: every integer output exact (landmark ids and masks, n_pts,
n_obs, window ids, culled ids, edge tables); floats of the stages before
BA within 1e-5. Whole step against the jitted reference: integers exact,
keyframe poses within 1e-3 (float32 LM over 10 iterations in another
summation order; measured up to 2.6e-4, the reference's own jit-vs-eager
spread on such a window is 7e-5); landmarks: median within 5e-4 and all
within 1% of their distance (a landmark seen by two keyframes slides
along its ray; measured median 1.5e-4, worst 1.5e-2 = 0.25% of its
distance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.slam import map as JM
from splslam_tpu.slam import mapping_ops as JMO
from splslam_tpu.slam import system as JS
from splslam_tpu_torch import convert
from splslam_tpu_torch.geometry.camera import Camera as TCam
from splslam_tpu_torch.slam import mapping_ops as TMO
from splslam_tpu_torch.slam.map import KeyFrames

W, H, N_FRAMES = 320, 240, 13
FLOAT_ATOL = 1e-5


class Ref:
    """The captured step: `before` (numpy map), `kf`, `kw`, `after`."""


@pytest.fixture(scope="module")
def ref():
    K, bf, frames, _ = make_stereo_sequence(n_frames=N_FRAMES, motion="forward",
                                            width=W, height=H)
    st = JS.Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=W, height=H, n_features=600,
        n_levels=4, th_depth=40.0, fps=10, max_points=8192, max_keyframes=64,
        local_window=1024, enable_local_mapping=True,
        enable_relocalization=False, force_kf_every=4,
    )
    calls = []
    orig = JMO.mapping_step

    def capture(m, kf, cam, scales, **kw):
        before = jax.device_get(m)
        out = orig(m, kf, cam, scales, **kw)
        calls.append((before, int(kf), kw, jax.device_get(out)))
        return out

    JMO.mapping_step = capture
    try:
        js = JS.System(st, JS.Sensor.STEREO)
        for i, (l, r) in enumerate(frames):
            js.track_stereo(l, r, i * 0.1)
        js.drain()
    finally:
        JMO.mapping_step = orig
    assert len(calls) >= 2
    r = Ref()
    r.before, r.kf, r.kw, (r.after, r.stats) = calls[-1]
    r.kb = r.kw["k_bucket"]
    r.jcam = js.cam
    r.tcam = TCam.create(st.fx, st.fy, st.cx, st.cy, bf=st.bf, width=W, height=H)
    r.scales = np.asarray(js.spec.scales, np.float32)
    return r


def jmap(r):
    """Reference map, keyframe tables cut to the step's bucket."""
    m = jax.tree.map(jnp.asarray, r.before)
    return m._replace(kfs=jax.tree.map(lambda x: x[:r.kb], m.kfs))


def tmap(r):
    m = convert.map_state_from_numpy(r.before, "cpu")
    return m._replace(kfs=KeyFrames(*[x[:r.kb] for x in m.kfs]))


def assert_maps_equal(tm, jm, float_atol=FLOAT_ATOL):
    tm = convert.map_state_to_numpy(tm)
    jm = jax.device_get(jm)
    for name in ("n_pts", "n_kfs"):
        assert int(getattr(tm, name)) == int(getattr(jm, name)), name
    for group in ("pts", "kfs"):
        for f in getattr(jm, group)._fields:
            a = np.asarray(getattr(getattr(tm, group), f))
            b = np.asarray(getattr(getattr(jm, group), f))
            if b.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f"{group}.{f}")
            else:
                np.testing.assert_allclose(a, b, rtol=float_atol, atol=float_atol,
                                           err_msg=f"{group}.{f}")


def _jax_upkeep(r):
    """Eager reference stages 1-3; returns (map after each, neighbours)."""
    kf = jnp.int32(r.kf)
    sc = jnp.asarray(r.scales)
    with jax.disable_jit():
        culled = JMO.cull_points(jmap(r), kf, th_obs=3)
        nb, _ = JMO._topk_covisible(culled, kf, JMO.N_NEIGH)
        created = JMO.create_new_points(culled, r.jcam, sc, kf, nb, 1.2, 4)
        fused = JMO.fuse_neighbors(created, r.jcam, sc, kf, nb, 1.2, 4)
    return culled, created, fused, nb


@pytest.fixture(scope="module")
def jstages(ref):
    return _jax_upkeep(ref)


def _port_upkeep(r, upto):
    sc = torch.from_numpy(r.scales)
    m = TMO.cull_points(tmap(r), r.kf, th_obs=3)
    nb, _ = TMO._topk_covisible(m, r.kf, TMO.N_NEIGH)
    if upto >= 1:
        m = TMO.create_new_points(m, r.tcam, sc, r.kf, nb, 1.2, 4)
    if upto >= 2:
        m = TMO.fuse_neighbors(m, r.tcam, sc, r.kf, nb, 1.2, 4)
    return m, nb


def test_topk_covisible(ref):
    for k in (TMO.N_NEIGH, TMO.N_WINDOW + TMO.N_FIXED - 1):
        with jax.disable_jit():
            ji, jc = JMO._topk_covisible(jmap(ref), jnp.int32(ref.kf), k)
        ti, tc = TMO._topk_covisible(tmap(ref), ref.kf, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (np.asarray(ji) >= 0).sum() >= 2


def test_cull_points(ref, jstages):
    m, _ = _port_upkeep(ref, 0)
    assert_maps_equal(m, jstages[0])
    assert np.asarray(ref.before.pts.recent).any()   # landmarks on probation


def test_create_new_points(ref, jstages):
    m, nb = _port_upkeep(ref, 1)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jstages[3]))
    assert_maps_equal(m, jstages[1])
    assert int(jstages[1].n_pts) > int(jstages[0].n_pts)


def test_fuse_neighbors(ref, jstages):
    m, _ = _port_upkeep(ref, 2)
    assert_maps_equal(m, jstages[2])


@pytest.fixture(scope="module")
def jwindow(ref, jstages):
    kf = jnp.int32(ref.kf)
    with jax.disable_jit():
        cams, lm_ids = JMO.build_ba_window(jstages[2], kf)
        refreshed = JMO.refresh_landmark_stats(jstages[2], cams, lm_ids, 1.2, 4)
        prob = JMO.make_ba_problem(refreshed, cams, lm_ids)
    return cams, lm_ids, refreshed, jax.device_get(prob)


def test_build_ba_window(ref, jwindow):
    m, _ = _port_upkeep(ref, 2)
    cams, lm_ids = TMO.build_ba_window(m, ref.kf)
    np.testing.assert_array_equal(cams.numpy(), np.asarray(jwindow[0]))
    np.testing.assert_array_equal(lm_ids.numpy(), np.asarray(jwindow[1]))
    assert (lm_ids >= 0).sum() > 100


def test_refresh_landmark_stats(ref, jwindow):
    m, _ = _port_upkeep(ref, 2)
    cams, lm_ids = TMO.build_ba_window(m, ref.kf)
    m = TMO.refresh_landmark_stats(m, cams, lm_ids, 1.2, 4)
    assert_maps_equal(m, jwindow[2])


def test_make_ba_problem(ref, jwindow):
    m, _ = _port_upkeep(ref, 2)
    cams, lm_ids = TMO.build_ba_window(m, ref.kf)
    m = TMO.refresh_landmark_stats(m, cams, lm_ids, 1.2, 4)
    tp = convert.ba_problem_to_numpy(TMO.make_ba_problem(m, cams, lm_ids))
    jp = jwindow[3]
    for f in jp._fields:
        a, b = getattr(tp, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert jp.e_ok.sum() > 500


def test_apply_ba_result(ref, jwindow):
    """The same solver result written back by both sides, with every 5th
    edge declared an outlier so that erasures happen. The window holds
    keyframe 0 followed by -1 pads, which clamp onto keyframe 0's row:
    the reference's scatter keeps the last (a pad's unchanged row)."""
    cams, lm_ids, refreshed, jp = jwindow
    res = TMO.ba_solve(ref.tcam, convert.ba_problem_from_numpy(jp, "cpu"),
                       rounds=2, iters=5, n_free=TMO.N_WINDOW)
    every_5th = torch.arange(res.e_inlier.shape[0]) % 5 == 0
    res = res._replace(e_inlier=res.e_inlier & ~every_5th)
    res_np = convert.ba_result_to_numpy(res)
    c = np.asarray(cams)
    assert (c == 0).any() and c[np.argmax(c == 0) + 1:].min() == -1
    with jax.disable_jit():
        jm = JMO.apply_ba_result(refreshed, cams, lm_ids,
                                 jax.tree.map(jnp.asarray, jp),
                                 jax.tree.map(jnp.asarray, res_np))
    tm = convert.map_state_from_numpy(jax.device_get(refreshed), "cpu")
    tm = TMO.apply_ba_result(tm, torch.from_numpy(np.array(cams)),
                             torch.from_numpy(np.array(lm_ids)),
                             convert.ba_problem_from_numpy(jp, "cpu"), res)
    assert_maps_equal(tm, jm, float_atol=0)
    # Keyframe 0's erasures are lost (its row is rewritten unchanged by the
    # pads after it) while its landmarks' n_obs still drop: a reference
    # fault the port reproduces (ROADMAP queue C).
    slot0 = int(np.argmax(c == 0))
    N = np.asarray(refreshed.kfs.lm_idx).shape[1]
    bad0 = (jp.e_ok & ~res_np.e_inlier)[slot0 * N:(slot0 + 1) * N]
    assert bad0.any()
    np.testing.assert_array_equal(np.asarray(jm.kfs.lm_idx)[0],
                                  np.asarray(refreshed.kfs.lm_idx)[0])


def _redundant_map(P=256, K=8, N=64, n_same=6):
    """`n_same` keyframes all observing the same N landmarks at octave 0
    (tests/test_ba.py::test_keyframe_culling_marks_redundant)."""
    m = jax.device_get(JM.MapState.empty(P, 4, K, N, 1))
    kfs = m.kfs._replace(lm_idx=np.array(m.kfs.lm_idx), fvalid=np.array(m.kfs.fvalid),
                         valid=np.array(m.kfs.valid))
    kfs.lm_idx[:n_same] = np.arange(N, dtype=np.int32)
    kfs.fvalid[:n_same] = True
    kfs.valid[:n_same] = True
    pts = m.pts._replace(valid=np.arange(P) < N,
                         n_obs=np.where(np.arange(P) < N, n_same, 0).astype(np.int32))
    return m._replace(kfs=kfs, pts=pts, n_kfs=np.int32(n_same))


@pytest.mark.parametrize("source", ["redundant", "captured"])
def test_cull_keyframes(ref, source):
    if source == "redundant":
        m, kf = _redundant_map(), 5
    else:
        m, kf = convert.map_state_to_numpy(tmap(ref)), ref.kf
    with jax.disable_jit():
        jm, jids = JMO.cull_keyframes(jax.tree.map(jnp.asarray, m), jnp.int32(kf))
    tm, tids = TMO.cull_keyframes(convert.map_state_from_numpy(m, "cpu"), kf)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert_maps_equal(tm, jm, float_atol=0)
    if source == "redundant":
        assert sorted(tids.tolist()) != [-1, -1]


def test_mapping_step_matches_jitted_reference(ref):
    m = convert.map_state_from_numpy(ref.before, "cpu")
    tm, stats = TMO.mapping_step(m, ref.kf, ref.tcam, torch.from_numpy(ref.scales),
                                 **ref.kw)
    tm = convert.map_state_to_numpy(tm)
    jm = ref.after
    js = np.asarray(ref.stats)
    ts = stats.numpy()
    assert ts.shape == js.shape == (TMO.MSTAT_LEN,) == (JMO.MSTAT_LEN,)
    for name in ("MAX_KF_CULL", "MSTAT_POSE", "MSTAT_CULL", "MSTAT_GUARD",
                 "MSTAT_REVERT", "MSTAT_LMSING"):
        assert getattr(TMO, name) == getattr(JMO, name), name
    ints = np.r_[0:3, TMO.MSTAT_CULL + 17 * np.arange(TMO.MAX_KF_CULL),
                 TMO.MSTAT_GUARD:TMO.MSTAT_LEN]
    np.testing.assert_array_equal(ts[ints], js[ints])
    np.testing.assert_allclose(ts[3], js[3], rtol=1e-3)
    np.testing.assert_allclose(ts[4:20], js[4:20], atol=1e-3)
    assert int(tm.n_pts) == int(jm.n_pts)
    for group in ("pts", "kfs"):
        for f in getattr(jm, group)._fields:
            a = np.asarray(getattr(getattr(tm, group), f))
            b = np.asarray(getattr(getattr(jm, group), f))
            if b.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f"{group}.{f}")
    np.testing.assert_allclose(tm.kfs.Tcw, jm.kfs.Tcw, atol=1e-3)
    live = np.asarray(jm.pts.valid)
    d = np.linalg.norm(tm.pts.xyz - jm.pts.xyz, axis=-1)[live]
    assert np.median(d) <= 5e-4
    assert (d <= 0.01 * np.maximum(1.0, np.linalg.norm(jm.pts.xyz[live], axis=-1))).all()
    assert js[1] > 500 and js[2] > 0.9 * js[1]


def test_fuse_no_hits_leaves_rows_untouched():
    """tests/test_fuse_sentinel.py: a fuse pass with zero hits (every
    landmark behind the neighbour) must leave every observation row, the
    last slot's canary included, bit-identical."""
    import test_fuse_sentinel as JFS

    st = jax.device_get(JFS._tiny_map())
    cam = TCam.create(200.0, 200.0, 160.0, 120.0, bf=24.0, width=320, height=240)
    scales = torch.tensor([1.2 ** i for i in range(8)], dtype=torch.float32)
    m = convert.map_state_from_numpy(st, "cpu")
    out = TMO.fuse_neighbors(m, cam, scales, 0, torch.tensor([1], dtype=torch.int32),
                             1.2, 8)
    after = out.kfs.lm_idx.numpy()
    assert after[1, -1] == 20, "last-slot canary was clobbered"
    np.testing.assert_array_equal(after, np.asarray(st.kfs.lm_idx))
    np.testing.assert_array_equal(out.pts.n_obs.numpy(), np.asarray(st.pts.n_obs))


def _duplicate_map():
    """Keyframe 0 holds landmarks 0..3 at features 0..3 and again 1 at
    feature 4; keyframe 1 has only free features at the same pixels. The
    non-mutual fuse match sends features 1 and 4 (and, with a copied
    descriptor, 0) of keyframe 0 onto one feature of keyframe 1."""
    K, N, P = 4, 8, 16
    m = jax.device_get(JM.MapState.empty(P, 4, K, N, 1))
    rng = np.random.default_rng(7)
    desc = rng.integers(0, 2 ** 32, size=(K, N, 8), dtype=np.uint64).astype(np.uint32)
    desc[1, :5] = desc[0, :5]
    desc[0, 0] = desc[0, 1]                 # rows 0, 1 and 4 hit one column
    desc[0, 4] = desc[0, 1]
    xy = np.zeros((K, N, 2), np.float32)
    xy[:, :, 0] = 100.0 + 10.0 * np.arange(N)
    xy[:, :, 1] = 120.0
    xy[0, 4] = xy[0, 1]
    xy[0, 0] = xy[0, 1]
    lm = np.full((K, N), -1, np.int32)
    lm[0, :5] = [0, 1, 2, 3, 1]
    fvalid = np.zeros((K, N), bool)
    fvalid[:2, :5] = True
    X = np.zeros((P, 3), np.float32)
    X[:4, 0] = (xy[0, :4, 0] - 160.0) / 200.0 * 5.0
    X[:4, 1] = (xy[0, :4, 1] - 120.0) / 200.0 * 5.0
    X[:4, 2] = 5.0
    # dmax just under the distance: predicted octave 0, inside the band.
    dmax = np.full(P, 50.0, np.float32)
    dmax[:4] = 0.95 * np.linalg.norm(X[:4], axis=-1)
    pts = m.pts._replace(
        xyz=X, desc=np.concatenate([desc[0, :4], np.zeros((P - 4, 8), np.uint32)]),
        normal=np.tile(np.float32([0, 0, 1]), (P, 1)), dmin=np.full(P, 0.1, np.float32),
        dmax=dmax, valid=np.arange(P) < 4,
        n_obs=np.where(np.arange(P) < 4, 2, 0).astype(np.int32))
    kfs = m.kfs._replace(lm_idx=lm, fvalid=fvalid, xy=xy, desc=desc,
                         valid=np.arange(K) < 2, Tcw=np.tile(np.eye(4, dtype=np.float32),
                                                             (K, 1, 1)))
    return m._replace(pts=pts, kfs=kfs, n_pts=np.int32(4), n_kfs=np.int32(2))


def test_fuse_duplicate_scatter_matches_jax():
    """Two rows of one keyframe fuse onto the same free feature of the
    neighbour: the reference's scatter keeps the last (highest) row."""
    from splslam_tpu.geometry.camera import Camera as JCam

    m = _duplicate_map()
    cam_args = (200.0, 200.0, 160.0, 120.0)
    jcam = JCam.create(*cam_args, bf=24.0, width=320, height=240)
    tcam = TCam.create(*cam_args, bf=24.0, width=320, height=240)
    scales = [1.2 ** i for i in range(8)]
    nb = np.array([1], np.int32)
    with jax.disable_jit():
        jm = JMO.fuse_neighbors(jax.tree.map(jnp.asarray, m), jcam,
                                jnp.asarray(scales, jnp.float32), jnp.int32(0),
                                jnp.asarray(nb), 1.2, 8)
    tm = TMO.fuse_neighbors(convert.map_state_from_numpy(m, "cpu"), tcam,
                            torch.tensor(scales), 0, torch.from_numpy(nb), 1.2, 8)
    assert_maps_equal(tm, jm, float_atol=0)
    row = np.asarray(jm.kfs.lm_idx)[1]
    # Rows 0 (landmark 0), 1 and 4 (landmark 1) all hit feature 1: row 4 won.
    np.testing.assert_array_equal(row[:5], [-1, 1, 2, 3, -1])
    np.testing.assert_array_equal(np.asarray(jm.pts.n_obs)[:4], [3, 4, 3, 3])


def test_last_writer_matches_xla_scatter():
    """`_scatter_set_last` against `.at[].set` with many duplicates."""
    rng = np.random.default_rng(3)
    for n, size in ((50, 8), (500, 64), (7, 3)):
        idx = rng.integers(0, size, n).astype(np.int32)
        ok = rng.random(n) < 0.7
        val = rng.integers(-100, 100, n).astype(np.int32)
        base = rng.integers(-100, 100, size).astype(np.int32)
        ref = np.asarray(jnp.asarray(base).at[jnp.where(ok, idx, size)].set(
            jnp.asarray(val), mode="drop"))
        got = TMO._scatter_set_last(torch.from_numpy(base), torch.from_numpy(idx),
                                    torch.from_numpy(ok), torch.from_numpy(val))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_popcount32_exact():
    """The shared popcount (`ops/match.py`), which mapping_ops imports."""
    from splslam_tpu_torch.ops import match as TM

    assert TMO.popcount32 is TM.popcount32
    rng = np.random.default_rng(11)
    w = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    ref = np.unpackbits(w.view(np.uint8)).reshape(-1, 32).sum(1)
    got = TM.popcount32(torch.from_numpy(w.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, ref)


def test_mapping_step_with_lines_on_a_points_map(ref):
    """`with_lines=True` on a map with no line table (1 slot, no lines):
    the line stages find nothing, the dual BA's line pass has no edge and
    never wins a camera, so the step ends where the points-only step does
    (integers exact, poses within 1e-3: its joint pass starts from the
    point pass's optimum and runs on)."""
    sc = torch.from_numpy(ref.scales)
    kw = dict(ref.kw)
    a, sa = TMO.mapping_step(convert.map_state_from_numpy(ref.before, "cpu"), ref.kf,
                             ref.tcam, sc, **kw)
    kw["with_lines"] = True
    b, sb = TMO.mapping_step(convert.map_state_from_numpy(ref.before, "cpu"), ref.kf,
                             ref.tcam, sc, **kw)
    ints = np.r_[0:3, TMO.MSTAT_CULL + 17 * np.arange(TMO.MAX_KF_CULL), TMO.MSTAT_REVERT]
    np.testing.assert_array_equal(sb.numpy()[ints], sa.numpy()[ints])
    a, b = convert.map_state_to_numpy(a), convert.map_state_to_numpy(b)
    for group in ("pts", "lns", "kfs"):
        for f in getattr(a, group)._fields:
            x, y = np.asarray(getattr(getattr(a, group), f)), np.asarray(getattr(getattr(b, group), f))
            if x.dtype.kind in "biu":
                np.testing.assert_array_equal(y, x, err_msg=f"{group}.{f}")
    assert int(b.n_lns) == 0 and not b.lns.valid.any()
    np.testing.assert_allclose(b.kfs.Tcw, a.kfs.Tcw, atol=1e-3)
