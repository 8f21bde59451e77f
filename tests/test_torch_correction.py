"""Loop correction and global BA of the PyTorch port
(`splslam_tpu_torch/slam/loop_closing.py`) against the JAX package's, on
the CPU, from the same numpy inputs.

Two maps are used: tests/test_loop_lines.py's hand-built 6-keyframe map
(with line observations added, so the line covisibility matrix is not
all zeros), and a captured loop map: the port's own run of
tests/test_loop.py's 98-frame circuit (`make_loop_circuit`) with the
correction off, which
verifies one loop. The captured map crosses to the JAX package through
`splslam_tpu_torch.convert`; both packages' `LoopCloser`s then run on a
stub of the host state they read.

Tolerances, with the values measured when the tests were written, stand
beside each assert. Integer outputs (edge lists, `lm_idx`, `valid`,
`n_obs`, counters) are held exactly for every function given the same
inputs. `_correct` whole chains them: the two packages' pose graphs end
3e-5 apart, which can move one loop landmark's projection across a
window edge in the fuse that follows, so there `lm_idx` may differ in
0.1% of its entries and `valid` / `n_obs` in 8 landmarks.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import ate_rmse
from splslam_tpu.slam import loop_closing as JLC
from splslam_tpu.slam import system as JS
from splslam_tpu.slam.map import MapState as JMapState
from splslam_tpu.slam.mapping_ops import _topk_covisible as j_topk
from splslam_tpu_torch import convert
from splslam_tpu_torch.geometry import se3 as TSE3
from splslam_tpu_torch.io.synthetic import make_loop_circuit, make_stereo_sequence
from splslam_tpu_torch.slam import loop_closing as TLC
from splslam_tpu_torch.slam import system as TS
from splslam_tpu_torch.slam.map import MapState
from tests.test_loop_lines import _small_map


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module runs the port's System for some 250 frames. Beside
    other test processes, torch's 8 OpenMP threads spin at every small
    op's barrier while the cores are taken (two such runs side by side
    took over 20x as long as one); one thread has no barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _map_np(st):
    """The port's map as numpy COPIES: `convert` returns views of the
    tensors, which the port goes on updating in place."""
    return jax.tree.map(np.copy, convert.map_state_to_numpy(st))


def _circuit_settings(K, bf, **kw):
    return dict(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=500, n_levels=4, th_depth=60.0, fps=5,
        max_points=16384, max_keyframes=64, local_window=1024,
        enable_local_mapping=True, **kw)


def _run_circuit(correction: bool):
    K, bf, frames, gt = make_loop_circuit()
    sysm = TS.System(TS.Settings(**_circuit_settings(
        K, bf, enable_loop_correction=correction)), TS.Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.2)
    sysm.drain()
    return sysm, K, bf, gt


@pytest.fixture(scope="module")
def loop_run():
    """The port's circuit run with the correction off, its map as numpy,
    the verified loop and its measured Sim3 (numpy)."""
    sysm, K, bf, gt = _run_circuit(False)
    assert sysm.state == TS.TrackingState.OK
    assert len(sysm.loop_closer.verified_loops) >= 1
    kf, cand = sysm.loop_closer.verified_loops[0]
    assert kf - cand >= 5
    gen = torch.Generator().manual_seed(kf)
    *_, S12 = TLC.compute_sim3_attempt(sysm.map, kf, cand, torch.from_numpy(K),
                                       True, generator=gen)
    return types.SimpleNamespace(
        sysm=sysm, K=K, bf=bf, gt=gt, kf=kf, cand=cand,
        S12=tuple(x.numpy() for x in S12),
        map_np=_map_np(sysm.map),
        kf_pose_host={k: v.copy() for k, v in sysm.kf_pose_host.items()})


def _stubs(r, map_np=None):
    """(port stub, JAX stub) of the host state `_correct` and
    `run_global_ba` read, each holding a fresh copy of the map."""
    m = r.map_np if map_np is None else map_np
    n = r.sysm.n_kfs
    common = dict(n_kfs=n, step=None, map_version=0)
    kw = _circuit_settings(r.K, r.bf)
    tsys = types.SimpleNamespace(
        map=convert.map_state_from_numpy(m, "cpu"), device=torch.device("cpu"),
        sensor=TS.Sensor.STEREO, cam=r.sysm.cam, scales=r.sysm.scales,
        settings=r.sysm.settings, mapper=types.SimpleNamespace(big_change_idx=0),
        kf_pose_host={}, **common)
    jsys = types.SimpleNamespace(
        map=_jnp(m), sensor=JS.Sensor.STEREO, cam=JS.Settings(**kw).camera(),
        scales=jnp.asarray(r.sysm.scales.numpy()),
        mapper=types.SimpleNamespace(big_change_idx=0), kf_pose_host={}, **common)
    return tsys, jsys


# ---------------------------------------------------------------------
# the hand-built map of tests/test_loop_lines.py, with line observations
# ---------------------------------------------------------------------
def _small_map_np():
    st, n_kf, n_pts, n_lns = _small_map()
    ll_idx = np.full(st.kfs.ll_idx.shape, -1, np.int32)
    lvalid = np.zeros(st.kfs.lvalid.shape, bool)
    for k in range(n_kf):                   # keyframe k sees lines k .. k+4
        ids = np.arange(k, min(k + 5, n_lns))
        ll_idx[k, :len(ids)] = ids
        lvalid[k, :len(ids)] = True
    ll_idx[3, 0] = -1                        # a hole, and a dead line
    lns_valid = np.array(st.lns.valid)
    lns_valid[4] = False
    st = st._replace(
        kfs=st.kfs._replace(ll_idx=jnp.asarray(ll_idx), lvalid=jnp.asarray(lvalid)),
        lns=st.lns._replace(valid=jnp.asarray(lns_valid)))
    return jax.device_get(st), n_kf, n_lns


def _maps(m):
    return convert.map_state_from_numpy(m, "cpu"), _jnp(m)


def test_covis_matrices_match_jax_on_small_map():
    m, n_kf, _ = _small_map_np()
    tm, jm = _maps(m)
    C = TLC._covis_matrix(tm).numpy()
    np.testing.assert_array_equal(C, np.asarray(JLC._covis_matrix(jm)))
    CL = TLC._covis_matrix_lines(tm).numpy()
    np.testing.assert_array_equal(CL, np.asarray(JLC._covis_matrix_lines(jm)))
    assert C[1, 0] == 15 and C[0, 0] == 20          # by construction
    assert CL[1, 0] == 3 and CL[:n_kf, :n_kf].any()  # lines 1..3 (4 is dead)
    assert not C[n_kf:].any() and not CL[n_kf:].any()


def test_covis_matrix_matches_jax_on_captured_map(loop_run):
    tm, jm = _maps(loop_run.map_np)
    assert (loop_run.map_np.kfs.lm_idx == 0).any()   # landmark 0 counts here
    C = TLC._covis_matrix(tm).numpy()
    np.testing.assert_array_equal(C, np.asarray(JLC._covis_matrix(jm)))
    assert C.dtype == np.int32 and C.max() >= 100
    np.testing.assert_array_equal(
        TLC._covis_matrix_lines(tm).numpy(),
        np.asarray(JLC._covis_matrix_lines(jm)))     # the 1-slot dummy: zeros


def _assert_edges_equal(te, je):
    for f in ("i", "j", "weight"):
        np.testing.assert_array_equal(getattr(te, f).numpy(),
                                      np.asarray(getattr(je, f)), err_msg=f)
    assert te.i.dtype == te.j.dtype == torch.int32
    for f in ("s", "R", "t"):
        # both sides run the same numpy code on the same poses: measured 0
        np.testing.assert_allclose(getattr(te, f).numpy(),
                                   np.asarray(getattr(je, f)), rtol=0, atol=1e-6,
                                   err_msg=f)


def test_pose_graph_edges_match_jax_on_small_map():
    m, n_kf, _ = _small_map_np()
    tm, jm = _maps(m)
    S_loop = (1.1, np.eye(3, dtype=np.float32), np.array([0.2, 0.0, 0.0], np.float32))
    args = (n_kf, n_kf - 1, 0, S_loop)
    kw = dict(past_loops=[(4, 1), (7, 0)], covis_min=10)
    te = TLC._build_pose_graph_edges(tm, *args, **kw)
    _assert_edges_equal(te, JLC._build_pose_graph_edges(jm, *args, **kw))
    ei, ej, w = te.i.numpy(), te.j.numpy(), te.weight.numpy()
    assert (ei[-1], ej[-1], w[-1]) == (n_kf - 1, 0, float(n_kf))
    assert float(te.s[-1]) == np.float32(1.1)
    assert (4, 1) in set(zip(ei[w == n_kf].tolist(), ej[w == n_kf].tolist()))
    # the line tree adds a parent the point tree does not give: with lines
    # off the edge list is shorter or equal, never longer
    no_lines = m._replace(kfs=m.kfs._replace(lvalid=np.zeros_like(m.kfs.lvalid)))
    te0 = TLC._build_pose_graph_edges(convert.map_state_from_numpy(no_lines, "cpu"),
                                      *args, **kw)
    assert te0.i.shape[0] <= te.i.shape[0]


def test_pose_graph_edges_match_jax_on_captured_map(loop_run):
    r = loop_run
    tm, jm = _maps(r.map_np)
    n = r.sysm.n_kfs
    te = TLC._build_pose_graph_edges(tm, n, r.kf, r.cand, r.S12)
    _assert_edges_equal(te, JLC._build_pose_graph_edges(jm, n, r.kf, r.cand, r.S12))
    assert te.i.shape[0] >= n                  # the chain and the loop edge


def test_pose_graph_edges_cross_convert():
    m, n_kf, _ = _small_map_np()
    S_loop = (1.0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    je = jax.device_get(JLC._build_pose_graph_edges(_jnp(m), n_kf, n_kf - 1, 0, S_loop))
    te = convert.pose_graph_edges_from_numpy(je, "cpu")
    back = convert.pose_graph_edges_to_numpy(te)
    for f in je._fields:
        np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(je, f)))


def test_apply_pose_graph_matches_jax_and_moves_lines_like_points():
    m, n_kf, n_lns = _small_map_np()
    tm, jm = _maps(m)
    K = 4                     # a bucketed leading slice of the 8-slot table
    rng = np.random.default_rng(3)
    s_f = (1.0 + 0.03 * np.arange(K)).astype(np.float32)       # non-unit scales
    R_f = np.stack([TSE3.so3_exp(torch.tensor([0.0, 0.05 * k, 0.01 * k])).numpy()
                    for k in range(K)]).astype(np.float32)
    t_f = (m.kfs.Tcw[:K, :3, 3] + rng.normal(0, 0.1, (K, 3))).astype(np.float32)
    valid_k = np.arange(K) < 3
    # first_kf beyond the slice clamps to K - 1, as in the reference
    jo = JLC._apply_pose_graph(jm, jnp.asarray(s_f), jnp.asarray(R_f),
                               jnp.asarray(t_f), jnp.asarray(valid_k))
    to = TLC._apply_pose_graph(tm, *(torch.from_numpy(x) for x in
                                     (s_f, R_f, t_f, valid_k)))
    # measured 4.8e-7 (points), 4.8e-7 (lines), 0 (poses)
    np.testing.assert_allclose(to.kfs.Tcw.numpy(), np.asarray(jo.kfs.Tcw), atol=1e-6)
    np.testing.assert_allclose(to.pts.xyz.numpy(), np.asarray(jo.pts.xyz), atol=2e-6)
    np.testing.assert_allclose(to.lns.xyz.numpy(), np.asarray(jo.lns.xyz), atol=2e-6)
    np.testing.assert_array_equal(to.kfs.Tcw[3:].numpy(), m.kfs.Tcw[3:])
    # a line's three rows move like points owned by the same keyframe
    new_Tcw = to.kfs.Tcw.numpy()
    moved = 0
    for q in range(n_lns):
        k = min(int(m.lns.first_kf[q]), K - 1)
        if not (m.lns.valid[q] and valid_k[k]):
            np.testing.assert_array_equal(to.lns.xyz[q].numpy(), m.lns.xyz[q])
            continue
        To, Tn = m.kfs.Tcw[k], new_Tcw[k]
        for row in range(3):
            pc = To[:3, :3] @ m.lns.xyz[q, row] + To[:3, 3]
            expect = Tn[:3, :3].T @ (pc / s_f[k] - Tn[:3, 3])
            np.testing.assert_allclose(to.lns.xyz[q, row].numpy(), expect,
                                       rtol=1e-4, atol=1e-5)
        moved += 1
    assert moved >= 3


# ---------------------------------------------------------------------
# SearchAndFuse
# ---------------------------------------------------------------------
def _fuse_inputs(r, tm):
    """The current group and the loop-area landmarks of the verified loop,
    as `_correct` derives them (numpy)."""
    from splslam_tpu_torch.slam.mapping_ops import _topk_covisible

    def group(k):
        return np.concatenate([[k], _topk_covisible(tm, k, 7)[0].numpy()]).astype(np.int32)
    cur, loop = group(r.kf), group(r.cand)
    rows = r.map_np.kfs.lm_idx[np.clip(loop, 0, None)]
    ids = np.unique(np.where((loop >= 0)[:, None], rows, -1))
    ids = ids[ids >= 0][:TLC.MAX_LOOP_LMS]
    return cur, np.pad(ids, (0, TLC.MAX_LOOP_LMS - len(ids)),
                       constant_values=-1).astype(np.int32)


def test_loop_search_and_fuse_matches_jax_on_captured_map(loop_run):
    r = loop_run
    tm, jm = _maps(r.map_np)
    cur, loop_lms = _fuse_inputs(r, tm)
    tsys, jsys = _stubs(r)
    jo = JLC.loop_search_and_fuse(jm, jnp.asarray(cur), jnp.asarray(loop_lms),
                                  jsys.cam, jsys.scales, 1.2, 4)
    to = TLC.loop_search_and_fuse(tm, torch.from_numpy(cur), torch.from_numpy(loop_lms),
                                  tsys.cam, tsys.scales, 1.2, 4)
    np.testing.assert_array_equal(to.kfs.lm_idx.numpy(), np.asarray(jo.kfs.lm_idx))
    np.testing.assert_array_equal(to.pts.valid.numpy(), np.asarray(jo.pts.valid))
    np.testing.assert_array_equal(to.pts.n_obs.numpy(), np.asarray(jo.pts.n_obs))
    n_merged = int(r.map_np.pts.valid.sum() - to.pts.valid.sum())
    assert n_merged > 0                      # the revisit's duplicates merged
    assert int((to.kfs.lm_idx.numpy() != r.map_np.kfs.lm_idx).sum()) >= n_merged


def _fuse_case():
    """One keyframe at the identity with three features; four loop
    landmarks in front of it. Rows 0 and 1 both match feature 0, which
    holds landmark 5: both forward 5 (one `tgt`), the last row wins. Rows
    2 and 3 both match the free feature 1: the last row's observation is
    written. Feature 2 is far from every projection."""
    P, N = 16, 3
    st = MapState.empty(P, 1, 2, N, 1, "cpu")
    fx = fy = 100.0
    cx, cy = 80.0, 60.0
    cam = types.SimpleNamespace(fx=fx, fy=fy, cx=cx, cy=cy, width=160, height=120)
    xyz = np.array([[0.0, 0.0, 4.0], [0.004, 0.0, 4.0],
                    [0.4, 0.2, 4.0], [0.404, 0.2, 4.0]], np.float32)
    st.pts.xyz[:4] = torch.from_numpy(xyz)
    st.pts.valid[:6] = True
    st.pts.dmin[:] = 1.0
    st.pts.dmax[:] = 8.0
    st.pts.n_obs[:6] = torch.tensor([2, 2, 2, 2, 2, 7], dtype=torch.int32)
    desc = np.zeros((P, 8), np.int32)
    desc[1, 0] = 1          # row 1 is one bit off feature 0; row 0 equals it
    desc[2, 0] = 3          # row 2 is two bits off feature 1; row 3 equals it
    st.pts.desc.copy_(torch.from_numpy(desc))
    uv = np.stack([fx * xyz[:, 0] / 4.0 + cx, fy * xyz[:, 1] / 4.0 + cy], -1)
    kfs = st.kfs
    kfs.valid[0] = True
    kfs.fvalid[0] = True
    kfs.xy[0] = torch.from_numpy(np.array([uv[0], uv[3], [150.0, 110.0]], np.float32))
    # dmax 8 at distance ~4: ceil(log(2) / log(1.2)) = 4, clamped to 3
    kfs.octave[0] = 3
    kfs.lm_idx[0] = torch.tensor([5, -1, -1], dtype=torch.int32)
    scales = torch.tensor([1.0, 1.2, 1.44, 1.728])
    return st, cam, scales


def test_loop_search_and_fuse_last_writer_matches_jax():
    st, cam, scales = _fuse_case()
    m = _map_np(st)
    cur = np.array([0, -1], np.int32)
    loop_lms = np.array([0, 1, 2, 3, -1, -1], np.int32)
    jcam = JS.Settings(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=160,
                       height=120).camera()
    jo = JLC.loop_search_and_fuse(_jnp(m), jnp.asarray(cur), jnp.asarray(loop_lms),
                                  jcam, jnp.asarray(scales.numpy()), 1.2, 4)
    to = TLC.loop_search_and_fuse(st, torch.from_numpy(cur), torch.from_numpy(loop_lms),
                                  cam, scales, 1.2, 4)
    np.testing.assert_array_equal(to.kfs.lm_idx.numpy(), np.asarray(jo.kfs.lm_idx))
    np.testing.assert_array_equal(to.pts.valid.numpy(), np.asarray(jo.pts.valid))
    np.testing.assert_array_equal(to.pts.n_obs.numpy(), np.asarray(jo.pts.n_obs))
    # landmark 5 forwarded to the LAST row that hit its feature (row 1),
    # the free feature took the last row's landmark (3)
    assert to.kfs.lm_idx[0].tolist() == [1, 3, -1]
    assert not bool(to.pts.valid[5]) and int(to.pts.n_obs[1]) == 2 + 7
    assert to.pts.valid[:4].all()


# ---------------------------------------------------------------------
# _correct and run_global_ba whole, both packages from one map
# ---------------------------------------------------------------------
def _assert_maps_close(tm, jm, n, pose_atol, xyz_atol, flips=0):
    """`flips`: how many landmarks' fuse decisions may differ."""
    lm_t, lm_j = tm.kfs.lm_idx.numpy(), np.asarray(jm.kfs.lm_idx)
    assert (lm_t != lm_j).sum() <= (0.001 * lm_t.size if flips else 0)
    assert (tm.pts.valid.numpy() != np.asarray(jm.pts.valid)).sum() <= flips
    assert (tm.pts.n_obs.numpy() != np.asarray(jm.pts.n_obs)).sum() <= flips
    np.testing.assert_allclose(tm.kfs.Tcw.numpy(), np.asarray(jm.kfs.Tcw),
                               rtol=0, atol=pose_atol)
    ok = tm.pts.valid.numpy() & np.asarray(jm.pts.valid)
    d = np.linalg.norm(tm.pts.xyz.numpy() - np.asarray(jm.pts.xyz), axis=-1)[ok]
    print(f"maps: lm_idx entries differing {(lm_t != lm_j).sum()}, pose max abs "
          f"{np.abs(tm.kfs.Tcw.numpy() - np.asarray(jm.kfs.Tcw)).max():.2e}, "
          f"landmarks q99 {np.quantile(d, 0.99):.2e} max {d.max():.2e}")
    assert np.quantile(d, 0.99) <= xyz_atol, (np.quantile(d, 0.99), d.max())
    return d


def test_run_global_ba_matches_jax(loop_run):
    r = loop_run
    tsys, jsys = _stubs(r)
    tl, jl = TLC.LoopCloser(tsys), JLC.LoopCloser(jsys)
    res = tl.run_global_ba(rounds=1)
    jl.run_global_ba(rounds=1)
    assert tl.n_guarded == jl.n_guarded == 0
    assert int(res.n_state_revert) == 0
    assert tsys.map_version == jsys.map_version == 1
    n = r.sysm.n_kfs
    # measured: poses 1.0e-6, landmarks q99 6.2e-6 (max 1.7e-5)
    _assert_maps_close(tsys.map, jsys.map, n, pose_atol=2e-4, xyz_atol=5e-4)
    for k in range(n):
        np.testing.assert_allclose(tsys.kf_pose_host[k], jsys.kf_pose_host[k],
                                   atol=2e-4)
    # keyframe 0 is the gauge anchor; the solve moved something
    np.testing.assert_array_equal(tsys.map.kfs.Tcw[0].numpy(), r.map_np.kfs.Tcw[0])
    assert np.abs(tsys.map.kfs.Tcw.numpy() - r.map_np.kfs.Tcw).max() > 1e-5


# ---------------------------------------------------------------------
# global BA with line edges: tests/test_gba_lines.py's scene, the port's
# own copy of its fixture
# ---------------------------------------------------------------------
GBA_CAM = (300.0, 300.0, 160.0, 120.0)


def _gba_lines_map(perturb=0.15, seed=5):
    """3 keyframes at their true poses observing 36 points at their true
    positions and 4 map lines: lines 0..2 seen by all 3 keyframes, line 3
    by keyframe 0 only. The lines' world endpoints are perturbed, their
    2D observations exact. Returns (port map, true line endpoints [4,2,3],
    n_kf, n_lines)."""
    K_CAP, N, Lf, P, Q = 4, 64, 8, 64, 8
    n_kf, n_pts, n_lns = 3, 36, 4
    fx, fy, cx, cy = GBA_CAM
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0, 0], [0.4, 0.05, 0], [0.8, -0.05, 0]], np.float32)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (K_CAP, 1, 1))
    Tcw[:n_kf, :3, 3] = -centers
    xyz = rng.uniform([-0.8, -0.8, 3.0], [1.6, 0.8, 5.0], (n_pts, 3)).astype(np.float32)
    gt = np.zeros((n_lns, 2, 3), np.float32)
    gt[:, 0] = rng.uniform([-0.6, -0.6, 3.2], [1.2, 0.6, 4.6], (n_lns, 3))
    d = rng.normal(0, 1, (n_lns, 3)).astype(np.float32)
    gt[:, 1] = gt[:, 0] + 0.8 * d / np.linalg.norm(d, axis=1, keepdims=True)

    def proj(p3, k):
        rel = p3 - centers[k]
        return np.stack([fx * rel[:, 0] / rel[:, 2] + cx, fy * rel[:, 1] / rel[:, 2] + cy], -1)

    st = MapState.empty(P, Q, K_CAP, N, Lf, "cpu")
    kfs, pts, lns = st.kfs, st.pts, st.lns
    kfs.Tcw.copy_(torch.from_numpy(Tcw))
    for k in range(n_kf):
        kfs.lm_idx[k, :n_pts] = torch.arange(n_pts, dtype=torch.int32)
        kfs.fvalid[k, :n_pts] = True
        kfs.xy[k, :n_pts] = torch.from_numpy(proj(xyz, k).astype(np.float32))
        obs = n_lns if k == 0 else n_lns - 1
        seg = np.concatenate([proj(gt[:obs, 0], k), proj(gt[:obs, 1], k)], -1)
        kfs.lseg[k, :obs] = torch.from_numpy(seg.astype(np.float32))
        kfs.lvalid[k, :obs] = True
        kfs.ll_idx[k, :obs] = torch.arange(obs, dtype=torch.int32)
    kfs.valid[:n_kf] = True
    pts.xyz[:n_pts] = torch.from_numpy(xyz)
    pts.valid[:n_pts] = True
    pert = gt + rng.normal(0, perturb, gt.shape).astype(np.float32)
    lns.xyz[:n_lns] = torch.from_numpy(np.stack(
        [pert[:, 0], 0.5 * (pert[:, 0] + pert[:, 1]), pert[:, 1]], 1))
    lns.valid[:n_lns] = True
    return st._replace(n_kfs=torch.tensor(n_kf, dtype=torch.int32)), gt, n_kf, n_lns


def _gba_port(st, n_kf, with_lines):
    from splslam_tpu_torch.geometry.camera import Camera as TCam

    stub = types.SimpleNamespace(
        map=st, n_kfs=n_kf, device=torch.device("cpu"), kf_pose_host={}, map_version=0,
        cam=TCam.create(*GBA_CAM, width=320, height=240))
    lc = TLC.LoopCloser(stub)
    lc.run_global_ba(rounds=1, with_lines=with_lines)
    return stub.map, lc


def _perp_err(endpts, gt):
    """Distance of each endpoint to its true infinite 3D line (along the
    line the endpoints are unobserved)."""
    d = gt[:, 1] - gt[:, 0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rel = endpts - gt[:, :1, :]
    par = np.sum(rel * d[:, None, :], -1, keepdims=True) * d[:, None, :]
    return np.linalg.norm(rel - par, axis=-1)


def test_gba_pulls_perturbed_line_endpoints_to_gt():
    """tests/test_gba_lines.py, on the port."""
    st, gt, n_kf, n_lns = _gba_lines_map()
    before = st.lns.xyz[:n_lns].numpy().copy()
    Tcw0 = st.kfs.Tcw[:n_kf].numpy().copy()
    err_b = _perp_err(before[:3][:, (0, 2)], gt[:3]).mean()
    out, lc = _gba_port(st, n_kf, True)
    after = out.lns.xyz[:n_lns].numpy()
    err_a = _perp_err(after[:3][:, (0, 2)], gt[:3]).mean()
    assert err_b > 0.05, err_b
    assert err_a < 0.02 * err_b, (err_b, err_a)
    np.testing.assert_allclose(after[:3, 1], 0.5 * (after[:3, 0] + after[:3, 2]), atol=1e-5)
    assert np.abs(out.kfs.Tcw[:n_kf].numpy() - Tcw0).max() < 0.02
    assert lc.n_guarded == 0


def test_gba_single_observation_line_is_carried_not_snapped():
    st, gt, n_kf, n_lns = _gba_lines_map()
    before = st.lns.xyz[n_lns - 1].numpy().copy()
    out, _ = _gba_port(st, n_kf, True)
    assert np.abs(out.lns.xyz[n_lns - 1].numpy() - before).max() < 0.05


def test_gba_with_lines_false_matches_carry_path():
    st, gt, n_kf, n_lns = _gba_lines_map()
    xyz0 = st.pts.xyz.numpy().copy()
    out, _ = _gba_port(st, n_kf, False)
    assert np.abs(out.pts.xyz.numpy() - xyz0).max() < 0.02


@pytest.mark.parametrize("with_lines", [True, False])
def test_run_global_ba_with_lines_matches_jax(with_lines):
    """Both packages' `run_global_ba` on the same map (the fixture above),
    with test_run_global_ba_matches_jax's tolerances: poses within 2e-4,
    points within 5e-4; adopted line endpoints off the reference's line
    within 1e-3 (along the line they are unobserved), carried lines
    within 1e-4. Measured with lines: poses 1.7e-5, points 1.1e-4,
    endpoints off the line 8.0e-5."""
    from splslam_tpu.geometry.camera import Camera as JCam

    st, gt, n_kf, n_lns = _gba_lines_map()
    m = _map_np(st)
    jsys = types.SimpleNamespace(map=_jnp(m), cam=JCam.create(*GBA_CAM, width=320,
                                                              height=240),
                                 n_kfs=n_kf, kf_pose_host={})
    jl = JLC.LoopCloser.__new__(JLC.LoopCloser)
    jl.sys = jsys
    jl.run_global_ba(rounds=1, with_lines=with_lines)
    jm = jax.device_get(jsys.map)
    tm, lc = _gba_port(st, n_kf, with_lines)
    assert lc.n_guarded == jl.n_guarded == 0
    np.testing.assert_allclose(tm.kfs.Tcw.numpy(), np.asarray(jm.kfs.Tcw), atol=2e-4)
    np.testing.assert_allclose(tm.pts.xyz.numpy(), np.asarray(jm.pts.xyz), atol=5e-4)
    jx, tx = np.asarray(jm.lns.xyz)[:n_lns], tm.lns.xyz[:n_lns].numpy()
    adopted = 3 if with_lines else 0
    if adopted:
        d = jx[:adopted, 2] - jx[:adopted, 0]
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        off = tx[:adopted] - jx[:adopted]
        off = off - np.sum(off * d[:, None], -1)[..., None] * d[:, None]
        np.testing.assert_allclose(off, 0, atol=1e-3)
    np.testing.assert_allclose(tx[adopted:], jx[adopted:], atol=1e-4)


def _drifted(r):
    """tests/test_loop.py's injected drift (:144-167) on the captured map:
    the post-loop keyframes and the landmarks they own slide away along a
    ramp, as odometry drift does. Returns (map as numpy, host poses)."""
    m = r.map_np
    n = r.sysm.n_kfs
    Tcw_d, xyz_d = m.kfs.Tcw.copy(), m.pts.xyz.copy()
    kph = {k: v.copy() for k, v in r.kf_pose_host.items()}
    ramp0 = r.cand + 2
    for k in range(ramp0, n):
        a = (k - ramp0) / max(n - 1 - ramp0, 1)
        xi = (0.25 * a * np.array([1.0, 0.4, 0.0, 0.0, 0.0, 0.0])).astype(np.float32)
        W = TSE3.se3_exp(torch.from_numpy(xi)).numpy()
        Tcw_d[k] = Tcw_d[k] @ np.linalg.inv(W)
        own = m.pts.first_kf == k
        xyz_d[own] = xyz_d[own] @ W[:3, :3].T + W[:3, 3]
        kph[k] = Tcw_d[k].copy()
    return m._replace(kfs=m.kfs._replace(Tcw=Tcw_d),
                      pts=m.pts._replace(xyz=xyz_d)), kph


def test_correct_matches_jax_and_removes_injected_drift(loop_run):
    r = loop_run
    sysm = r.sysm
    n = sysm.n_kfs
    ate0 = ate_rmse(sysm.poses_reconstructed(), r.gt)
    m_d, kph = _drifted(r)
    tsys, jsys = _stubs(r, m_d)
    tsys.kf_pose_host = {k: v.copy() for k, v in kph.items()}
    # the loop Sim3 re-measured on the drifted map, by the port, for both
    gen = torch.Generator().manual_seed(r.kf)
    *_, S12 = TLC.compute_sim3_attempt(tsys.map, r.kf, r.cand, torch.from_numpy(r.K),
                                       True, generator=gen)
    S12 = tuple(x.numpy() for x in S12)
    tl, jl = TLC.LoopCloser(tsys), JLC.LoopCloser(jsys)
    tl._correct(r.kf, r.cand, tuple(torch.from_numpy(x) for x in S12))
    jl._correct(r.kf, r.cand, tuple(jnp.asarray(x) for x in S12))
    assert tl.n_guarded == jl.n_guarded == 0
    assert tl.loop_edges == jl.loop_edges == [(r.kf, r.cand)]
    assert tl.corrections == jl.corrections == 1
    assert tsys.mapper.big_change_idx == jsys.mapper.big_change_idx == 1
    assert tsys.map_version == jsys.map_version == 2
    # measured: 4 of 32,000 `lm_idx` entries (one landmark), and behind the
    # global BA that follows, poses 3.8e-4 and landmarks q99 8.0e-4; on the
    # map 8 torch threads give: 0 entries, 3.0e-5 and 3.5e-5
    _assert_maps_close(tsys.map, jsys.map, n, pose_atol=1e-3, xyz_atol=2e-3,
                       flips=8)
    assert int(tsys.map.pts.valid.sum()) < int(m_d.pts.valid.sum())
    for k in range(n):
        np.testing.assert_allclose(tsys.kf_pose_host[k], jsys.kf_pose_host[k],
                                   atol=1e-3)

    # the correction removes most of the drift (tests/test_loop.py:168-180)
    def ate(kf_Tcw):
        est = [np.linalg.inv(e.Tcr @ kf_Tcw[e.ref_kf]) for e in sysm.trajectory]
        return ate_rmse(np.stack(est), r.gt)
    ate_drift, ate_corr = ate(m_d.kfs.Tcw), ate(tsys.map.kfs.Tcw.numpy())
    assert ate_drift > 2.0 * ate0, (ate0, ate_drift)   # measured 0.0384 -> 0.0916
    assert ate_corr < 0.5 * ate_drift, (ate_drift, ate_corr)   # measured 0.0292


# ---------------------------------------------------------------------
# the System with the correction on
# ---------------------------------------------------------------------
def test_live_loop_correction(loop_run):
    """tests/test_loop_live.py's run: the correction fires inside the
    tracking loop while a mapping result is pending."""
    base, gt = loop_run.sysm, loop_run.gt
    ate_base = ate_rmse(base.poses_reconstructed(), gt)
    sysm, *_ = _run_circuit(True)
    assert sysm.state == TS.TrackingState.OK
    h = sysm.health()
    assert h["loop_corrections"] == sysm.loop_closer.corrections >= 1
    assert sysm.loop_closer.loop_edges == sysm.loop_closer.verified_loops
    assert h["loop_guarded"] == 0 and h["mapping_state_revert"] == 0
    assert h["mapping_guarded"] <= max(3, h["mapping_steps"] // 25), h
    assert sysm.map_changed() and sysm.map_version >= 2
    ate_live = ate_rmse(sysm.poses_reconstructed(), gt)
    # measured: base 0.0384, live 0.0212
    assert ate_live < max(1.25 * ate_base, ate_base + 0.01), (ate_base, ate_live)
    # the default run is what it was: the same loop, verified and left alone
    assert base.loop_closer.corrections == 0 and base.loop_closer.loop_edges == []
    assert base.map_version == 0
    assert sysm.loop_closer.verified_loops[0] == base.loop_closer.verified_loops[0]


def _forward_system(**kw):
    K, bf, frames, _ = make_stereo_sequence(n_frames=24, motion="forward",
                                            width=320, height=240, seed=4)
    st = TS.Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=600, n_levels=4, th_depth=40.0, fps=10, max_points=8192,
        max_keyframes=64, local_window=1024, force_kf_every=6, **kw)
    return TS.System(st, TS.Sensor.STEREO, "cpu"), frames


def test_stale_mapping_pose_cannot_overwrite_correction():
    """tests/test_loop_live.py:69-109 for the port: a mapping result
    dispatched BEFORE a whole-map rewrite (a `map_version` bump) must not
    write its post-BA pose into `kf_pose_host`; one dispatched after must."""
    sysm, frames = _forward_system(enable_loop_correction=True,
                                   enable_relocalization=False)
    assert not sysm.map_changed()
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    assert sysm.map_changed()                  # mapping steps count as changes
    assert sysm.mapper._pending is not None
    kf = sysm.mapper._pending[1]
    sentinel = np.diag([7.0, 7.0, 7.0, 1.0]).astype(np.float32)
    sysm.kf_pose_host[kf] = sentinel.copy()
    sysm.map_version += 1
    sysm.mapper.flush()
    assert np.array_equal(sysm.kf_pose_host[kf], sentinel)
    for i, (l, r) in enumerate(frames[:8]):
        sysm.track_stereo(l, r, (24 + i) * 0.1)
    assert sysm.mapper._pending is not None
    kf2 = sysm.mapper._pending[1]
    sysm.kf_pose_host[kf2] = sentinel.copy()
    sysm.mapper.flush()
    assert not np.array_equal(sysm.kf_pose_host[kf2], sentinel)
    # a global BA in between is such a rewrite: the pending pose is dropped
    # and the pose log holds the BA's poses
    for i, (l, r) in enumerate(frames[8:14]):
        sysm.track_stereo(l, r, (32 + i) * 0.1)
    assert sysm.mapper._pending is not None
    kf3, version = sysm.mapper._pending[1:]
    sysm.loop_closer.run_global_ba(rounds=1)
    assert sysm.map_version == version + 1 and sysm.loop_closer.n_guarded == 0
    after_ba = sysm.kf_pose_host[kf3].copy()
    sysm.mapper.flush()
    np.testing.assert_array_equal(sysm.kf_pose_host[kf3], after_ba)
    np.testing.assert_allclose(after_ba, sysm.map.kfs.Tcw[kf3].numpy(), atol=1e-6)
    sysm.drain()
    assert sysm.get_tracking_state() == TS.TrackingState.OK


def test_keyframe_trajectory_export(loop_run, tmp_path):
    sysm = loop_run.sysm
    path = tmp_path / "kf.tum"
    sysm.save_keyframe_trajectory_tum(str(path))
    rows = [l.split() for l in path.read_text().strip().split("\n")]
    valid = sysm.map.kfs.valid[:sysm.n_kfs].numpy()
    assert len(rows) == int(valid.sum()) and all(len(r) == 8 for r in rows)
    k0 = int(np.nonzero(valid)[0][-1])
    Twc = np.linalg.inv(sysm.map.kfs.Tcw[k0].numpy())
    np.testing.assert_allclose([float(x) for x in rows[-1][1:4]], Twc[:3, 3], atol=1e-6)
    q = np.array([float(x) for x in rows[-1][4:]])
    assert abs(np.linalg.norm(q) - 1.0) < 1e-4   # float32 rotation, 7 decimals
    assert sysm.poses_reconstructed().shape == (len(sysm.trajectory), 4, 4)


def test_jax_stub_state_is_a_jax_map(loop_run):
    """The JAX side of these tests really is the JAX package's state."""
    _, jsys = _stubs(loop_run)
    assert set(JMapState._fields) == set(type(jsys.map)._fields)
    ids, _ = j_topk(jsys.map, jnp.int32(loop_run.kf), 7)
    from splslam_tpu_torch.slam.mapping_ops import _topk_covisible
    tm, _ = _maps(loop_run.map_np)
    np.testing.assert_array_equal(_topk_covisible(tm, loop_run.kf, 7)[0].numpy(),
                                  np.asarray(ids))
