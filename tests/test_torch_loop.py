"""Loop detection and Sim3 verification of the PyTorch port
(`splslam_tpu_torch/slam/loop_closing.py`) against the JAX package's.

- The four cases of tests/test_loop_detect.py (a hand-built 12-keyframe
  chain map and hand-built BoW rows) run through both packages'
  LoopCloser: the candidates reaching verification, the consistency
  groups and their counts are equal.
- `_covisible_mask` on a map captured from a JAX run (7 frames of the
  forward sequence, keyframes every 2 frames), landmark 0 included.
- `compute_sim3_attempt` between two keyframes of that map with the JAX
  package's 3-point sets injected (its Gumbel top-k draw, recomputed from
  the same key): n_matches, n_sim3_inliers and n_proj equal, S12 within
  1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.ops import match as JM
from splslam_tpu.slam import loop_closing as JLC
from splslam_tpu.slam import system as JS
from splslam_tpu.slam.map import MapState as JMapState
from splslam_tpu_torch import convert
from splslam_tpu_torch.bow.vocabulary import BowTable
from splslam_tpu_torch.slam import loop_closing as TLC
from splslam_tpu_torch.slam import reloc as TR
from splslam_tpu_torch.slam.map import MapState

K_CAP, N_FEAT, P_CAP, W = 16, 128, 1024, 64
N_KF = 12
S12_ATOL = 1e-4


def _chain_tables():
    """tests/test_loop_detect.py's map: KF k observes landmarks 40k ..
    40k+119 (80 shared at distance 1, 40 at distance 2)."""
    lm_idx = np.full((K_CAP, N_FEAT), -1, np.int32)
    fvalid = np.zeros((K_CAP, N_FEAT), bool)
    pvalid = np.zeros((P_CAP,), bool)
    for k in range(N_KF):
        ids = np.arange(40 * k, 40 * k + 120)
        lm_idx[k, :120] = ids
        fvalid[k, :120] = True
        pvalid[ids] = True
    return lm_idx, fvalid, pvalid, np.arange(K_CAP) < N_KF


def _bow_dense():
    """tests/test_loop_detect.py's rows: the revisit {9,10,11} of place A
    scores against {0,1,2}; mid-map queries have no far candidates."""
    rows = np.zeros((K_CAP, W), np.float32)
    A, B1, B2 = np.arange(0, 16), np.arange(16, 24), np.arange(24, 32)
    for k in range(N_KF):
        if k >= 9:
            sub = A[:8] if k == 9 else (A if k == 10 else A[8:])
            rows[k, sub] = 1.0 / len(sub)
            continue
        place = A if k <= 2 else (B1 if k <= 5 else B2)
        rows[k, place] = 0.5 / len(place)
        if k == 0:
            rows[k, 32] += 0.5
        else:
            rows[k, 32 + k - 1] += 0.25
            rows[k, 32 + k] += 0.25
    return rows


def _sparse(rows):
    K, Wd = rows.shape
    S = max(int((rows > 0).sum(1).max()), 1)
    ids = np.full((K, S), Wd, np.int32)
    vals = np.zeros((K, S), np.float32)
    for k in range(K):
        nz = np.nonzero(rows[k])[0]
        ids[k, :len(nz)] = nz
        vals[k, :len(nz)] = rows[k, nz]
    return ids, vals


class _Stub:
    """The host state LoopCloser.on_keyframe reads, for either package."""

    def __init__(self, port: bool):
        lm_idx, fvalid, pvalid, kvalid = _chain_tables()
        ids, vals = _sparse(_bow_dense())
        if port:
            st = MapState.empty(P_CAP, 4, K_CAP, N_FEAT, 4, "cpu")
            st.kfs.lm_idx.copy_(torch.from_numpy(lm_idx))
            st.kfs.fvalid.copy_(torch.from_numpy(fvalid))
            st.kfs.valid.copy_(torch.from_numpy(kvalid))
            st.pts.valid.copy_(torch.from_numpy(pvalid))
            self.map = st._replace(n_kfs=torch.tensor(N_KF, dtype=torch.int32))
            self.kf_bow = BowTable(torch.from_numpy(ids), torch.from_numpy(vals))
        else:
            from splslam_tpu.bow.vocabulary import BowTable as JBow

            st = JMapState.empty(P_CAP, 4, K_CAP, N_FEAT, 4)
            self.map = st._replace(
                kfs=st.kfs._replace(lm_idx=jnp.asarray(lm_idx),
                                    fvalid=jnp.asarray(fvalid),
                                    valid=jnp.asarray(kvalid)),
                pts=st.pts._replace(valid=jnp.asarray(pvalid)),
                n_kfs=jnp.int32(N_KF))
            self.kf_bow = JBow(jnp.asarray(ids), jnp.asarray(vals))
        self.bow_n_words = W
        self.n_kfs = N_KF
        self.vocab = object()  # only checked for non-None


def _closers(verify=True):
    out = []
    for port, mod in ((True, TLC), (False, JLC)):
        lc = mod.LoopCloser(_Stub(port))
        lc.calls = []
        lc._verify_and_close = (
            lambda kf, cand, lc=lc: lc.calls.append((kf, cand)) or verify)
        out.append(lc)
    return out


def test_covisible_mask_matches_construction():
    tl, _ = _closers()
    cov9 = TLC._covisible_mask(tl.sys.map, 9).numpy()
    assert cov9[7] and cov9[8] and cov9[10] and cov9[11]
    assert not cov9[:7].any() and not cov9[N_KF:].any()
    for kf in range(N_KF):
        np.testing.assert_array_equal(
            TLC._covisible_mask(tl.sys.map, kf).numpy(),
            np.asarray(JLC._covisible_mask(_Stub(False).map, jnp.int32(kf))))


def test_temporal_consistency_fires_on_third_consecutive_hit():
    tl, jl = _closers()
    for kf in (9, 10, 11):
        for lc in (tl, jl):
            lc.on_keyframe(kf)
        assert tl.consistent == jl.consistent
        if kf < 11:
            assert not tl.calls and tl.consistent
    assert tl.calls == jl.calls
    kf, cand = tl.calls[0]
    assert kf == 11 and cand in (0, 1, 2)


def test_consistency_resets_when_candidates_vanish():
    tl, jl = _closers()
    for lc in (tl, jl):
        lc.on_keyframe(9)
    assert tl.consistent == jl.consistent and tl.consistent
    for lc in (tl, jl):
        lc.on_keyframe(5)
    assert tl.consistent == jl.consistent == []


def test_neighbors_are_not_loop_candidates():
    tl, jl = _closers(verify=False)
    for kf in (9, 10, 11):
        for lc in (tl, jl):
            lc.on_keyframe(kf)
    assert tl.calls == jl.calls and tl.calls
    for kf, cand in tl.calls:
        cov = TLC._covisible_mask(tl.sys.map, kf).numpy()
        assert not cov[cand] and cand != kf


@pytest.fixture(scope="module")
def captured():
    """A JAX map after 7 frames (keyframes every 2 frames), as numpy."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=7, motion="forward",
                                            width=320, height=240)
    st = JS.Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=600, n_levels=4, th_depth=40.0, fps=10, max_points=8192,
        max_keyframes=64, local_window=1024, enable_local_mapping=False,
        enable_relocalization=False, force_kf_every=2)
    js = JS.System(st, JS.Sensor.STEREO)
    for i, (l, r) in enumerate(frames):
        js.track_stereo(l, r, i * 0.1)
    js.drain()
    assert js.n_kfs >= 3
    K3 = np.array([[st.fx, 0, st.cx], [0, st.fy, st.cy], [0, 0, 1]], np.float32)
    return jax.device_get(js.map), js.n_kfs, K3


def test_covisible_mask_matches_jax_on_captured_map(captured):
    m, n_kfs, _ = captured
    tm = convert.map_state_from_numpy(m, "cpu")
    assert (np.asarray(m.kfs.lm_idx[:n_kfs]) == 0).any()   # landmark 0 is used
    jm = jax.tree.map(jnp.asarray, m)
    for kf in range(n_kfs):
        got = TLC._covisible_mask(tm, kf).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JLC._covisible_mask(jm, jnp.int32(kf))))
        assert got[:n_kfs].any()
    # a row whose last non-positive entry is landmark 0 keeps landmark 0
    row = np.array(m.kfs.lm_idx[0])
    row[np.nonzero(row <= 0)[0][-1]] = 0
    tm.kfs.lm_idx[0] = torch.from_numpy(row)
    jm = jm._replace(kfs=jm.kfs._replace(lm_idx=jm.kfs.lm_idx.at[0].set(row)))
    np.testing.assert_array_equal(
        TLC._covisible_mask(tm, 0).numpy(),
        np.asarray(JLC._covisible_mask(jm, jnp.int32(0))))


def _jax_matched(m, kf, cand):
    """splslam_tpu/slam/loop_closing.py:66-76."""
    kfs = m.kfs
    lm1, lm2 = kfs.lm_idx[kf], kfs.lm_idx[cand]
    ok1 = kfs.fvalid[kf] & (lm1 >= 0) & m.pts.valid[jnp.clip(lm1, 0)]
    ok2 = kfs.fvalid[cand] & (lm2 >= 0) & m.pts.valid[jnp.clip(lm2, 0)]
    dist = JM.masked_distances(JM.hamming_matrix(kfs.desc[kf], kfs.desc[cand]),
                               ok1, ok2)
    mt, _ = JM.nn_match(dist, max_dist=JM.TH_LOW, ratio=0.75, mutual=True)
    return np.asarray(mt) >= 0


@pytest.mark.parametrize("fix_scale", [True, False])
def test_compute_sim3_attempt_matches_jax_with_injected_samples(captured, fix_scale):
    m, n_kfs, K3 = captured
    kf, cand = n_kfs - 1, 0
    jm = jax.tree.map(jnp.asarray, m)
    key = jax.random.PRNGKey(kf)
    n_m, n_opt, n_proj, n_grd, (s, R, t) = JLC.compute_sim3_attempt(
        key, jm, jnp.int32(kf), jnp.int32(cand), jnp.asarray(K3),
        jnp.float32(1.0 if fix_scale else 0.0))
    matched = _jax_matched(jm, kf, cand)
    logits = jnp.where(jnp.asarray(matched), 0.0, -1e9)
    g = jax.random.gumbel(key, (TLC.N_HYP_SIM3, matched.shape[0])) + logits[None]
    samples = torch.from_numpy(np.array(jax.lax.top_k(g, 3)[1]))
    tm = convert.map_state_from_numpy(m, "cpu")
    tn_m, tn_opt, tn_proj, tn_grd, (ts, tR, tt) = TLC.compute_sim3_attempt(
        tm, kf, cand, torch.from_numpy(K3), fix_scale, samples=samples)
    assert int(tn_m) == int(n_m) == int(matched.sum()) >= TLC.MIN_MATCHES
    assert int(tn_opt) == int(n_opt)
    assert int(tn_proj) == int(n_proj) >= TLC.MIN_PROJ_MATCHES
    assert int(tn_grd) == int(n_grd)
    for a, b in ((ts, s), (tR, R), (tt, t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=S12_ATOL)
    # S12 is the relative pose of the two keyframes
    Tcw = np.asarray(m.kfs.Tcw)
    rel = Tcw[kf] @ np.linalg.inv(Tcw[cand])
    np.testing.assert_allclose(tR.numpy(), rel[:3, :3], atol=0.01)


def test_compute_sim3_attempt_draws_from_a_generator(captured):
    m, n_kfs, K3 = captured
    tm = convert.map_state_from_numpy(m, "cpu")
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(n_kfs - 1)
        outs.append(TLC.compute_sim3_attempt(tm, n_kfs - 1, 0, torch.from_numpy(K3),
                                             True, generator=gen))
    assert [int(x) for x in outs[0][:4]] == [int(x) for x in outs[1][:4]]
    assert int(outs[0][1]) >= TLC.MIN_SIM3_INLIERS
    assert float(outs[0][4][0]) == 1.0
    assert TR.N_HYP == 192 and TLC.N_HYP_SIM3 == 128
