"""The port's Sim(3) group (`geometry/se3.py`) and Sim3 estimation
(`optim/sim3.py`) against the JAX package's on the same inputs.

Tolerances: the group maps within 1e-6; Horn within 1e-5; RANSAC and GN
with the JAX package's minimal sets injected (its Gumbel top-k draw,
recomputed here from the same key): the winner's (s, R, t) within 1e-4
and inlier counts equal; Jacobians of the residuals from
`torch.func.jacfwd` within 1e-4 of `jax.jacfwd` (and finite at xi = 0,
where every small-angle and small-scale branch of sim3_exp is taken).
The behaviours of tests/test_sim3.py's Horn, outlier and fixed-scale
tests hold for the port with its own draws. `pose_graph_sim3` on
tests/test_sim3.py's drifted 12-keyframe circle, with a weight-0 edge, a
second anchored slot and a loop measurement of scale 1.05: (s, R, t)
within 2e-6 of the JAX package's after 15 iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from splslam_tpu.geometry import se3 as JSE3
from splslam_tpu.optim import sim3 as JS3
from splslam_tpu_torch.geometry import se3 as TSE3
from splslam_tpu_torch.optim import sim3 as TS3
from splslam_tpu_torch.slam.reloc import sample_minimal_sets

K_NP = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)

# tangents covering each branch of sim3_exp: general, small angle, small
# scale, both small, and exactly zero
XIS = np.array([
    [0.1, -0.2, 0.3, 0.2, -0.1, 0.3, 0.15],
    [0.1, -0.2, 0.3, 1e-7, 0.0, 2e-7, 0.2],
    [0.1, -0.2, 0.3, 0.2, -0.1, 0.3, 3e-6],
    [0.1, -0.2, 0.3, 1e-7, 0.0, 0.0, 1e-6],
    [0.0] * 7,
], np.float32)


def _make_sim3_problem(n=80, outliers=10, s_gt=1.3, seed=0):
    """tests/test_sim3.py's problem, as numpy."""
    rng = np.random.default_rng(seed)
    ang = 0.3
    R_gt = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                     [0, 0, 1]], np.float32)
    t_gt = np.array([0.4, -0.2, 0.1], np.float32)
    X2 = rng.uniform([-1, -1, 3], [1, 1, 6], (n, 3)).astype(np.float32)
    X1 = s_gt * X2 @ R_gt.T + t_gt
    X1 += rng.normal(0, 0.005, X1.shape)
    bad = rng.choice(n, outliers, replace=False)
    X1[bad] += rng.uniform(0.5, 1.0, (outliers, 3))

    def proj(X):
        return (X[:, :2] / X[:, 2:]) * 400.0 + [320.0, 240.0]

    return (R_gt, t_gt, s_gt, X1.astype(np.float32), X2,
            proj(X1).astype(np.float32), proj(X2).astype(np.float32), bad)


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _jax_samples(key, mask, n_hyp, m):
    """The JAX package's draw (splslam_tpu/optim/sim3.py:90-92)."""
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    g = jax.random.gumbel(key, (n_hyp, mask.shape[0])) + logits[None]
    return torch.from_numpy(np.asarray(jax.lax.top_k(g, m)[1]))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("i", range(len(XIS)))
def test_sim3_exp_matches_jax(i):
    xi = XIS[i]
    for got, want in zip(TSE3.sim3_exp(torch.from_numpy(xi)),
                         JSE3.sim3_exp(jnp.asarray(xi))):
        _close(got, want, 1e-6)


def test_sim3_exp_batched_and_jacobian_at_zero():
    got = TSE3.sim3_exp(torch.from_numpy(XIS))
    for i in range(len(XIS)):
        for g, w in zip(got, JSE3.sim3_exp(jnp.asarray(XIS[i]))):
            _close(g[i], w, 1e-6)
    # forward-mode derivative at 0: every limit branch, no NaN
    zero = np.zeros(7, np.float32)
    jt = jacfwd(lambda x: torch.cat([v.reshape(-1) for v in TSE3.sim3_exp(x)]))(
        torch.from_numpy(zero))
    jj = jax.jacfwd(lambda x: jnp.concatenate(
        [v.reshape(-1) for v in JSE3.sim3_exp(x)]))(jnp.asarray(zero))
    assert torch.isfinite(jt).all() and jt.dtype == torch.float32
    _close(jt, jj, 1e-6)


def test_sim3_inverse_compose_apply_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    a = [np.asarray(v) for v in JSE3.sim3_exp(jnp.asarray(XIS[0]))]
    b = [np.asarray(v) for v in JSE3.sim3_exp(jnp.asarray(XIS[1] * 3))]
    ta, tb = _t(*a), _t(*b)
    for got, want in zip(TSE3.sim3_inverse(*ta), JSE3.sim3_inverse(*a)):
        _close(got, want, 1e-6)
    for got, want in zip(TSE3.sim3_compose(ta, tb), JSE3.sim3_compose(a, b)):
        _close(got, want, 1e-6)
    _close(TSE3.sim3_apply(*ta, torch.from_numpy(pts)),
           JSE3.sim3_apply(*[jnp.asarray(v) for v in a], jnp.asarray(pts)), 1e-6)
    # a o a^-1 is the identity
    s, R, t = TSE3.sim3_compose(ta, TSE3.sim3_inverse(*ta))
    _close(s, 1.0, 1e-6)
    _close(R, np.eye(3), 1e-6)
    _close(t, np.zeros(3), 1e-6)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_horn_matches_jax(fix_scale):
    _, _, _, X1, X2, *_ = _make_sim3_problem(outliers=0)
    w = np.random.default_rng(1).random(X1.shape[0]).astype(np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        want = JS3.sim3_horn(jnp.asarray(X1), jnp.asarray(X2), jw, fix_scale=fix_scale)
        got = TS3.sim3_horn(*_t(X1, X2), tw, fix_scale=fix_scale)
        for g, wv in zip(got, want):
            _close(g, wv, 1e-5)


def _inputs(**kw):
    R_gt, t_gt, s_gt, X1, X2, uv1, uv2, bad = _make_sim3_problem(**kw)
    n = X1.shape[0]
    ones = np.ones(n, np.float32)
    mask = np.ones(n, bool)
    return (R_gt, t_gt, s_gt, bad), (X1, X2, uv1, uv2, ones, ones, mask, K_NP)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim3_ransac_and_optimize_match_jax_with_injected_samples(seed):
    _, args = _inputs(seed=seed)
    key = jax.random.PRNGKey(seed)
    jargs = [jnp.asarray(a) for a in args]
    targs = _t(*args)
    (sj, Rj, tj), nj, inlj = JS3.sim3_ransac(key, *jargs)
    (st, Rt, tt), nt, inlt = TS3.sim3_ransac(
        *targs, samples=_jax_samples(key, args[6], 128, 3))
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(inlt.numpy(), np.asarray(inlj))
    for g, w in ((st, sj), (Rt, Rj), (tt, tj)):
        _close(g, w, 1e-4)
    (sj2, Rj2, tj2), nj2, inlj2, gj = JS3.optimize_sim3(sj, Rj, tj, *jargs[:6],
                                                        inlj, jargs[7])
    (st2, Rt2, tt2), nt2, inlt2, gt = TS3.optimize_sim3(
        *_t(sj, Rj, tj), *targs[:6], torch.from_numpy(np.asarray(inlj)), targs[7])
    assert int(nt2) == int(nj2) and int(gt) == int(gj) == 0
    np.testing.assert_array_equal(inlt2.numpy(), np.asarray(inlj2))
    for g, w in ((st2, sj2), (Rt2, Rj2), (tt2, tj2)):
        _close(g, w, 1e-4)


def test_optimize_sim3_fix_scale_matches_jax():
    _, args = _inputs(s_gt=1.0, outliers=0)
    jargs = [jnp.asarray(a) for a in args]
    s0, R0, t0 = JS3.sim3_horn(jargs[0], jargs[1], fix_scale=True)
    R0 = R0 @ JSE3.so3_exp(jnp.asarray([0.01, -0.02, 0.01]))   # start off
    (sj, Rj, tj), nj, _, _ = JS3.optimize_sim3(s0, R0, t0, *jargs[:7], jargs[7],
                                               fix_scale=True)
    (st, Rt, tt), nt, _, _ = TS3.optimize_sim3(*_t(s0, R0, t0), *_t(*args),
                                               fix_scale=True)
    assert int(nt) == int(nj) and abs(float(st) - 1.0) < 1e-6
    for g, w in ((st, sj), (Rt, Rj), (tt, tj)):
        _close(g, w, 1e-4)


def _jax_residuals(xi, s, R, t, X1, X2, uv1, uv2, is1, is2, K):
    """The residuals of splslam_tpu/optim/sim3.py:140-154."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ds, dR, dt = JSE3.sim3_exp(xi)
    s_n, R_n, t_n = s * ds, dR @ R, ds * (dR @ t) + dt
    p1 = s_n * (X2 @ R_n.T) + t_n
    r1 = (JS3._project(fx, fy, cx, cy, p1) - uv1) * jnp.sqrt(is1)[:, None]
    si, Ri, ti = JSE3.sim3_inverse(s_n, R_n, t_n)
    p2 = si * (X1 @ Ri.T) + ti
    r2 = (JS3._project(fx, fy, cx, cy, p2) - uv2) * jnp.sqrt(is2)[:, None]
    return jnp.concatenate([r1, r2], axis=0)


@pytest.mark.parametrize("at", ["zero", "off_zero"])
def test_residual_jacobians_match_jax(at):
    _, (X1, X2, uv1, uv2, is1, is2, _, K) = _inputs(seed=4)
    s, R, t = (np.asarray(v) for v in JSE3.sim3_exp(jnp.asarray(XIS[0])))
    xi = np.zeros(7, np.float32) if at == "zero" else XIS[2] * 0.1
    data = (X1, X2, uv1, uv2, is1, is2, K)
    jj = jax.jacfwd(lambda x: _jax_residuals(
        x, *[jnp.asarray(v) for v in (s, R, t, *data)]))(jnp.asarray(xi))
    ts, tR, tt, tX1, tX2, tuv1, tuv2, tis1, tis2, tK = _t(s, R, t, *data)
    jt = jacfwd(lambda x: TS3.sim3_residuals(
        x, ts, tR, tt, tX1, tX2, tuv1, tuv2, torch.sqrt(tis1)[:, None],
        torch.sqrt(tis2)[:, None], tK))(torch.from_numpy(xi))
    assert jt.shape == (2 * X1.shape[0], 2, 7) and jt.dtype == torch.float32
    assert torch.isfinite(jt).all()
    _close(jt, jj, 1e-4)


def test_sim3_horn_exact():
    R_gt, t_gt, s_gt, X1, X2, *_ = _make_sim3_problem(outliers=0)
    s, R, t = TS3.sim3_horn(*_t(X1, X2))
    assert abs(float(s) - s_gt) < 0.01
    assert np.linalg.norm(R.numpy() - R_gt) < 0.02
    assert np.linalg.norm(t.numpy() - t_gt) < 0.02


def test_sim3_ransac_rejects_outliers():
    (R_gt, _, s_gt, bad), args = _inputs()
    targs = _t(*args)
    gen = torch.Generator().manual_seed(0)
    samples = sample_minimal_sets(gen, targs[6], 128, 3)
    (s, R, t), n_in, inl = TS3.sim3_ransac(*targs, samples=samples)
    n = args[0].shape[0]
    assert int(n_in) >= n - len(bad) - 5
    assert inl.numpy()[bad].mean() < 0.2
    assert abs(float(s) - s_gt) < 0.02
    (s2, R2, _), _, _, n_grd = TS3.optimize_sim3(s, R, t, *targs[:6], inl, targs[7])
    assert int(n_grd) == 0
    assert abs(float(s2) - s_gt) < 0.01
    assert np.linalg.norm(R2.numpy() - R_gt) < 0.01


def test_sim3_fix_scale():
    _, _, _, X1, X2, *_ = _make_sim3_problem(s_gt=1.0, outliers=0)
    s, _, _ = TS3.sim3_horn(*_t(X1, X2), fix_scale=True)
    assert float(s) == 1.0


@pytest.fixture
def one_thread():
    """Many small ops: beside other test processes torch's OpenMP threads
    spin at every barrier while the cores are taken; one thread has none."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drifted_circle(Kn=12):
    """tests/test_sim3.py:84-120: poses on a circle, noisy odometry, the
    chain's measured edges and a loop edge with the true relative pose."""
    gt = []
    for k in range(Kn):
        a = 2 * np.pi * k / Kn
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        Twc[:3, 3] = [np.sin(a), 0.0, 1.0 - np.cos(a)]
        gt.append(np.linalg.inv(Twc))
    gt = np.array(gt, np.float32)
    rng = np.random.default_rng(0)
    est = [gt[0]]
    for k in range(1, Kn):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        xi = rng.normal(0, 0.01, 6).astype(np.float32)
        est.append(np.asarray(JSE3.se3_exp(jnp.asarray(xi))) @ rel @ est[-1])
    est = np.array(est, np.float32)
    ei, ej, Rs, ts = [], [], [], []
    for k in range(1, Kn):
        rel = est[k] @ np.linalg.inv(est[k - 1])
        ei.append(k), ej.append(k - 1), Rs.append(rel[:3, :3]), ts.append(rel[:3, 3])
    loop = gt[-1] @ np.linalg.inv(gt[0])
    ei.append(Kn - 1), ej.append(0), Rs.append(loop[:3, :3]), ts.append(loop[:3, 3])
    return gt, est, ei, ej, Rs, ts


@pytest.mark.parametrize("fix_scale", [False, True])
def test_pose_graph_sim3_matches_jax(fix_scale, one_thread):
    gt, est, ei, ej, Rs, ts = _drifted_circle()
    Kn = gt.shape[0]
    E = len(ei)
    ss, w = [1.0] * E, [1.0] * E
    ss[-1] = 1.05                       # the loop measures a scale
    # a masked edge that would otherwise pull keyframe 5 onto keyframe 2
    ei.append(5), ej.append(2), Rs.append(np.eye(3)), ts.append(np.zeros(3))
    ss.append(1.0), w.append(0.0)
    free = np.array([False] + [True] * (Kn - 1))
    free[7] = False                     # a second anchored slot
    e_np = JS3.PoseGraphEdges(
        i=np.asarray(ei, np.int32), j=np.asarray(ej, np.int32),
        s=np.asarray(ss, np.float32), R=np.asarray(Rs, np.float32),
        t=np.asarray(ts, np.float32), weight=np.asarray(w, np.float32))
    R0, t0 = est[:, :3, :3].copy(), est[:, :3, 3].copy()
    s, R, t, ng = JS3.pose_graph_sim3(
        jnp.ones((Kn,)), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(free),
        jax.tree.map(jnp.asarray, e_np), iters=15, fix_scale=fix_scale)
    from splslam_tpu_torch import convert
    ts_, tR, tt, tng = TS3.pose_graph_sim3(
        torch.ones(Kn), *_t(R0, t0, free),
        convert.pose_graph_edges_from_numpy(e_np, "cpu"), iters=15,
        fix_scale=fix_scale)
    assert int(tng) == int(ng) == 0
    assert ts_.dtype == tR.dtype == tt.dtype == torch.float32
    # measured: s 1.2e-7, R 1.2e-7, t 2.4e-7
    _close(ts_, s, 2e-6), _close(tR, R, 2e-6), _close(tt, t, 2e-6)
    # anchors do not move; the drift at the loop's end falls
    for k in (0, 7):
        np.testing.assert_array_equal(tt[k].numpy(), t0[k])
        np.testing.assert_array_equal(tR[k].numpy(), R0[k])
    drift0 = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    drift1 = np.linalg.norm(tt[-1].numpy() - gt[-1][:3, 3])
    assert drift1 < 0.6 * drift0, (drift0, drift1)
    if fix_scale:
        assert torch.equal(ts_, torch.ones(Kn))
    else:
        assert float(ts_[-1]) > 1.01     # the measured scale spreads in


def test_pose_graph_sim3_counts_a_guarded_solve(one_thread):
    """A non-finite measurement makes every solve non-finite: each
    iteration is counted and the poses come back unchanged."""
    gt, est, ei, ej, Rs, ts = _drifted_circle()
    Kn = gt.shape[0]
    E = len(ei)
    Rs = np.asarray(Rs, np.float32)
    Rs[3] = np.nan
    e_np = JS3.PoseGraphEdges(
        i=np.asarray(ei, np.int32), j=np.asarray(ej, np.int32),
        s=np.ones(E, np.float32), R=Rs, t=np.asarray(ts, np.float32),
        weight=np.ones(E, np.float32))
    free = np.array([False] + [True] * (Kn - 1))
    R0, t0 = est[:, :3, :3].copy(), est[:, :3, 3].copy()
    *_, ng = JS3.pose_graph_sim3(
        jnp.ones((Kn,)), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(free),
        jax.tree.map(jnp.asarray, e_np), iters=3)
    from splslam_tpu_torch import convert
    s, R, t, tng = TS3.pose_graph_sim3(
        torch.ones(Kn), *_t(R0, t0, free),
        convert.pose_graph_edges_from_numpy(e_np, "cpu"), iters=3)
    assert int(tng) == int(ng) == 3
    np.testing.assert_array_equal(t.numpy(), t0)
    np.testing.assert_array_equal(R.numpy(), R0)
