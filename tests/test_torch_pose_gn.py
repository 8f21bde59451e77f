"""Pose-only Gauss-Newton of the PyTorch port against the JAX reference on
identical synthetic observations (numpy, seeded), mono and stereo rows,
with outliers.

Tolerances: Tcw within 1e-4 (float32 sums taken in another order, and
XLA's fused multiply-adds, over 16-40 GN steps); inlier masks exact.
solve6 within a relative 1e-5 of the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.geometry import se3 as JSE3
from splslam_tpu.geometry.camera import Camera as JCam
from splslam_tpu.optim import pose_gn as JG
from splslam_tpu_torch.geometry import se3 as TSE3
from splslam_tpu_torch.geometry.camera import Camera as TCam
from splslam_tpu_torch.optim import pose_gn as TG

CAM_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0,
                width=640, height=480)
JCAM, TCAM = JCam.create(**CAM_ARGS), TCam.create(**CAM_ARGS)


def make_obs(seed, n=160, n_out=30, stereo_frac=0.6):
    r = np.random.default_rng(seed)
    X = np.stack([r.uniform(-3, 3, n), r.uniform(-2, 2, n),
                  r.uniform(4, 12, n)], 1).astype(np.float32)
    xi = r.normal(0, 0.08, 6).astype(np.float32)
    T = np.asarray(JSE3.se3_exp(jnp.asarray(xi)))
    pc = X @ T[:3, :3].T + T[:3, 3]
    u = 500.0 * pc[:, 0] / pc[:, 2] + 320.0
    v = 500.0 * pc[:, 1] / pc[:, 2] + 240.0
    uv = np.stack([u, v], 1) + r.normal(0, 0.5, (n, 2))
    uv[:n_out] += r.uniform(25, 70, (n_out, 2))
    ur = u - 40.0 / pc[:, 2] + r.normal(0, 0.5, n)
    ur = np.where(r.random(n) < stereo_frac, ur, -1.0)
    inv_s2 = 1.0 / (1.2 ** r.integers(0, 4, n)) ** 2
    mask = r.random(n) > 0.1
    return dict(X=X, uv=uv.astype(np.float32), ur=ur.astype(np.float32),
                inv_s2=inv_s2.astype(np.float32), mask=mask, T=T)


def test_hat_and_se3_exp():
    r = np.random.default_rng(0)
    xi = np.concatenate([r.normal(0, 0.3, (5, 6)), np.zeros((1, 6)),
                         r.normal(0, 1e-5, (1, 6))]).astype(np.float32)
    np.testing.assert_allclose(TSE3.se3_exp(torch.from_numpy(xi)).numpy(),
                               np.asarray(JSE3.se3_exp(jnp.asarray(xi))),
                               atol=1e-6)
    T = np.array(JSE3.se3_exp(jnp.asarray(xi[0])))
    np.testing.assert_allclose(
        TSE3.se3_retract(torch.from_numpy(T), torch.from_numpy(xi[1])).numpy(),
        np.asarray(JSE3.se3_retract(jnp.asarray(T), jnp.asarray(xi[1]))),
        atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve6(seed):
    r = np.random.default_rng(seed)
    A = r.normal(size=(6, 6)).astype(np.float32)
    H = (A @ A.T + 0.1 * np.eye(6)).astype(np.float32)
    b = r.normal(size=6).astype(np.float32)
    ref = np.asarray(JG.solve6(jnp.asarray(H), jnp.asarray(b)))
    got = TG.solve6(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_solve6_singular_stays_finite():
    H = np.zeros((6, 6), np.float32)
    H[0, 0] = 1.0
    got = TG.solve6(torch.from_numpy(H), torch.ones(6)).numpy()
    ref = np.asarray(JG.solve6(jnp.asarray(H), jnp.ones(6)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("seed,stereo", [(3, True), (4, True), (5, False)])
def test_pose_optimize_matches_jax(seed, stereo):
    o = make_obs(seed)
    ur = o["ur"] if stereo else None
    j_pts = JG.PointObs(jnp.asarray(o["X"]), jnp.asarray(o["uv"]),
                        jnp.asarray(o["inv_s2"]), jnp.asarray(o["mask"]),
                        None if ur is None else jnp.asarray(ur))
    t_pts = TG.PointObs(torch.from_numpy(o["X"]), torch.from_numpy(o["uv"]),
                        torch.from_numpy(o["inv_s2"]), torch.from_numpy(o["mask"]),
                        None if ur is None else torch.from_numpy(ur))
    for kw in (dict(rounds=2, iters=4), dict(rounds=4, iters=6), {}):
        jr = JG.pose_optimize(jnp.eye(4), JCAM, j_pts, JG.LineObs.empty(1), **kw)
        tr = TG.pose_optimize(torch.eye(4), TCAM, t_pts,
                              TG.LineObs.empty(1, "cpu"), **kw)
        np.testing.assert_allclose(tr.Tcw.numpy(), np.asarray(jr.Tcw), atol=1e-4)
        np.testing.assert_array_equal(tr.inlier_pt.numpy(), np.asarray(jr.inlier_pt))
        assert int(tr.n_inlier_pt) == int(jr.n_inlier_pt)
        np.testing.assert_allclose(float(tr.unit_error), float(jr.unit_error),
                                   rtol=1e-3)
    # the solve recovers the true pose and rejects the outliers
    assert np.abs(tr.Tcw.numpy() - o["T"]).max() < 5e-3
    assert not tr.inlier_pt.numpy()[:30].any()


def test_pose_optimize_empty_and_line_tables():
    pts = TG.PointObs(torch.zeros((8, 3)), torch.zeros((8, 2)), torch.ones(8),
                      torch.zeros(8, dtype=torch.bool))
    res = TG.pose_optimize(torch.eye(4), TCAM, pts)
    torch.testing.assert_close(res.Tcw, torch.eye(4))
    with pytest.raises(NotImplementedError):
        TG.pose_optimize(torch.eye(4), TCAM, pts, TG.LineObs.empty(4, "cpu"))
