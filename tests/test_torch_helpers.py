"""The port's public helpers against their JAX twins on the same numpy
inputs, with the cases of the JAX package's own tests
(tests/test_geometry.py, tests/test_ops.py): `geometry/se3.py`'s
`so3_log`, `se3_log`, `se3_inverse` and `transform_points`;
`geometry/camera.py`'s `project`, `backproject`, `project_world`,
`in_image`, `Camera.K` and `Camera.has_distortion`; `ops/stereo.py`'s
`bilinear_sample` and `masked_median`; `optim/pose_gn.py`'s
`PointObs.empty`.

Each case holds the port to the JAX test's own gate and to the JAX
function's output: float32 results within 1e-5 (1e-4 where the JAX test
gates a round trip at 1e-3 or looser, since the log map's arccos and the
3x3 solve round differently), masks, shapes and dtypes exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.geometry import camera as JC
from splslam_tpu.geometry import se3 as JSE3
from splslam_tpu.ops import stereo as JST
from splslam_tpu.optim import pose_gn as JPG
from splslam_tpu_torch.geometry import camera as TC
from splslam_tpu_torch.geometry import se3 as TSE3
from splslam_tpu_torch.ops import stereo as TST
from splslam_tpu_torch.optim import pose_gn as TPG

ATOL = 1e-5
LOG_ATOL = 1e-4
CAM_KW = dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7, k1=0.2624, k2=-0.9531,
              p1=-0.0054, p2=0.0026, k3=1.1633, bf=40.0, width=640, height=480)


def _both(jfn, tfn, *args):
    """(JAX output, port output) as numpy, from the same numpy inputs."""
    j = jfn(*(jnp.asarray(a) for a in args))
    t = tfn(*(torch.from_numpy(np.array(a)) for a in args))
    to_np = lambda x: np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
    if isinstance(j, tuple):
        return tuple(map(to_np, j)), tuple(map(to_np, t))
    return to_np(j), to_np(t)


def _phis(rng, n):
    phis = rng.normal(size=(n, 3)).astype(np.float32)
    phis *= (rng.uniform(0.01, 3.0, size=(n, 1))
             / np.linalg.norm(phis, axis=1, keepdims=True)).astype(np.float32)
    return phis


def test_so3_log_roundtrip_matches_jax():
    """tests/test_geometry.py TestSO3.test_exp_log_roundtrip."""
    phis = _phis(np.random.default_rng(0), 50)
    R = np.asarray(JSE3.so3_exp(jnp.asarray(phis)))
    j, t = _both(JSE3.so3_log, TSE3.so3_log, R)
    np.testing.assert_allclose(t, phis, atol=2e-4)
    np.testing.assert_allclose(t, j, atol=LOG_ATOL)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_so3_log_near_pi_matches_jax(axis):
    """TestSO3.test_log_near_pi, about each axis: the diagonal branch."""
    phi = np.zeros(3, np.float32)
    phi[axis] = np.pi - 1e-4
    R = np.asarray(JSE3.so3_exp(jnp.asarray(phi)))
    j, t = _both(JSE3.so3_log, TSE3.so3_log, R)
    np.testing.assert_allclose(np.abs(t), np.abs(phi), atol=1e-2)
    np.testing.assert_allclose(t, j, atol=LOG_ATOL)


def test_so3_log_identity_matches_jax():
    j, t = _both(JSE3.so3_log, TSE3.so3_log, np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(t, 0.0, atol=1e-7)


def test_se3_log_roundtrip_matches_jax():
    """TestSE3.test_exp_log_roundtrip."""
    xi = np.random.default_rng(1).normal(size=(30, 6)).astype(np.float32) * 0.8
    T = np.asarray(JSE3.se3_exp(jnp.asarray(xi)))
    j, t = _both(JSE3.se3_log, TSE3.se3_log, T)
    np.testing.assert_allclose(t, xi, atol=1e-3)
    np.testing.assert_allclose(t, j, atol=LOG_ATOL)


def test_se3_inverse_matches_jax():
    """TestSE3.test_inverse."""
    xi = np.random.default_rng(2).normal(size=(10, 6)).astype(np.float32)
    T = np.asarray(JSE3.se3_exp(jnp.asarray(xi)))
    j, t = _both(JSE3.se3_inverse, TSE3.se3_inverse, T)
    np.testing.assert_allclose(T @ t, np.broadcast_to(np.eye(4), (10, 4, 4)), atol=1e-5)
    np.testing.assert_allclose(t, j, atol=ATOL)
    # one pose, unbatched
    j1, t1 = _both(JSE3.se3_inverse, TSE3.se3_inverse, T[0])
    np.testing.assert_allclose(t1, j1, atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_transform_points_matches_jax(batched):
    """TestSE3.test_transform_points, one pose and a batch of poses."""
    rng = np.random.default_rng(3)
    n_pose = 4 if batched else 1
    T = np.asarray(JSE3.se3_exp(jnp.asarray(
        rng.normal(size=(n_pose, 6)).astype(np.float32))))
    pts = rng.normal(size=(n_pose, 17, 3)).astype(np.float32)
    if not batched:
        T, pts = T[0], pts[0]
    j, t = _both(JSE3.transform_points, TSE3.transform_points, T, pts)
    expect = np.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]
    np.testing.assert_allclose(t, expect, atol=1e-5)
    np.testing.assert_allclose(t, j, atol=ATOL)
    assert t.shape == pts.shape


def test_project_backproject_match_jax():
    """TestCamera.test_project_backproject, and `project`'s guard on a
    depth within 1e-6 of 0."""
    rng = np.random.default_rng(4)
    jcam, tcam = JC.Camera.create(**CAM_KW), TC.Camera.create(**CAM_KW)
    pts = rng.uniform(-2, 2, size=(40, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 1.0
    pts[0, 2] = 1e-7
    (juv, jz), (tuv, tz) = _both(lambda p: JC.project(jcam, p),
                                 lambda p: TC.project(tcam, p), pts)
    np.testing.assert_allclose(tuv, juv, rtol=1e-6, atol=ATOL)
    np.testing.assert_array_equal(tz, jz)
    j, t = _both(lambda uv, z: JC.backproject(jcam, uv, z),
                 lambda uv, z: TC.backproject(tcam, uv, z), tuv[1:], tz[1:])
    np.testing.assert_allclose(t, pts[1:], atol=1e-4)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=ATOL)


def test_project_world_matches_jax():
    rng = np.random.default_rng(5)
    jcam, tcam = JC.Camera.create(**CAM_KW), TC.Camera.create(**CAM_KW)
    T = np.asarray(JSE3.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.3)))
    pts = rng.uniform([-2, -2, 3], [2, 2, 8], size=(25, 3)).astype(np.float32)
    (juv, jz), (tuv, tz) = _both(lambda T, p: JC.project_world(jcam, T, p),
                                 lambda T, p: TC.project_world(tcam, T, p), T, pts)
    np.testing.assert_allclose(tuv, juv, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tz, jz, rtol=1e-6, atol=ATOL)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    np.testing.assert_allclose(tz, pc[:, 2], atol=1e-5)


@pytest.mark.parametrize("border", [0.0, 2.5])
def test_in_image_matches_jax(border):
    """TestCamera.test_in_image, and a border."""
    jcam, tcam = JC.Camera.create(**CAM_KW), TC.Camera.create(**CAM_KW)
    uv = np.array([[0, 0], [639.5, 479.5], [-1, 5], [320, 480], [2.5, 2.5],
                   [637.4, 10.0], [637.5, 10.0]], np.float32)
    j, t = _both(lambda uv: JC.in_image(jcam, uv, border),
                 lambda uv: TC.in_image(tcam, uv, border), uv)
    assert t.dtype == np.bool_
    np.testing.assert_array_equal(t, j)
    if border == 0.0:
        assert list(t[:4]) == [True, True, False, False]


def test_camera_K_and_has_distortion_match_jax():
    jcam, tcam = JC.Camera.create(**CAM_KW), TC.Camera.create(**CAM_KW)
    assert tcam.K.dtype == torch.float32
    np.testing.assert_array_equal(tcam.K.numpy(), np.asarray(jcam.K))
    assert tcam.has_distortion is jcam.has_distortion is True


def test_bilinear_sample_matches_jax():
    """tests/test_ops.py test_bilinear_sample (3.5 at (1.5, 0.5)), then a
    seeded image at fractional, border and out-of-range coordinates."""
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    j, t = _both(JST.bilinear_sample, TST.bilinear_sample, img,
                 np.array([1.5, 0.5], np.float32))
    assert t.shape == () and abs(float(t) - 3.5) < 1e-5
    np.testing.assert_allclose(t, j, atol=ATOL)
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (24, 32)).astype(np.float32)
    xy = np.concatenate([
        rng.uniform(-3, 35, (5, 7, 2)).reshape(-1, 2),
        np.array([[0, 0], [31, 23], [30.999, 22.999], [-1, 40]], np.float32),
    ]).astype(np.float32).reshape(-1, 1, 2)
    j, t = _both(JST.bilinear_sample, TST.bilinear_sample, img, xy)
    assert t.shape == xy.shape[:-1]
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("case", ["test_ops", "even", "empty", "all"])
def test_masked_median_matches_jax(case):
    """tests/test_ops.py test_masked_median (3.0), an even count (the
    upper median), no masked-in value (the fill) and every value."""
    rng = np.random.default_rng(7)
    vals, mask = {
        "test_ops": (np.array([5.0, 1.0, 3.0, 100.0], np.float32),
                     np.array([True, True, True, False])),
        "even": (rng.normal(size=10).astype(np.float32), np.arange(10) % 3 != 0),
        "empty": (rng.normal(size=6).astype(np.float32), np.zeros(6, bool)),
        "all": (rng.normal(size=9).astype(np.float32), np.ones(9, bool)),
    }[case]
    j, t = _both(JST.masked_median, TST.masked_median, vals, mask)
    np.testing.assert_array_equal(t, j)
    if case == "test_ops":
        assert float(t) == 3.0


def test_point_obs_empty_matches_jax():
    j = JPG.PointObs.empty(7)
    t = TPG.PointObs.empty(7, "cpu")
    assert t.ur is None and j.ur is None
    for name in ("xyz_w", "uv", "inv_sigma2", "mask"):
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
