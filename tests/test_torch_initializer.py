"""The two-view initializer of the PyTorch port
(`splslam_tpu_torch/slam/initializer.py`) against the JAX reference on
tests/test_initializer.py's four scenes (general F, planar H, too few
matches, pure rotation), with the reference's own RANSAC draws passed in
(its Gumbel top-k from PRNGKey(0), recomputed here); and the 3x3 SVD and
triangulation it is built from.

Gates: `ok`, `used_h` and the `good` mask exact; R21 within 1e-4 and t21
within 5e-4 (the reference's SVD and eigh are float32 LAPACK, the port's
null vectors and 3x3 SVDs float64 inverse iteration and Jacobi; measured
1e-5 and 1.2e-4); parallax within 1e-3 deg; and tests/test_initializer.py's
own gates on the port (rotation within 0.5 deg, translation direction
cosine > 0.995)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.slam.initializer import two_view_init as j_two_view_init
from splslam_tpu_torch.ops.linalg import svd3
from splslam_tpu_torch.slam import initializer as TI
from test_initializer import _make_corrs


def jax_samples(mask: np.ndarray, n_hyp: int = 256) -> np.ndarray:
    """The reference's hypotheses (initializer.py:294-296)."""
    m = jnp.asarray(mask)
    g = jax.random.gumbel(jax.random.PRNGKey(0), (n_hyp, m.shape[0])) \
        + jnp.where(m, 0.0, -1e9)[None]
    return np.asarray(jax.lax.top_k(g, 8)[1]).astype(np.int64)


def _pure_rotation():
    rng = np.random.default_rng(1)
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)
    X = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                  rng.uniform(3, 8, 200)], axis=-1)
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])

    def proj(P, Rc):
        pc = P @ Rc.T
        return (pc[:, :2] / pc[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    return (K, R, np.zeros(3), proj(X, np.eye(3)).astype(np.float32),
            proj(X, R).astype(np.float32), np.ones(200, bool))


SCENES = {
    "fundamental": lambda: _make_corrs(planar=False),
    "homography": lambda: _make_corrs(planar=True),
    "too_few": lambda: _make_corrs(n=20, n_pad=236),
    "pure_rotation": _pure_rotation,
}
EXPECT = {"fundamental": (True, False), "homography": (True, True),
          "too_few": (False, None), "pure_rotation": (False, None)}


@pytest.mark.parametrize("scene", list(SCENES))
def test_two_view_init_matches_jax(scene):
    K, R_gt, t_gt, xy1, xy2, mask = SCENES[scene]()
    j = jax.device_get(j_two_view_init(jax.random.PRNGKey(0), jnp.asarray(xy1),
                                       jnp.asarray(xy2), jnp.asarray(mask),
                                       jnp.asarray(K)))
    t = lambda a: torch.from_numpy(np.array(a))
    r = TI.two_view_init(t(jax_samples(mask)), t(xy1), t(xy2), t(mask), t(K))
    assert bool(r.ok) == bool(j.ok) == EXPECT[scene][0]
    assert bool(r.used_h) == bool(j.used_h)
    if EXPECT[scene][1] is not None:
        assert bool(r.used_h) == EXPECT[scene][1]
    np.testing.assert_array_equal(r.good.numpy(), np.asarray(j.good))
    assert int(r.n_good) == int(j.n_good)
    np.testing.assert_allclose(float(r.parallax), float(j.parallax), atol=1e-3)
    if not bool(j.ok):
        return
    np.testing.assert_allclose(r.R21.numpy(), np.asarray(j.R21), atol=1e-4)
    np.testing.assert_allclose(r.t21.numpy(), np.asarray(j.t21), atol=5e-4)
    g = np.asarray(j.good)
    np.testing.assert_allclose(r.xyz.numpy()[g], np.asarray(j.xyz)[g], rtol=2e-3, atol=2e-3)
    # tests/test_initializer.py's gates
    R, tt = r.R21.numpy(), r.t21.numpy()
    ang = np.degrees(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1)))
    assert ang < 0.5
    assert abs(tt @ t_gt / (np.linalg.norm(tt) * np.linalg.norm(t_gt))) > 0.995


def test_port_draws_initialize():
    """With the port's own draws (a torch.Generator seeded 0) the general
    scene initializes to the same model and pose as the reference."""
    from splslam_tpu_torch.slam.mono import draw_init_samples

    K, R_gt, t_gt, xy1, xy2, mask = _make_corrs(planar=False)
    t = lambda a: torch.from_numpy(np.array(a))
    s = draw_init_samples(t(mask))
    assert s.shape == (256, 8) and bool(t(mask)[s].all())
    assert all(len(set(row.tolist())) == 8 for row in s)
    r = TI.two_view_init(s, t(xy1), t(xy2), t(mask), t(K))
    assert bool(r.ok) and not bool(r.used_h)
    R = r.R21.numpy()
    assert np.degrees(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1))) < 0.5


@pytest.mark.parametrize("rank", [3, 2])
def test_svd3_reconstructs(rank):
    """M = U diag(s) V^T with orthogonal U, V, descending s, for random
    and rank-2 (essential-like, two equal singular values) matrices."""
    r = np.random.default_rng(rank)
    M = r.normal(size=(64, 3, 3))
    if rank == 2:
        U0, _, V0 = np.linalg.svd(M)
        M = U0 @ np.diag([1.0, 1.0, 0.0]) @ V0
    U, s, V = svd3(torch.from_numpy(M))
    U, s, V = U.numpy(), s.numpy(), V.numpy()
    np.testing.assert_allclose(U * s[:, None, :] @ np.swapaxes(V, 1, 2), M, atol=1e-7)
    eye = np.broadcast_to(np.eye(3), M.shape)
    np.testing.assert_allclose(np.swapaxes(U, 1, 2) @ U, eye, atol=1e-7)
    np.testing.assert_allclose(np.swapaxes(V, 1, 2) @ V, eye, atol=1e-7)
    assert (np.diff(s, axis=1) <= 1e-12).all()
    np.testing.assert_allclose(s, np.linalg.svd(M, compute_uv=False), atol=1e-7)


def test_dlt_points_triangulates():
    r = np.random.default_rng(4)
    X = np.stack([r.uniform(-2, 2, 50), r.uniform(-1, 1, 50), r.uniform(3, 8, 50)], 1)
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    Rt = np.concatenate([np.eye(3), [[-0.3], [0.0], [0.05]]], 1)
    P1, P2 = K @ np.eye(3, 4), K @ Rt
    h = lambda P: (X @ P[:, :3].T + P[:, 3])[:, :2] / (X @ P[:, :3].T + P[:, 3])[:, 2:]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    got = TI.dlt_points(t(P1), t(P2), t(h(P1)), t(h(P2))).numpy()
    np.testing.assert_allclose(got, X, atol=2e-3)
