"""The port's `geometry/triangulate.py` against the JAX package's, on
tests/test_geometry.py's two-view setup (fx 500 at 640x480, a 0.5 m
baseline with a small rotation), the same numpy inputs to both:

- `projection_matrix` within 1e-5;
- `triangulate_dlt` of 100 points 4-12 m ahead: within 5e-2 of the JAX
  package's result and of the truth (tests/test_geometry.py's gate: the
  reference solves a float32 SVD), and the port's own within 1e-3 of the
  truth (its nullspace is a float64 Jacobi eigen-decomposition);
- `triangulation_checks` exactly equal to the JAX mask, on points in
  front, behind, with noisy observations under and over the chi2
  threshold, and at too little parallax;
- `triangulate_lines` within 0.1 of the truth (tests/test_geometry.py)
  and 5e-2 of the JAX package;
- and a degenerate row (the two views' rays parallel, A of rank < 4)
  finite on both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.geometry import triangulate as JT
from splslam_tpu_torch.geometry import triangulate as TT
from test_geometry import np_rodrigues

rng = np.random.default_rng(11)
K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], dtype=np.float32)
T1 = np.eye(4, dtype=np.float32)
T2 = np.eye(4, dtype=np.float32)
T2[:3, 3] = [-0.5, 0.02, 0.01]
T2[:3, :3] = np_rodrigues(np.array([0.01, -0.03, 0.005]))
JAX_GATE = 5e-2      # tests/test_geometry.py


def proj(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = pc @ K.T
    return (uv[:, :2] / uv[:, 2:3]).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def both_P():
    jp = [np.asarray(JT.projection_matrix(jnp.asarray(K), jnp.asarray(T)))
          for T in (T1, T2)]
    tp = [TT.projection_matrix(t(K), t(T)) for T in (T1, T2)]
    return jp, tp


def test_projection_matrix_matches_jax():
    jp, tp = both_P()
    for a, b in zip(tp, jp):
        assert a.shape == (3, 4)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


def test_points_match_jax_and_truth():
    X = rng.uniform(-3, 3, size=(100, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(4, 12, size=100)
    uv1, uv2 = proj(T1, X), proj(T2, X)
    (jP1, jP2), (tP1, tP2) = both_P()
    jx = np.asarray(JT.triangulate_dlt(jnp.asarray(jP1), jnp.asarray(jP2),
                                       jnp.asarray(uv1), jnp.asarray(uv2)))
    tx = TT.triangulate_dlt(tP1, tP2, t(uv1), t(uv2))
    assert tx.shape == (100, 3) and tx.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), jx, atol=JAX_GATE)
    np.testing.assert_allclose(tx.numpy(), X, atol=JAX_GATE)
    np.testing.assert_allclose(tx.numpy(), X, atol=1e-3)


@pytest.mark.parametrize("case", ["front", "behind", "noise", "parallax"])
def test_checks_match_jax(case):
    X = rng.uniform(-2, 2, size=(64, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(4, 10, size=64)
    uv1, uv2 = proj(T1, X), proj(T2, X)
    s1 = np.ones(64, np.float32)
    s2 = np.ones(64, np.float32)
    Tb = T2
    if case == "behind":
        X[::2, 2] *= -1.0
    elif case == "noise":
        # half the rows a few pixels off: some over the chi2 gate, at sigma
        # 1 and at the octave scales
        uv2[::2] += rng.normal(0, 3.0, size=(32, 2)).astype(np.float32)
        s2 = (1.2 ** (2 * rng.integers(0, 4, 64))).astype(np.float32)
    elif case == "parallax":
        Tb = T2.copy()
        Tb[:3, 3] = [-0.002, 0.0, 0.0]   # 2 mm baseline: rays almost parallel
        uv2 = proj(Tb, X)
    jm = np.asarray(JT.triangulation_checks(
        jnp.asarray(X), jnp.asarray(T1), jnp.asarray(Tb), jnp.asarray(uv1),
        jnp.asarray(uv2), jnp.asarray(K), jnp.asarray(s1), jnp.asarray(s2)))
    tm = TT.triangulation_checks(t(X), t(T1), t(Tb), t(uv1), t(uv2), t(K), t(s1), t(s2))
    assert tm.dtype == torch.bool
    np.testing.assert_array_equal(tm.numpy(), jm)
    want = {"front": 64, "behind": 32, "parallax": 0}
    if case in want:
        assert int(tm.sum()) == want[case]
    else:
        assert 0 < int(tm.sum()) < 64


def test_lines_match_jax_and_truth():
    S = rng.uniform(-2, 2, size=(20, 3)).astype(np.float32)
    S[:, 2] = rng.uniform(4, 8, size=20)
    E = S + rng.uniform(-1, 1, size=(20, 3)).astype(np.float32)
    seg1 = np.concatenate([proj(T1, S), proj(T1, E)], axis=1)
    seg2 = np.concatenate([proj(T2, S), proj(T2, E)], axis=1)
    (jP1, jP2), (tP1, tP2) = both_P()
    jo = np.asarray(JT.triangulate_lines(jnp.asarray(jP1), jnp.asarray(jP2),
                                         jnp.asarray(seg1), jnp.asarray(seg2)))
    to = TT.triangulate_lines(tP1, tP2, t(seg1), t(seg2)).numpy()
    assert to.shape == (20, 3, 3)
    np.testing.assert_allclose(to, jo, atol=JAX_GATE)
    np.testing.assert_allclose(to[:, 0], S, atol=0.1)
    np.testing.assert_allclose(to[:, 1], 0.5 * (S + E), atol=0.1)
    np.testing.assert_allclose(to[:, 2], E, atol=0.1)


def test_degenerate_row_is_finite():
    """The same pixel in two identical views: every ray parallel, the DLT
    matrix of rank 2; both packages return finite points."""
    (jP1, _), (tP1, _) = both_P()
    uv = np.array([[320.0, 240.0], [100.0, 50.0]], np.float32)
    tx = TT.triangulate_dlt(tP1, tP1, t(uv), t(uv))
    jx = np.asarray(JT.triangulate_dlt(jnp.asarray(jP1), jnp.asarray(jP1),
                                       jnp.asarray(uv), jnp.asarray(uv)))
    assert bool(torch.isfinite(tx).all()) and np.isfinite(jx).all()
