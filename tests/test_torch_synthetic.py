"""The port's synthetic sequences (`splslam_tpu_torch/io/synthetic.py`, a
copy kept so the port imports nothing of the JAX package) equal the JAX
package's `splslam_tpu/io/synthetic.py` array for array. Both are numpy
and scipy only; equality is exact."""

import numpy as np
import pytest

from splslam_tpu.io import synthetic as JS
from splslam_tpu_torch.io import synthetic as TS


def assert_sequences_equal(a, b):
    (Ka, bfa, fa, ga), (Kb, bfb, fb, gb) = a, b
    np.testing.assert_array_equal(Ka, Kb)
    assert bfa == bfb
    np.testing.assert_array_equal(ga, gb)
    assert len(fa) == len(fb)
    for (la, ra), (lb, rb) in zip(fa, fb):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(ra, rb)


@pytest.mark.parametrize("motion", ["forward", "lateral"])
@pytest.mark.parametrize("seed", [0, 3])
def test_stereo_sequence_equals_jax_package(motion, seed):
    kw = dict(n_frames=3, width=96, height=64, motion=motion, seed=seed)
    assert_sequences_equal(JS.make_stereo_sequence(**kw),
                           TS.make_stereo_sequence(**kw))


def test_rgbd_sequence_equals_jax_package():
    kw = dict(n_frames=3, width=96, height=64, depth_dropout=0.1,
              depth_noise=0.01)
    assert_sequences_equal(JS.make_rgbd_sequence(**kw),
                           TS.make_rgbd_sequence(**kw))


def test_textures_and_corridor_equal_jax_package():
    np.testing.assert_array_equal(JS.make_grid_texture(512, seed=2),
                                  TS.make_grid_texture(512, seed=2))
    kw = dict(n_frames=2, width=96, height=64, scene="corridor",
              texture="grid", motion="arc")
    assert_sequences_equal(JS.make_stereo_sequence(**kw),
                           TS.make_stereo_sequence(**kw))


def test_path_length_and_ate_equal_jax_package():
    _, _, _, gt = TS.make_stereo_sequence(n_frames=12, width=2, height=2,
                                          motion="tour")
    rng = np.random.default_rng(5)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (len(gt), 3))
    assert TS.path_length(gt) == JS.path_length(gt) > 0
    for align in (True, False):
        for scale in (False, True):
            assert (TS.ate_rmse(est, gt, align, scale)
                    == JS.ate_rmse(est, gt, align, scale))


def test_loop_circuit_equals_the_jax_tests_scene():
    """`make_loop_circuit` is tests/test_loop.py's `_circuit`."""
    from tests.test_loop import _circuit

    kw = dict(n_long=4, n_short=2)
    assert_sequences_equal(_circuit(**kw), TS.make_loop_circuit(**kw))
    assert len(TS.make_loop_circuit(**kw)[2]) == 2 * (4 + 2) + 10
