"""Front end of the PyTorch port against the JAX reference: pyramid, blur,
FAST + NMS, grid top-k, and stereo matching on identical features.

The reference functions run op by op (as its own module functions are
unjitted), so float32 results are compared bit for bit. Stereo matching
gets the SAME OrbFeatures on both sides (the JAX table converted with
splslam_tpu_torch.convert), so its tolerance isolates the stereo stage:
u_right within 1e-3 px, and exactly the same features get depth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.ops import fast as JF
from splslam_tpu.ops import orb as JO
from splslam_tpu.ops import pyramid as JP
from splslam_tpu.ops import stereo as JS
from splslam_tpu.ops import topk as JT
from splslam_tpu_torch import convert
from splslam_tpu_torch.ops import fast as TF
from splslam_tpu_torch.ops import match as TM
from splslam_tpu_torch.ops import pyramid as TP
from splslam_tpu_torch.ops import stereo as TS
from splslam_tpu_torch.ops import topk as TT

W, H = 320, 240


@pytest.fixture(scope="module")
def pair():
    K, bf, frames, _ = make_stereo_sequence(n_frames=1, motion="forward",
                                            width=W, height=H)
    l, r = (f.astype(np.uint8).astype(np.float32) for f in frames[0])
    return K, bf, l, r


@pytest.fixture(scope="module")
def levels(pair):
    img = pair[2]
    spec = JP.PyramidSpec.create(H, W, 4, 1.2, 600)
    jl = [np.array(x) for x in JP.build_pyramid(jnp.asarray(img), spec)]
    tl = [x.numpy() for x in TP.build_pyramid(torch.from_numpy(img),
                                              TP.PyramidSpec.create(H, W, 4, 1.2, 600))]
    return jl, tl


def test_pyramid_spec_equal():
    for args in ((240, 320, 4, 1.2, 600), (376, 1241, 8, 1.2, 2000)):
        assert tuple(TP.PyramidSpec.create(*args)) == tuple(JP.PyramidSpec.create(*args))


def test_build_pyramid_exact(levels):
    jl, tl = levels
    assert len(jl) == len(tl) == 4
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b, a)


def test_gaussian_blur_exact(levels):
    for a in levels[0]:
        ja = np.asarray(JP.gaussian_blur(jnp.asarray(a)))
        np.testing.assert_array_equal(TP.gaussian_blur(torch.from_numpy(a)).numpy(), ja)


def test_fast_corners_exact(levels):
    """Levels >= 1 have fractional pixels, so this also pins where the
    bf16 ring arithmetic rounds."""
    for a in levels[0]:
        js = np.asarray(JF.fast_corners(jnp.asarray(a), 12.0))
        ts = TF.fast_corners(torch.from_numpy(a), 12.0).numpy()
        np.testing.assert_array_equal(ts, js)
        assert (ts > 0).sum() > 100


@pytest.mark.parametrize("k_total", [50, 211])
def test_grid_topk_exact(levels, k_total):
    score = np.array(JF.fast_corners(jnp.asarray(levels[0][1]), 12.0))
    xy_j, r_j, v_j = JT.grid_topk(jnp.asarray(score), k_total)
    xy_t, r_t, v_t = TT.grid_topk(torch.from_numpy(score), k_total)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_grid_topk_ties_go_to_lower_index():
    score = np.zeros((32, 32), np.float32)
    score[3, 3] = score[20, 4] = score[5, 25] = 7.0   # equal responses
    xy_j, _, _ = JT.grid_topk(jnp.asarray(score), 2)
    xy_t, _, _ = TT.grid_topk(torch.from_numpy(score), 2)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))


def test_hamming_exact():
    rng = np.random.default_rng(4)
    d1 = rng.integers(0, 2 ** 32, (37, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 2 ** 32, (23, 8), dtype=np.uint64).astype(np.uint32)
    from splslam_tpu.ops.match import hamming_matrix_xor
    ref = np.asarray(hamming_matrix_xor(jnp.asarray(d1), jnp.asarray(d2)))
    got = TM.hamming(torch.from_numpy(d1.view(np.int32)),
                     torch.from_numpy(d2.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_stereo_match_on_identical_features(pair):
    K, bf, l, r = pair
    spec = JP.PyramidSpec.create(H, W, 4, 1.2, 600)
    fl = JO.extract_orb(jnp.asarray(l), spec)
    fr = JO.extract_orb(jnp.asarray(r), spec)
    scales = np.asarray(spec.scales, np.float32)
    bf32, fx32 = np.float32(bf), np.float32(K[0, 0])
    ur_j, d_j = JS.stereo_match(fl, fr, jnp.asarray(l), jnp.asarray(r),
                                jnp.asarray(scales), jnp.asarray(bf32),
                                jnp.asarray(fx32))
    tl = convert.orb_features_from_numpy(fl, "cpu")
    tr = convert.orb_features_from_numpy(fr, "cpu")
    ur_t, d_t = TS.stereo_match(tl, tr, torch.from_numpy(l), torch.from_numpy(r),
                                torch.from_numpy(scales), float(bf32), float(fx32))
    ur_j, d_j = np.asarray(ur_j), np.asarray(d_j)
    np.testing.assert_array_equal(d_t.numpy() > 0, d_j > 0)
    np.testing.assert_allclose(ur_t.numpy(), ur_j, atol=1e-3)
    assert (d_j > 0).sum() > 150
