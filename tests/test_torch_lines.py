"""The line detector and LBD descriptor of the PyTorch port
(`splslam_tpu_torch/ops/lines.py`) against the JAX reference run op by op
(`jax.disable_jit()`: jit fusion contracts multiply-adds, which moves the
march's rounding decisions), on frame 0 and frame 3 of the synthetic grid
sequence at 320x240; plus tests/test_lines.py's recall and matching gates
for the port, and `undistort_points`.

Tolerances: Sobel gradients exact; seed magnitudes within a relative
1e-6 (an ulp); bilinear samples within 1e-4 (the
same four products summed in the same order, float32); march run lengths
exact; seed validity, candidate validity, segment validity and octaves
exact; endpoints within 2e-3 px (measured 1.2e-4; the refits go through
atan2/cos/sin, whose float32 results differ by an ulp between the two
libraries); LBD bits agreeing on at least 99.5% of the valid lines' bits
(the bar the two JAX ORB paths meet, tests/test_orb_pallas.py; measured
100%)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.geometry.camera import Camera as JCam
from splslam_tpu.geometry.camera import undistort_points as j_undistort
from splslam_tpu.ops import lines as JL
from splslam_tpu_torch.geometry.camera import Camera as TCam
from splslam_tpu_torch.geometry.camera import undistort_points as t_undistort
from splslam_tpu_torch.io.synthetic import make_stereo_sequence
from splslam_tpu_torch.ops import lines as TL
from splslam_tpu_torch.ops.match import hamming
from test_lines import SEGS, _recall, _render_segments

SEG_ATOL = 2e-3


def _bits(desc: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(desc).view(np.uint8).reshape(len(desc), -1), axis=1)


@pytest.fixture(scope="module")
def images():
    torch.set_num_threads(1)
    _, _, frames, _ = make_stereo_sequence(n_frames=4, motion="lateral", width=320,
                                           height=240, texture="grid")
    return [np.asarray(frames[i][0], np.float32) for i in (0, 3)]


@pytest.fixture(scope="module")
def ref_lines(images):
    """The reference's extract_lines, op by op, per (image, backend)."""
    out = {}
    with jax.disable_jit():
        for i, img in enumerate(images):
            for backend in ("grow", "fld"):
                out[i, backend] = jax.device_get(
                    JL.extract_lines(jnp.asarray(img), capacity=64, backend=backend))
    return out


def test_sobel_gradients(images):
    img = images[0]
    with jax.disable_jit():
        jgx, jgy = JL.sobel_gradients(jnp.asarray(img))
    tgx, tgy = TL.sobel_gradients(torch.from_numpy(img))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(tgy.numpy(), np.asarray(jgy))
    # the zero pad makes the image border the strongest gradient
    assert np.abs(tgx.numpy()[:, 0]).mean() > np.abs(tgx.numpy()[:, 5:-5]).mean()


def test_bilinear(images):
    img = images[0]
    r = np.random.default_rng(0)
    x = r.uniform(-5, 330, (64, 16)).astype(np.float32)
    y = r.uniform(-5, 250, (64, 16)).astype(np.float32)
    with jax.disable_jit():
        j = JL._bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    t = TL._bilinear(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-4)


def test_grow_fb(images):
    """Forward and backward run lengths of the first march of one octave:
    seeds, angles and fields from the reference, run lengths exact."""
    img = jnp.asarray(images[0])
    with jax.disable_jit():
        gx, gy = JL.sobel_gradients(img)
        mag = jnp.sqrt(gx * gx + gy * gy)
        ang_map = jnp.arctan2(gy, gx) + 0.5 * jnp.pi
        r = np.random.default_rng(1)
        seeds = jnp.asarray(r.uniform(10, 230, (300, 2)).astype(np.float32))
        ys, xs = np.asarray(seeds[:, 1]).astype(int), np.asarray(seeds[:, 0]).astype(int)
        angle = ang_map[ys, xs]
        th = jnp.maximum(jnp.max(mag) * JL.MAG_FRAC, 1e-3)
        jf, jb = JL._grow_fb(seeds, angle, ang_map, JL._pack4(mag), th)
    t = lambda a: torch.from_numpy(np.asarray(a))
    tf, tb = TL._grow_fb(t(seeds), t(angle), t(ang_map), t(mag), t(th))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert (np.asarray(jf) + np.asarray(jb)).max() >= 24


@pytest.mark.parametrize("backend", ["grow", "fld"])
def test_detect_level(images, backend):
    img = images[0]
    with jax.disable_jit():
        ja, jb, jln, jok, jcm = JL._detect_level(jnp.asarray(img), 16, 24.0, backend=backend)
    ta, tb, tln, tok, tcm = TL._detect_level(torch.from_numpy(img), 16, 24.0, backend=backend)
    ok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), ok)
    np.testing.assert_allclose(tcm.numpy(), np.asarray(jcm), rtol=1e-6)
    np.testing.assert_allclose(ta.numpy()[ok], np.asarray(ja)[ok], atol=SEG_ATOL)
    np.testing.assert_allclose(tb.numpy()[ok], np.asarray(jb)[ok], atol=SEG_ATOL)
    np.testing.assert_allclose(tln.numpy()[ok], np.asarray(jln)[ok], atol=SEG_ATOL)
    assert ok.sum() >= 20


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("backend", ["grow", "fld"])
def test_extract_lines_matches_jax(images, ref_lines, frame, backend):
    j = ref_lines[frame, backend]
    t = TL.extract_lines(torch.from_numpy(images[frame]), capacity=64, backend=backend)
    v = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), v)
    np.testing.assert_array_equal(t.octave.numpy(), np.asarray(j.octave))
    assert v.sum() >= 15 and (np.asarray(j.octave)[v] == 1).any()
    for f in ("seg", "midpoint", "length"):
        np.testing.assert_allclose(getattr(t, f).numpy()[v], np.asarray(getattr(j, f))[v],
                                   atol=SEG_ATOL, err_msg=f)
    np.testing.assert_allclose(t.response.numpy(), np.asarray(j.response), atol=1e-3)
    agree = (_bits(t.desc.numpy()[v]) == _bits(np.asarray(j.desc).view(np.int32)[v])).mean()
    assert agree >= 0.995, agree


def test_lbd_descriptor_matches_jax(images):
    """The descriptor alone, on the reference's own segments."""
    img = images[0]
    with jax.disable_jit():
        gx, gy = JL.sobel_gradients(jnp.asarray(img))
        f = JL.extract_lines(jnp.asarray(img), capacity=64)
        jd = JL.lbd_descriptor(jnp.asarray(img), gx, gy, f.seg, f.angle, f.length)
    t = lambda a: torch.from_numpy(np.asarray(a))
    td = TL.lbd_descriptor(t(img), t(gx), t(gy), t(f.seg), t(f.angle), t(f.length))
    v = np.asarray(f.valid)
    agree = (_bits(td.numpy()[v]) == _bits(np.asarray(jd).view(np.int32)[v])).mean()
    assert agree >= 0.995, agree


def test_with_segments_and_empty():
    e = TL.LineFeatures.empty(8, "cpu")
    assert e.capacity == 8 and not e.valid.any() and e.desc.dtype == torch.int32
    seg = torch.tensor([[0.0, 0.0, 3.0, 4.0], [10.0, 10.0, 10.0, 0.0]])
    f = TL.LineFeatures.empty(2, "cpu").with_segments(seg)
    np.testing.assert_allclose(f.length.numpy(), [5.0, 10.0])
    np.testing.assert_allclose(f.midpoint.numpy(), [[1.5, 2.0], [10.0, 5.0]])
    np.testing.assert_allclose(f.angle.numpy(), [np.arctan2(4, 3), -np.pi / 2], rtol=1e-6)


def test_undistort_points_matches_jax():
    kw = dict(fx=520.0, fy=515.0, cx=318.0, cy=242.0, k1=-0.28, k2=0.07,
              p1=1e-3, p2=-5e-4, k3=0.01)
    uv = np.random.default_rng(2).uniform([0, 0], [640, 480], (500, 2)).astype(np.float32)
    j = np.asarray(j_undistort(JCam.create(**kw), jnp.asarray(uv)))
    t = t_undistort(TCam.create(**kw), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-3)
    assert np.abs(t - uv).max() > 5.0    # the model moved the corners


# ---- tests/test_lines.py's gates, for the port ----
def _extract(img, **kw):
    return TL.extract_lines(torch.from_numpy(img), capacity=64, **kw)


def test_port_recall_sharp_lines():
    assert _recall(SEGS, _extract(_render_segments(SEGS))) >= 0.8


def test_port_multi_octave_recovers_blurred_lines():
    img = _render_segments(SEGS, thickness=6, contrast=35.0, noise=6.0, blur=3)
    r1 = _recall(SEGS, _extract(img, n_octaves=1), tol_perp=6.0)
    r2 = _recall(SEGS, _extract(img, n_octaves=2), tol_perp=6.0)
    assert r2 >= r1 and r2 >= 0.6, (r1, r2)


def test_port_fld_backend_recall():
    segs = [(40, 40, 280, 60), (60, 200, 240, 120), (160, 20, 170, 220)]
    assert _recall(segs, _extract(_render_segments(segs), backend="fld")) >= 2 / 3


def test_port_lbd_matches_on_true_camera_shift():
    """One canvas, two crops offset by (4, 3): LBD must re-match nearly
    every detection (tests/test_lines.py's gate: >= 4 matches, >= 80%
    geometrically right)."""
    H, W, ox, oy = 240, 320, 4, 3
    segs = [(x1 + ox, y1 + oy, x2 + ox, y2 + oy) for (x1, y1, x2, y2) in SEGS]
    canvas = _render_segments(segs, H=H + 2 * oy, W=W + 2 * ox, seed=7)
    f1 = _extract(np.ascontiguousarray(canvas[:H, :W]))
    f2 = _extract(np.ascontiguousarray(canvas[oy:oy + H, ox:ox + W]))
    v1, v2 = f1.valid.numpy(), f2.valid.numpy()
    d = hamming(f1.desc, f2.desc).numpy().astype(float)
    d[~v1] = 1e9
    d[:, ~v2] = 1e9
    s1, s2 = f1.seg.numpy(), f2.seg.numpy()
    good = tot = 0
    for i in np.nonzero(v1)[0]:
        j = int(np.argmin(d[i]))
        if d[i, j] > 80:
            continue
        tot += 1
        a, b = s2[j, :2], s2[j, 2:]
        n = np.array([-(b - a)[1], (b - a)[0]]) / max(np.linalg.norm(b - a), 1e-6)
        p1, p2 = s1[i, :2] - [ox, oy], s1[i, 2:] - [ox, oy]
        if abs(np.dot(p1 - a, n)) < 5.0 and abs(np.dot(p2 - a, n)) < 5.0:
            good += 1
    assert tot >= 4 and good / tot >= 0.8, (good, tot)
