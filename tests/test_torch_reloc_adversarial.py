"""Adversarial relocalization seeding in the port (`slam/reloc.py::
reloc_attempt`'s EPnL line branch) against the JAX package's, on
tests/test_reloc_adversarial.py's scene: a candidate keyframe with only
10 correct landmarks (too few for the point seed, n0 < 12) and 10 map
lines that are a perfectly self-consistent WRONG pose's (4 m away,
rotated 0.6 rad), with identical LBDs so every line matches. A wrong
line seed must not give a confident relocalization: either fewer than 50
inliers (the reference's acceptance gate) or the true pose (within 0.1).

The attempt runs in both packages on the same numpy scene, the port with
the JAX package's minimal sets injected (its Gumbel top-k draws
recomputed from the same key, as tests/test_torch_reloc.py does): the
point and line associations and the inlier count equal, the pose within
1e-3. The port's own draws (`torch.Generator`s, several seeds) must hold
the invariant too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.geometry.camera import Camera as JCam
from splslam_tpu.io.synth_map import _bits_pm1, _pack_desc
from splslam_tpu.ops.lines import LineFeatures
from splslam_tpu.ops.orb import OrbFeatures
from splslam_tpu.slam import reloc as JR
from splslam_tpu.slam.frame import FrameData
from splslam_tpu_torch import convert
from splslam_tpu_torch.geometry.camera import Camera as TCam
from splslam_tpu_torch.slam import reloc as TR
from test_torch_reloc import _jax_samples, _line_samples

FX, CX, CY = 500.0, 320.0, 240.0
ACCEPT = 50          # the reference's relocalization acceptance gate
TRUE_POSE_TOL = 0.1
POSE_ATOL = 1e-3     # tests/test_torch_reloc.py's


def _proj(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                     FX * pc[:, 1] / pc[:, 2] + CY], -1), pc[:, 2]


def _unproj(T, uv, z):
    """Pixel + depth -> world point under camera pose T (Tcw)."""
    pc = np.stack([(uv[:, 0] - CX) / FX * z, (uv[:, 1] - CY) / FX * z, z], -1)
    Twc = np.linalg.inv(T)
    return pc @ Twc[:3, :3].T + Twc[:3, 3]


@pytest.fixture(scope="module")
def scene():
    """tests/test_reloc_adversarial.py's scene, drawn from its seed 11 in
    the same order: (JAX frame on the host, candidate arrays, T_gt)."""
    rng = np.random.default_rng(11)
    N, Lc = 200, 16
    T_gt = np.eye(4, dtype=np.float32)
    T_bad = np.eye(4, dtype=np.float32)
    T_bad[:3, 3] = (4.0, -2.0, 1.5)
    th = 0.6
    T_bad[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                              [-np.sin(th), 0, np.cos(th)]], np.float32)
    n_match = 10
    lm_xyz = rng.uniform([-2, -1.5, 4], [2, 1.5, 9], (N, 3)).astype(np.float32)
    kf_desc_bits = rng.integers(0, 2, (N, 256)).astype(np.uint8)
    kf_desc = _pack_desc(kf_desc_bits)
    kf_lm = np.arange(N, dtype=np.int32)
    uv_gt, _ = _proj(T_gt, lm_xyz[:n_match])
    f_xy = rng.uniform([0, 0], [640, 480], (N, 2)).astype(np.float32)
    f_xy[:n_match] = uv_gt
    f_bits = rng.integers(0, 2, (N, 256)).astype(np.uint8)
    f_bits[:n_match] = kf_desc_bits[:n_match]
    f_desc = _pack_desc(f_bits)

    nl = 10
    mid2d = rng.uniform([60, 60], [580, 420], (nl, 2)).astype(np.float32)
    ang = rng.uniform(0, np.pi, nl)
    half = rng.uniform(20, 50, nl)[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    seg = np.concatenate([mid2d - half, mid2d + half], -1).astype(np.float32)
    zs = rng.uniform(4, 8, nl)
    S3 = _unproj(T_bad, seg[:, :2], zs)
    E3 = _unproj(T_bad, seg[:, 2:4], zs * rng.uniform(0.9, 1.1, nl))
    kf_ll_xyz3 = np.zeros((Lc, 3, 3), np.float32)
    kf_ll_xyz3[:nl] = np.stack([S3, 0.5 * (S3 + E3), E3], 1)
    kf_ldesc = _pack_desc(rng.integers(0, 2, (Lc, 256)).astype(np.uint8))
    kf_ll = np.full((Lc,), -1, np.int32)
    kf_ll[:nl] = np.arange(nl)

    pad = lambda a: np.pad(a, ((0, Lc - nl),) + ((0, 0),) * (a.ndim - 1))
    d = seg[:, 2:4] - seg[:, :2]
    feat = OrbFeatures(
        xy=jnp.asarray(f_xy), response=jnp.zeros((N,)), angle=jnp.zeros((N,)),
        octave=jnp.zeros((N,), jnp.int32), sigma2=jnp.ones((N,)),
        desc=jnp.asarray(f_desc), valid=jnp.ones((N,), bool),
        bits=jnp.asarray(_bits_pm1(f_desc), jnp.bfloat16),
    )
    lines = LineFeatures.empty(Lc)._replace(
        seg=jnp.asarray(pad(seg)), midpoint=jnp.asarray(pad(mid2d)),
        angle=jnp.asarray(pad(np.arctan2(d[:, 1], d[:, 0]))),
        length=jnp.asarray(pad(np.linalg.norm(d, axis=-1))),
        desc=jnp.asarray(kf_ldesc), valid=jnp.asarray(np.arange(Lc) < nl),
    )
    frame = jax.device_get(FrameData(feat=feat, u_right=jnp.full((N,), -1.0),
                                     depth=jnp.full((N,), -1.0), lines=lines))
    cand = (kf_desc, np.ones((N,), bool), kf_lm, lm_xyz, kf_ldesc, kf_ll, kf_ll_xyz3)
    return frame, cand, T_gt


def _port_args(frame, cand):
    t = lambda a: torch.from_numpy(np.array(a))
    desc, fvalid, lm, xyz, ldesc, ll, ll_xyz3 = cand
    return (convert.frame_from_numpy(frame, "cpu"),
            [t(desc.view(np.int32)), t(fvalid), t(lm), t(xyz),
             t(ldesc.view(np.int32)), t(ll), t(ll_xyz3)])


def _confident_and_wrong(T, n, T_gt):
    t_err = float(np.linalg.norm(np.asarray(T)[:3, 3] - T_gt[:3, 3]))
    return n >= ACCEPT and t_err >= TRUE_POSE_TOL, t_err


def test_wrong_line_seed_cannot_fake_a_confident_reloc(scene):
    frame, cand, T_gt = scene
    key = jax.random.PRNGKey(0)
    jcam = JCam.create(fx=FX, fy=FX, cx=CX, cy=CY, bf=50.0, width=640, height=480)
    Tj, nj, gidj, llj = JR.reloc_attempt(key, jcam, jax.tree.map(jnp.asarray, frame),
                                         *map(jnp.asarray, cand))
    tframe, targs = _port_args(frame, cand)
    _, gid0, _ = TR.global_match(tframe, *targs[:4])
    ll0, _ = TR.line_match(tframe, *targs[4:])
    assert int((ll0 >= 0).sum()) == 10 and int((gid0 >= 0).sum()) >= 10
    samples = _jax_samples(key, gid0.numpy() >= 0, TR.N_HYP, 6)
    lsamples = _line_samples(jax.random.fold_in(key, 1),
                             (ll0.numpy() >= 0) & tframe.lines.valid.numpy())
    tcam = TCam.create(FX, FX, CX, CY, bf=50.0, width=640, height=480)
    Tt, nt, gidt, llt = TR.reloc_attempt(tcam, tframe, *targs, samples=samples,
                                         line_samples=lsamples)
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(gidt.numpy(), np.asarray(gidj))
    np.testing.assert_array_equal(llt.numpy(), np.asarray(llj))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=POSE_ATOL)
    bad, t_err = _confident_and_wrong(Tt.numpy(), int(nt), T_gt)
    assert not bad, (int(nt), t_err, Tt.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wrong_line_seed_with_the_ports_own_draws(scene, seed):
    frame, cand, T_gt = scene
    tframe, targs = _port_args(frame, cand)
    tcam = TCam.create(FX, FX, CX, CY, bf=50.0, width=640, height=480)
    g = torch.Generator().manual_seed(seed)
    Tt, nt, _, _ = TR.reloc_attempt(tcam, tframe, *targs, generator=g)
    bad, t_err = _confident_and_wrong(Tt.numpy(), int(nt), T_gt)
    assert not bad, (int(nt), t_err, Tt.numpy())
