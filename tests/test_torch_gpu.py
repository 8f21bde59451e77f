"""Tests that need a CUDA device: the hand-written `orb_describe` kernel
against its plain PyTorch version, and the port on the GPU against the
port on the CPU. Every test skips on a host without a card.

This file imports no JAX (a GPU host need not have it, and
tests/conftest.py imports it), so on a GPU host run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Tolerances: angle 1e-3 rad and descriptor bits >= 99.5% equal (the
repo's kernel tolerance, tests/test_orb_pallas.py); keypoint tables
exact; poses within 1e-3 of the CPU run (float32 sums in another order
on the GPU)."""

import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import ate_rmse, make_stereo_sequence
from splslam_tpu_torch.ops import orb as TO
from splslam_tpu_torch.ops import orb_kernel as OK
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.slam import system as TS

pytestmark = pytest.mark.gpu

ANGLE_ATOL = 1e-3
BIT_AGREE = 0.995


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bit_agreement(d1, d2) -> float:
    b1 = np.unpackbits(d1.cpu().numpy().view(np.uint8))
    b2 = np.unpackbits(d2.cpu().numpy().view(np.uint8))
    return float((b1 == b2).mean())


def assert_describe_agrees(packed, cy, cx):
    before = OK.orb_describe.launches
    a_k, d_k = OK.orb_describe(packed, cy, cx)
    a_p, d_p = OK.orb_describe_reference(packed, cy, cx)
    torch.cuda.synchronize()
    assert OK.orb_describe.launches == before + 1
    assert float((a_k - a_p).abs().max()) <= ANGLE_ATOL
    assert bit_agreement(d_k, d_p) >= BIT_AGREE


def test_kernel_matches_plain_at_main_path_shapes(cuda):
    """KITTI 1241x376, 2000 features, 8 levels: packed bf16 [1739, 1536]."""
    _, _, frames, _ = make_stereo_sequence(
        n_frames=1, width=1241, height=376, fx=718.0, baseline=0.54,
        motion="forward", seed=3)
    img = torch.from_numpy(frames[0][0].astype(np.uint8)).to(cuda).float()
    _, packed, cy, cx = TO.detect_and_pack(
        img, PyramidSpec.create(376, 1241, 8, 1.2, 2000))
    assert tuple(packed.shape) == (1739, 1536) and cy.shape[0] == 2000
    assert_describe_agrees(packed, cy, cx)


@pytest.mark.parametrize("n", [1, 7, 33, 130])
def test_kernel_ragged_counts_and_clamped_corners(cuda, n):
    """Counts that leave a block partly empty, and corners outside the
    buffer, which kernel and plain version both clamp."""
    rng = np.random.default_rng(n)
    packed = torch.from_numpy(rng.uniform(0, 256, (300, 400)).astype(np.float32))
    packed = packed.to(cuda).to(torch.bfloat16)
    cy = torch.from_numpy(rng.integers(-50, 320, n).astype(np.int32)).to(cuda)
    cx = torch.from_numpy(rng.integers(-50, 420, n).astype(np.int32)).to(cuda)
    assert_describe_agrees(packed, cy, cx)


def test_kernel_rejects_what_it_does_not_take(cuda):
    packed = torch.zeros((64, 64), dtype=torch.bfloat16, device=cuda)
    c = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        OK.orb_describe(packed.float(), c, c)
    with pytest.raises(ValueError):
        OK.orb_describe(packed, c.long(), c)
    with pytest.raises(ValueError):
        strided = torch.zeros(16, dtype=torch.int32, device=cuda)[::2]
        OK.orb_describe(packed, strided, strided)
    with pytest.raises(ValueError):
        OK.orb_describe(packed, c.cpu(), c.cpu())


def test_extract_orb_gpu_matches_cpu(cuda):
    _, _, frames, _ = make_stereo_sequence(n_frames=1, motion="forward",
                                           width=320, height=240)
    img = torch.from_numpy(frames[0][0].astype(np.uint8)).float()
    spec = PyramidSpec.create(240, 320, 4, 1.2, 600)
    fc = TO.extract_orb(img, spec)
    fg = TO.extract_orb(img.to(cuda), spec)
    for name in ("xy", "response", "octave", "valid"):
        torch.testing.assert_close(getattr(fg, name).cpu(), getattr(fc, name),
                                   rtol=0, atol=0, msg=name)
    assert float((fg.angle.cpu() - fc.angle).abs().max()) <= ANGLE_ATOL
    assert bit_agreement(fg.desc, fc.desc) >= BIT_AGREE


def test_system_gpu_matches_cpu(cuda):
    K, bf, frames, gt = make_stereo_sequence(n_frames=20, motion="forward",
                                             width=320, height=240)
    st = TS.Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=600, n_levels=4, th_depth=40.0, fps=10,
        max_points=8192, max_keyframes=64, local_window=1024,
    )
    runs = []
    for dev in ("cpu", cuda):
        sysm = TS.System(st, TS.Sensor.STEREO, dev)
        before = OK.orb_describe.launches
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
        assert sysm.get_tracking_state() == TS.TrackingState.OK
        runs.append((sysm, OK.orb_describe.launches - before))
    (sc, lc), (sg, lg) = runs
    assert lc == 0 and lg >= 2 * len(frames)
    assert sg.n_kfs == sc.n_kfs
    pc, pg = sc.poses(), sg.poses()
    np.testing.assert_allclose(pg[:, :3, :4], pc[:, :3, :4], atol=1e-3)
    assert ate_rmse(pg, gt) < 0.05
