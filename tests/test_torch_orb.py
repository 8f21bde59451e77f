"""ORB orientation/descriptor stage of the PyTorch port against the JAX
reference: the test pattern, the pair table, the plain version of the
`orb_describe` kernel, and full `extract_orb`.

Tolerances: angle 1e-3 rad and descriptor bits >= 99.5% equal are the
repo's own kernel tolerance (tests/test_orb_pallas.py). Keypoint
coordinates, octaves, validity and responses must be exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.ops import orb as JO
from splslam_tpu.ops import orb_pallas as OP
from splslam_tpu.ops.pyramid import PyramidSpec as JSpec
from splslam_tpu_torch.ops import orb as TO
from splslam_tpu_torch.ops import orb_kernel as OK
from splslam_tpu_torch.ops.pyramid import PyramidSpec as TSpec

ANGLE_ATOL = 1e-3
BIT_AGREE = 0.995


def bit_agreement(d_jax, d_torch) -> float:
    b1 = np.unpackbits(np.asarray(d_jax).view(np.uint8))
    b2 = np.unpackbits(d_torch.cpu().numpy().view(np.uint8))
    return float((b1 == b2).mean())


def random_packed(seed=0, R=256, Wp=256, n=24):
    """The input of tests/test_orb_pallas.py."""
    rng = np.random.default_rng(seed)
    packed = rng.uniform(0, 255, (R, Wp)).astype(np.float32)
    cy = rng.integers(0, R - OP.PATCH - 8, n).astype(np.int32)
    cx = rng.integers(0, Wp - OP.PATCH - 128, n).astype(np.int32)
    return packed, cy, cx


def test_make_pattern_equals_jax():
    np.testing.assert_array_equal(TO.make_pattern(), JO._PATTERN)


def test_pair_table_matches_jax_diff_table():
    """Every (bin, pair) of the kernel's offset table addresses the pixels
    the reference's +-1 difference table picks."""
    diff, _ = OP._tables()
    table = OK.pair_table().astype(np.int64)
    to_prow = lambda i: (i // OK.PATCH) * OP.PROW + i % OK.PATCH
    for b in range(OK.N_BINS):
        col = diff[:, b * 256:(b + 1) * 256].astype(np.int32)
        expect = np.zeros_like(col)
        np.add.at(expect, (to_prow(table[b, :, 0]), np.arange(256)), 1)
        np.add.at(expect, (to_prow(table[b, :, 1]), np.arange(256)), -1)
        np.testing.assert_array_equal(col, expect)


@pytest.mark.parametrize("seed", [0, 1])
def test_describe_reference_matches_xla(seed):
    packed, cy, cx = random_packed(seed)
    pj = jnp.asarray(packed).astype(jnp.bfloat16)
    a_j, d_j, _ = OP.patch_orient_describe_xla(pj, jnp.asarray(cy), jnp.asarray(cx))
    pt = torch.from_numpy(packed).to(torch.bfloat16)
    a_t, d_t = OK.orb_describe_reference(pt, torch.from_numpy(cy),
                                         torch.from_numpy(cx))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=ANGLE_ATOL)
    assert bit_agreement(d_j, d_t) >= BIT_AGREE
    # measured: every word equal on both seeds
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j).view(np.int32))


def test_wrapper_takes_plain_version_on_cpu_only():
    packed, cy, cx = random_packed(3)
    args = (torch.from_numpy(packed).to(torch.bfloat16), torch.from_numpy(cy),
            torch.from_numpy(cx))
    before = OK.orb_describe.launches
    a1, d1 = OK.orb_describe(*args)
    a2, d2 = OK.orb_describe_reference(*args)
    assert OK.orb_describe.launches == before  # the plain path is no launch
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    with pytest.raises(ValueError):
        OK.orb_describe(args[0].float(), args[1], args[2])
    with pytest.raises(ValueError):
        OK.orb_describe(args[0].to("meta"), args[1].to("meta"),
                        args[2].to("meta"))


def test_pack_bits_layout():
    bits = torch.zeros((2, 256), dtype=torch.bool)
    bits[0, 0] = True      # word 0 bit 0
    bits[0, 31] = True     # word 0 bit 31 (sign bit of the int32 view)
    bits[1, 32 * 7 + 5] = True
    w = OK.pack_bits(bits).numpy().view(np.uint32)
    assert w[0, 0] == (1 | (1 << 31)) and w[1, 7] == 1 << 5
    assert w.sum() == w[0, 0] + w[1, 7]


@pytest.fixture(scope="module")
def frame_image():
    _, _, frames, _ = make_stereo_sequence(n_frames=1, motion="forward",
                                           width=320, height=240)
    return frames[0][0].astype(np.uint8).astype(np.float32)


def test_extract_orb_matches_jax(frame_image):
    """Full extraction at 320x240, 600 features, 4 levels. The reference
    runs op by op (jax.disable_jit): under jit, XLA's CPU fusion turns
    the pyramid's and blur's multiply-adds into FMAs, which moves blurred
    pixels by an ulp (measured: 1 of 76800 level-0 bf16 pixels flips,
    moving one angle by 1.45e-3 rad; ROADMAP queue C)."""
    spec = JSpec.create(240, 320, 4, 1.2, 600)
    with jax.disable_jit():
        fj = JO.extract_orb(jnp.asarray(frame_image), spec)
    ft = TO.extract_orb(torch.from_numpy(frame_image),
                        TSpec.create(240, 320, 4, 1.2, 600))
    for name in ("xy", "response", "octave", "valid", "sigma2"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(),
                                      np.asarray(getattr(fj, name)), err_msg=name)
    np.testing.assert_allclose(ft.angle.numpy(), np.asarray(fj.angle),
                               atol=ANGLE_ATOL)
    assert bit_agreement(fj.desc, ft.desc) >= BIT_AGREE
    assert int(ft.valid.sum()) > 300


def test_extract_orb_keypoints_match_jitted_jax(frame_image):
    """Against the jitted reference (what its System runs) the keypoint
    table is still exact on this frame; descriptors within tolerance."""
    spec = JSpec.create(240, 320, 4, 1.2, 600)
    fj = JO.extract_orb(jnp.asarray(frame_image), spec)
    ft = TO.extract_orb(torch.from_numpy(frame_image),
                        TSpec.create(240, 320, 4, 1.2, 600))
    for name in ("xy", "response", "octave", "valid"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(),
                                      np.asarray(getattr(fj, name)), err_msg=name)
    assert bit_agreement(fj.desc, ft.desc) >= BIT_AGREE
