"""ORB orientation/descriptor stage of the PyTorch port against the JAX
reference: the test pattern, the pair table, the plain version of the
`orb_describe` kernel (blur, packing, corners and descriptors on random
levels and edge-case slots, against the reference's steps run op by
op), the pair form, and full `extract_orb`.

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
from splslam_tpu.ops import pyramid as JP
from splslam_tpu.ops.pyramid import PyramidSpec as JSpec
from splslam_tpu_torch.ops import orb as TO
from splslam_tpu_torch.ops import orb_kernel as OK
from splslam_tpu_torch.ops.pyramid import PyramidSpec as TSpec
from test_torch_gpu import edge_case_inputs

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
    """The plain version's last step, on the packed buffer and corners of
    tests/test_orb_pallas.py, against the reference's XLA path."""
    packed, cy, cx = random_packed(seed)
    pj = jnp.asarray(packed).astype(jnp.bfloat16)
    a_j, d_j, _ = OP.patch_orient_describe_xla(pj, jnp.asarray(cy), jnp.asarray(cx))
    pt = torch.from_numpy(packed).to(torch.bfloat16)
    a_t, d_t = OK.describe_packed(pt, torch.from_numpy(cy), torch.from_numpy(cx))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=ANGLE_ATOL)
    assert bit_agreement(d_j, d_t) >= BIT_AGREE
    # measured: every word equal on both seeds
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j).view(np.int32))


def jax_describe(levels, xy, spec):
    """The reference's steps, op by op: `gaussian_blur` per level, the
    packing and corner clamping of splslam_tpu/ops/orb.py:205-222, then
    `patch_orient_describe_xla`. One image; (angle, desc as int32)."""
    Wp = JO._lane_pad(spec.sizes[0][1])
    with jax.disable_jit():
        rows, row_off, acc = [], [], 0
        for lv, img in enumerate(levels):
            H, W = spec.sizes[lv]
            rows.append(jnp.pad(JP.gaussian_blur(jnp.asarray(img)),
                                ((0, 0), (0, Wp - W))))
            row_off.append(acc)
            acc += H
        packed = jnp.concatenate(rows + [jnp.zeros((8, Wp), jnp.float32)], axis=0)
        packed = jnp.pad(packed, ((0, 0), (0, 256))).astype(jnp.bfloat16)
        cys, cxs, i0 = [], [], 0
        for lv, budget in enumerate(spec.budgets):
            if budget == 0:
                continue
            xi = jnp.asarray(xy[i0:i0 + budget]).astype(jnp.int32)
            cys.append(jnp.clip(xi[:, 1] - OP.C + row_off[lv], 0, acc - OP.PATCH))
            cxs.append(jnp.clip(xi[:, 0] - OP.C, 0, Wp - OP.PATCH))
            i0 += budget
        ang, desc, _ = OP.patch_orient_describe_xla(
            packed, jnp.concatenate(cys), jnp.concatenate(cxs))
    return np.asarray(ang), np.asarray(desc).view(np.int32)


def _torch_inputs(levels, xy):
    return ([[torch.from_numpy(x) for x in pyr] for pyr in levels],
            torch.from_numpy(xy))


@pytest.mark.parametrize("n_levels", [1, 4, 8])
def test_plain_describe_matches_jax_on_edge_slots(n_levels):
    """Every slot, straddling and clamped ones included: words equal,
    angle within 1e-6 (the moment sums are exact in float32 here; only
    atan2's last bit may differ)."""
    spec, levels, xy = edge_case_inputs(n_levels, 1, seed=10 + n_levels)
    a_t, d_t = OK.orb_describe_reference(*_torch_inputs(levels, xy), spec)
    a_j, d_j = jax_describe(levels[0], xy[0], spec)
    np.testing.assert_array_equal(d_t[0].numpy(), d_j)
    np.testing.assert_allclose(a_t[0].numpy(), a_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_levels", [1, 4, 8])
def test_pair_call_equals_two_single_calls(n_levels):
    spec, levels, xy = edge_case_inputs(n_levels, 2, seed=20 + n_levels)
    lv, pts = _torch_inputs(levels, xy)
    a2, d2 = OK.orb_describe(lv, pts, spec)
    assert a2.shape == (2, spec.total_capacity)
    assert d2.shape == (2, spec.total_capacity, OK.N_WORDS)
    for b in range(2):
        a1, d1 = OK.orb_describe(lv[b:b + 1], pts[b:b + 1], spec)
        torch.testing.assert_close(a2[b], a1[0], rtol=0, atol=0)
        torch.testing.assert_close(d2[b], d1[0], rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu_only():
    spec, levels, xy = edge_case_inputs(4, 2, seed=3)
    lv, pts = _torch_inputs(levels, xy)
    before = OK.orb_describe.launches
    a1, d1 = OK.orb_describe(lv, pts, spec)
    a2, d2 = OK.orb_describe_reference(lv, pts, spec)
    assert OK.orb_describe.launches == before  # the plain path is no launch
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    with pytest.raises(ValueError):
        OK.orb_describe([[x.double() for x in p] for p in lv], pts, spec)
    with pytest.raises(ValueError):
        OK.orb_describe(lv, pts[:, :-1], spec)
    with pytest.raises(ValueError):
        OK.orb_describe(lv[:1], pts, spec)
    with pytest.raises(ValueError):
        OK.orb_describe([[x.to("meta") for x in p] for p in lv],
                        pts.to("meta"), spec)


def test_extract_orb_pair_equals_single_extractions(frame_image):
    spec = TSpec.create(240, 320, 4, 1.2, 600)
    left = torch.from_numpy(frame_image)
    right = torch.roll(left, 7, dims=1)
    pair = TO.extract_orb_pair(left, right, spec)
    for img, f in zip((left, right), pair):
        g = TO.extract_orb(img, spec)
        for name in f._fields:
            torch.testing.assert_close(getattr(f, name), getattr(g, name),
                                       rtol=0, atol=0, msg=name)


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
