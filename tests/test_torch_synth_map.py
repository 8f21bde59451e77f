"""The port's `io/synth_map.py` against the JAX package's: the same
`default_rng(seed)` draws give the same map, next frame and tracker
state, every table exactly equal (uint32 descriptors as int32 bits; the
reference frame's +-1 bit cache is `_bits_pm1`'s, held equal as a numpy
helper), at a cut size (4 keyframes of 300 features at 640x480, an
8,192-point table) and at bench_mapping.py's widths (2000 features at
KITTI 1241x376, 12 keyframes). The port's map then carries a mapping step
on the CPU (landmarks created, BA with inlier edges, no revert) and a
batch of one tracked frame from the returned state."""

import jax
import numpy as np
import pytest
import torch

from splslam_tpu.io import synth_map as JSM
from splslam_tpu_torch import convert
from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.io import synth_map as TSM
from splslam_tpu_torch.slam import mapping_ops as MO
from splslam_tpu_torch.slam import pipeline as TP

SMALL = dict(n_kfs=4, n_feat=300, p_cap=8192, k_cap=16, q_cap=32, width=640,
             height=480, fx=500.0, seed=5)
BENCH = dict(n_kfs=12, n_feat=2000, width=1241, height=376, fx=718.0,
             baseline=0.54)      # bench_mapping.py:57-60


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tup, prefix=""):
    for f, v in zip(tup._fields, tup):
        if isinstance(v, tuple):
            yield from _leaves(v, f"{prefix}{f}.")
        elif v is not None:
            yield f"{prefix}{f}", v


def _assert_same(port_np, jax_np):
    jl = dict(_leaves(jax_np))
    n = 0
    for name, a in _leaves(port_np):
        b = np.asarray(jl[name])
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
        n += 1
    return n


@pytest.mark.parametrize("kw", [SMALL, BENCH], ids=["small", "bench_mapping"])
def test_synthetic_map_matches_jax(kw):
    jm, jf, js, jT = jax.device_get(JSM.make_synthetic_map(**kw))
    tm, tf, ts, tT = TSM.make_synthetic_map(**kw, device="cpu")
    assert tm.pts.desc.dtype == torch.int32 and tm.kfs.desc.device.type == "cpu"
    assert _assert_same(convert.map_state_to_numpy(tm), jm) == 11 + 8 + 20 + 3
    assert _assert_same(convert.frame_to_numpy(tf), jf) == 7 + 2 + 8
    assert _assert_same(convert.step_state_to_numpy(ts), js) == 17 + 7
    np.testing.assert_array_equal(tT, jT)
    assert int(tm.n_kfs) == kw["n_kfs"] and int(tm.pts.valid.sum()) > kw["n_feat"]


def test_bit_helpers_match_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (50, 256)).astype(np.uint8)
    np.testing.assert_array_equal(TSM._pack_desc(bits), JSM._pack_desc(bits))
    desc = TSM._pack_desc(bits)
    assert desc.dtype == np.uint32
    np.testing.assert_array_equal(TSM._bits_pm1(desc), JSM._bits_pm1(desc))
    np.testing.assert_array_equal(TSM._bits_pm1(desc), bits * 2.0 - 1.0)


@pytest.fixture(scope="module")
def small_map():
    m, frame, step, Tcw_next = TSM.make_synthetic_map(**SMALL, device="cpu")
    cam = Camera.create(SMALL["fx"], SMALL["fx"], SMALL["width"] / 2.0,
                        SMALL["height"] / 2.0, bf=SMALL["fx"] * 0.54,
                        width=SMALL["width"], height=SMALL["height"])
    scales = torch.tensor([1.2 ** i for i in range(8)], dtype=torch.float32)
    return m, frame, step, Tcw_next, cam, scales


def test_mapping_step_runs_on_the_synthetic_map(small_map):
    m, _, _, _, cam, scales = small_map
    m = m.to("cpu")
    n0 = int(m.n_pts)
    kf = int(m.n_kfs) - 1
    m, stats = MO.mapping_step(m, kf, cam, scales, k_bucket=16)
    assert bool(torch.isfinite(stats).all())
    # [n_pts, BA edges, BA inlier edges, chi2, ...] (mapping_ops.MSTAT_*)
    assert int(stats[0]) > n0
    assert int(stats[2]) > 0
    assert int(stats[MO.MSTAT_REVERT]) == 0


def test_tracks_a_frame_from_the_returned_state(small_map):
    """The next frame against the map from the returned tracker state (its
    features and landmark bindings are the frame's own, so the motion
    model finds them)."""
    m, frame, step, Tcw_next, cam, scales = small_map
    m = m.to("cpu")
    m, new, stats = TP.track_frames_batch([frame], m, step, 20.0, int(m.n_kfs) - 1,
                                          cam, scales, m_local=1024)
    assert stats.shape == (1, TP.STATS_LEN)
    assert int(stats[0, TP.S_N_IN]) > 100
    np.testing.assert_allclose(new.Tcw.numpy(), Tcw_next, atol=0.05)
