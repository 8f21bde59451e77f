"""Trajectory re-rooting past culled reference keyframes in the port
(`splslam_tpu_torch/slam/system.py`: `System._on_mapping_result`,
`_TrajEntry`) against the JAX package's, with the cases of
tests/test_traj_reroot.py.

Both packages' host bookkeeping runs on identical bare Systems (the
trajectory, the host keyframe poses and the live reference keyframe,
nothing on a device): a keyframe culled with an anchor re-roots the
entries logged against it, a second cull chains through, and a later
correction of the anchor carries the re-rooted frames with it, read back
through `poses_reconstructed()` against a stub map's final keyframe
poses. Tolerances: reference keyframe ids and the host pose table's keys
equal; Tcr equal to the JAX package's within 1e-6 (the same float32
products); reconstructed poses within 1e-5 (tests/test_traj_reroot.py's
gate)."""

from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from splslam_tpu.slam import system as JS
from splslam_tpu_torch.slam import system as TS

ATOL = 1e-5
TCR_ATOL = 1e-6


def _se3(yaw=0.0, t=(0, 0, 0)):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    T[:3, 3] = t
    return T


def _bare_system(pkg, kf_pose_host, ref_kf, entries, kf_Tcw=None):
    """A System of package `pkg` with only its host bookkeeping: the given
    trajectory entries, host keyframe poses and reference keyframe, no
    pending stats, and (with `kf_Tcw`) a stub map of final keyframe poses."""
    sysm = pkg.System.__new__(pkg.System)
    sysm.trajectory = [pkg._TrajEntry(ts, Tcr.copy(), ref, lost, Tcw.copy())
                       for ts, Tcr, ref, lost, Tcw in entries]
    sysm.kf_pose_host = {k: v.copy() for k, v in kf_pose_host.items()}
    sysm.ref_kf = ref_kf
    sysm._pending, sysm._pending_batches = deque(), deque()
    sysm.mapper = SimpleNamespace(flush=lambda: None)
    if kf_Tcw is not None:
        tcw = torch.from_numpy(kf_Tcw) if pkg is TS else kf_Tcw
        sysm.map = SimpleNamespace(kfs=SimpleNamespace(Tcw=tcw))
    return sysm


def _assert_same_bookkeeping(t, j):
    assert [e.ref_kf for e in t.trajectory] == [e.ref_kf for e in j.trajectory]
    for et, ej in zip(t.trajectory, j.trajectory):
        assert et.Tcr.dtype == ej.Tcr.dtype == np.float32
        np.testing.assert_allclose(et.Tcr, ej.Tcr, rtol=0, atol=TCR_ATOL)
    assert sorted(t.kf_pose_host) == sorted(j.kf_pose_host)
    assert t.ref_kf == j.ref_kf


def _first_case():
    T_culled = _se3(yaw=0.3, t=(1.0, 0.5, 0.0))   # kf 3 pose at cull time
    T_anchor = _se3(yaw=0.1, t=(2.0, 0.0, 0.1))   # kf 7 pose at cull time
    frames = [_se3(yaw=0.3 + d, t=(1.0 + d, 0.5, 0.0)) for d in (0.01, 0.02, 0.03)]
    entries = [(float(i), (Tcw @ np.linalg.inv(T_culled)).astype(np.float32), 3,
                False, Tcw) for i, Tcw in enumerate(frames)]
    entries.append((9.0, np.eye(4, dtype=np.float32), 7, False, T_anchor))
    return T_culled, T_anchor, frames, entries


@pytest.mark.parametrize("correction", [False, True])
def test_reroot_preserves_pose_and_follows_corrections(correction):
    """Three frames logged against kf 3, one against kf 7; kf 3 culled
    with anchor kf 7 (Tcp captured at cull time). With the anchor at its
    cull-time pose the reconstruction is unchanged; after a rigid
    correction of the anchor (a loop closure's; the culled keyframe's
    stored pose does not move) the frames move with it."""
    T_culled, T_anchor, frames, entries = _first_case()
    corr = _se3(yaw=-0.2, t=(0.0, -1.0, 0.3))
    kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    kf_Tcw[3] = T_culled
    kf_Tcw[7] = T_anchor @ corr if correction else T_anchor
    hosts = {3: T_culled, 7: T_anchor}
    j = _bare_system(JS, hosts, 3, entries, kf_Tcw)
    t = _bare_system(TS, hosts, 3, entries, kf_Tcw)
    Tcp = (T_culled @ np.linalg.inv(T_anchor)).astype(np.float32)
    j._on_mapping_result(7, T_anchor, [(3, Tcp)])
    t._on_mapping_result(7, T_anchor, [(3, Tcp)])
    _assert_same_bookkeeping(t, j)
    assert all(e.ref_kf == 7 for e in t.trajectory)
    assert 3 not in t.kf_pose_host and t.ref_kf == 7

    Twc_t, Twc_j = t.poses_reconstructed(), j.poses_reconstructed()
    np.testing.assert_allclose(Twc_t, Twc_j, rtol=0, atol=ATOL)
    want = [Tcw @ corr if correction else Tcw for Tcw in frames]
    for Twc, Tcw in zip(Twc_t[:3], want):
        np.testing.assert_allclose(np.linalg.inv(Twc), Tcw, atol=ATOL)


def test_reroot_chains_through_second_cull():
    """kf 3 re-rooted onto kf 7; later kf 7 itself is culled with anchor
    kf 9: the entry lands on kf 9 with the composed relative pose."""
    T3, T7, T9 = (_se3(yaw=a, t=(a, 0, 0)) for a in (0.3, 0.5, 0.7))
    Tcw = _se3(yaw=0.31, t=(0.35, 0.1, 0.0))
    entries = [(0.0, (Tcw @ np.linalg.inv(T3)).astype(np.float32), 3, False, Tcw)]
    hosts = {3: T3, 7: T7, 9: T9}
    j = _bare_system(JS, hosts, 9, entries)
    t = _bare_system(TS, hosts, 9, entries)
    for sysm in (j, t):
        sysm._on_mapping_result(7, T7, [(3, T3 @ np.linalg.inv(T7))])
        sysm._on_mapping_result(9, T9, [(7, T7 @ np.linalg.inv(T9))])
    _assert_same_bookkeeping(t, j)
    e = t.trajectory[0]
    assert e.ref_kf == 9
    np.testing.assert_allclose(e.Tcr @ T9, Tcw, atol=ATOL)


def test_stale_pose_and_self_cull_are_skipped():
    """`pose=None` (a correction landed after the mapping dispatch) leaves
    the host pose as it was, and a cull list naming the anchor itself
    re-roots nothing, in both packages."""
    T_culled, T_anchor, _, entries = _first_case()
    hosts = {3: T_culled, 7: T_anchor}
    j = _bare_system(JS, hosts, 3, entries)
    t = _bare_system(TS, hosts, 3, entries)
    for sysm in (j, t):
        sysm._on_mapping_result(7, None, [(7, np.eye(4, dtype=np.float32))])
    _assert_same_bookkeeping(t, j)
    np.testing.assert_array_equal(t.kf_pose_host[7], T_anchor)
    assert [e.ref_kf for e in t.trajectory] == [3, 3, 3, 7] and t.ref_kf == 3
