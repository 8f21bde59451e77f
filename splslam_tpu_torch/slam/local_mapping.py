"""Local mapping: the host side of the per-keyframe mapping step (port of
splslam_tpu/slam/local_mapping.py).

Right after a keyframe is inserted, `LocalMapper.on_keyframe` enqueues
`mapping_ops.mapping_step` on the device and starts copying its small
stats vector to the host. The vector is read one keyframe LATE (the next
`on_keyframe`, or `flush` from `System.drain`), so the host never waits
for the step it has just enqueued. That lag decides when the stepped
keyframe's post-BA pose reaches `System.kf_pose_host`, and so which pose
later frames are logged against; it is the reference's.
"""

from __future__ import annotations

from splslam_tpu_torch.slam import mapping_ops
from splslam_tpu_torch.slam.mapping_ops import (MAX_KF_CULL, MSTAT_CULL,
                                                MSTAT_GUARD, MSTAT_LMSING,
                                                MSTAT_POSE, MSTAT_REVERT)
from splslam_tpu_torch.trace import HostRead


class LocalMapper:
    def __init__(self, system):
        self.sys = system
        self._pending = None     # (HostRead of stats, kf, map_version)
        self.big_change_idx = 0  # reference Map::mnBigChangeIdx
        self.n_steps = 0
        # BAResult guard counters summed over the run: transient camera-
        # step zeroings (rate-bounded), non-finite end-state reverts (must
        # stay 0), single-landmark step zeroings (benign).
        self.n_guarded = 0
        self.n_state_revert = 0
        self.n_lm_singular = 0

    def on_keyframe(self, kf_idx: int):
        sys = self.sys
        if not sys.settings.enable_local_mapping or sys.n_kfs < 2:
            return
        # Keyframe-axis bucket: the next power of two >= the live count,
        # floor 32, as the reference.
        kb = min(sys.map.kfs.Tcw.shape[0],
                 max(32, 1 << (sys.n_kfs - 1).bit_length()))
        sys.map, stats = mapping_ops.mapping_step(
            sys.map, kf_idx, sys.cam, sys.scales,
            scale_factor=sys.settings.scale_factor,
            n_levels=sys.settings.n_levels,
            ba_rounds=sys.settings.local_ba_rounds,
            ba_iters=sys.settings.local_ba_iters,
            # cnThObs: 2 mono / 3 stereo (reference LocalMapping.cc:419)
            th_obs=2 if sys.sensor.name == "MONOCULAR" else 3,
            with_lines=sys.settings.using_line,
            k_bucket=kb,
        )
        fetch = HostRead(stats)
        self.flush()  # consume the PREVIOUS step's bookkeeping first
        self._pending = (fetch, kf_idx, sys.map_version)
        self.big_change_idx += 1
        self.n_steps += 1
        # The step may have moved landmarks the live tracker state caches.
        if sys.step is not None:
            sys.step = sys.step._replace(
                lm_xyz=sys.map.pts.xyz[sys.step.lm_gid.clamp(min=0).long()])

    def flush(self):
        if self._pending is None:
            return
        fetch, kf, version = self._pending
        self._pending = None
        v = fetch.get()
        pose = v[MSTAT_POSE:MSTAT_POSE + 16].reshape(4, 4)
        culled = []
        for i in range(MAX_KF_CULL):
            off = MSTAT_CULL + i * 17
            cid = int(v[off])
            if cid >= 0:
                culled.append((cid, v[off + 1:off + 17].reshape(4, 4)))
        self.n_guarded += int(v[MSTAT_GUARD])
        self.n_state_revert += int(v[MSTAT_REVERT])
        self.n_lm_singular += int(v[MSTAT_LMSING])
        # A correction that landed after the dispatch makes this post-BA
        # pose stale: skip it; the culled keyframes' Tcp is relative and
        # still applies.
        stale = version != self.sys.map_version
        self.sys._on_mapping_result(kf, None if stale else pose, culled)
