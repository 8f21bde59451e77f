"""The median synced wall of the one-frame calls in which System.n_kfs did
not grow (no keyframe, no mapping step), outside the profiler."""

import numpy as np

LAYER = "tracking"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(ctx):
    calls = [c for c in ctx.window.calls if c.n_frames == 1 and not c.kf_grew]
    untraced = [c for c in calls if not c.traced]
    ms = [c.ms for c in (untraced or calls)]
    return float(np.median(ms)) if ms else None
