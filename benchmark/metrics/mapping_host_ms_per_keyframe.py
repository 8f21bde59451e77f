"""The mean of the System's own host timer "Mapping total / keyframe" over
the window's keyframes, outside the profiler where any ran outside it:
the host wall of each local mapping step as the program enqueues it."""

import numpy as np

LAYER = "mapping"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms_p95"


def read(ctx):
    ms = ctx.window.mapping_ms
    lo, hi = ctx.window.mapping_traced
    ms = (ms[:lo] + ms[hi:]) or ms
    return float(np.mean(ms)) if ms else None
