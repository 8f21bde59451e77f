"""The mean of the program's `map.local_ba` spans (host ms: local BA's
window, solve and write-back as the host enqueues them) over the
keyframes made in the window's untraced calls."""

import numpy as np

from harness import program_spans as P

LAYER = "mapping"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms_p95"


def read(ctx):
    calls = P.window_calls(ctx, traced=False)
    if calls is None:
        return None
    ms = [(r[3] - r[2]) / 1e6 for _, s in calls for r in s if r[1] == "map.local_ba"]
    return float(np.mean(ms)) if ms else None
