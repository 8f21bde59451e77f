"""The arithmetic of a run's timings: frames a second over a window, and
the 95th percentile of call times where ten calls lie beyond it (the
rule of `tail_quantile` in `splslam_tpu_torch/bench/common.py` at commit
ba65753).
"""

from __future__ import annotations

import numpy as np

MIN_TAIL_CALLS = 200     # a p95 needs ten calls beyond it


def frames_per_s(frames: int, window_s: float) -> float:
    """Frames whose call returned inside the window over the window's
    wall (start to the last call's synced end)."""
    if window_s <= 0:
        raise ValueError("empty window")
    return frames / window_s


def p95_ms(call_ms: list[float]) -> float | None:
    """The 95th percentile of every call's synced wall (linear
    interpolation between order statistics), or None with fewer calls
    than a tail needs."""
    if len(call_ms) < MIN_TAIL_CALLS:
        return None
    return float(np.percentile(np.asarray(call_ms, np.float64), 95.0))


def median_ms(call_ms: list[float]) -> float | None:
    return float(np.median(call_ms)) if call_ms else None
