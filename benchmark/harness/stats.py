"""The arithmetic of a run's timings: frames a second over a window, and
the 95th percentile of every call's time in it.

A cell that reports `frame_ms_p95` has to report it in every run, so the
tail is taken over however many calls the window holds: at the live
cell's rate on an H100 a 51 s window holds 150 to 320 calls, seven to
sixteen beyond the 95th percentile, fewer on a slower host, and the
tail is the tail of all of them.
"""

from __future__ import annotations

import numpy as np


def frames_per_s(frames: int, window_s: float) -> float:
    """Frames whose call returned inside the window over the window's
    wall (start to the last call's synced end)."""
    if window_s <= 0:
        raise ValueError("empty window")
    return frames / window_s


def p95_ms(call_ms: list[float]) -> float | None:
    """The 95th percentile of every call's synced wall (linear
    interpolation between order statistics), or None for no calls."""
    if not call_ms:
        return None
    return float(np.percentile(np.asarray(call_ms, np.float64), 95.0))


def median_ms(call_ms: list[float]) -> float | None:
    return float(np.median(call_ms)) if call_ms else None
