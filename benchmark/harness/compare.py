"""The comparison that decides `correct`.

Once the window has closed, the program's answers are copied to the host
(`collect`), the System is freed, and each check that a cell's traffic
names under "checks" works out its numbers on the CPU against its own
reference: `checks/<name>.py`, found by name, whose `read(cell, scene,
out, control)` returns {number: value}, the program's, or with `control`
its control's in the program's place. Each number has its limit in
`limits/<workload>.json`, and `judge` holds it there.

A check reads the cell, the scene the frames were rendered from, and the
`Outputs`: every window frame's answered pose, the window's keyframes as
local BA left them, and a host copy of each sampled frame's whole
`FrameData` (keypoints, descriptors, stereo depth, lines). Here is the
arithmetic that checks share: the gaps between answered and true camera
positions, and the control that answers each frame with the truth of the
frame before (one frame late), which breaks the guarantee that a call
answers for the frame it was handed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from harness import cell as C


@dataclass
class Outputs:
    """What the program answered in the window, on the host."""

    answers: dict = field(default_factory=dict)     # frame -> Twc
    attempted: int = 0
    failed: int = 0                                 # frames lost or never answered
    keyframes: list = field(default_factory=list)   # (frame, Twc) made in the window
    sample: list = field(default_factory=list)      # (frame, FrameData) of the sampled frames
    fill: dict = field(default_factory=dict)


def to_host(x):
    """`x` with every tensor in it, through nested named tuples, on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    return x


def collect(loop, window) -> Outputs:
    """Copy the program's answers to the host: every window frame's pose,
    the window's keyframes, the sampled frames, the map's fill."""
    s, sc = loop.sys, loop.scene
    s.drain()
    lo, hi = window.first_frame(), window.calls[-1].frame
    out = Outputs(attempted=window.frames)
    lost = set()
    for e in s.trajectory:
        f = sc.frame_of(e.ts)
        if lo <= f <= hi:
            out.answers[f] = np.linalg.inv(e.Tcw.astype(np.float64))
            if e.lost:
                lost.add(f)
            else:
                lost.discard(f)
    out.failed = len(lost) + (hi - lo + 1 - len(out.answers))
    kfs = s.map.kfs
    n0, n1 = window.n_kfs0, s.n_kfs
    if n1 > n0:
        Tcw = kfs.Tcw[n0:n1].cpu().numpy().astype(np.float64)
        ok = kfs.valid[n0:n1].cpu().numpy()
        ts = kfs.ts[n0:n1].cpu().numpy()
        out.keyframes = [(sc.frame_of(float(t)), np.linalg.inv(T)) for T, t, v in zip(Tcw, ts, ok) if v]
    out.sample = [(f, to_host(frame)) for f, frame in sorted(loop.sample.items, key=lambda x: x[0])]
    out.fill = {"keyframes": int(s.n_kfs), "max_keyframes": int(s.settings.max_keyframes),
                "points": int(s.map.n_pts), "max_points": int(s.settings.max_points),
                "map_lines": int(s.map.n_lns), "max_map_lines": int(s.settings.max_maplines)}
    return out


def _gaps(answers: dict, truth) -> np.ndarray:
    """The distance between answered and true camera positions, a frame."""
    frames = sorted(answers)
    est = np.stack([answers[f][:3, 3] for f in frames])
    gt = np.stack([truth(f)[:3, 3] for f in frames])
    return np.linalg.norm(est - gt, axis=1)


def pose_err(answers: dict, truth) -> float:
    """The largest distance between answered and true camera positions."""
    return float(np.max(_gaps(answers, truth)))


def pose_rmse(answers: dict, truth) -> float:
    """The root mean square of the gaps between answered and true camera
    positions over every frame (the absolute trajectory error)."""
    return float(np.sqrt(np.mean(_gaps(answers, truth) ** 2)))


def late(scene, frames) -> dict:
    """The control of a pose: each frame answered with the truth of the
    frame before."""
    return {f: scene.gt(f - 1) for f in frames}


def numbers(cell, scene, out: Outputs, control: bool = False) -> dict:
    """The numbers this cell compares, check by check in its traffic's
    order: the program's, or with `control` the controls' in its place."""
    res = {}
    for name in cell.traffic["checks"]:
        res.update(C.check(name).read(cell, scene, out, control))
    return res


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number without a limit is not correct."""
    table = {k: {"value": v, "limit": limits.get(k)} for k, v in values.items()}
    ok = all(t["limit"] is not None and np.isfinite(t["value"]) and t["value"] <= t["limit"]
             for t in table.values())
    return bool(ok and table), table
