"""The comparison that decides `correct`.

Once the window has closed, the program's answers are copied to the host
(`collect`), the System is freed, and the numbers a cell's traffic names
under "checks" are worked out on the CPU against the references:

- `orb_keypoints_off`: over a sample of the window's frames drawn from
  the seed, the keypoints (level, x, y) that the program and the plain
  ORB of `reference/orb.py` do not share, over all they find;
- `orb_bits_off`: the descriptor bits that differ on the keypoints both
  find, over all their bits;
- `pose_err_m`: the largest distance between the camera position a
  tracking call answered and the one the scene was rendered from, over
  every frame of the window;
- `pose_rmse_m`: the root mean square of those distances over every
  frame of the window (the absolute trajectory error);
- `kf_pose_err_m`: the largest distance for every keyframe made in the
  window, with its pose as the local BA left it.

Each number has its limit in `limits/<workload>.json`. The controls are
the reference put in the program's place: the ORB numbers' control is
the plain ORB computed in bfloat16, the precision below the
configuration's float32; the pose numbers' control breaks the guarantee
that a call answers for the frame it was handed, by answering with the
truth of the frame before it (one frame late).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from reference import orb as RO


@dataclass
class Outputs:
    """What the program answered in the window, on the host."""

    answers: dict = field(default_factory=dict)     # frame -> Twc
    attempted: int = 0
    failed: int = 0                                 # frames lost or never answered
    keyframes: list = field(default_factory=list)   # (frame, Twc) made in the window
    sample: list = field(default_factory=list)      # (frame, keypoints) of the sampled frames
    fill: dict = field(default_factory=dict)


def program_keypoints(feat, scale: float) -> RO.Keypoints:
    valid = feat.valid.cpu().numpy()
    lv = feat.octave.cpu().numpy()[valid].astype(np.int64)
    xy = feat.xy.cpu().numpy()[valid].astype(np.float64) / scale ** lv[:, None]
    return RO.Keypoints(lv, np.rint(xy[:, 0]).astype(np.int64), np.rint(xy[:, 1]).astype(np.int64),
                        feat.desc.cpu().numpy()[valid].view(np.uint32))


def collect(loop, window) -> Outputs:
    """Copy the program's answers to the host: every window frame's pose,
    the window's keyframes, the sampled frames' features, the map's fill."""
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
    scale = float(loop.cell.yaml["ORBextractor.scaleFactor"])
    out.sample = [(f, program_keypoints(frame.feat, scale))
                  for f, frame in sorted(loop.sample.items, key=lambda x: x[0])]
    out.fill = {"keyframes": int(s.n_kfs), "max_keyframes": int(s.settings.max_keyframes),
                "points": int(s.map.n_pts), "max_points": int(s.settings.max_points),
                "map_lines": int(s.map.n_lns), "max_map_lines": int(s.settings.max_maplines)}
    return out


def _keyset(kp: RO.Keypoints) -> dict:
    return {(int(l), int(x), int(y)): i for i, (l, x, y) in enumerate(zip(kp.level, kp.x, kp.y))}


def orb_gaps(pairs: list) -> tuple[float, float]:
    """(keypoints off, descriptor bits off) of (candidate, reference)
    keypoint tables, pooled over frames."""
    diff = union = bits = compared = 0
    for cand, ref in pairs:
        a, b = _keyset(cand), _keyset(ref)
        both = a.keys() & b.keys()
        diff += len(a.keys() ^ b.keys())
        union += len(a.keys() | b.keys())
        if both:
            ia = np.array([a[k] for k in both])
            ib = np.array([b[k] for k in both])
            x = np.bitwise_xor(cand.desc[ia], ref.desc[ib])
            bits += int(np.unpackbits(x.view(np.uint8)).sum())
            compared += 256 * len(both)
    return diff / max(union, 1), (bits / compared if compared else 1.0)


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


def numbers(cell, scene, out: Outputs, control: bool = False) -> dict:
    """The numbers this cell compares: the program's, or with `control`
    the control's in the program's place (the plain ORB in bfloat16; each
    pose the truth of the frame before)."""
    checks = cell.traffic["checks"]
    y = cell.yaml

    def late(frames):
        return {f: scene.gt(f - 1) for f in frames}

    res = {}
    if "orb" in checks:
        args = (int(y["ORBextractor.nFeatures"]), int(y["ORBextractor.nLevels"]),
                float(y["ORBextractor.scaleFactor"]))
        pairs = []
        for f, kp in out.sample:
            image = scene.views(f)[0]
            ref = RO.extract(image, *args)
            cand = RO.extract(image, *args, dtype=torch.bfloat16) if control else kp
            pairs.append((cand, ref))
        res["orb_keypoints_off"], res["orb_bits_off"] = orb_gaps(pairs)
    answers = late(out.answers) if control else out.answers
    if "pose" in checks:
        res["pose_err_m"] = pose_err(answers, scene.gt)
    if "pose_rmse" in checks:
        res["pose_rmse_m"] = pose_rmse(answers, scene.gt)
    if "keyframe_pose" in checks:
        kfs = dict(out.keyframes)
        kfs = late(kfs) if control else kfs
        res["kf_pose_err_m"] = pose_err(kfs, scene.gt) if kfs else float("inf")
    return res


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number without a limit is not correct."""
    table = {k: {"value": v, "limit": limits.get(k)} for k, v in values.items()}
    ok = all(t["limit"] is not None and np.isfinite(t["value"]) and t["value"] <= t["limit"]
             for t in table.values())
    return bool(ok and table), table
