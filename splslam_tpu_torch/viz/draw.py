"""Headless frame overlay + map rendering (port of splslam_tpu/viz/draw.py).

- `draw_frame` re-creates FrameDrawer::DrawFrame(Both) (reference
  src/FrameDrawer.cc:38-129): tracked keypoints as green squares, tracked
  line segments in red, with the status text bar.
- `plot_map` re-creates the MapDrawer content (src/MapDrawer.cc:45-234:
  DrawMapPoints black / reference points red, DrawMapLines, DrawKeyFrames
  frusta, trajectory) as a top-down matplotlib figure saved to disk.

The tracker replaces `system.step` every frame and updates the map's
tables in place, possibly while the `Viewer` thread draws: each reader
takes `system.step` and `system.map` into locals once and copies every
table it draws with one host copy (`_host`), so a table is never read half
old, half new. The copies wait for the card; never draw while
`torch.cuda.set_sync_debug_mode("error")` is on.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(t) -> np.ndarray:
    """One host copy of a table (a tensor on any device, or an array)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.array(t)


def draw_frame(img: np.ndarray, kp_xy: np.ndarray, kp_tracked: np.ndarray,
               lines_seg: np.ndarray | None = None,
               lines_tracked: np.ndarray | None = None,
               state_text: str = "") -> np.ndarray:
    """Grayscale image + feature tables -> BGR overlay image."""
    import cv2

    out = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR)
    for (x, y), ok in zip(kp_xy, kp_tracked):
        if not ok:
            continue
        p1 = (int(x) - 3, int(y) - 3)
        p2 = (int(x) + 3, int(y) + 3)
        cv2.rectangle(out, p1, p2, (0, 255, 0), 1)
        cv2.circle(out, (int(x), int(y)), 1, (0, 255, 0), -1)
    if lines_seg is not None and lines_tracked is not None:
        for (sx, sy, ex, ey), ok in zip(lines_seg, lines_tracked):
            if not ok:
                continue
            cv2.line(out, (int(sx), int(sy)), (int(ex), int(ey)),
                     (0, 0, 255), 2)
    if state_text:
        h = out.shape[0]
        cv2.rectangle(out, (0, h - 22), (out.shape[1], h), (0, 0, 0), -1)
        cv2.putText(out, state_text, (6, h - 6), cv2.FONT_HERSHEY_PLAIN,
                    1.0, (255, 255, 255), 1)
    return out


def render_current_frame(system, image: np.ndarray) -> np.ndarray:
    """FrameDrawer::Update + DrawFrame against the live tracker state."""
    st, m = system.step, system.map
    if st is None:
        return draw_frame(image, np.zeros((0, 2)), np.zeros((0,), bool),
                          state_text=system.state.name)
    kp = _host(st.frame.feat.xy)
    tracked = _host(st.lm_gid) >= 0
    seg = _host(st.frame.lines.seg)
    lt = _host(st.ll_gid) >= 0
    n_pts = int(_host(m.pts.valid).sum())
    txt = (f"{system.state.name}  KFs:{system.n_kfs} "
           f"MPs:{n_pts}  matches:{int(tracked.sum())}")
    return draw_frame(image, kp, tracked, seg, lt, txt)


def _trajectory(system, kf_Tcw: np.ndarray) -> np.ndarray:
    """Per-frame Twc against the keyframe poses `kf_Tcw`, as
    `System.poses_reconstructed` computes them but without draining the
    tracker's queue (the viewer thread must not consume it)."""
    traj = list(system.trajectory)
    if not traj:
        return np.zeros((0, 4, 4))
    eye = np.eye(4)
    return np.stack([np.linalg.inv(e.Tcr @ (kf_Tcw[e.ref_kf] if e.ref_kf >= 0
                                            else eye)) for e in traj])


def plot_map(system, path: str, top_down: bool = True) -> None:
    """Save a map figure: landmarks, map-lines, keyframe positions,
    per-frame trajectory."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = system.map
    pts = _host(m.pts.xyz)[_host(m.pts.valid)]
    kf_valid = _host(m.kfs.valid)
    kf_Tcw = _host(m.kfs.Tcw)
    Twc = np.linalg.inv(kf_Tcw[kf_valid]) if kf_valid.any() \
        else np.zeros((0, 4, 4))
    traj = _trajectory(system, kf_Tcw)
    lns_v = _host(m.lns.valid)
    lns = _host(m.lns.xyz)[lns_v] if lns_v.any() else np.zeros((0, 3, 3))

    ax_a, ax_b = (0, 2) if top_down else (0, 1)
    fig, ax = plt.subplots(figsize=(8, 8))
    if len(pts):
        ax.scatter(pts[:, ax_a], pts[:, ax_b], s=1, c="k", alpha=0.4,
                   label=f"map points ({len(pts)})")
    for seg in lns:
        ax.plot([seg[0, ax_a], seg[2, ax_a]], [seg[0, ax_b], seg[2, ax_b]],
                "r-", lw=1.2)
    if len(traj):
        ax.plot(traj[:, ax_a, 3], traj[:, ax_b, 3], "b-", lw=1,
                label="trajectory")
    if len(Twc):
        ax.scatter(Twc[:, ax_a, 3], Twc[:, ax_b, 3], marker="s", s=14,
                   c="tab:green", label=f"keyframes ({len(Twc)})")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]" if top_down else "y [m]")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
