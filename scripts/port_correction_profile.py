"""Where the time of a loop correction and of a global BA goes in the
PyTorch port (`splslam_tpu_torch`), on one GPU.

    python3 scripts/port_correction_profile.py [--reps 3]

  1. Runs the 98-frame loop circuit (`make_loop_circuit`, tests/test_loop.py's
     settings, correction off) on the card and takes its verified loop.
     Then, `--reps` times from identical copies of that map: the stages of
     `LoopCloser._correct` (essential-graph assembly on the host,
     `pose_graph_sim3`, `_apply_pose_graph`, `loop_search_and_fuse`,
     `run_global_ba`) timed synced, and `_correct` whole; and once each
     under torch.profiler (CUDA activity): device activities and device
     ms, with the synced wall ms of a run without the profiler and the
     idle share that gives.
  2. Tracks chip_smoke's 40 KITTI-size frames with local mapping on and a
     keyframe every 4 frames, then times and profiles
     `run_global_ba(rounds=1)` over that map (keyframe bucket 32, 64,000
     edge rows, 65,536 points) and `ba_solve_pcg` alone.
  3. The segment sums of `ba_solve_pcg` at that size: `index_add_` of
     [E,3] rows into the landmark table and of [E,6] rows into the camera
     table with the edge table's own (unsorted) index, and with the rows
     gathered into sorted order first (the gather inside the timing, as a
     matrix-vector product would pay it), by CUDA events.
Prints the card line and one JSON line with every number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_correction_profile: no CUDA device")
    import chip_smoke as smoke
    from splslam_tpu_torch.io.synthetic import make_loop_circuit, make_stereo_sequence
    from splslam_tpu_torch.optim import ba as BA
    from splslam_tpu_torch.optim import sim3 as S3
    from splslam_tpu_torch.slam import loop_closing as LC
    from splslam_tpu_torch.slam.system import Sensor, Settings, System

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    out = {"card": card}

    def profile(fn, before=lambda: None):
        """Device activities and ms of one fn() under torch.profiler, and
        the synced wall of another without it; `before` resets the state."""
        before()
        n, dev_ms, _ = smoke.device_kernels(fn)
        before()
        wall: list[float] = []
        smoke._timed(fn, wall, "cuda")()
        return {"device_activities": n, "device_ms": dev_ms, "wall_ms": wall[0],
                "idle_share": 1.0 - dev_ms / wall[0]}

    # ---- 1. one correction on the circuit map ----
    K, bf, frames, _ = make_loop_circuit()
    sysm = System(smoke.circuit_settings(Settings, K, bf, False), Sensor.STEREO, "cuda")
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.2)
    sysm.drain()
    lc = sysm.loop_closer
    kf, cand = lc.verified_loops[0]
    K3 = torch.from_numpy(K).cuda()
    gen = torch.Generator(device="cuda")
    *_, S12 = LC.compute_sim3_attempt(sysm.map, kf, cand, K3, True,
                                      generator=gen.manual_seed(kf))
    map0 = sysm.map.to("cuda")
    kph0 = dict(sysm.kf_pose_host)

    def restore():
        sysm.map = map0.to("cuda")
        sysm.kf_pose_host = dict(kph0)
        lc.loop_edges, lc.corrections = [], 0

    names = ("_build_pose_graph_edges", "pose_graph_sim3", "_apply_pose_graph",
             "loop_search_and_fuse", "run_global_ba", "_correct")
    stage_ms = {k: [] for k in names}
    originals = {"_build_pose_graph_edges": (LC, LC._build_pose_graph_edges),
                 "pose_graph_sim3": (S3, S3.pose_graph_sim3),
                 "_apply_pose_graph": (LC, LC._apply_pose_graph),
                 "loop_search_and_fuse": (LC, LC.loop_search_and_fuse)}
    for name, (mod, fn) in originals.items():
        setattr(mod, name, smoke._timed(fn, stage_ms[name], "cuda"))
    lc.run_global_ba = smoke._timed(lc.run_global_ba, stage_ms["run_global_ba"], "cuda")
    try:
        for _ in range(args.reps + 1):        # the first repeat warms up
            restore()
            smoke._timed(lc._correct, stage_ms["_correct"], "cuda")(kf, cand, S12)
    finally:
        for name, (mod, fn) in originals.items():
            setattr(mod, name, fn)
        del lc.run_global_ba
    n = sysm.n_kfs
    Kb = LC._k_bucket(sysm.map.kfs.Tcw.shape[0], n)
    restore()
    edges = LC._build_pose_graph_edges(sysm.map, n, kf, cand, S12)
    Tcw = sysm.map.kfs.Tcw[:Kb]
    free = (torch.arange(Kb, device="cuda") < n) & (torch.arange(Kb, device="cuda") != 0)
    pg = lambda: S3.pose_graph_sim3(
        torch.ones((Kb,), device="cuda"), Tcw[:, :3, :3], Tcw[:, :3, 3], free, edges,
        iters=15, fix_scale=True)
    out["correction"] = {
        "loop": [kf, cand], "n_kfs": n, "k_bucket": Kb, "edges": int(edges.i.shape[0]),
        "n_guarded": lc.n_guarded,
        "stages_ms": {k: float(np.median(v[1:])) for k, v in stage_ms.items()},
        "pose_graph_sim3_profile": profile(pg),
        "run_global_ba_profile": profile(lambda: lc.run_global_ba(rounds=1)),
    }
    out["correction"]["_correct_profile"] = profile(
        lambda: lc._correct(kf, cand, S12), before=restore)
    print(f"correction: {out['correction']}", flush=True)

    # ---- 2. global BA at KITTI size ----
    K, bf, frames, _ = make_stereo_sequence(
        n_frames=40, width=smoke.KITTI_W, height=smoke.KITTI_H, fx=718.0,
        baseline=0.54, motion="forward", seed=3)
    st = dataclasses.replace(smoke.kitti_settings(Settings, K, bf),
                             enable_local_mapping=True, force_kf_every=4)
    sysm = System(st, Sensor.STEREO, "cuda")
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    lc = sysm.loop_closer
    probs = []
    solve = BA.ba_solve_pcg
    LC.ba_solve_pcg = lambda cam, p, **kw: probs.append(p) or solve(cam, p, **kw)
    try:
        gba_ms = []
        for _ in range(args.reps + 1):
            smoke._timed(lc.run_global_ba, gba_ms, "cuda")(rounds=1)
    finally:
        LC.ba_solve_pcg = solve
    p = probs[-1]
    out["global_ba"] = {
        "n_kfs": sysm.n_kfs, "edge_rows": int(p.e_ok.shape[0]),
        "edges_ok": int(p.e_ok.sum()), "points": int(p.xyz.shape[0]),
        "n_guarded": lc.n_guarded,
        "run_global_ba_ms": float(np.median(gba_ms[1:])),
        "ba_solve_pcg_ms": smoke.cuda_ms(lambda: solve(sysm.cam, p, rounds=1),
                                         reps=5, warmup=1),
        "profile": profile(lambda: lc.run_global_ba(rounds=1)),
    }
    print(f"global_ba: {out['global_ba']}", flush=True)

    # ---- 3. the segment sums, unsorted against sorted ----
    E, L, C = p.e_lm.shape[0], p.xyz.shape[0], p.Tcw.shape[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    scat = {}
    for name, idx, size, width in (("landmarks", p.e_lm.long(), L, 3),
                                   ("cameras", p.e_cam.long(), C, 6)):
        rows = torch.randn((E, width), device="cuda", generator=g)
        order = torch.argsort(idx, stable=True)
        sidx = idx[order]
        scat[name] = {
            "unsorted_ms": smoke.cuda_ms(lambda: torch.zeros(
                (size, width), device="cuda").index_add_(0, idx, rows)),
            "gather_then_sorted_ms": smoke.cuda_ms(lambda: torch.zeros(
                (size, width), device="cuda").index_add_(0, sidx, rows[order])),
        }
    out["segment_sums"] = {"E": E, **scat}
    print(f"segment_sums: {out['segment_sums']}", flush=True)
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
