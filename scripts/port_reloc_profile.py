"""Where the time of relocalization, the BoW keyframe database and loop
verification goes in the PyTorch port (`splslam_tpu_torch`), on one GPU.

    python3 scripts/port_reloc_profile.py [--turns 2]

At chip_smoke's KITTI-size configuration (1241x376, 2000 features, 8
levels, local mapping on, a keyframe every 4 frames), on the 40-frame
forward sequence (seed 3):
  1. tracks the sequence with relocalization and loop detection off and
     on, in turns (off, on, on, off for --turns 2), and prints the
     `track_stereo` medians over frames 10-39, all frames and the frames
     that inserted no keyframe;
  2. times, synced, the stages of one relocalization attempt of frame 20
     against the live keyframe made nearest to it, and of one on a blank
     frame: global match, the 192-hypothesis PnP RANSAC, the seed
     pose GN, the two projection rounds; then the whole attempt, and its
     device activities and device ms from torch.profiler (CUDA activity);
  3. the same for one `update_bow_row` and one `query_bow` with the
     bundled 10^5-word vocabulary, and for one `compute_sim3_attempt`
     between the last keyframe and keyframe 0 (with its Sim3 RANSAC and GN
     stages).
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
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_reloc_profile: no CUDA device")
    import chip_smoke as smoke
    from splslam_tpu_torch.bow import vocabulary as V
    from splslam_tpu_torch.io.synthetic import make_stereo_sequence
    from splslam_tpu_torch.optim import sim3 as S3
    from splslam_tpu_torch.optim.pose_gn import PointObs, pose_optimize
    from splslam_tpu_torch.slam import loop_closing as LC
    from splslam_tpu_torch.slam import reloc as R
    from splslam_tpu_torch.slam.frame import build_frame_stereo
    from splslam_tpu_torch.slam.system import Sensor, Settings, System

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    K, bf, frames, _ = make_stereo_sequence(
        n_frames=40, width=smoke.KITTI_W, height=smoke.KITTI_H, fx=718.0,
        baseline=0.54, motion="forward", seed=3)
    base = dataclasses.replace(smoke.kitti_settings(Settings, K, bf),
                               enable_local_mapping=True, force_kf_every=4)
    out = {"card": card, "turns": []}

    def sync_ms(fn, reps=5):
        fn()
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    def run(on: bool):
        st = dataclasses.replace(base, enable_relocalization=on,
                                 enable_loop_closing=on)
        sysm = System(st, Sensor.STEREO, "cuda")
        times, kf_frame = [], []
        for i, (l, r) in enumerate(frames):
            n = sysm.n_kfs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sysm.track_stereo(l, r, i * 0.1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            kf_frame.append(sysm.n_kfs > n)
        sysm.drain()
        t, k = np.array(times[10:]), np.array(kf_frame[10:])
        return sysm, {"reloc_and_loop": on, "median_ms": float(np.median(t)),
                      "median_non_kf_ms": float(np.median(t[~k])),
                      "median_kf_ms": float(np.median(t[k])),
                      "n_kf_frames": int(k.sum())}

    order = []
    for i in range(args.turns):          # off, on, on, off, ...
        order += [False, True] if i % 2 == 0 else [True, False]
    sysm = None
    for on in order:
        s, row = run(on)
        out["turns"].append(row)
        print(f"turn: {row}", flush=True)
        if on:
            sysm = s

    cam, kfs, v = sysm.cam, sysm.map.kfs, sysm.vocab

    def frame_of(imgs):
        t = torch.from_numpy(np.stack(imgs).astype(np.uint8)).cuda()
        return build_frame_stereo(t[0].float(), t[1].float(), cam, sysm.spec,
                                  sysm.scales, sysm.line_cap)

    def profile(fn):
        n, dev_ms, _ = smoke.device_kernels(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return {"device_activities": n, "device_ms": dev_ms, "wall_ms": wall,
                "idle_share": 1.0 - dev_ms / wall}

    blank = np.full(frames[0][0].shape, 128, np.uint8)
    fid = kfs.frame_id[:sysm.n_kfs].cpu().numpy()
    live = kfs.valid[:sysm.n_kfs].cpu().numpy()
    c = int(np.argmin(np.where(live, np.abs(fid - 20), 10 ** 6)))
    out["candidate"] = {"kf": c, "frame": int(fid[c])}
    lm = kfs.lm_idx[c]
    xyz = sysm.map.pts.xyz[lm.clamp(min=0).long()]
    kf_args = (kfs.desc[c], kfs.fvalid[c], lm, xyz)
    for name, imgs in (("frame_20", frames[20]), ("blank", (blank, blank))):
        f = frame_of(imgs)
        gen = torch.Generator(device="cuda")
        dist, gid, axyz = R.global_match(f, *kf_args)
        has = gid >= 0
        samples = R.sample_minimal_sets(gen.manual_seed(0), has, R.N_HYP, 6)
        inv = 1.0 / f.feat.sigma2
        T0, _, inl0 = R.pnp_ransac(cam, f.feat.xy, axyz, inv, has, samples)
        obs = PointObs(xyz_w=axyz, uv=f.feat.xy, inv_sigma2=inv, mask=has & inl0,
                       ur=f.u_right)
        res = pose_optimize(T0, cam, obs)
        pr = (cam, f, dist, kf_args[1], kf_args[2], kf_args[3])
        stages = {
            "global_match": sync_ms(lambda: R.global_match(f, *kf_args)),
            "sample_minimal_sets": sync_ms(
                lambda: R.sample_minimal_sets(gen.manual_seed(0), has, R.N_HYP, 6)),
            "pnp_ransac": sync_ms(lambda: R.pnp_ransac(cam, f.feat.xy, axyz, inv,
                                                       has, samples)),
            "pose_optimize": sync_ms(lambda: pose_optimize(T0, cam, obs)),
            "proj_round": sync_ms(lambda: R.proj_round(*pr, res.Tcw, gid, axyz, 10.0)),
            "reloc_attempt": sync_ms(lambda: R.reloc_attempt(
                cam, f, *kf_args, generator=gen.manual_seed(0))),
        }
        prof = profile(lambda: R.reloc_attempt(cam, f, *kf_args,
                                               generator=gen.manual_seed(0)))
        n_in = int(R.reloc_attempt(cam, f, *kf_args, generator=gen.manual_seed(0))[1])
        out[name] = {"n_matches": int(has.sum()), "n_inliers": n_in,
                     "stages_ms": stages, "profile": prof}
        print(f"{name}: {out[name]}", flush=True)

    f = frame_of(frames[20])
    args_bow = (v.level_desc, v.weights, v.k, v.depth, f.feat.desc, f.feat.valid)
    ids, vals = sysm.kf_bow.ids.clone(), sysm.kf_bow.vals.clone()
    out["bow"] = {
        "transform_words_ms": sync_ms(lambda: V.transform_words(v, f.feat.desc,
                                                                f.feat.valid)),
        "update_bow_row_ms": sync_ms(lambda: V.update_bow_row(ids, vals, *args_bow, 0)),
        "query_bow_ms": sync_ms(lambda: V.query_bow(*args_bow)),
        "update_bow_row_profile": profile(lambda: V.update_bow_row(ids, vals,
                                                                    *args_bow, 0)),
    }
    print(f"bow: {out['bow']}", flush=True)

    K3 = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                       [0.0, 0.0, 1.0]], device="cuda")
    kf, cand = sysm.n_kfs - 1, 0
    gen = torch.Generator(device="cuda")

    def sim3():
        return LC.compute_sim3_attempt(sysm.map, kf, cand, K3, True,
                                       generator=gen.manual_seed(kf))

    n_m, n_opt, n_proj, n_grd, (s, Rm, t) = sim3()
    stage = {}
    run_ransac, run_opt = S3.sim3_ransac, S3.optimize_sim3
    for name, fn in (("sim3_ransac", run_ransac), ("optimize_sim3", run_opt)):
        sink = []
        setattr(S3, name, smoke._timed(fn, sink, "cuda"))
        try:
            for _ in range(5):
                sim3()
        finally:
            setattr(S3, name, fn)
        stage[name] = float(np.median(sink))
    out["sim3"] = {"kf": kf, "cand": cand, "n_matches": int(n_m),
                   "n_sim3_inliers": int(n_opt), "n_proj": int(n_proj),
                   "n_guarded": int(n_grd),
                   "compute_sim3_attempt_ms": sync_ms(sim3), "stages_ms": stage,
                   "profile": profile(sim3)}
    print(f"sim3: {out['sim3']}", flush=True)
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
