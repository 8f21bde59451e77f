"""Card-vs-CPU spread of one local BA step of the PyTorch port, repeated;
or, with `--gba-lines`, the card's run-to-run spread of a global BA with
line edges.

    python3 scripts/port_ba_spread.py [--root DIR] [--reps 4] [--gba-lines]

Imports `splslam_tpu_torch` from DIR (default: the checkout that holds
this script), so that two trees can be compared in turns on one card.
Builds the map of `tests/test_torch_gpu.py::test_mapping_step_gpu_matches_cpu`
on the CPU (13 frames of the 320x240 forward sequence, a keyframe every
4 frames), then `--reps` times runs `map_upkeep` + `local_ba` on its last
keyframe from identical copies on the card and on the CPU, and prints per
repeat the 99th percentile and the largest distance between the two
runs' window landmarks, the largest keyframe-pose difference and the
inlier agreement (the test's gates: q99 <= 1e-3, poses <= 1e-3,
agreement >= 0.99).

`--gba-lines` builds a monocular point+line map on the CPU instead (20
frames of the 320x240 grid sequence, 128 line slots, the JAX package's
defaults: local mapping with its line stages), then `--reps` times runs
`run_global_ba(rounds=1, with_lines=True)` from identical copies on the
card, and once on the CPU, and prints per repeat the largest pose
difference, the 99th percentile and the largest landmark distance and
the largest line-endpoint distance, against the card's first repeat and
against the CPU (the segment sums of `ba_solve_pcg` are float atomics on
the card).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--gba-lines", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_ba_spread: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from splslam_tpu_torch.io.synthetic import make_stereo_sequence
    from splslam_tpu_torch.slam import mapping_ops as TMO
    from splslam_tpu_torch.slam import system as TS

    if args.gba_lines:
        gba_lines_spread(args, make_stereo_sequence, TS)
        return

    K, bf, frames, _ = make_stereo_sequence(n_frames=13, motion="forward",
                                            width=320, height=240)
    kw = dict(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
              cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
              n_features=600, n_levels=4, th_depth=40.0, fps=10,
              max_points=8192, max_keyframes=64, local_window=1024,
              force_kf_every=4)
    sysm = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    kf = sysm.n_kfs - 1
    for rep in range(args.reps):
        out = {}
        for dev in ("cpu", "cuda"):
            m = sysm.map.to(dev)
            m = m._replace(kfs=type(m.kfs)(*[x[:32] for x in m.kfs]))
            m, _ = TMO.map_upkeep(m, kf, sysm.cam, sysm.scales.to(dev), 1.2, 4)
            m, prob, res = TMO.local_ba(m, kf, sysm.cam, 1.2, 4)
            out[dev] = (prob, res)
        (pc, rc), (_, rg) = out["cpu"], out["cuda"]
        d = (rg.xyz.cpu() - rc.xyz).norm(dim=-1)[pc.lm_ok]
        agree = (rg.e_inlier.cpu() == rc.e_inlier)[pc.e_ok].float().mean()
        print(f"{args.root} rep {rep}: landmarks {int(pc.lm_ok.sum())}, q99 "
              f"{float(torch.quantile(d, 0.99)):.3e}, max {float(d.max()):.3e}, "
              f"pose {float((rg.Tcw.cpu() - rc.Tcw).abs().max()):.3e}, "
              f"inlier agreement {float(agree):.5f}", flush=True)


def gba_lines_spread(args, make_stereo_sequence, TS) -> None:
    import types

    import torch

    from splslam_tpu_torch.slam import loop_closing as TLC

    K, _, frames, _ = make_stereo_sequence(n_frames=20, motion="lateral", width=320,
                                           height=240, texture="grid")
    st = TS.Settings(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                     cy=float(K[1, 2]), width=320, height=240, n_features=600,
                     n_levels=4, fps=10, max_points=8192, max_keyframes=64,
                     local_window=1024, using_line=True, line_features=128)
    sysm = TS.System(st, TS.Sensor.MONOCULAR, "cpu")
    for i, (l, _) in enumerate(frames):
        sysm.track_mono(l, i * 0.1)
    sysm.drain()

    def gba(dev):
        stub = types.SimpleNamespace(map=sysm.map.to(dev), n_kfs=sysm.n_kfs,
                                     device=torch.device(dev), cam=sysm.cam,
                                     kf_pose_host={}, map_version=0)
        res = TLC.LoopCloser(stub).run_global_ba(rounds=1, with_lines=True)
        return res.Tcw.cpu(), stub.map.pts.xyz.cpu(), stub.map.lns.xyz.cpu()

    ok, lv = sysm.map.pts.valid, sysm.map.lns.valid
    print(f"{args.root}: {sysm.n_kfs} keyframes, {int(ok.sum())} points, "
          f"{int(lv.sum())} map lines", flush=True)
    ref_cpu = gba("cpu")
    first = None
    for rep in range(args.reps):
        run = gba("cuda")
        first = first or run
        for name, ref in (("card rep 0", first), ("CPU", ref_cpu)):
            d = (run[1] - ref[1]).norm(dim=-1)[ok]
            print(f"{args.root} rep {rep} vs {name}: pose "
                  f"{float((run[0] - ref[0]).abs().max()):.3e}, landmarks q99 "
                  f"{float(torch.quantile(d, 0.99)):.3e} max {float(d.max()):.3e}, "
                  f"line endpoints max {float((run[2] - ref[2])[lv].norm(dim=-1).max()):.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
