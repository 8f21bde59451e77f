"""Card-vs-CPU spread of one local BA step of the PyTorch port, repeated;
with `--gba-lines`, the card's run-to-run spread of a global BA with
line edges; with `--solves`, the run-to-run spread, synced ms and device
activities of each global solve at chip_smoke.py's sizes.

    python3 scripts/port_ba_spread.py [--root DIR] [--reps 4] [--gba-lines | --solves]

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
against the CPU, and "equal" where every output equals the first
repeat's to the bit, else the first output that differs. The segment
sums of `ba_solve_pcg` run in one fixed order (`ops/segsum.py`), so the
repeats should be equal; the card and the CPU differ by the rounding of
the products around the sums.

`--solves` runs, on the card, `--reps` times from identical copies each:
`run_global_ba(rounds=1)` over chip_smoke phase 5's map (40 KITTI-size
frames with mapping: 64,000 edge rows), `pose_graph_sim3` with the inputs
`_correct` gives it and `_correct` itself on phase 7's circuit map with
phase 8's injected drift, `run_global_ba(rounds=1, with_lines=True)` on
the `--gba-lines` map, and `gba_sharded` at world 1 over NCCL at
`make_gba_problem()`'s size (phase 15 d's schedule). Per solve: the
synced ms of each repeat, the device activities and device ms of one
more under torch.profiler (chip_smoke's `device_kernels`), and for each
repeat "equal" or the first output that differs and each output's
largest difference to the first (for a global BA also the landmarks'
99th percentile). Where the tree has `ops/segsum.py`, the full-width
global BA runs once more with its sums by the kernel's plain version
(the pairwise tree in PyTorch ops), the candidate the kernel was chosen
over.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=4)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--gba-lines", action="store_true")
    mode.add_argument("--solves", action="store_true")
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
    if args.solves:
        solves(args, make_stereo_sequence, TS)
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


def line_map(make_stereo_sequence, TS):
    """The monocular point+line map of `--gba-lines`, built on the CPU."""
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
    return sysm


def gba_stub(sysm, dev):
    """The host state `run_global_ba` reads, with a copy of the map on `dev`."""
    import types

    import torch

    return types.SimpleNamespace(map=sysm.map.to(dev), n_kfs=sysm.n_kfs,
                                 device=torch.device(dev), cam=sysm.cam,
                                 kf_pose_host={}, map_version=0)


def gaps(run, ref, ok, lv) -> str:
    """Largest pose difference, landmark q99 and max distance, line-endpoint
    distance of `run` against `ref` (Tcw, point xyz, line xyz)."""
    import torch

    d = (run[1] - ref[1]).norm(dim=-1)[ok]
    lines = (run[2] - ref[2])[lv].norm(dim=-1)
    return (f"pose {float((run[0] - ref[0]).abs().max()):.3e}, landmarks q99 "
            f"{float(torch.quantile(d, 0.99)):.3e} max {float(d.max()):.3e}, "
            f"line endpoints max {float(lines.max()) if lines.numel() else 0.0:.3e}")


def gba_lines_spread(args, make_stereo_sequence, TS) -> None:
    from splslam_tpu_torch.slam import loop_closing as TLC

    sysm = line_map(make_stereo_sequence, TS)

    def gba(dev):
        stub = gba_stub(sysm, dev)
        res = TLC.LoopCloser(stub).run_global_ba(rounds=1, with_lines=True)
        m = stub.map
        return (res.Tcw.cpu(), m.pts.xyz.cpu(), m.lns.xyz.cpu(), res.xyz.cpu(),
                res.e_inlier.cpu(), res.chi2.cpu(), res.n_guarded.cpu())

    names = ("Tcw", "map points", "map lines", "xyz", "e_inlier", "chi2", "n_guarded")
    ok, lv = sysm.map.pts.valid, sysm.map.lns.valid
    print(f"{args.root}: {sysm.n_kfs} keyframes, {int(ok.sum())} points, "
          f"{int(lv.sum())} map lines", flush=True)
    ref_cpu = gba("cpu")
    first = None
    for rep in range(args.reps):
        run = gba("cuda")
        first = first or run
        print(f"{args.root} rep {rep} vs card rep 0: {gaps(run, first, ok, lv)}; "
              f"{first_difference(names, run, first)}", flush=True)
        print(f"{args.root} rep {rep} vs CPU: {gaps(run, ref_cpu, ok, lv)}", flush=True)


def chip_smoke():
    """This checkout's chip_smoke.py (DIR may hold another), as a module."""
    import importlib.util

    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      HERE / "chip_smoke.py")
        sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["chip_smoke"])
    return sys.modules["chip_smoke"]


def first_difference(names, a, b) -> str:
    import torch

    for name, x, y in zip(names, a, b):
        if not torch.equal(x, y):
            return f"first difference: {name}"
    return "equal"


def repeat(name, args, card, prepare, solve, outputs, names, gap=None) -> None:
    """`prepare()` then `solve()` `--reps` times, then once more under the
    profiler; prints ms, device activities and each repeat against the
    first."""
    import numpy as np
    import torch


    CS = chip_smoke()
    ms, outs = [], []
    for _ in range(args.reps):
        prepare()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(tuple(x.clone() for x in outputs(res)))
    prepare()
    n_dev, dev_ms, _ = CS.device_kernels(solve)
    diffs = [first_difference(names, o, outs[0]) for o in outs[1:]]
    extra = "; ".join(gap(o, outs[0]) for o in outs[1:]) if gap else ""
    largest = [", ".join(f"{n} {largest_difference(x, y):.3e}"
                         for n, x, y in zip(names, o, outs[0])) for o in outs[1:]]
    print(f"{args.root} {name}: synced ms {[round(x, 2) for x in ms]} (median "
          f"{np.median(ms):.2f}); one more under torch.profiler: {n_dev} device "
          f"activities, {dev_ms:.3f} ms device time; repeats vs the first: {diffs}"
          f"{'; ' + extra if extra else ''}; largest differences: {largest}; "
          f"on {card}", flush=True)


def largest_difference(x, y) -> float:
    """max |x - y| of two outputs (of a boolean one: the entries that
    differ)."""
    import torch

    if x.dtype == torch.bool:
        return float((x != y).sum())
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def solves(args, make_stereo_sequence, TS) -> None:
    import dataclasses

    import torch

    from splslam_tpu_torch.convert import ba_problem_to_numpy
    from splslam_tpu_torch.graft_entry import make_gba_problem
    from splslam_tpu_torch.optim import sim3 as S3
    from splslam_tpu_torch.parallel.gba_sharded import solve_on_rank
    from splslam_tpu_torch.parallel.mesh import launch
    from splslam_tpu_torch.slam import loop_closing as TLC

    CS = chip_smoke()
    card = CS.card_line()
    gba_names = ("Tcw", "xyz", "e_inlier", "chi2", "n_guarded", "map Tcw",
                 "map points", "map lines")

    def gba_outputs(res, m):
        return (res.Tcw, res.xyz, res.e_inlier, res.chi2, res.n_guarded,
                m.kfs.Tcw, m.pts.xyz, m.lns.xyz)

    def gba_gap(o, ref):
        d = (o[6] - ref[6]).norm(dim=-1)
        return (f"pose {float((o[0] - ref[0]).abs().max()):.3e}, landmarks q99 "
                f"{float(torch.quantile(d.cpu(), 0.99)):.3e} max {float(d.max()):.3e}, "
                f"line endpoints max {float((o[7] - ref[7]).norm(dim=-1).max()):.3e}")

    # run_global_ba at full width over phase 5's map
    K, bf, leg, _ = make_stereo_sequence(
        n_frames=CS.BATCH_FRAMES, width=CS.KITTI_W, height=CS.KITTI_H, fx=718.0,
        baseline=0.54, motion="forward", seed=3)
    st = dataclasses.replace(CS.kitti_settings(TS.Settings, K, bf),
                             enable_local_mapping=True, force_kf_every=4)
    sysm = TS.System(st, TS.Sensor.STEREO, "cuda")
    for i, (l, r) in enumerate(leg[:CS.N_FRAMES]):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.get_tracking_state()
    snap = CS._snapshot(sysm)
    lc = sysm.loop_closer
    print(f"{args.root}: phase 5's map, {sysm.n_kfs} keyframes", flush=True)
    repeat("run_global_ba at full width", args, card, lambda: CS._restore(sysm, snap),
           lambda: lc.run_global_ba(rounds=1),
           lambda res: gba_outputs(res, sysm.map), gba_names, gba_gap)
    from splslam_tpu_torch.optim import ba as BA
    if hasattr(BA, "segment_sum"):
        # the torch candidate: the same sums by the plain version's tree
        from splslam_tpu_torch.ops.segsum import segment_sum_reference
        kernel, BA.segment_sum = BA.segment_sum, segment_sum_reference
        try:
            repeat("run_global_ba at full width, sums by the plain tree", args, card,
                   lambda: CS._restore(sysm, snap), lambda: lc.run_global_ba(rounds=1),
                   lambda res: gba_outputs(res, sysm.map), gba_names, gba_gap)
        finally:
            BA.segment_sum = kernel

    # pose_graph_sim3 and _correct on phase 7's circuit with phase 8's drift
    _, base, scene = CS.loop_phase(card)
    S12 = CS.inject_drift(base, scene[0], "cuda")
    lcb = base.loop_closer
    snap = CS._snapshot(base)
    state = (list(lcb.loop_edges), lcb.corrections, base.mapper.big_change_idx)
    kf, cand = lcb.verified_loops[0]

    def prepare_correct():
        CS._restore(base, snap)
        lcb.loop_edges[:] = state[0]
        lcb.corrections, base.mapper.big_change_idx = state[1], state[2]

    calls = []
    run_pg = S3.pose_graph_sim3

    def recorded(*a, **kw):
        calls.append(([CS._clone(x) for x in a], kw))
        return run_pg(*a, **kw)

    S3.pose_graph_sim3 = recorded
    try:
        prepare_correct()
        lcb._correct(kf, cand, S12)
    finally:
        S3.pose_graph_sim3 = run_pg
    pg_args, pg_kw = calls[0]
    repeat("pose_graph_sim3", args, card, lambda: None,
           lambda: run_pg(*[CS._clone(x) for x in pg_args], **pg_kw),
           lambda out: out, ("s", "R", "t", "n_guarded"))
    repeat("_correct", args, card, prepare_correct,
           lambda: lcb._correct(kf, cand, S12),
           lambda _: (base.map.kfs.Tcw, base.map.pts.xyz, base.map.pts.valid,
                      base.map.lns.xyz),
           ("map Tcw", "map points", "point validity", "map lines"))

    # run_global_ba with line edges on the --gba-lines map
    lm = line_map(make_stereo_sequence, TS)
    holder = {}

    def prepare_lines():
        holder["stub"] = gba_stub(lm, "cuda")

    repeat("run_global_ba with lines", args, card, prepare_lines,
           lambda: TLC.LoopCloser(holder["stub"]).run_global_ba(rounds=1,
                                                                with_lines=True),
           lambda res: gba_outputs(res, holder["stub"].map), gba_names, gba_gap)

    # gba_sharded at world 1 over NCCL
    cam, p = make_gba_problem(device="cpu")
    out = launch(solve_on_rank, 1, "cuda", timeout_s=300,
                 args=(cam, ba_problem_to_numpy(p), CS.GBA_KW, args.reps))[0]
    print(f"{args.root} gba_sharded world 1 NCCL: synced ms "
          f"{[round(x, 2) for x in out['ms']]}; repeats vs the first (pose, landmark "
          f"max, q99): {out['spread']}; equal {out.get('equal', 'not reported')}; "
          f"segment_sum launches {out.get('seg_launches', 'none')}; on {card}",
          flush=True)


if __name__ == "__main__":
    main()
