"""Smoke run of the PyTorch/CUDA port (`splslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. report the card (nvidia-smi name and power limit), torch and CUDA
     versions; turn TF32 off for matmuls and cuDNN;
  2. build the hand-written kernels (`csrc/orb_describe.cu`,
     `csrc/segment_sum.cu`) from this checkout's sources, one nvcc each,
     started together; print ptxas's registers, shared memory and stack,
     and the ORB kernel's resident blocks per SM;
  3. hold the kernel against its plain PyTorch version at main-path
     shapes (both images of one 1241x376 stereo frame, 8 unblurred
     levels each, 2 x 2000 slots, one launch): angle within 1e-3 rad,
     descriptor bits >= 99.5% equal; print the share of equal words and
     the largest angle error. Time the kernel on the device (CUDA events
     around a CUDA graph of 20 launches), the wrapper call and the plain
     version (CUDA events, median of 20 after 3 warm-ups), and the torch
     blur + packing + corner stage the kernel absorbed (`replaced_ms`);
     print the bound from the bytes and operations of this input;
  4. drive the port's main path, `System(..., device="cuda").track_stereo`,
     over 40 KITTI-sized synthetic stereo frames at the benchmark
     configuration (2000 features, 8 levels, 65536 points, 256 keyframes,
     2048-landmark local window; local mapping, relocalization and loop
     closing off):
     the run must stay OK with no frame lost, keep ATE-RMSE within 1% of
     the path length, and launch the kernel exactly once per frame. Then
     count the device kernels of one `build_frame_stereo` call with
     `torch.profiler` (CUDA activity);
  5. drive the mapping path at the same configuration with local mapping
     on and a keyframe every 4 frames (the reference's pinned cadence)
     over 40 frames: OK, no frame lost, one mapping step per keyframe
     after the first, >= 8 keyframes, no non-finite BA revert, a bounded
     rate of guarded BA iterations, steps that create landmarks and BA
     windows with inlier edges, ATE within 1% of the path, one kernel
     launch per frame. Then one mapping step from identical copies of
     the final map on the card and on the CPU: the integer tables after
     cull, triangulate and fuse equal; after local BA, keyframe poses
     within 1e-3, 99% of the window's landmarks within 1e-3 and inlier
     masks >= 99% equal;
  6. relocalization at the same configuration with the JAX package's
     defaults (relocalization and loop detection on, the bundled 10^5-word
     vocabulary, read from the JAX package's assets by path), local mapping
     on and a keyframe every 4 frames: track the 40 frames, then 3 blank
     frames (the state must be LOST, with no reset; each runs a
     relocalization that finds nothing), then replay frame 20 twice: the
     state must be OK and the last pose within 0.05 m of ground truth
     (tests/test_reloc.py's gate). On this sequence the JAX package's
     reference-keyframe fallback recovers the replay before a
     relocalization is needed, so the map is then saved, loaded into a
     fresh System (which starts LOST with no tracker state and
     relocalizes every frame) and frame 20 replayed twice: both frames
     relocalize within 0.05 m, with `ref_kf` the winning BoW candidate.
     Every keyframe has a BoW row, the loop counters of `health()` are 0,
     and the kernel runs once per frame built. Prints the ms of
     `_try_relocalize` and its attempts, of `_register_kf_bow`, of
     `loop_closer.on_keyframe`, and the frame median beside phase 5's;
  7. loop verification on a rectangular circuit over a textured plane
     (tests/test_loop.py's scene and settings: 320x240, 500 features, 4
     levels, correction off): state OK, at least one verified loop with
     kf - cand >= 5, no correction, no correction-path guard. Prints the
     verified loops, the guarded verifications and the ms of
     `compute_sim3_attempt`;
  8. loop correction and global BA. Global BA at full width: at the end
     of phase 5 (1241x376, 2000 features, 65,536-point table, keyframe
     bucket 32, 64,000 edge rows) `loop_closer.run_global_ba(rounds=1)`
     must fire no guard, revert nothing and keep ATE within 1.2x; prints
     its synced ms, device activities and busy share. It runs twice from
     identical copies of the map: every output equal to the bit (a
     gate). The `segment_sum` kernel is held against its plain version on
     every table the second solve and phase 5's local BA summed (see
     below). Offline correction:
     drift is injected into a copy of phase 7's circuit map
     (tests/test_loop.py's ramp over the post-loop keyframes and the
     landmarks they own), the loop Sim3 re-measured and `_correct` run:
     ATE more than doubles with the drift and the correction takes it
     below half, no guard fires, the fuse merges landmarks, the loop edge
     is kept; prints the three ATEs and the ms of `pose_graph_sim3`,
     `loop_search_and_fuse`, `run_global_ba` and `_correct`; the
     `pose_graph_sim3` of `_correct` runs again from copies of its
     inputs: every output equal to the bit (a gate). Live
     correction: the circuit again with `enable_loop_correction=True`:
     state OK, at least one correction, no correction-path guard, no BA
     revert, a bounded rate of guarded BA iterations, and ATE against the
     final keyframe poses no worse than max(1.25x, +0.01) of phase 7's;
  9. the monocular point+line path at bench_mono.py's configuration
     (640x480, fx 520, the grid texture, oscillating lateral motion,
     seed 4; 1000 features, 8 levels, 128 line slots, fps 30,
     min_kf_gap 20, 16,384 points, 128 keyframes, 2048-landmark window;
     local mapping, relocalization and loop closing off), cut from 120
     frames to 72 to keep the phase near 150 s of the card's time,
     `track_mono` one frame at a time: state OK with no frame lost, one
     B = 1 kernel launch per frame. Prints the init frame and model, the
     map points and lines, the median line inliers per frame, the
     Sim3-aligned ATE, ms/frame (median and p90 from init + 10), the
     device kernels of one `build_frame_mono` and the synced ms of its
     `extract_lines`. Holds one B = 1 `orb_describe` launch on a frame of
     the sequence against its plain version (timed as in phase 3), and
     `extract_lines` on the card against the CPU (validity and octaves
     equal). Then the sequence's first 36 frames points only
     (bench_mono.py's ablation: its state and lost frames), and the
     low-texture two-view init trials of bench_components.py (4 of its 10
     seeds, with and without lines; the bench runs all of both), whose
     success counts print beside the JAX package's record
     (BENCH_HEADLINES.json: 10/10 with lines, 0/10 without);
 10. point+line SLAM with the back end on: phase 9's 72 frames at the same
     configuration with the JAX package's defaults (local mapping with
     its line stages, relocalization and loop detection on, correction
     off) and a keyframe every 5 frames (bench_mono.py's min_kf_gap of
     20 was set for a run without mapping), `track_mono` one frame at a
     time: state OK with no frame lost, lines created by mapping,
     `mapping_state_revert` 0, `mapping_guarded` at most LINE_GUARD_GATE
     a step (the dual BA zeroes camera steps on most of its line-only
     iterations, as the JAX package does: its rate on
     tests/test_torch_mono_lines.py's run plus the slack that test holds
     the port to; phase 5's max(3, steps // 25) holds for points), one
     B = 1 launch per frame. Prints the init,
     keyframes, mapping
     steps, map points and lines (the init's, after mapping, their
     median n_obs), the median line inliers a frame beside phase 9's, the
     Sim3-aligned ATE, `health()` and the guarded iterations of each BA
     pass, ms/frame (median, p90) and ms per line
     mapping step (synced around `on_keyframe`), and one step's device
     kernels and idle share. Then, on the final map: `run_global_ba(
     rounds=1, with_lines=True)` (ms, lines adopted; poses and lines
     finite), twice from identical copies of the map: every output equal
     to the bit (a gate); the last line mapping step again on the card and on the
     CPU from identical copies (the integer tables after cull,
     triangulate and fuse equal, and those of the whole step); and the
     map saved, loaded into a fresh System and frame 40 relocalized with
     lines on (at least `reloc_min_inliers` inliers; the line inliers and
     the Sim3-aligned position error print);
 11. RGB-D at the TUM fr1 configuration of
     splslam_tpu/examples/configs/RGB-D/TUM1.yaml, its values written out
     here (`rgbd_settings`: 640x480, fx 517.306408, bf 40, ThDepth 40,
     DepthMapFactor 5000, 1000 features, 8 levels; distortion zero, as the
     synthetic frames are pinhole and the JAX `build_frame_rgbd` does not
     undistort), with the JAX defaults, a keyframe every 4 frames and
     phase 10's table sizes, over 90 synthetic forward frames with 25%
     depth holes and 2% depth noise, fed as depth x 5000 (the TUM
     driver's units): frames 0-59 mapping (OK, no frame lost, one
     mapping step per keyframe after the first, no BA revert,
     `mapping_guarded` within max(3, steps // 25), a BoW row per
     keyframe, ATE < 0.08, tests/test_e2e_rgbd.py's gate with holes and
     noise), frames 60-79 in localization mode (no keyframe and no
     mapping step, OK, ATE over the segment < 0.08), frames 80-89 after
     deactivation (keyframes resume); one B = 1 launch a frame. Prints
     ms/frame (median and p90 from frame 10), ms per mapping step, the
     timer rows, the device kernels of one `build_frame_rgbd`, one B = 1
     launch on frame 30 against its plain version, and one
     `vo_frame_step_rgbd` on the card against the CPU from identical
     copies of the final state (integers equal), with its synced ms,
     device activities and idle share;
 12. batched stereo at bench.py:45-65's configuration
     (`bench/stereo.py::settings`, which phases 4-6 cut to one frame a
     call): phase 4's, with
     relocalization and loop detection on as bench.py keeps them,
     `min_kf_gap=64`, `batch_defer_stats` at depth 3): frame 0 through
     `track_stereo`, then two batches of 32 of bench.py's forward leg
     (frames 1-64, the leg phase 4 starts), staged by `upload_batch`
     before the timed calls and both still in flight until the drain:
     OK, no frame lost, ATE within 1% of the path, 64 + 1 kernel
     launches, every position within 1e-3 m of a per-frame run of the
     same 65 frames at the same settings (the gap printed); ms/frame a
     batch (the call's wall / 32, bench.py's measure) and with the drain,
     beside the per-frame run's median and phase 4's. Then
     tests/test_reloc.py's mid-batch kidnap at its own settings (320x240,
     mapping, relocalization and loop detection on, stats deferred): OK,
     at most 1 of the last 8 frames lost, the last within 0.08 m; and a
     batch lost to its end with the next in flight (depth 2): one replay
     that takes the newer batch with it, OK within 0.08 m; one launch a
     frame built;
 13. batched mono point+line at bench_mono.py:80-128's configuration
     (`bench/mono.py::settings`; phases 9 and 10 cut it to one frame a call)
     (phase 9's 72 frames and settings with bench_mono.py's relocalization
     and loop detection on, B = 8, stats deferred at depth 3):
     `track_mono` one frame at a time until the two-view init, then
     `track_mono_batch` on batches staged before the timed calls: OK, no
     frame lost, no replay, Sim3-aligned ATE under 0.15
     (tests/test_torch_mono.py's gate), map lines tracked with a median
     of line inliers a frame no lower than phase 9's per-frame one (with
     mapping off this map keeps the init's few lines, and that median is
     0), one B = 1 launch a frame built; ms/frame a batch and with the
     drain;
 14. bench_mapping.py's synthetic map (`bench/mapping.py::map_kwargs`,
     `io/synth_map.py`, 12 keyframes of
     2000 features at 1241x376) built on the card; one `mapping_step` on
     each of 3 copies after a warm-up (synced ms, median), one under the
     profiler (device
     activities, idle share), and one on the CPU's build: card and CPU
     agree on the step's integers (landmark count, valid points and
     keyframes, culled keyframe ids, BA inlier edges, revert).
 15. the last module slice. (a) Phase 4's 40 frames written as a KITTI
     folder (times.txt, image_0/, image_1/, 8-bit gray PNGs written with
     zlib + struct) and read back through the native prefetcher
     (`io/native.py`, g++-built) into `track_stereo` with phase 4's
     settings, as `examples/stereo_kitti.py` runs: every pixel equal to
     the arrays written, no frame lost, every pose within 1e-5 m of phase
     4's, one launch a frame; the loader's ms a pair beside the frame's.
     (b) The same 40 pairs through the ROS `StereoGrabber`, the right
     image first on odd frames, right stamps 5 ms late, and a stale left
     with no partner before frame 20: 40 pairs tracked, the stale left
     dropped, every pose within 1e-5 m of (a). (c) With cv2 and
     matplotlib, the live `Viewer` records PNGs during (b); with cv2, the
     AR plane anchors on (b)'s tracked points and `render_ar_frame` draws
     the overlay; what does not run is named with its reason. (d)
     `gba_sharded` at `make_gba_problem()`'s size (64 keyframes, 16,384
     points, 1,024 lines, 139,264 edges; 2 rounds of 2 GN steps of 8 CG
     iterations, dryrun_multichip's schedule) at world 1 over NCCL (4 runs:
     ms, edges/s as scripts/bench_gba_scaling.py counts them, the
     run-to-run spread), with 4 gloo ranks sharing the card (3 runs), and
     at world 1 on the CPU: the run-to-run spread 0 and every repeat equal
     to the bit at world 1 and on each gloo rank (gates), the
     `segment_sum` kernel launched at world 1, n_guarded 0 for every
     run, 4 ranks against world 1 and
     world 1 against the CPU within tests/test_torch_parallel.py's
     tolerance (poses 1e-4, point landmarks 5e-4, line endpoints 5e-4 off
     the other run's line); NCCL asked for two ranks on one card (refused
     or not, printed); 4 NCCL ranks, one card each, where 4 cards exist.
     (e) `dryrun_multichip(torch.cuda.device_count())`: fleet tracking
     with a summed statistic, then the sharded BA; one launch a fleet row.
     The launches of (a), (b) and (e) count into the kernel line.
 16. the entry point and the JAX package's proof suites, each case with
     the counts set to 0 before it, one launch a frame built, and every
     gate printed beside its value. `graft_entry.entry("cuda")` (its frame
     builds an 8-slot line table, as the reference's entry) on its example
     arguments and on a rendered grid pair, against `entry("cpu")`: the
     inlier count and the valid lines equal (some on the grid pair), Tcw
     within 1e-5. Then one case of each suite the GPU tests run in full,
     at the suite's size and gates: tests/test_e2e_robustness.py's
     dynamic object (60 corridor frames clean and with a moving patch:
     OK, ATE within 2% of the path and within 1% of the clean run's, no
     BA revert, at most 2 guarded iterations), tests/test_bow_retrieval.py's
     places, 120 of its 360 (no far retrieval, top-1 within 2 places >=
     0.95 and within 1 >= 0.70, median own/far score > 1.1),
     tests/test_e2e_parity_matrix.py's corridor cell of seed 5 (220
     frames with mapping: OK, ATE within 1% of the path; the GPU tests run
     the tour cells, held to the JAX package's values, and the rest) and
     tests/test_line_repeatability.py's floors (matcher re-association
     0.50 / 0.57, geometric repeatability 0.62).
 17. the port's bench (`splslam_tpu_torch/bench/`, `bench_torch.py`) in
     process at a short size (`bench_short_sizes`: full widths, short
     sequences, one repeat): the stereo rows over 16 batched, 8 per-frame
     and 17 mapping frames of a 16-frame leg, the mapping bench's eleven
     rows with 1 call each, 12 mono frames with and without lines, 1
     low-texture init trial and 2 relocalization problems. Every row must be ok (its own
     checks: state, ATE, frames lost, replays, guards, one kernel launch
     a frame built) and name this card (nvidia-smi's name and power
     limit); the phase's launches count into the kernel line.

The runs of phases 5, 8 and 10 whose path holds a BA count the
`segment_sum` kernel's launches from 0 and fail if it did not launch.
Phase 5's local BA (the card's problem solved once more), phase 8's
second global BA and second `pose_graph_sim3`, and phase 10's second
global BA with lines record every table their solvers sum; on each, the
kernel must equal its plain version to the bit in one launch, and each
is timed on the device (a CUDA graph of 20 calls) with the host's
enqueue time a call, beside its plain version, `index_add_` and its
bound. The kernel line carries every table's numbers; its top-level
ones are the CG products' camera sum's, the most frequent call.
Prints a JSON line describing each kernel, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when no CUDA device is present. Uses no JAX and nothing of the
JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ANGLE_ATOL = 1e-3    # rad; the repo's kernel tolerance (tests/test_orb_pallas.py)
BIT_AGREE = 0.995    # descriptor bits; same source
N_FRAMES = 40
KITTI_W, KITTI_H = 1241, 376
MAP_POSE_ATOL = 1e-3   # card vs CPU after local BA (tests/test_torch_gpu.py)
MAP_INLIER_AGREE = 0.99
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at a 700 W limit
FP32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores, same source


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, by CUDA events around each call."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, per_graph: int = 20, reps: int = 20) -> float:
    """Device time of one fn() in ms: CUDA events around replays of a CUDA
    graph holding `per_graph` calls, median over `reps`, divided by
    `per_graph` (no host time between the launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    return cuda_ms(g.replay, reps=reps) / per_graph


def device_kernels(fn):
    """(count, device ms) of the device activities (kernels, copies, sets)
    that one fn() runs, from torch.profiler with CUDA activity, and the
    device ms of those whose name holds "orb_describe"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    orb = [e for e in dev if "orb_describe" in e.name]
    ms = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3
    return len(dev), ms(dev), ms(orb)


def kitti_settings(Settings, K, bf):
    """The benchmark configuration (`bench.py:45-65`, the port's
    `bench/stereo.py::settings`) cut to the smoke run: relocalization and
    loop closing off (phases 5 and 6 turn them on), no minimum keyframe
    gap, one frame a call. (`Settings`, the class, is the scripts'
    `scripts/port_*.py` calling convention.)"""
    from splslam_tpu_torch.bench import stereo as SB

    return dataclasses.replace(
        SB.settings(K, bf), enable_relocalization=False, enable_loop_closing=False,
        min_kf_gap=1, batch_defer_stats=False, batch_defer_depth=1)


def kernel_bound(levels, xy, spec, OK):
    """(bound ms, "bytes" or "operations", bytes, float32 ops) of one
    `orb_describe` call on these inputs: each input read once and each
    output written once, over the memory rate; the blur of the rows and
    columns each patch needs plus the moments, over the float32 rate."""
    import numpy as np

    B, n = xy.shape[0], xy.shape[1]
    level_px = sum(h * w for h, w in spec.sizes)
    nbytes = (B * level_px * 4 + xy.numel() * 4 + OK.N_BINS * 256 * 4
              + B * n * (4 + OK.N_WORDS * 4))
    row_off = np.cumsum([0] + [h for h, _ in spec.sizes])
    widths = np.array([w for _, w in spec.sizes])
    d = np.arange(OK.PATCH) - OK.C
    n_circle = int((d[:, None] ** 2 + d[None, :] ** 2 <= OK.R_C ** 2).sum())
    flops = 0
    for pts in xy.cpu():
        cy, cx = (c.numpy().astype(np.int64) for c in OK.patch_corners(
            pts, spec, [int(r) for r in row_off[:-1]]))
        rows = cy[:, None] + np.arange(OK.PATCH)[None, :]
        in_level = rows < row_off[-1]
        lv = np.searchsorted(row_off, np.minimum(rows, row_off[-1] - 1),
                             side="right") - 1
        cols = np.clip(widths[lv] - cx[:, None], 0, OK.PATCH)
        # vertical pass: 46 window columns a row; horizontal: the columns
        # inside the level; 7 multiplies and 7 adds an output
        flops += int((in_level * (14 * (OK.PATCH + 6) + 14 * cols)).sum())
        flops += n * 4 * n_circle
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, flops


def bit_agreement(d1, d2) -> float:
    import numpy as np

    b1 = np.unpackbits(d1.cpu().numpy().view(np.uint8))
    b2 = np.unpackbits(d2.cpu().numpy().view(np.uint8))
    return float((b1 == b2).mean())


SEG_RUNS: list = []   # (path, segment_sum launches) of each main-path run read
SEG_TABLES: list = []  # the segment_sum kernel's check and times, a table each
SEG_KERNEL: dict = {}  # the CG products' camera sum's (phase 8): the kernel line


def seg_reset() -> None:
    """The segment_sum kernel's count to 0, just before a main-path run."""
    from splslam_tpu_torch.ops import segsum as SS

    SS.segment_sum.launches = 0


def seg_read(path: str, on_path: bool) -> int:
    """The segment_sum kernel's launches in the run just ended, kept for
    the kernel line; a run whose path holds a BA (`on_path`) fails if
    the kernel was not launched."""
    from splslam_tpu_torch.ops import segsum as SS

    n = SS.segment_sum.launches
    SEG_RUNS.append((path, n))
    print(f"segment_sum kernel launches in {path}: {n}")
    if on_path and n == 0:
        raise SystemExit(f"chip_smoke: {path}: the segment_sum kernel was not "
                         "launched")
    return n


def segsum_bound(seg, width: int):
    """(bound ms, "bytes" or "operations") of one `segment_sum` call on a
    table of `width` columns: the kept rows read once with their order
    entries, the cell starts read, the sums written; one float32 add a
    kept row a column beyond each cell's first."""
    kept = int(seg.start[-1])
    nonempty = int((seg.start[1:] > seg.start[:-1]).sum())
    nbytes = kept * width * 4 + kept * 4 + (seg.n_cells + 1) * 4 \
        + seg.n_cells * width * 4
    flops = (kept - nonempty) * width
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@contextlib.contextmanager
def seg_recording(recorded: dict, solve: str):
    """Inside, every table that `optim/ba.py` and `optim/sim3.py` sum is
    kept in `recorded` (solve, cells, width) -> (segments, a copy of the
    rows), the first of each key; the sums themselves run as before."""
    from splslam_tpu_torch.optim import ba as BA
    from splslam_tpu_torch.optim import sim3 as S3

    runs = [(m, m.segment_sum) for m in (BA, S3)]

    def recording(run):
        def call(seg, rows):
            recorded.setdefault((solve, seg.n_cells, rows.shape[1]), (seg, rows.clone()))
            return run(seg, rows)
        return call

    for m, run in runs:
        m.segment_sum = recording(run)
    try:
        yield recorded
    finally:
        for m, run in runs:
            m.segment_sum = run


def enqueue_us(fn, calls: int = 50) -> float:
    """Host microseconds a call of fn(), the device left to catch up after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def segsum_numbers(seg, rows, calls: int = 50) -> dict:
    """One table's check and times on the card: the kernel against its
    plain version (equal to the bit: only a zero's sign may differ; max abs
    err; launches of one sum), the kernel's device ms (a CUDA graph of 20
    calls), the host's enqueue us a call, the plain version's and
    `index_add_`'s ms (atomics: not repeatable; CUDA events, median of
    10), and the bound from this table's bytes and operations."""
    import torch

    from splslam_tpu_torch.ops import segsum as SS

    n, w = seg.n_cells, rows.shape[1]
    before = SS.segment_sum.launches
    k = SS.segment_sum(seg, rows)
    ref = SS.segment_sum_reference(seg, rows)
    torch.cuda.synchronize()
    launches = SS.segment_sum.launches - before
    bound_ms, bound_by = segsum_bound(seg, w)
    return dict(
        rows=int(rows.shape[0]), kept=int(seg.start[-1]), cells=int(n), width=int(w),
        equal=torch.equal(k, ref), launches=launches,
        max_abs_err=float((k - ref).abs().max()) if k.numel() else 0.0,
        ms=graph_ms(lambda: SS.segment_sum(seg, rows)),
        call_us=enqueue_us(lambda: SS.segment_sum(seg, rows), calls),
        plain_ms=cuda_ms(lambda: SS.segment_sum_reference(seg, rows), reps=10),
        library_ms=cuda_ms(lambda: torch.zeros((n + 1, w), device=rows.device)
                           .index_add_(0, seg.cell, rows), reps=10),
        bound_ms=bound_ms, bound_by=bound_by)


def check_segsum(recorded: dict, card: str) -> None:
    """`segsum_numbers` on every table recorded (`seg_recording`): each
    must equal its plain version to the bit in one launch."""
    for (solve, n, w), (seg, rows) in recorded.items():
        t = dict(solve=solve, **segsum_numbers(seg, rows))
        print(f"segment_sum, {solve}: {t['rows']} rows ({t['kept']} kept) into {n} "
              f"cells x {w}: equal to plain {t['equal']}, max abs err "
              f"{t['max_abs_err']:.3e}, {t['launches']} launch; kernel {t['ms']:.5f} ms "
              f"on the device (graph of 20), {t['call_us']:.1f} us enqueue a call, plain "
              f"{t['plain_ms']:.4f} ms, index_add_ {t['library_ms']:.5f} ms; bound "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bound_ms'] / t['ms']:.3f} "
              f"of it), on {card}")
        SEG_TABLES.append(t)
        if not t["equal"] or t["launches"] != 1:
            raise SystemExit(f"chip_smoke: segment_sum, {solve}, {n} cells x {w}: "
                             f"equal {t['equal']}, {t['launches']} launches a sum")


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence, path_length
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.ops import segsum as SS
    from splslam_tpu_torch.ops.orb import detect
    from splslam_tpu_torch.ops.pyramid import PyramidSpec
    from splslam_tpu_torch.slam.frame import build_frame_stereo
    from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

    # ---- 1. the card ----
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build: one nvcc a source, started together ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        lib, seg_lib = pool.map(lambda m: m.build(), (OK, SS))
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.path.name}, "
          f"{seg_lib.path.name}")
    for line in (lib.log + seg_lib.log).splitlines():
        if any(w in line for w in ("registers", "spill", "stack", "smem")):
            print(f"  ptxas: {line.strip()}")
    blocks = lib.lib.orb_describe_occupancy()
    print(f"occupancy: {blocks} resident blocks (slots) per SM, "
          f"{blocks * 4} warps of 64")

    # ---- 3. kernel vs plain at main-path shapes, both images ----
    # bench.py's forward leg (a frame's pose is its own, whatever the
    # length): phases 4-6 take its first 40 frames, phase 12 its first 65
    K, bf, leg, leg_gt = make_stereo_sequence(
        n_frames=BATCH_FRAMES, width=KITTI_W, height=KITTI_H,
        fx=718.0, baseline=0.54, motion="forward", seed=3,
    )
    frames, gt = leg[:N_FRAMES], leg_gt[:N_FRAMES]
    st = kitti_settings(Settings, K, bf)
    spec = PyramidSpec.create(KITTI_H, KITTI_W, st.n_levels, st.scale_factor,
                              st.n_features)
    found = [detect(torch.from_numpy(f.astype(np.uint8)).cuda().float(), spec)
             for f in frames[0]]
    levels = [lv for lv, _ in found]
    xy = torch.stack([torch.cat([d[1] for d in det]) for _, det in found])
    ang_k, desc_k = OK.orb_describe(levels, xy, spec)
    ang_p, desc_p = OK.orb_describe_reference(levels, xy, spec)
    torch.cuda.synchronize()
    err = float((ang_k - ang_p).abs().max())
    agree = bit_agreement(desc_k, desc_p)
    words = float((desc_k == desc_p).float().mean())
    print(f"orb_describe vs plain, B={xy.shape[0]} x N={xy.shape[1]} slots, "
          f"{spec.n_levels} levels of {KITTI_W}x{KITTI_H}: angle max abs err "
          f"{err:.3e} rad, desc bits agree {agree:.6f}, words equal {words:.6f}")
    if not (np.isfinite(err) and err <= ANGLE_ATOL and agree >= BIT_AGREE):
        raise SystemExit("chip_smoke: kernel disagrees with its plain version")

    def replaced():
        for pyr, pts in zip(levels, xy):
            _, row_off = OK.pack_pyramid(pyr, spec)
            OK.patch_corners(pts, spec, row_off)

    k_ms = graph_ms(lambda: OK.orb_describe(levels, xy, spec))
    call_ms = cuda_ms(lambda: OK.orb_describe(levels, xy, spec))
    p_ms = cuda_ms(lambda: OK.orb_describe_reference(levels, xy, spec))
    r_ms = cuda_ms(replaced)
    bound_ms, bound_by, nbytes, flops = kernel_bound(levels, xy, spec, OK)
    print(f"orb_describe: kernel {k_ms:.5f} ms on the device (graph of 20), "
          f"wrapper call {call_ms:.5f} ms, plain {p_ms:.4f} ms, replaced "
          f"blur+pack+corners {r_ms:.4f} ms (CUDA events, median of 20) on {card}")
    print(f"orb_describe bound: {nbytes} B -> {nbytes / HBM_BYTES_PER_S * 1e3:.5f} "
          f"ms, {flops} float32 ops -> {flops / FP32_FLOPS_PER_S * 1e3:.5f} ms; "
          f"bound {bound_ms:.5f} ms by {bound_by}, kernel at "
          f"{bound_ms / k_ms:.3f} of it")

    # ---- 4. the main path at the benchmark configuration ----
    sysm = System(st, Sensor.STEREO, "cuda")
    OK.orb_describe.launches = 0
    times = []
    for i, (l, r) in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sysm.track_stereo(l, r, i * 0.1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    state = sysm.get_tracking_state()
    launches = OK.orb_describe.launches
    est = sysm.poses()
    n_lost = sum(e.lost for e in sysm.trajectory)
    ate = ate_rmse(est, gt)
    gate = 0.01 * path_length(gt)
    ms = float(np.median(times[10:]))
    print(f"main path: {N_FRAMES} frames, state {state.name}, lost {n_lost}, "
          f"keyframes {sysm.n_kfs}, landmarks {sysm.n_pts}, ATE {ate:.5f} "
          f"(gate {gate:.5f}), kernel launches {launches}")
    print(f"track_stereo: median {ms:.2f} ms/frame over frames 10-39 "
          f"(min {min(times[10:]):.2f}, max {max(times[10:]):.2f}) on {card}")
    checks = {
        "state OK": state == TrackingState.OK,
        "no frame lost": n_lost == 0,
        "poses finite, one per frame": est.shape == (N_FRAMES, 4, 4)
        and bool(np.isfinite(est).all()),
        "n_kfs >= 1": sysm.n_kfs >= 1,
        "ATE within 1% of path": ate <= gate,
        "one kernel launch per frame": launches == N_FRAMES,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: main path failed: {failed}")
    imgs = torch.from_numpy(np.stack(frames[-1]).astype(np.uint8)).cuda()
    n_dev, dev_ms, orb_ms = device_kernels(lambda: build_frame_stereo(
        imgs[0].float(), imgs[1].float(), sysm.cam, sysm.spec, sysm.scales,
        sysm.line_cap))
    print(f"build_frame_stereo: {n_dev} device kernels (torch.profiler, CUDA "
          f"activity), {dev_ms:.3f} ms device time, orb_describe {orb_ms:.5f} ms")

    map_launches, map_frame_ms = mapping_phase(st, frames, gt, card)
    reloc_launches = reloc_phase(st, frames, gt, card, map_frame_ms)
    loop_launches, loop_sys, scene = loop_phase(card)
    live_launches = correction_phase(loop_sys, scene, card)
    mono_launches, mono_ln_in = mono_phase(card)
    backend_launches = line_backend_phase(card, mono_ln_in)
    rgbd_launches = rgbd_phase(card)
    batch_launches = batch_phase(st, leg, leg_gt, card, ms)
    mono_batch_launches = mono_batch_phase(card, mono_ln_in)
    synth_map_phase(card)
    slice_launches = kitti_ros_viz_phase(st, frames, est, card)
    sharded_gba_phase(card)
    slice_launches += fleet_phase(card)
    proof_launches = proof_phase(card)
    bench_launches = bench_phase(card)

    print(json.dumps({"kernels": [{
        "name": "orb_describe",
        "route": "cuda",
        "source": "splslam_tpu_torch/csrc/orb_describe.cu",
        "replaces": "splslam_tpu/ops/orb_pallas.py:172",
        "launches": (launches + map_launches + reloc_launches + loop_launches
                     + live_launches + mono_launches + backend_launches
                     + rgbd_launches + batch_launches + mono_batch_launches
                     + slice_launches + proof_launches + bench_launches),
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library_why": "no single PyTorch call computes blur, IC angle and "
                       "steered BRIEF",
        "replaced_ms": r_ms,
        "call_ms": call_ms,
    }, {
        "name": "segment_sum",
        "route": "cuda",
        "source": "splslam_tpu_torch/csrc/segment_sum.cu",
        "replaces": "splslam_tpu/optim/ba.py:715",
        "replaces_what": "no TPU kernel: the XLA scatter-adds of the solvers' "
                         "segment sums (also splslam_tpu/optim/sim3.py:290)",
        "launches": sum(n for _, n in SEG_RUNS),
        "launches_by_path": dict(SEG_RUNS),
        "max_abs_err": max(t["max_abs_err"] for t in SEG_TABLES),
        **SEG_KERNEL,
        "tables": SEG_TABLES,
        "library_call": "Tensor.index_add_",
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def mapping_phase(st, frames, gt, card):
    """Phase 5. Returns the kernel launches during the mapping run."""
    import numpy as np
    import torch

    from splslam_tpu_torch.io.synthetic import ate_rmse, path_length
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.slam import mapping_ops as MO
    from splslam_tpu_torch.slam.map import KeyFrames
    from splslam_tpu_torch.slam.system import Sensor, System, TrackingState

    st = dataclasses.replace(st, enable_local_mapping=True, force_kf_every=4)
    sysm = System(st, Sensor.STEREO, "cuda")
    steps, map_ms = [], []
    run_step = MO.mapping_step

    def recorded_step(m, kf, *args, **kw):
        n0 = m.n_pts.clone()
        m, stats = run_step(m, kf, *args, **kw)
        steps.append((n0, stats.clone()))
        return m, stats

    on_keyframe = sysm.mapper.on_keyframe

    def timed_on_keyframe(kf):
        n = sysm.mapper.n_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_keyframe(kf)
        torch.cuda.synchronize()
        if sysm.mapper.n_steps > n:
            map_ms.append((time.perf_counter() - t0) * 1e3)

    sysm.mapper.on_keyframe = timed_on_keyframe
    MO.mapping_step = recorded_step
    times = []
    try:
        OK.orb_describe.launches = 0
        seg_reset()
        for i, (l, r) in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sysm.track_stereo(l, r, i * 0.1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        state = sysm.get_tracking_state()
        launches = OK.orb_describe.launches
        seg_read("phase 5 mapping", True)
    finally:
        MO.mapping_step = run_step
    health = sysm.health()
    est = sysm.poses()
    n_lost = sum(e.lost for e in sysm.trajectory)
    ate = ate_rmse(est, gt)
    gate = 0.01 * path_length(gt)
    n_steps = sysm.mapper.n_steps
    created = [int(s[0]) - int(n0) for n0, s in steps]
    inliers = [int(s[2]) for _, s in steps]
    print(f"mapping path: {len(frames)} frames, state {state.name}, lost {n_lost}, "
          f"keyframes {sysm.n_kfs}, mapping steps {n_steps}, landmarks "
          f"{sysm.n_pts}, ATE {ate:.5f} (gate {gate:.5f}), kernel launches "
          f"{launches}, health {health}")
    print(f"mapping steps: landmarks created {created}, BA inlier edges "
          f"{inliers}, edges {[int(s[1]) for _, s in steps]}")
    print(f"mapping: {np.median(map_ms):.2f} ms/keyframe median over "
          f"{len(map_ms)} steps (synced around on_keyframe; all "
          f"{[round(t, 1) for t in map_ms]}); "
          f"track_stereo {np.median(times[10:]):.2f} ms/frame median over "
          f"frames 10-{len(frames) - 1}, keyframe frames included, on {card}")
    checks = {
        "state OK": state == TrackingState.OK,
        "no frame lost": n_lost == 0,
        "poses finite, one per frame": est.shape == (len(frames), 4, 4)
        and bool(np.isfinite(est).all()),
        "n_steps == n_kfs - 1": n_steps == sysm.n_kfs - 1 == len(steps),
        "n_kfs >= 8": sysm.n_kfs >= 8,
        "mapping_state_revert == 0": health["mapping_state_revert"] == 0,
        "mapping_guarded <= max(3, steps // 25)":
            health["mapping_guarded"] <= max(3, n_steps // 25),
        "a step created landmarks": max(created, default=0) > 0,
        "a BA had inlier edges": max(inliers, default=0) > 0,
        "ATE within 1% of path": ate <= gate,
        "one kernel launch per frame": launches == len(frames),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: mapping path failed: {failed}")

    # One step on the card and on the CPU from identical copies of the map.
    kf = sysm.n_kfs - 1
    kb = max(32, 1 << (sysm.n_kfs - 1).bit_length())
    out = {}
    for dev in ("cuda", "cpu"):
        m = sysm.map.to(dev)
        m = m._replace(kfs=KeyFrames(*[x[:kb] for x in m.kfs]))
        m, _ = MO.map_upkeep(m, kf, sysm.cam, sysm.scales.to(dev),
                             st.scale_factor, st.n_levels)
        ints = {"n_pts": m.n_pts, "pts.valid": m.pts.valid,
                "pts.recent": m.pts.recent, "pts.n_obs": m.pts.n_obs,
                "pts.first_kf": m.pts.first_kf, "pts.desc": m.pts.desc,
                "kfs.lm_idx": m.kfs.lm_idx, "kfs.valid": m.kfs.valid}
        ints = {k: v.to("cpu", copy=True) for k, v in ints.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, prob, res = MO.local_ba(m, kf, sysm.cam, st.scale_factor, st.n_levels)
        torch.cuda.synchronize()
        out[dev] = (ints, prob, res, (time.perf_counter() - t0) * 1e3)
    (ig, pg, rg, ba_ms), (ic, pc, rc, _) = out["cuda"], out["cpu"]
    int_diff = {k: int((ig[k] != ic[k]).sum()) for k in ig}
    pose_err = float((rg.Tcw.cpu() - rc.Tcw).abs().max())
    d = (rg.xyz.cpu() - rc.xyz).norm(dim=-1)[pc.lm_ok]
    lm_q99 = float(torch.quantile(d, 0.99))
    agree = float((rg.e_inlier.cpu() == rc.e_inlier)[pc.e_ok].float().mean())
    solve_ms = cuda_ms(lambda: MO.ba_solve(sysm.cam, pg, n_free=MO.N_WINDOW),
                       reps=5, warmup=1)
    tables: dict = {}
    with seg_recording(tables, "phase 5 local BA"):
        MO.ba_solve(sysm.cam, pg, n_free=MO.N_WINDOW)
    print(f"mapping step card vs CPU (kf {kf}): integer tables differing "
          f"{int_diff}; BA edges {int(pc.e_ok.sum())}, window landmarks "
          f"{int(pc.lm_ok.sum())}, pose max abs err {pose_err:.3e}, landmark "
          f"err q99 {lm_q99:.3e} max {float(d.max()):.3e}, inlier agreement "
          f"{agree:.5f}, revert {int(rg.n_state_revert)}/{int(rc.n_state_revert)}")
    print(f"local BA stage (window, landmark upkeep, solve, write-back): "
          f"{ba_ms:.2f} ms synced; ba_solve alone {solve_ms:.2f} ms (CUDA "
          f"events, median of 5) on {card}")
    checks = {
        "integer tables equal after cull/create/fuse": not any(int_diff.values()),
        "BA edge masks equal": bool((pg.e_ok.cpu() == pc.e_ok).all()),
        "BA poses within 1e-3": pose_err <= MAP_POSE_ATOL,
        "99% of landmarks within 1e-3": lm_q99 <= MAP_POSE_ATOL,
        "inlier masks >= 99% equal": agree >= MAP_INLIER_AGREE,
        "no revert": int(rg.n_state_revert) == int(rc.n_state_revert) == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: mapping step card vs CPU failed: {failed}")
    global_ba_at_full_width(sysm, gt, card, tables)
    return launches, float(np.median(times[10:]))


def _snapshot(sysm):
    """What `run_global_ba` changes: a copy of the map, the host pose log,
    `map_version` and the loop closer's guard count."""
    return (sysm.map.to(sysm.device), {k: v.copy() for k, v in sysm.kf_pose_host.items()},
            sysm.map_version, sysm.loop_closer.n_guarded)


def _restore(sysm, snap):
    m, poses, version, guarded = snap
    sysm.map = m.to(sysm.device)
    sysm.kf_pose_host = {k: v.copy() for k, v in poses.items()}
    sysm.map_version = version
    sysm.loop_closer.n_guarded = guarded


def _gba_outputs(res, sysm) -> tuple:
    """Every output of a global BA: the solver's and the tables it wrote."""
    m = sysm.map
    return tuple(res) + (m.kfs.Tcw.clone(), m.pts.xyz.clone(), m.lns.xyz.clone())


def _clone(x):
    """A copy of a tensor or of a NamedTuple of tensors."""
    return type(x)(*map(_clone, x)) if isinstance(x, tuple) else x.clone()


def _first_difference(names, a, b) -> str:
    import torch

    for name, x, y in zip(names, a, b):
        if not torch.equal(x, y):
            return name
    return "none"


GBA_OUTPUTS = ("Tcw", "xyz", "e_inlier", "chi2", "total_chi2", "n_guarded",
               "n_state_revert", "n_lm_singular", "map Tcw", "map points", "map lines")


def global_ba_at_full_width(sysm, gt, card, tables: dict):
    """Phase 8, first part: global BA over phase 5's final map, twice from
    identical copies (every output equal to the bit), the segment_sum
    kernel held against its plain version on the solve's own tables and
    on phase 5's local BA's (`tables`)."""
    import torch

    from splslam_tpu_torch.io.synthetic import ate_rmse
    from splslam_tpu_torch.slam.loop_closing import _k_bucket

    lc = sysm.loop_closer
    K = _k_bucket(sysm.map.kfs.Tcw.shape[0], sysm.n_kfs)
    ate0 = ate_rmse(sysm.poses_reconstructed(), gt)
    version = sysm.map_version
    snap = _snapshot(sysm)

    def solve(path):
        seg_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lc.run_global_ba(rounds=1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return res, ms, seg_read(path, True), _gba_outputs(res, sysm)

    res, ms, seg_n, out1 = solve("phase 8 global BA at full width")
    ate1 = ate_rmse(sysm.poses_reconstructed(), gt)
    _restore(sysm, snap)
    with seg_recording(tables, "phase 8 global BA"):
        _, ms2, _, out2 = solve("phase 8 global BA at full width, again")
    n_dev, dev_ms, _ = device_kernels(lambda: lc.run_global_ba(rounds=1))
    ate2 = ate_rmse(sysm.poses_reconstructed(), gt)
    print(f"global BA at full width: {sysm.n_kfs} keyframes (bucket {K}), "
          f"{K * sysm.map.kfs.lm_idx.shape[1]} edge rows ({int(res.e_inlier.sum())} "
          f"inliers), {sysm.map.pts.xyz.shape[0]}-point table; n_guarded "
          f"{lc.n_guarded}, n_state_revert {int(res.n_state_revert)}, "
          f"n_lm_singular {int(res.n_lm_singular)}; ATE {ate0:.5f} -> {ate1:.5f} "
          f"-> {ate2:.5f} (a third solve)")
    print(f"run_global_ba(rounds=1): {ms:.2f} and {ms2:.2f} ms synced, "
          f"{seg_n} segment_sum launches; a third solve under torch.profiler: "
          f"{n_dev} device activities, {dev_ms:.3f} ms device time (busy "
          f"{dev_ms / ms:.3f} of the synced ms) on {card}")
    check_segsum(tables, card)
    cg = min((t for t in SEG_TABLES if t["solve"] == "phase 8 global BA"
              and t["width"] == 6), key=lambda t: t["rows"])
    SEG_KERNEL.update({k: cg[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "call_us")},
                      shape=[cg["rows"], cg["cells"], cg["width"]])
    first = _first_difference(GBA_OUTPUTS, out1, out2)
    bad = failed_gates("phase 8 global BA, two runs from identical copies", [
        ("first output that differs", first, "==", "none")])
    checks = {
        "n_guarded == 0": lc.n_guarded == 0,
        "n_state_revert == 0": int(res.n_state_revert) == 0,
        "ATE no worse than 1.2x": ate1 <= 1.2 * ate0 and ate2 <= 1.2 * ate0,
        "map_version bumped": sysm.map_version == version + 2,
        "poses finite": bool(torch.isfinite(sysm.map.kfs.Tcw).all()),
    }
    failed = [k for k, ok in checks.items() if not ok] + bad
    if failed:
        raise SystemExit(f"chip_smoke: global BA failed: {failed}")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, sink: list, device):
    """fn wrapped to append its synced wall ms to `sink`."""
    def run(*args, **kw):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(device)
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def _ms(xs) -> str:
    import numpy as np

    return (f"median {np.median(xs):.2f} ms over {len(xs)} (min {min(xs):.2f}, "
            f"max {max(xs):.2f})") if xs else "not run"


def reloc_phase(st, frames, gt, card, map_frame_ms, device="cuda", view=20):
    """Phase 6. Returns the kernel launches of the run."""
    import tempfile

    import numpy as np
    import torch

    from splslam_tpu_torch.bow import vocabulary as V
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.slam import reloc as R
    from splslam_tpu_torch.slam.system import Sensor, System, TrackingState

    st = dataclasses.replace(st, enable_local_mapping=True, force_kf_every=4,
                             enable_relocalization=True, enable_loop_closing=True)
    ms = {"reloc": [], "bow": [], "loop": []}
    attempts: list[list[int]] = []   # n_inliers of each attempt, per call
    wins = []                        # (expected winner, ref_kf, Tcw)
    run_attempt = R.reloc_attempt

    def counted_attempt(*args, **kw):
        out = run_attempt(*args, **kw)
        attempts[-1].append(int(out[1]))
        return out

    def instrument(sysm):
        try_reloc = _timed(sysm._try_relocalize, ms["reloc"], device)

        def checked_reloc(step_state, ts, fid=None):
            # the candidate order, recomputed: the three best BoW scores
            f, v, kfs = step_state.frame, sysm.vocab, sysm.map.kfs
            q = V.query_bow(v.level_desc, v.weights, v.k, v.depth, f.feat.desc,
                            f.feat.valid)
            sc = R.reloc_scores(sysm.kf_bow.ids, sysm.kf_bow.vals, kfs.valid, q,
                                torch.zeros_like(kfs.valid)).cpu().numpy()
            order = [int(c) for c in np.argsort(sc)[::-1][:3] if c < sysm.n_kfs]
            attempts.append([])
            ok = try_reloc(step_state, ts, fid)
            if ok:
                won = order[next(i for i, x in enumerate(attempts[-1])
                                 if x >= st.reloc_min_inliers)]
                wins.append((won, sysm.ref_kf, sysm.last_Tcw_np.copy()))
            return ok

        sysm._try_relocalize = checked_reloc
        sysm._register_kf_bow = _timed(sysm._register_kf_bow, ms["bow"], device)
        sysm.loop_closer.on_keyframe = _timed(sysm.loop_closer.on_keyframe,
                                              ms["loop"], device)
        return sysm

    sysm = instrument(System(st, Sensor.STEREO, device))
    R.reloc_attempt = counted_attempt
    times = []
    blank = np.full(frames[0][0].shape, 128, np.uint8)
    try:
        OK.orb_describe.launches = 0
        for i, (l, r) in enumerate(frames):
            _sync(device)
            t0 = time.perf_counter()
            sysm.track_stereo(l, r, i * 0.1)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        tracked = sysm.get_tracking_state()
        n_kfs = sysm.n_kfs
        for j in range(3):
            sysm.track_stereo(blank, blank, 10.0 + j * 0.1)
        lost = sysm.get_tracking_state()
        n_blank_calls = len(attempts)
        for j in range(2):
            sysm.track_stereo(*frames[view], 11.0 + j * 0.1)
        state = sysm.get_tracking_state()
        replay_err = float(np.linalg.norm(sysm.poses()[-1][:3, 3]
                                          - gt[view][:3, 3]))
        n_kidnap_wins = len(wins)
        # the relocalization itself: a fresh System on the saved map
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/map.npz"
            sysm.save_map(path)
            loaded = instrument(System(st, Sensor.STEREO, device))
            loaded.load_map(path)
        for j in range(2):
            loaded.track_stereo(*frames[view], 12.0 + j * 0.1)
        reloc_state = loaded.get_tracking_state()
        launches = OK.orb_describe.launches
    finally:
        R.reloc_attempt = run_attempt
    n_built = len(frames) + 7
    health = sysm.health()
    W = sysm.bow_n_words
    rows = [bool((sysm.kf_bow.ids[k] < W).any()) for k in range(sysm.n_kfs)]
    err = [float(np.linalg.norm(np.linalg.inv(T)[:3, 3] - gt[view][:3, 3]))
           for _, _, T in wins]
    print(f"relocalization: {len(frames)} frames ({tracked.name}, {n_kfs} "
          f"keyframes), 3 blank -> {lost.name} ({n_blank_calls} relocalization "
          f"calls), frame {view} twice -> {state.name} (relocalized "
          f"{n_kidnap_wins} times; last pose {replay_err:.5f} m from ground "
          f"truth, gate 0.05); saved map loaded, frame {view} twice -> "
          f"{reloc_state.name}: (winner, ref_kf) "
          f"{[(w, k) for w, k, _ in wins]}, error {err} m; n_inliers of the "
          f"attempts per call {attempts}; kernel launches {launches} for "
          f"{n_built} frames; health {health}")
    print(f"_try_relocalize: {_ms(ms['reloc'])}, synced, on {card}")
    print(f"_register_kf_bow: {_ms(ms['bow'])}; loop_closer.on_keyframe: "
          f"{_ms(ms['loop'])}; synced, on {card}")
    print(f"track_stereo with relocalization and loop detection on: median "
          f"{np.median(times[10:]):.2f} ms/frame over frames 10-"
          f"{len(frames) - 1} (phase 5: {map_frame_ms:.2f}) on {card}")
    checks = {
        "OK after tracking": tracked == TrackingState.OK,
        "LOST after the blank frames, no reset":
            lost == TrackingState.LOST and sysm.n_kfs >= n_kfs > 5,
        "relocalization tried on every blank frame": n_blank_calls == 3,
        "OK after the replay, within 0.05 m":
            state == TrackingState.OK and replay_err < 0.05,
        "loaded map: both frames relocalized within 0.05 m":
            reloc_state == TrackingState.OK and len(wins) == n_kidnap_wins + 2
            and max(err) < 0.05,
        "ref_kf is the winning candidate": all(w == k for w, k, _ in wins),
        "every keyframe has a BoW row": all(rows),
        "loop counters 0": all(health[k] == 0 for k in (
            "loop_guarded", "loop_verify_guarded", "loop_corrections",
            "verified_loops")),
        "one kernel launch per frame":
            launches == n_built or torch.device(device).type != "cuda",
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: relocalization failed: {failed}")
    return launches


def circuit_settings(Settings, K, bf, correction: bool):
    """tests/test_loop.py's settings for the circuit."""
    return Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=500, n_levels=4, th_depth=60.0, fps=5,
        max_points=16384, max_keyframes=64, local_window=1024,
        enable_local_mapping=True, enable_loop_correction=correction,
    )


def loop_phase(card, device="cuda"):
    """Phase 7. Returns (kernel launches of the run, the System, the
    circuit (K, bf, frames, gt))."""
    import torch

    from splslam_tpu_torch.io.synthetic import make_loop_circuit
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.slam import loop_closing as LC
    from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

    scene = make_loop_circuit()
    K, bf, frames, _ = scene
    sysm = System(circuit_settings(Settings, K, bf, False), Sensor.STEREO, device)
    sim3_ms: list[float] = []
    run_sim3 = LC.compute_sim3_attempt
    LC.compute_sim3_attempt = _timed(run_sim3, sim3_ms, device)
    t0 = time.perf_counter()
    try:
        OK.orb_describe.launches = 0
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.2)
        state = sysm.get_tracking_state()
        launches = OK.orb_describe.launches
    finally:
        LC.compute_sim3_attempt = run_sim3
    wall = time.perf_counter() - t0
    lc = sysm.loop_closer
    health = sysm.health()
    print(f"loop circuit: {len(frames)} frames in {wall:.1f} s, state "
          f"{state.name}, keyframes {sysm.n_kfs}, verified loops "
          f"{lc.verified_loops}, n_guarded_verify {lc.n_guarded_verify}, "
          f"kernel launches {launches}, health {health}")
    print(f"compute_sim3_attempt: {_ms(sim3_ms)}, synced, on {card}")
    checks = {
        "state OK": state == TrackingState.OK,
        "a verified loop with kf - cand >= 5":
            any(kf - cand >= 5 for kf, cand in lc.verified_loops),
        "no correction": health["loop_corrections"] == 0,
        "n_guarded == 0": lc.n_guarded == 0,
        "one kernel launch per frame":
            launches == len(frames) or torch.device(device).type != "cuda",
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: loop verification failed: {failed}")
    return launches, sysm, scene


def inject_drift(base, K, device):
    """Drift into a copy of phase 7's map (tests/test_loop.py's ramp over
    the keyframes after the loop candidate + 2 and the landmarks they
    own), the host pose log with it; returns the loop's Sim3 re-measured
    on the drifted map."""
    import numpy as np
    import torch

    from splslam_tpu_torch.geometry import se3
    from splslam_tpu_torch.slam import loop_closing as LC

    kf, cand = base.loop_closer.verified_loops[0]
    n = base.n_kfs
    m = base.map.to("cpu")
    base.kf_pose_host = {k: v.copy() for k, v in base.kf_pose_host.items()}
    Tcw_d, xyz_d = m.kfs.Tcw.numpy(), m.pts.xyz.numpy()   # views of the copy
    first_kf = m.pts.first_kf.numpy()
    ramp0 = cand + 2
    for k in range(ramp0, n):
        a = (k - ramp0) / max(n - 1 - ramp0, 1)
        xi = torch.tensor([0.25 * a, 0.1 * a, 0.0, 0.0, 0.0, 0.0])
        W = se3.se3_exp(xi).numpy()                         # world-side drift
        Tcw_d[k] = Tcw_d[k] @ np.linalg.inv(W)
        own = first_kf == k
        xyz_d[own] = xyz_d[own] @ W[:3, :3].T + W[:3, 3]
        base.kf_pose_host[k] = Tcw_d[k].copy()
    base.map = m.to(device)
    K3 = torch.from_numpy(K).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(kf)
    *_, S12 = LC.compute_sim3_attempt(base.map, kf, cand, K3, True, generator=gen)
    return S12


def correction_phase(base, scene, card, device="cuda"):
    """Phase 8, second and third part: the offline correction of injected
    drift on phase 7's map, then the circuit with the correction live.
    Returns the kernel launches of the live run."""
    import torch

    from splslam_tpu_torch.io.synthetic import ate_rmse
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.optim import sim3 as S3
    from splslam_tpu_torch.slam import loop_closing as LC
    from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

    K, bf, frames, gt = scene
    lc = base.loop_closer
    kf, cand = lc.verified_loops[0]
    n = base.n_kfs
    ate0 = ate_rmse(base.poses_reconstructed(), gt)
    base_mapping_guarded = base.health()["mapping_guarded"]

    # ---- offline: drift into a copy of the map, then _correct ----
    S12 = inject_drift(base, K, device)
    ate_drift = ate_rmse(base.poses_reconstructed(), gt)
    n_valid = int(base.map.pts.valid.sum())
    ms = {"pose_graph_sim3": [], "loop_search_and_fuse": [], "run_global_ba": [],
          "_correct": []}
    run_pg, run_fuse = S3.pose_graph_sim3, LC.loop_search_and_fuse
    timed_pg = _timed(run_pg, ms["pose_graph_sim3"], device)
    pg_calls = []

    def recorded_pg(*args, **kw):
        """The solve, its inputs copied and its outputs kept."""
        copies = [_clone(x) for x in args]
        out = timed_pg(*args, **kw)
        pg_calls.append((copies, kw, out))
        return out

    S3.pose_graph_sim3 = recorded_pg
    LC.loop_search_and_fuse = _timed(run_fuse, ms["loop_search_and_fuse"], device)
    lc.run_global_ba = _timed(lc.run_global_ba, ms["run_global_ba"], device)
    try:
        seg_reset()
        _timed(lc._correct, ms["_correct"], device)(kf, cand, S12)
        seg_read("phase 8 offline correction", torch.device(device).type == "cuda")
    finally:
        S3.pose_graph_sim3, LC.loop_search_and_fuse = run_pg, run_fuse
        del lc.run_global_ba
    ate_corr = ate_rmse(base.poses_reconstructed(), gt)
    n_valid_after = int(base.map.pts.valid.sum())
    # pose_graph_sim3 again from copies of the same inputs
    (args, kw, out1), = pg_calls
    pg_tables: dict = {}
    with seg_recording(pg_tables, "phase 8 pose graph"):
        out2 = run_pg(*[_clone(x) for x in args], **kw)
    if torch.device(device).type == "cuda":
        check_segsum(pg_tables, card)
    pg_first = _first_difference(("s", "R", "t", "n_guarded"), out1, out2)
    print(f"offline correction of loop ({kf}, {cand}), {n} keyframes: ATE "
          f"{ate0:.5f} -> drifted {ate_drift:.5f} -> corrected {ate_corr:.5f}; "
          f"valid landmarks {n_valid} -> {n_valid_after}; n_guarded "
          f"{lc.n_guarded}, loop_edges {lc.loop_edges}")
    print("correction stages, synced ms: "
          + ", ".join(f"{k} {v[0]:.2f}" for k, v in ms.items()) + f" on {card}")
    bad = failed_gates("phase 8 pose_graph_sim3, two runs from identical copies", [
        ("first output that differs", pg_first, "==", "none")])
    checks = {
        "drift injected (ATE > 2x)": ate_drift > 2.0 * ate0,
        "n_guarded == 0": lc.n_guarded == 0,
        "corrected below half": ate_corr < 0.5 * ate_drift,
        "the fuse merged landmarks": n_valid_after < n_valid,
        "loop edge kept": lc.loop_edges == [(kf, cand)],
    }
    failed = [k for k, ok in checks.items() if not ok] + bad
    if failed:
        raise SystemExit(f"chip_smoke: offline correction failed: {failed}")

    # ---- live: the circuit again with the correction on ----
    sysm = System(circuit_settings(Settings, K, bf, True), Sensor.STEREO, device)
    live_ms: list[float] = []
    sysm.loop_closer._correct = _timed(sysm.loop_closer._correct, live_ms, device)
    t0 = time.perf_counter()
    OK.orb_describe.launches = 0
    seg_reset()
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.2)
    state = sysm.get_tracking_state()
    launches = OK.orb_describe.launches
    seg_read("phase 8 live correction", torch.device(device).type == "cuda")
    wall = time.perf_counter() - t0
    health = sysm.health()
    ate_live = ate_rmse(sysm.poses_reconstructed(), gt)
    steps = health["mapping_steps"]
    print(f"live correction: {len(frames)} frames in {wall:.1f} s, state "
          f"{state.name}, keyframes {sysm.n_kfs}, corrections "
          f"{sysm.loop_closer.corrections} of loops {sysm.loop_closer.loop_edges}, "
          f"ATE {ate_live:.5f} (phase 7's run {ate0:.5f}), map_version "
          f"{sysm.map_version}, kernel launches {launches}, health {health} "
          f"(phase 7's mapping_guarded {base_mapping_guarded})")
    print(f"_correct, live: {_ms(live_ms)}, synced, on {card}")
    checks = {
        "state OK": state == TrackingState.OK,
        "corrections >= 1": sysm.loop_closer.corrections >= 1,
        "loop_guarded == 0": health["loop_guarded"] == 0,
        "mapping_state_revert == 0": health["mapping_state_revert"] == 0,
        "mapping_guarded <= max(3, steps // 25)":
            health["mapping_guarded"] <= max(3, steps // 25),
        "ATE in family with phase 7's":
            ate_live < max(1.25 * ate0, ate0 + 0.01),
        "one kernel launch per frame":
            launches == len(frames) or torch.device(device).type != "cuda",
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: live correction failed: {failed}")
    return launches


MONO_W, MONO_H = 640, 480   # bench/mono.py's FULL
MONO_FRAMES = 72   # bench_mono.py runs 120
# phase 9's cuts of what the bench (phase 17, bench_torch.py) runs in full
ABLATION_FRAMES = 36
LOW_TEXTURE_SEEDS = 4
# Guarded BA iterations a line mapping step: the JAX package's count on
# tests/test_torch_mono_lines.py's run (36 in 3 steps), plus the slack a
# step that the test holds the port's count to (GUARD_SLACK there).
LINE_GUARD_GATE = 36 // 3 + 3


def mono_settings(Settings, K, using_line: bool):
    """bench_mono.py's configuration (bench_mono.py:55-92, the port's
    `bench/mono.py::settings`), tracking only, one frame a call (phase 13
    takes the bench's settings as they are; `Settings` as in
    `kitti_settings`)."""
    from splslam_tpu_torch.bench import mono as MB

    return dataclasses.replace(
        MB.settings(K, using_line), enable_relocalization=False,
        enable_loop_closing=False, batch_defer_stats=False, batch_defer_depth=1)


def _mono_run(sysm, frames, device):
    """Track `frames` with `track_mono`, one synced frame at a time.
    Returns (per-frame ms, per-frame line inliers of the consumed stats)."""
    import numpy as np
    import torch

    from splslam_tpu_torch.slam import pipeline

    ln_in = []
    consume = sysm._process_one

    def _process_one():
        stats = sysm._pending[0][0]
        consume()
        ln_in.append(int(stats[pipeline.S_N_LN_IN]))

    sysm._process_one = _process_one
    times = []
    for i, (l, _) in enumerate(frames):
        _sync(device)
        t0 = time.perf_counter()
        sysm.track_mono(l, i / 30.0)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    sysm.drain()
    del sysm._process_one
    return np.asarray(times), ln_in


def _low_texture_trials(card, device, n_trials: int = 10):
    """bench_components.py's mono init trials (bench_components.py:45-118,
    the port's `bench/components.py`): a low-contrast texture crossed by
    dark grid strokes, 14 frames of lateral motion; success = state OK
    within the 14 frames. Relocalization and loop detection off."""
    import numpy as np

    from splslam_tpu_torch.bench import components as CB
    from splslam_tpu_torch.io.synthetic import PlaneScene
    from splslam_tpu_torch.slam.system import Sensor, System, TrackingState

    W, H = CB.W, CB.H
    K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1]], np.float32)

    out = {}
    t0 = time.perf_counter()
    for using_line in (True, False):
        ok, pts, lns = 0, 0, 0
        for seed in range(100, 100 + n_trials):
            scene = PlaneScene(CB._low_texture_grid(seed), z0=3.0, z1=None,
                               px_per_unit=60.0)
            phase = np.random.default_rng(seed).uniform(0, 3.0)
            st = dataclasses.replace(CB.init_settings(using_line),
                                     enable_relocalization=False, enable_loop_closing=False)
            sysm = System(st, Sensor.MONOCULAR, device)
            for i in range(14):
                Twc = np.eye(4)
                Twc[0, 3] = 0.06 * i
                Twc[1, 3] = 0.01 * np.sin(i + phase)
                sysm.track_mono(scene.render(K, Twc, H, W), i * 0.1)
                if sysm.get_tracking_state() == TrackingState.OK:
                    ok += 1
                    pts += int(sysm.map.pts.valid.sum())
                    lns += int(sysm.map.lns.valid.sum())
                    break
        out["point_line" if using_line else "points_only"] = (ok, pts / max(ok, 1),
                                                              lns / max(ok, 1))
    wall = time.perf_counter() - t0
    (a, ap, al), (b, bp, bl) = out["point_line"], out["points_only"]
    print(f"low-texture mono init ({n_trials} seeds, {wall:.1f} s): point+line "
          f"{a}/{n_trials} (mean {ap:.1f} points, {al:.1f} lines), points only "
          f"{b}/{n_trials} (mean {bp:.1f} points); the JAX package's record "
          f"(BENCH_HEADLINES.json mono_init_success_low_texture): 10/10 and 0/10")
    return a, b


def mono_phase(card, device="cuda"):
    """Phase 9: the monocular point+line path. Returns the kernel launches
    of its main run."""
    import numpy as np
    import torch

    from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence
    from splslam_tpu_torch.ops import lines as LN
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.ops.orb import detect
    from splslam_tpu_torch.slam import frame as FR
    from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

    t_phase = time.perf_counter()
    K, _, frames, gt = make_stereo_sequence(
        n_frames=MONO_FRAMES, width=MONO_W, height=MONO_H, fx=520.0, motion="oscillate",
        seed=4, osc_amp=0.5, texture="grid")
    sysm = System(mono_settings(Settings, K, True), Sensor.MONOCULAR, device)
    OK.orb_describe.launches = 0
    times, ln_in = _mono_run(sysm, frames, device)
    launches = OK.orb_describe.launches
    state = sysm.get_tracking_state()
    n_lost = sum(e.lost for e in sysm.trajectory)
    i_init = int(round(sysm.trajectory[1].ts * 30.0)) if len(sysm.trajectory) > 1 else -1
    idx = [int(round(e.ts * 30.0)) for e in sysm.trajectory if not e.lost]
    est = sysm.poses()
    ate = ate_rmse(est, gt[idx], align_scale=True)
    tail = times[i_init + 10:] if i_init >= 0 else times
    n_pts, n_lns = int(sysm.map.pts.valid.sum()), int(sysm.map.lns.valid.sum())
    print(f"mono+lines: {len(frames)} frames of {MONO_W}x{MONO_H}, init at frame "
          f"{i_init} (reference frame {int(round(sysm.trajectory[0].ts * 30.0))}), "
          f"init_used_h {sysm.init_used_h}, state {state.name}, lost {n_lost}, "
          f"keyframes {sysm.n_kfs}, map points {n_pts}, map lines {n_lns}, median "
          f"line inliers/frame {float(np.median(ln_in)) if ln_in else 0.0}, "
          f"Sim3-aligned ATE {ate:.5f}, kernel launches {launches}")
    print(f"track_mono (lines): median {np.median(tail):.2f} ms/frame, p90 "
          f"{np.percentile(tail, 90):.2f} over frames {i_init + 10}-{len(frames) - 1}, "
          f"synced, on {card} (the reference C++ on a CPU, BASELINE.md: 41.54 "
          f"ms/frame TUM mono+line, context only)")

    # one build_frame_mono: its device kernels, and extract_lines inside it
    img = torch.from_numpy(frames[60][0].astype(np.float32)).to(device)
    lines_ms: list[float] = []
    run_lines = FR.extract_lines
    FR.extract_lines = _timed(run_lines, lines_ms, device)
    try:
        FR.build_frame_mono(img, sysm.cam, sysm.spec, with_lines=True,
                            line_capacity=128)
        for _ in range(5):
            FR.build_frame_mono(img, sysm.cam, sysm.spec, with_lines=True,
                                line_capacity=128)
    finally:
        FR.extract_lines = run_lines
    n_dev, dev_ms, orb_ms = device_kernels(lambda: FR.build_frame_mono(
        img, sysm.cam, sysm.spec, with_lines=True, line_capacity=128))
    n_ln_dev, ln_dev_ms, _ = device_kernels(lambda: LN.extract_lines(img, capacity=128))
    print(f"build_frame_mono: {n_dev} device kernels, {dev_ms:.3f} ms device time, "
          f"orb_describe {orb_ms:.5f} ms; extract_lines inside it "
          f"{_ms(lines_ms[1:])} synced, {n_ln_dev} device kernels, "
          f"{ln_dev_ms:.3f} ms device time, on {card}")

    # one B = 1 orb_describe launch against its plain version
    spec = sysm.spec
    lv, det = detect(img, spec)
    xy = torch.cat([d[1] for d in det])[None]
    ang_k, desc_k = OK.orb_describe([lv], xy, spec)
    ang_p, desc_p = OK.orb_describe_reference([lv], xy, spec)
    torch.cuda.synchronize()
    err1 = float((ang_k - ang_p).abs().max())
    agree1 = bit_agreement(desc_k, desc_p)
    k1_ms = graph_ms(lambda: OK.orb_describe([lv], xy, spec))
    p1_ms = cuda_ms(lambda: OK.orb_describe_reference([lv], xy, spec))
    b1_ms, b1_by, _, _ = kernel_bound([lv], xy, spec, OK)
    print(f"orb_describe B=1 ({xy.shape[1]} slots, {MONO_W}x{MONO_H}, 8 levels): "
          f"angle max abs err {err1:.3e} rad, bits agree {agree1:.6f}; kernel "
          f"{k1_ms:.5f} ms (graph of 20), plain {p1_ms:.4f} ms, bound {b1_ms:.5f} ms "
          f"by {b1_by}, on {card}")

    # extract_lines on the card against the CPU
    fg = LN.extract_lines(img, capacity=128)
    fc = LN.extract_lines(img.cpu(), capacity=128)
    v = fc.valid
    ints_equal = bool(torch.equal(fg.valid.cpu(), v)
                      and torch.equal(fg.octave.cpu(), fc.octave))
    seg_err = float((fg.seg.cpu()[v] - fc.seg[v]).abs().max()) if ints_equal else float("nan")
    print(f"extract_lines card vs CPU: {int(v.sum())} lines, validity and octaves "
          f"equal {ints_equal}, endpoint max abs err {seg_err:.3e} px, bits agree "
          f"{bit_agreement(fg.desc.cpu()[v], fc.desc[v]) if ints_equal else float('nan'):.5f}")

    # bench_mono.py's ablation, the sequence's first ABLATION_FRAMES points
    # only (the bench runs it in full: its points-only row)
    abl = System(mono_settings(Settings, K, False), Sensor.MONOCULAR, device)
    abl_times, _ = _mono_run(abl, frames[:ABLATION_FRAMES], device)
    abl_state = abl.get_tracking_state()
    abl_lost = sum(e.lost for e in abl.trajectory)
    abl_init = int(round(abl.trajectory[1].ts * 30.0)) if len(abl.trajectory) > 1 else -1
    print(f"mono points only: state {abl_state.name}, lost {abl_lost}, init at frame "
          f"{abl_init}, keyframes {abl.n_kfs}, median "
          f"{np.median(abl_times[abl_init + 10:]):.2f} ms/frame over frames "
          f"{abl_init + 10}-{ABLATION_FRAMES - 1}, on {card}")

    lt_lines, lt_points = _low_texture_trials(card, device, LOW_TEXTURE_SEEDS)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    checks = {
        "state OK": state == TrackingState.OK,
        "no frame lost": n_lost == 0,
        "poses finite": bool(np.isfinite(est).all()),
        "map lines": n_lns >= 1,
        "one B=1 launch per frame": launches == len(frames),
        "orb_describe B=1 agrees": err1 <= ANGLE_ATOL and agree1 >= BIT_AGREE,
        "extract_lines integers equal card vs CPU": ints_equal,
        "low-texture init with lines succeeds": lt_lines >= 1,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: mono path failed: {failed}")
    return launches, float(np.median(ln_in)) if ln_in else 0.0


def _sim3_fit(p_est, p_gt):
    """(scale, R, mean_est, mean_gt) mapping estimated positions onto the
    ground truth (Umeyama, as `ate_rmse(align_scale=True)`)."""
    import numpy as np

    mu_e, mu_g = p_est.mean(0), p_gt.mean(0)
    E, G = p_est - mu_e, p_gt - mu_g
    U, sv, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    return float(np.trace(np.diag(sv) @ S) / max(np.sum(E * E), 1e-12)), \
        Vt.T @ S @ U.T, mu_e, mu_g


def line_backend_phase(card, phase9_ln_in, device="cuda", view=40):
    """Phase 10: point+line SLAM with the back end on. Returns the kernel
    launches of its main run."""
    import tempfile

    import numpy as np
    import torch

    from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.optim import ba as BA
    from splslam_tpu_torch.slam import mapping_ops as MO
    from splslam_tpu_torch.slam import reloc as R
    from splslam_tpu_torch.slam.frame import build_frame_mono
    from splslam_tpu_torch.slam.map import KeyFrames
    from splslam_tpu_torch.slam.pipeline import StepState
    from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

    t_phase = time.perf_counter()
    K, _, frames, gt = make_stereo_sequence(
        n_frames=MONO_FRAMES, width=MONO_W, height=MONO_H, fx=520.0, motion="oscillate",
        seed=4, osc_amp=0.5, texture="grid")
    st = dataclasses.replace(
        mono_settings(Settings, K, True), enable_local_mapping=True,
        enable_relocalization=True, enable_loop_closing=True, force_kf_every=5)
    sysm = System(st, Sensor.MONOCULAR, device)
    map_ms, last = [], {}
    lines_before_mapping = []
    run_step = MO.mapping_step
    run_solve = BA.ba_solve
    # the guarded iterations of the dual BA's three passes (points, lines,
    # joint: ba_solve_arbitrated's call order), kept on the device
    guarded = []

    def counted_solve(*args, **kw):
        res = run_solve(*args, **kw)
        guarded.append(res.n_guarded)
        return res

    def recorded_step(m, kf, *args, **kw):
        last.update(kf=kf, kw=dict(kw))
        BA.ba_solve = counted_solve
        try:
            return run_step(m, kf, *args, **kw)
        finally:
            BA.ba_solve = run_solve

    on_keyframe = sysm.mapper.on_keyframe

    def timed_on_keyframe(kf):
        n = sysm.mapper.n_steps
        # the map entering the step, copied (and its lines counted) outside
        # the timed window
        entering = sysm.map.to(device)
        if not lines_before_mapping:
            lines_before_mapping.append(int(entering.lns.valid.sum()))
        _sync(device)
        t0 = time.perf_counter()
        on_keyframe(kf)
        _sync(device)
        if sysm.mapper.n_steps > n:
            map_ms.append((time.perf_counter() - t0) * 1e3)
            last["state"] = entering

    sysm.mapper.on_keyframe = timed_on_keyframe
    MO.mapping_step = recorded_step
    try:
        OK.orb_describe.launches = 0
        seg_reset()
        times, ln_in = _mono_run(sysm, frames, device)
        launches = OK.orb_describe.launches
        seg_read("phase 10 line back end", torch.device(device).type == "cuda")
    finally:
        MO.mapping_step = run_step
        del sysm.mapper.on_keyframe
    state = sysm.get_tracking_state()
    n_lost = sum(e.lost for e in sysm.trajectory)
    i_init = int(round(sysm.trajectory[1].ts * 30.0)) if len(sysm.trajectory) > 1 else -1
    idx = [int(round(e.ts * 30.0)) for e in sysm.trajectory if not e.lost]
    est = sysm.poses()
    ate = ate_rmse(est, gt[idx], align_scale=True)
    health = sysm.health()
    n_steps = sysm.mapper.n_steps
    lv = sysm.map.lns.valid
    n_lns = int(lv.sum())
    n_init = lines_before_mapping[0] if lines_before_mapping else n_lns
    med_obs = float(sysm.map.lns.n_obs[lv].float().median()) if n_lns else 0.0
    tail = times[i_init + 10:] if i_init >= 0 else times
    print(f"mono+lines, back end on: {len(frames)} frames of {MONO_W}x{MONO_H}, init at "
          f"frame {i_init}, state {state.name}, lost {n_lost}, keyframes {sysm.n_kfs}, "
          f"mapping steps {n_steps}, map points {int(sysm.map.pts.valid.sum())}, map "
          f"lines {n_init} from the init -> {n_lns} after mapping ({int(sysm.map.n_lns)} "
          f"created in all), median line n_obs {med_obs:.1f}, median line inliers/"
          f"frame {float(np.median(ln_in)) if ln_in else 0.0} (phase 9, mapping off: "
          f"{phase9_ln_in}), Sim3-aligned ATE {ate:.5f}, kernel launches {launches}")
    by_pass = [int(sum(int(g) for g in guarded[i::3])) for i in range(3)]
    print(f"health {health}; guarded BA iterations by pass of the dual BA: points "
          f"{by_pass[0]}, lines {by_pass[1]}, joint {by_pass[2]}")
    print(f"track_mono (lines, back end on): median {np.median(tail):.2f} ms/frame, "
          f"p90 {np.percentile(tail, 90):.2f} over frames {i_init + 10}-"
          f"{len(frames) - 1}, keyframe frames included, synced; line mapping step "
          f"{_ms(map_ms)} synced around on_keyframe, on {card}")
    checks = {
        "state OK": state == TrackingState.OK,
        "no frame lost": n_lost == 0,
        "poses finite": bool(np.isfinite(est).all()),
        "mapping created lines": int(sysm.map.n_lns) > n_init and n_steps >= 1,
        "mapping_state_revert == 0": health["mapping_state_revert"] == 0,
        # the dual BA zeroes camera steps on most iterations of its line-only
        # pass where a camera sees few lines, as the JAX package does: held
        # to the reference's rate plus the slack that
        # tests/test_torch_mono_lines.py pins the port to
        f"mapping_guarded <= {LINE_GUARD_GATE} a step":
            health["mapping_guarded"] <= LINE_GUARD_GATE * n_steps,
        "one B=1 launch per frame built": launches == len(frames),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: line back end failed: {failed}")

    # one line mapping step's device kernels and idle share
    kf, kw = last["kf"], last["kw"]
    m_prof = last["state"].to(device)
    _sync(device)
    t0 = time.perf_counter()
    run_step(last["state"].to(device), kf, sysm.cam, sysm.scales, **kw)
    _sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3
    n_dev, dev_ms, _ = device_kernels(lambda: run_step(m_prof, kf, sysm.cam, sysm.scales,
                                                       **kw))
    print(f"line mapping step (kf {kf}): {step_ms:.2f} ms synced; under "
          f"torch.profiler {n_dev} device kernels, {dev_ms:.3f} ms device time, idle "
          f"{1.0 - dev_ms / step_ms:.3f} of the synced ms, on {card}")

    # global BA with line edges over the final map
    ll = sysm.map.kfs.ll_idx
    obs = ((ll >= 0) & sysm.map.kfs.lvalid & sysm.map.kfs.valid[:, None]
           & lv[ll.clamp(min=0).long()])
    cnt = torch.bincount(ll[obs].long(), minlength=lv.shape[0])
    n_adopt = int((lv & (cnt >= 2)).sum())
    lc = sysm.loop_closer
    g0 = lc.n_guarded
    snap = _snapshot(sysm)
    gba, line_tables = [], {}
    for path in ("phase 10 global BA with lines", "phase 10 global BA with lines, again"):
        if gba:
            _restore(sysm, snap)
        seg_reset()
        _sync(device)
        t0 = time.perf_counter()
        with (seg_recording(line_tables, "phase 10 global BA with lines") if gba
              else contextlib.nullcontext()):
            res = lc.run_global_ba(rounds=1, with_lines=True)
        _sync(device)
        gba.append(((time.perf_counter() - t0) * 1e3,
                    seg_read(path, torch.device(device).type == "cuda"),
                    _gba_outputs(res, sysm)))
    (gba_ms, seg_n, out1), (gba_ms2, _, out2) = gba
    if torch.device(device).type == "cuda":
        check_segsum(line_tables, card)
    finite = bool(torch.isfinite(sysm.map.kfs.Tcw).all()
                  and torch.isfinite(sysm.map.lns.xyz[lv]).all())
    ate_gba = ate_rmse(sysm.poses_reconstructed(), gt[idx], align_scale=True)
    print(f"run_global_ba(rounds=1, with_lines=True): {gba_ms:.2f} and {gba_ms2:.2f} "
          f"ms synced, {seg_n} segment_sum launches, "
          f"{sysm.n_kfs} keyframes, {n_lns} map lines, {n_adopt} adopted (>= 2 live "
          f"observations), n_guarded {lc.n_guarded - g0}, n_state_revert "
          f"{int(res.n_state_revert)}, finite {finite}, ATE of the reconstructed "
          f"frames {ate_gba:.5f}, on {card}")
    gba_bad = failed_gates("phase 10 global BA with lines, two runs from identical "
                           "copies", [("first output that differs",
                                       _first_difference(GBA_OUTPUTS, out1, out2),
                                       "==", "none")])

    # the last line mapping step on the card and on the CPU
    out = {}
    for dev in (device, "cpu"):
        m = last["state"].to(dev)
        m = m._replace(kfs=KeyFrames(*[x[:kw["k_bucket"]] for x in m.kfs]))
        m, _ = MO.map_upkeep(m, kf, sysm.cam, sysm.scales.to(dev), st.scale_factor,
                             st.n_levels, kw["th_obs"], True)
        ints = _line_ints(m)
        whole, _ = run_step(last["state"].to(dev), kf, sysm.cam, sysm.scales.to(dev),
                            **kw)
        out[dev] = (ints, _line_ints(whole))
    (ug, wg), (uc, wc) = out[device], out["cpu"]
    up_diff = {k: int((ug[k] != uc[k]).sum()) for k in ug if int((ug[k] != uc[k]).sum())}
    step_diff = {k: int((wg[k] != wc[k]).sum()) for k in wg if int((wg[k] != wc[k]).sum())}
    print(f"line mapping step card vs CPU (kf {kf}): integer entries differing after "
          f"cull/triangulate/fuse {up_diff or 'none'}, after the whole step "
          f"{step_diff or 'none'}")

    # save, load into a fresh System, relocalize a frame with lines on
    attempts = []
    run_attempt = R.reloc_attempt

    def counted_attempt(*args, **kw):
        o = run_attempt(*args, **kw)
        attempts.append((int(o[1]), int((o[3] >= 0).sum())))
        return o

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/map.npz"
        sysm.save_map(path)
        loaded = System(st, Sensor.MONOCULAR, device)
        loaded.load_map(path)
    img = torch.from_numpy(frames[view][0].astype(np.uint8)).to(device)
    frame = build_frame_mono(img.float(), loaded.cam, loaded.spec, with_lines=True,
                             line_capacity=loaded.line_cap, line_cfg=loaded.line_cfg)
    R.reloc_attempt = counted_attempt
    try:
        _sync(device)
        t0 = time.perf_counter()
        ok = loaded._try_relocalize(StepState.fresh(frame, torch.eye(4, device=device)),
                                    view / 30.0)
        _sync(device)
        reloc_ms = (time.perf_counter() - t0) * 1e3
    finally:
        R.reloc_attempt = run_attempt
    n_in, n_ln = attempts[-1] if attempts else (0, 0)
    c, Rg, mu_e, mu_g = _sim3_fit(est[:, :3, 3], gt[idx][:, :3, 3])
    pos = c * Rg @ (np.linalg.inv(loaded.last_Tcw_np)[:3, 3] - mu_e) + mu_g
    pos_err = float(np.linalg.norm(pos - gt[view][:3, 3]))
    print(f"loaded map, frame {view} relocalized {ok} against keyframe "
          f"{loaded.ref_kf}: {n_in} inliers (gate {st.reloc_min_inliers}), {n_ln} line "
          f"inliers, Sim3-aligned position error {pos_err:.5f}, attempts "
          f"{attempts}, {reloc_ms:.1f} ms, on {card}")
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    checks = {
        "global BA: poses and lines finite": finite,
        "global BA: no revert": int(res.n_state_revert) == 0,
        "line stages integer-equal card vs CPU": not up_diff,
        "line mapping step integer-equal card vs CPU": not step_diff,
        "loaded map relocalizes": ok and n_in >= st.reloc_min_inliers,
    }
    failed = [k for k, ok in checks.items() if not ok] + gba_bad
    if failed:
        raise SystemExit(f"chip_smoke: line back end failed: {failed}")
    return launches


RGBD_W, RGBD_H = 640, 480
RGBD_FRAMES = 90
RGBD_FX = 517.306408          # RGB-D/TUM1.yaml Camera.fx
RGBD_DEPTH_SCALE = 5000.0     # RGB-D/TUM1.yaml DepthMapFactor
RGBD_ATE_GATE = 0.08          # tests/test_e2e_rgbd.py (holes and noise)


def rgbd_settings(Settings, K):
    """TUM fr1 RGB-D (splslam_tpu/examples/configs/RGB-D/TUM1.yaml):
    640x480, fx 517.306408, bf 40, ThDepth 40, DepthMapFactor 5000 (a
    factor of 1/5000), 1000 features, 8 levels, scale 1.2, fps 30; fy and
    the principal point of the synthetic pinhole frames, distortion zero
    (the JAX `build_frame_rgbd` does not undistort). The JAX defaults (local
    mapping, relocalization and loop detection on, correction off), a
    keyframe every 4 frames (phase 5's cadence) and phase 10's table sizes."""
    return Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
        bf=40.0, width=RGBD_W, height=RGBD_H, fps=30.0, th_depth=40.0,
        depth_map_factor=1.0 / RGBD_DEPTH_SCALE, n_features=1000, n_levels=8,
        scale_factor=1.2, force_kf_every=4, max_points=16384, max_keyframes=128,
        local_window=2048,
    )


def rgbd_phase(card, device="cuda"):
    """Phase 11: RGB-D with the back end on, then localization mode, then
    mapping again. Returns the kernel launches of its main run."""
    import numpy as np
    import torch

    from splslam_tpu_torch import convert
    from splslam_tpu_torch.io.synthetic import ate_rmse, make_rgbd_sequence
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.ops.orb import detect
    from splslam_tpu_torch.slam import pipeline as PL
    from splslam_tpu_torch.slam.frame import build_frame_rgbd
    from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

    t_phase = time.perf_counter()
    # one frame more than the run: the card-vs-CPU step's input
    K, _, frames, gt = make_rgbd_sequence(
        n_frames=RGBD_FRAMES + 1, width=RGBD_W, height=RGBD_H, fx=RGBD_FX,
        baseline=40.0 / RGBD_FX, motion="forward", depth_dropout=0.25,
        depth_noise=0.02)
    t_data = time.perf_counter() - t_phase
    st = rgbd_settings(Settings, K)
    sysm = System(st, Sensor.RGBD, device)
    map_ms = []
    on_keyframe = sysm.mapper.on_keyframe

    def timed_on_keyframe(kf):
        n = sysm.mapper.n_steps
        _sync(device)
        t0 = time.perf_counter()
        on_keyframe(kf)
        _sync(device)
        if sysm.mapper.n_steps > n:
            map_ms.append((time.perf_counter() - t0) * 1e3)

    sysm.mapper.on_keyframe = timed_on_keyframe
    times = []

    def run(lo, hi):
        for i in range(lo, hi):
            img, depth = frames[i]
            _sync(device)
            t0 = time.perf_counter()
            sysm.track_rgbd(img, depth * RGBD_DEPTH_SCALE, i / 30.0)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        sysm.drain()
        return sysm.get_tracking_state(), sum(e.lost for e in sysm.trajectory)

    OK.orb_describe.launches = 0
    # 1. mapping
    state1, lost1 = run(0, 60)
    launches1 = OK.orb_describe.launches
    health = sysm.health()
    n_kfs1, n_steps1 = sysm.n_kfs, sysm.mapper.n_steps
    ids = sysm.kf_bow.ids[:n_kfs1].cpu()
    bow_rows = int((ids < sysm.bow_n_words).any(dim=1).sum())
    ate1 = ate_rmse(sysm.poses(), gt[:60])
    # 2. localization mode
    sysm.activate_localization_mode()
    state2, lost2 = run(60, 80)
    n_kfs2, n_steps2 = sysm.n_kfs, sysm.mapper.n_steps
    ate2 = ate_rmse(sysm.poses()[60:80], gt[60:80])
    # 3. mapping again
    sysm.deactivate_localization_mode()
    state3, lost3 = run(80, RGBD_FRAMES)
    launches = OK.orb_describe.launches
    sysm.mapper.on_keyframe = on_keyframe
    ate_all = ate_rmse(sysm.poses(), gt[:RGBD_FRAMES])
    tail = np.asarray(times[10:])
    print(f"rgbd: {RGBD_FRAMES} frames of {RGBD_W}x{RGBD_H}, depth x{RGBD_DEPTH_SCALE:g} "
          f"with 25% holes and 2% noise; frames 0-59 mapping: state {state1.name}, lost "
          f"{lost1}, keyframes {n_kfs1}, mapping steps {n_steps1}, landmarks "
          f"{int(sysm.map.pts.valid.sum())} valid at the end, BoW rows {bow_rows}, "
          f"ATE {ate1:.5f}, health {health}; frames 60-79 localization mode: state "
          f"{state2.name}, lost {lost2 - lost1}, keyframes {n_kfs2}, mapping steps "
          f"{n_steps2}, ATE over the segment {ate2:.5f}; frames 80-{RGBD_FRAMES - 1} "
          f"mapping again: state {state3.name}, keyframes {sysm.n_kfs}, ATE over the "
          f"run {ate_all:.5f}; kernel launches {launches}")
    print(f"track_rgbd: median {np.median(tail):.2f} ms/frame, p90 "
          f"{np.percentile(tail, 90):.2f} over frames 10-{RGBD_FRAMES - 1} (synced, "
          f"keyframe frames included); mapping {_ms(map_ms)} a step (synced around "
          f"on_keyframe), on {card}")
    print(f"rgbd timers: {sysm.timers.report()}")

    # one build_frame_rgbd: its device kernels; one B = 1 launch against
    # its plain version on frame 30
    img = torch.from_numpy(frames[30][0].astype(np.uint8)).to(device).float()
    dep = torch.from_numpy(frames[30][1] * RGBD_DEPTH_SCALE).to(device)
    n_dev, dev_ms, orb_ms = device_kernels(lambda: build_frame_rgbd(
        img, dep, sysm.cam, sysm.spec, st.depth_map_factor, sysm.line_cap))
    print(f"build_frame_rgbd: {n_dev} device kernels, {dev_ms:.3f} ms device time, "
          f"orb_describe {orb_ms:.5f} ms, on {card}")
    spec = sysm.spec
    lv, det = detect(img, spec)
    xy = torch.cat([d[1] for d in det])[None]
    ang_k, desc_k = OK.orb_describe([lv], xy, spec)
    ang_p, desc_p = OK.orb_describe_reference([lv], xy, spec)
    _sync(device)
    err1 = float((ang_k - ang_p).abs().max())
    agree1 = bit_agreement(desc_k, desc_p)
    k1_ms = graph_ms(lambda: OK.orb_describe([lv], xy, spec))
    p1_ms = cuda_ms(lambda: OK.orb_describe_reference([lv], xy, spec))
    b1_ms, b1_by, _, _ = kernel_bound([lv], xy, spec, OK)
    print(f"orb_describe B=1 ({xy.shape[1]} slots, {RGBD_W}x{RGBD_H}, 8 levels, rgbd "
          f"frame 30): angle max abs err {err1:.3e} rad, bits agree {agree1:.6f}; kernel "
          f"{k1_ms:.5f} ms (graph of 20), plain {p1_ms:.4f} ms, bound {b1_ms:.5f} ms by "
          f"{b1_by}, on {card}")

    # one vo_frame_step_rgbd from identical copies of the final state
    img_n = frames[RGBD_FRAMES][0].astype(np.uint8)
    dep_n = (frames[RGBD_FRAMES][1] * RGBD_DEPTH_SCALE).astype(np.float32)
    out = {}

    def step_on(dev):
        step = convert.step_state_from_numpy(convert.step_state_to_numpy(sysm.step), dev)
        args = (torch.from_numpy(img_n).to(dev), torch.from_numpy(dep_n).to(dev),
                sysm.map.to(dev), step, sysm.th_depth_m, sysm.ref_kf, sysm.cam,
                sysm.spec, sysm.scales.to(dev))
        return lambda: PL.vo_frame_step_rgbd(
            *args, m_local=st.local_window, scale_factor=st.scale_factor,
            n_levels=st.n_levels, depth_factor=st.depth_map_factor,
            line_capacity=sysm.line_cap, line_cfg=sysm.line_cfg)

    for dev in (device, "cpu"):
        _, new, stats = step_on(dev)()
        out[dev] = (stats.cpu(), new.lm_gid.cpu())
    (sg, gg), (sc, gc) = out[device], out["cpu"]
    ints_equal = bool(torch.equal(sg[16:], sc[16:]) and torch.equal(gg, gc))
    pose_err = float((sg[:16] - sc[:16]).abs().max())
    print(f"vo_frame_step_rgbd card vs CPU (frame {RGBD_FRAMES}): counts and landmark "
          f"ids equal {ints_equal} (counts {sg[16:].tolist()} / {sc[16:].tolist()}), "
          f"pose max abs err {pose_err:.3e}")
    # the frame step alone, on a fresh copy each time: synced wall ms,
    # then its device activities under the profiler
    step_ms = []
    for _ in range(5):
        run = step_on(device)
        _timed(run, step_ms, device)()
    n_step, step_dev_ms, _ = device_kernels(step_on(device))
    print(f"vo_frame_step_rgbd: {_ms(step_ms)} synced; {n_step} device activities, "
          f"{step_dev_ms:.3f} ms device time, idle {1 - step_dev_ms / np.median(step_ms):.3f} "
          f"of the median, on {card}")
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s ({t_data:.1f} s making the "
          f"sequence)")
    checks = {
        "mapping: state OK": state1 == TrackingState.OK,
        "mapping: no frame lost": lost1 == 0,
        "mapping: one step per keyframe after the first": n_steps1 == n_kfs1 - 1 >= 1,
        "mapping: mapping_state_revert == 0": health["mapping_state_revert"] == 0,
        "mapping: mapping_guarded <= max(3, steps // 25)":
            health["mapping_guarded"] <= max(3, n_steps1 // 25),
        "mapping: every keyframe has a BoW row": bow_rows == n_kfs1,
        "mapping: one B=1 launch per frame": launches1 == 60,
        "mapping: ATE < 0.08": ate1 < RGBD_ATE_GATE,
        "localization: no keyframe, no mapping step": (n_kfs2, n_steps2) == (n_kfs1, n_steps1),
        "localization: state OK, no frame lost": state2 == TrackingState.OK and lost2 == 0,
        "localization: ATE < 0.08": ate2 < RGBD_ATE_GATE,
        "deactivated: keyframes resume": sysm.n_kfs > n_kfs2 and state3 == TrackingState.OK,
        "one B=1 launch per frame": launches == RGBD_FRAMES,
        "orb_describe B=1 agrees": err1 <= ANGLE_ATOL and agree1 >= BIT_AGREE,
        "frame step integers equal card vs CPU": ints_equal,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: rgbd phase failed: {failed}")
    return launches


BATCH = 32                     # bench.py:85, bench/stereo.py's FULL.batch
BATCH_FRAMES = 1 + 2 * BATCH   # the bootstrap frame, then two batches
BATCH_POSE_GAP = 1e-3          # m, batched against per-frame on the card
KIDNAP_GATE = 0.08             # tests/test_reloc.py


def batch_settings(st):
    """bench.py:45-65 (the port's `bench/stereo.py::settings`) at phase
    4's camera: relocalization and loop detection on (the defaults), a
    64-frame minimum keyframe gap, and each batch's stats read three
    batches late."""
    import numpy as np

    from splslam_tpu_torch.bench import stereo as SB

    K = np.array([[st.fx, 0, st.cx], [0, st.fy, st.cy], [0, 0, 1]], np.float32)
    return SB.settings(K, st.bf)


def batch_phase(st, leg, leg_gt, card, frame_ms, device="cuda"):
    """Phase 12: batched stereo tracking at bench.py's configuration, and
    a kidnap inside a batch. Returns the kernel launches of its runs."""
    import numpy as np
    import torch

    from splslam_tpu_torch.bench.common import watched
    from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence, path_length
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

    t_phase = time.perf_counter()
    st = batch_settings(st)
    stamps = [i * 0.1 for i in range(BATCH_FRAMES)]
    # the same frames one at a time, at the same settings
    ref = System(st, Sensor.STEREO, device)
    per_frame = []
    for i, (l, r) in enumerate(leg):
        _timed(ref.track_stereo, per_frame, device)(l, r, stamps[i])
    ref_poses = ref.poses()
    # batched: frame 0 bootstraps the map, then two batches staged first
    sysm = System(st, Sensor.STEREO, device)
    OK.orb_describe.launches = 0
    sysm.track_stereo(*leg[0], stamps[0])
    chunks = [slice(1 + b * BATCH, 1 + (b + 1) * BATCH) for b in range(2)]
    staged = [sysm.upload_batch(leg[c]) for c in chunks]
    _sync(device)
    batch_ms = []
    t_run = time.perf_counter()
    for c, imgs in zip(chunks, staged):
        t0 = time.perf_counter()
        sysm.track_stereo_batch(imgs, stamps[c])
        batch_ms.append((time.perf_counter() - t0) * 1e3 / BATCH)
    in_flight = len(sysm._pending_batches)
    state = sysm.get_tracking_state()      # drains the deferred batches
    _sync(device)
    total_ms = (time.perf_counter() - t_run) * 1e3 / (2 * BATCH)
    launches = OK.orb_describe.launches
    est = sysm.poses()
    n_lost = sum(e.lost for e in sysm.trajectory)
    ate = ate_rmse(est, leg_gt)
    gate = 0.01 * path_length(leg_gt)
    gap = (float(np.abs(est[:, :3, 3] - ref_poses[:, :3, 3]).max())
           if est.shape == ref_poses.shape else float("inf"))
    print(f"batched stereo: {BATCH_FRAMES} frames (1 + 2 x {BATCH}), state {state.name}, "
          f"lost {n_lost}, keyframes {sysm.n_kfs} (per-frame run {ref.n_kfs}), "
          f"batches in flight before the drain {in_flight}, ATE {ate:.5f} (gate "
          f"{gate:.5f}), kernel launches {launches}; largest position gap to the "
          f"per-frame run {gap:.3e} m (gate {BATCH_POSE_GAP})")
    print(f"track_stereo_batch: {[round(x, 2) for x in batch_ms]} ms/frame per batch "
          f"(wall of the call / {BATCH}, bench.py's measure), {total_ms:.2f} ms/frame "
          f"with the drain; per-frame run of the same frames median "
          f"{np.median(per_frame[10:]):.2f} ms; phase 4's median {frame_ms:.2f} ms; "
          f"on {card}")

    # tests/test_reloc.py's mid-batch kidnap at its own settings, and a batch
    # lost to its end with the next in flight (the replay drops it)
    K, bf, frames, gt = make_stereo_sequence(n_frames=15, motion="forward",
                                             width=320, height=240)
    kst = Settings(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                   cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
                   n_features=600, n_levels=4, th_depth=40.0, fps=10,
                   max_points=8192, max_keyframes=64, local_window=1024,
                   batch_defer_stats=True)
    blank = np.full((240, 320), 128, np.uint8)
    kidnaps = {}
    OK.orb_describe.launches = 0
    for name, (batch_a, batch_b, depth, view) in {
        "mid-batch": ([(blank, blank)] + frames[6:9], frames[9:13], 1, 12),
        "lost with the next in flight": ([(blank, blank)] * 4, frames[6:10], 2, 9),
    }.items():
        ks = watched(System(dataclasses.replace(kst, batch_defer_depth=depth),
                                     Sensor.STEREO, device))
        for i, (l, r) in enumerate(frames[:6]):
            ks.track_stereo(l, r, i * 0.1)
        ks.drain()   # a batch does not consume per-frame stats still pending
        ks.track_stereo_batch(batch_a, [1.5 + 0.1 * j for j in range(4)])
        ks.track_stereo_batch(batch_b, [1.9 + 0.1 * j for j in range(4)])
        kstate = ks.get_tracking_state()
        lost8 = [e.lost for e in ks.trajectory[-8:]]
        err = float(np.linalg.norm(ks.poses()[-1][:3, 3] - gt[view][:3, 3]))
        kidnaps[name] = (kstate, lost8, err, ks.replays)
        print(f"kidnap ({name}, depth {depth}): state {kstate.name}, last 8 lost "
              f"{lost8}, replays {ks.replays}, last pose {err:.5f} m from frame "
              f"{view}'s ground truth (gate {KIDNAP_GATE})")
    k_launches = OK.orb_describe.launches
    k_built = 2 * (6 + 8) + 8                 # the second replays 8 frames
    print(f"kidnaps: kernel launches {k_launches} for {k_built} frames built; "
          f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    mid, lost_b = kidnaps["mid-batch"], kidnaps["lost with the next in flight"]
    checks = {
        "state OK": state == TrackingState.OK,
        "no frame lost": n_lost == 0,
        "poses finite, one per frame": est.shape == (BATCH_FRAMES, 4, 4)
        and bool(np.isfinite(est).all()),
        "ATE within 1% of path": ate <= gate,
        "64 + 1 kernel launches":
            launches == BATCH_FRAMES or torch.device(device).type != "cuda",
        "both batches deferred until the drain": in_flight == 2,
        f"within {BATCH_POSE_GAP} m of the per-frame run": gap <= BATCH_POSE_GAP,
        "mid-batch kidnap: OK, <= 1 of the last 8 lost, within 0.08 m":
            mid[0] == TrackingState.OK and sum(mid[1]) <= 1 and not mid[1][-1]
            and mid[2] < KIDNAP_GATE,
        "lost batch: one replay with the batch in flight, OK within 0.08 m":
            lost_b[3] == 1 and lost_b[0] == TrackingState.OK and not lost_b[1][-1]
            and lost_b[2] < KIDNAP_GATE,
        "kidnaps: one launch per frame built":
            k_launches == k_built or torch.device(device).type != "cuda",
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: batched stereo failed: {failed}")
    return launches + k_launches


MONO_B = 8            # bench_mono.py:108, bench/mono.py's FULL.batch


MONO_ATE_GATE = 0.15  # Sim3-aligned; tests/test_torch_mono.py (tests/test_e2e_mono.py)


def mono_batch_phase(card, phase9_ln_in, device="cuda"):
    """Phase 13: batched mono point+line tracking at bench_mono.py's
    configuration. Returns the kernel launches of its run."""
    import numpy as np
    import torch

    from splslam_tpu_torch.bench import mono as MB
    from splslam_tpu_torch.bench.common import watched
    from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.slam import pipeline
    from splslam_tpu_torch.slam.system import Sensor, System, TrackingState

    t_phase = time.perf_counter()
    K, _, frames, gt = make_stereo_sequence(
        n_frames=MONO_FRAMES, width=MONO_W, height=MONO_H, fx=520.0, motion="oscillate",
        seed=4, osc_amp=0.5, texture="grid")
    # bench_mono.py:100-107 keeps relocalization and loop detection on
    st = MB.settings(K, True)
    sysm = watched(System(st, Sensor.MONOCULAR, device))
    rows = []
    consume = sysm._consume_batch_stats

    def recorded(fetch, *args):
        rows.append(fetch.get().copy())
        return consume(fetch, *args)

    sysm._consume_batch_stats = recorded
    OK.orb_describe.launches = 0
    # one frame at a time until the two-view init, then batches of 8
    i = 0
    while sysm.get_tracking_state() != TrackingState.OK and i < len(frames):
        sysm.track_mono(frames[i][0], i / 30.0)
        i += 1
    init_end = i
    starts = list(range(init_end, len(frames), MONO_B))
    staged = [MB.staged([l for l, _ in frames[s:s + MONO_B]], torch.device(device))
              for s in starts]
    sysm.drain()
    _sync(device)
    batch_ms = []
    t_run = time.perf_counter()
    for s, imgs in zip(starts, staged):
        t0 = time.perf_counter()
        sysm.track_mono_batch(imgs, [j / 30.0 for j in range(s, s + len(imgs))])
        batch_ms.append((time.perf_counter() - t0) * 1e3 / len(imgs))
    state = sysm.get_tracking_state()
    _sync(device)
    total_ms = (time.perf_counter() - t_run) * 1e3 / (len(frames) - init_end)
    launches = OK.orb_describe.launches
    n_lost = sum(e.lost for e in sysm.trajectory)
    idx = [int(round(e.ts * 30.0)) for e in sysm.trajectory if not e.lost]
    est = sysm.poses()
    ate = ate_rmse(est, gt[idx], align_scale=True)
    ln_in = np.concatenate([r[:, pipeline.S_N_LN_IN] for r in rows]) if rows else np.zeros(0)
    med_ln = float(np.median(ln_in)) if len(ln_in) else 0.0
    max_ln = float(ln_in.max()) if len(ln_in) else 0.0
    print(f"batched mono+lines: {len(frames)} frames of {MONO_W}x{MONO_H}, init at frame "
          f"{init_end - 1} one frame at a time, then {len(starts)} batches of <= "
          f"{MONO_B} (depth {st.batch_defer_depth}); state {state.name}, lost {n_lost}, replays "
          f"{sysm.replays}, keyframes {sysm.n_kfs}, map lines "
          f"{int(sysm.map.lns.valid.sum())}, line inliers per batched frame median "
          f"{med_ln} (max {max_ln}; phase 9's per-frame median {phase9_ln_in}), "
          f"Sim3-aligned ATE "
          f"{ate:.5f} (gate {MONO_ATE_GATE}), kernel launches {launches}")
    print(f"track_mono_batch: median {np.median(batch_ms):.2f} ms/frame over "
          f"{len(batch_ms)} batches (wall of the call / B), {total_ms:.2f} ms/frame with "
          f"the drain, on {card}; phase 13: {time.perf_counter() - t_phase:.1f} s")
    checks = {
        "state OK": state == TrackingState.OK,
        "no frame lost": n_lost == 0,
        "no replay": sysm.replays == 0,
        "poses finite": bool(np.isfinite(est).all()),
        f"ATE < {MONO_ATE_GATE}": ate < MONO_ATE_GATE,
        # with mapping off this map keeps the init's few lines: phase 9's
        # per-frame median is 0 as well (PERF.md, PR 7)
        "lines tracked; median line inliers no lower than phase 9's":
            max_ln > 0 and med_ln >= phase9_ln_in,
        "one B=1 launch per frame built":
            launches == len(frames) or torch.device(device).type != "cuda",
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: batched mono failed: {failed}")
    return launches


def synth_map_phase(card, device="cuda"):
    """Phase 14: bench_mapping.py's synthetic map (12 keyframes, 2000
    features, KITTI 1241x376) built on the card; one mapping step on
    copies of it, and on the CPU's build."""
    import numpy as np
    import torch

    from splslam_tpu_torch.bench import mapping as MP
    from splslam_tpu_torch.io.synth_map import make_synthetic_map
    from splslam_tpu_torch.slam import mapping_ops as MO

    t_phase = time.perf_counter()
    kw = MP.map_kwargs()      # bench_mapping.py:57-60
    cam = MP.camera()
    scales = torch.tensor([1.2 ** i for i in range(kw["n_levels"])], dtype=torch.float32)
    kf = kw["n_kfs"] - 1
    kb = MP.k_bucket(kw["n_kfs"], kw["k_cap"])
    t0 = time.perf_counter()
    base, _, _, _ = make_synthetic_map(**kw, device=device)
    _sync(device)
    build_ms = (time.perf_counter() - t0) * 1e3
    base_cpu, _, _, _ = make_synthetic_map(**kw, device="cpu")

    def step(m, dev):
        return MO.mapping_step(m, kf, cam, scales.to(dev), k_bucket=kb)

    def outcome(m, stats):
        stats = stats.cpu()
        cull = stats[MO.MSTAT_CULL:MO.MSTAT_GUARD].reshape(MO.MAX_KF_CULL, 17)[:, 0]
        return (int(m.n_pts), int(m.pts.valid.sum()), int(m.kfs.valid.sum()),
                cull.long().tolist(), int(stats[2]), int(stats[MO.MSTAT_REVERT]),
                tuple(m.kfs.valid.cpu().tolist()))

    step(base.to(device), device)      # warm-up: the first call sets up the libraries
    step_ms = []
    for _ in range(3):
        m = base.to(device)
        m, stats = _timed(step, step_ms, device)(m, device)
    card_out = outcome(m, stats)
    m = base.to(device)
    n_dev, dev_ms, _ = device_kernels(lambda: step(m, device))
    cpu_ms = []
    m_c, stats_c = _timed(step, cpu_ms, "cpu")(base_cpu, "cpu")
    cpu_out = outcome(m_c, stats_c)
    print(f"synthetic map (bench_mapping.py's, {kw['n_kfs']} keyframes x {kw['n_feat']} "
          f"features, {int(base_cpu.n_pts)} landmarks) built on the card in "
          f"{build_ms:.1f} ms; mapping step (n_pts, valid points, valid keyframes, "
          f"culled ids, BA inlier edges, revert) card {card_out[:6]} / CPU "
          f"{cpu_out[:6]}, keyframe validity equal {card_out[6] == cpu_out[6]}")
    print(f"mapping_step on the synthetic map: {_ms(step_ms)} synced on copies "
          f"(CPU {cpu_ms[0]:.1f} ms); one step under torch.profiler: {n_dev} device "
          f"activities, {dev_ms:.3f} ms device time (idle "
          f"{1 - dev_ms / np.median(step_ms):.3f} of the median), on {card}; phase 14: "
          f"{time.perf_counter() - t_phase:.1f} s")
    checks = {
        "card and CPU agree on the step's integers": card_out == cpu_out,
        "landmarks created": card_out[0] > int(base_cpu.n_pts),
        "no revert": card_out[5] == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: synthetic map phase failed: {failed}")


# ---------------------------------------------------------------------
# phase 15: the prefetcher, the ROS grabber, the viewer and AR overlay,
# sharded global BA, the fleet dry run
# ---------------------------------------------------------------------
SLICE_POSE_GAP = 1e-5     # m: the same pixels and settings give the same poses
GBA_POSE_ATOL = 1e-4      # tests/test_torch_parallel.py
GBA_XYZ_ATOL = 5e-4       # same source: point landmarks, endpoints off-line
GBA_KW = dict(rounds=2, gn_iters=2, cg_iters=8)   # dryrun_multichip's


def write_png_gray(path, img) -> None:
    """An 8-bit grayscale PNG (no filter, one zlib stream) from the stdlib."""
    import struct
    import zlib

    h, w = img.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_kitti_folder(root, frames, dt: float = 0.1):
    """A KITTI odometry folder (times.txt, image_0/, image_1/) of the
    stereo pairs `frames` as 8-bit PNGs; returns the uint8 pairs written."""
    import os

    import numpy as np

    for d in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(repr(i * dt) for i in range(len(frames))) + "\n")
    pixels = []
    for i, (l, r) in enumerate(frames):
        pair = (np.asarray(l).astype(np.uint8), np.asarray(r).astype(np.uint8))
        for d, img in zip(("image_0", "image_1"), pair):
            write_png_gray(os.path.join(root, d, f"{i:06d}.png"), img)
        pixels.append(pair)
    return pixels


def _pose_gap(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1).max())


def kitti_ros_viz_phase(st, frames, est4, card, device="cuda"):
    """Phase 15 (a)-(c). Returns the kernel launches of (a) and (b)."""
    import glob
    import importlib.util
    import os
    import tempfile

    import numpy as np
    import torch

    from splslam_tpu_torch.io.datasets import load_kitti_stereo
    from splslam_tpu_torch.io.native import PrefetchLoader, _load_lib
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.ros import StereoGrabber
    from splslam_tpu_torch.slam.system import Sensor, System, TrackingState

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    _load_lib()
    build_s = time.perf_counter() - t0
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("cv2", "matplotlib")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as root:
        pixels = write_kitti_folder(root, frames)
        left, right, ts = load_kitti_stereo(root)

        # (a) the KITTI driver's path
        sysm = System(st, Sensor.STEREO, device)
        load_ms, track_ms, n_equal = [], [], 0
        OK.orb_describe.launches = 0
        with PrefetchLoader(left, st.width, st.height) as dl_l, \
                PrefetchLoader(right, st.width, st.height) as dl_r:
            for i, t in enumerate(ts):
                t0 = time.perf_counter()
                img_l, img_r = dl_l[i], dl_r[i]
                load_ms.append((time.perf_counter() - t0) * 1e3)
                n_equal += int(np.array_equal(img_l, pixels[i][0])
                               and np.array_equal(img_r, pixels[i][1]))
                _sync(device)
                t0 = time.perf_counter()
                sysm.track_stereo(img_l, img_r, t)
                _sync(device)
                track_ms.append((time.perf_counter() - t0) * 1e3)
        launches_a = OK.orb_describe.launches
        state_a = sysm.get_tracking_state()
        est_a = sysm.poses()
        lost_a = sum(e.lost for e in sysm.trajectory)
        gap_a = _pose_gap(est_a, est4)
        print(f"KITTI folder -> PrefetchLoader -> track_stereo: {len(ts)} pairs "
              f"(g++ build {build_s:.2f} s), pixels equal to the arrays written "
              f"{n_equal}/{len(ts)}, state {state_a.name}, lost {lost_a}, largest "
              f"pose gap to phase 4 {gap_a:.3e} m, kernel launches {launches_a}; "
              f"loader {_ms(load_ms)} a pair beside track_stereo {_ms(track_ms[10:])} "
              f"(frames 10 on) on {card}")

        # (b) the ROS grabber, with the viewer where it can run
        sysm_b = System(st, Sensor.STEREO, device)
        viewer = None
        if have["cv2"] and have["matplotlib"]:
            from splslam_tpu_torch.viz import Viewer

            viewer = Viewer(sysm_b, fps=20.0, out_dir=os.path.join(root, "viewer"),
                            show=False, map_every=10).start()
        g = StereoGrabber(sysm_b)
        OK.orb_describe.launches = 0
        for i, ((l, r), t) in enumerate(zip(pixels, ts)):
            if i == 20:
                g.push_left(pixels[19][0], t - 0.05)     # stale, never paired
            if i % 2:
                g.push_right(r, t + 0.005)
                g.push_left(l, t)
            else:
                g.push_left(l, t)
                g.push_right(r, t + 0.005)
        launches_b = OK.orb_describe.launches
        state_b = sysm_b.get_tracking_state()
        est_b = sysm_b.poses()
        gap_b = _pose_gap(est_b, est_a)
        print(f"StereoGrabber (right first on odd frames, 5 ms skew, a stale "
              f"left before frame 20): n_tracked {g.n_tracked}, state "
              f"{state_b.name}, {len(sysm_b.trajectory)} poses logged, largest "
              f"pose gap to (a) {gap_b:.3e} m, kernel launches {launches_b}")

        # (c) the viewer and the AR overlay
        n_png = 0
        if viewer is not None:
            viewer.request_stop()
            deadline = time.time() + 10.0
            while not viewer.is_stopped() and time.time() < deadline:
                time.sleep(0.01)
            stopped = viewer.is_stopped()
            viewer.release()
            viewer.request_finish()
            viewer.join(10.0)
            n_png = len(glob.glob(os.path.join(root, "viewer", "frame_*.png")))
            print(f"Viewer during (b): {n_png} overlay PNGs, {viewer.n_rendered} "
                  f"rendered, map.png "
                  f"{os.path.exists(os.path.join(root, 'viewer', 'map.png'))}, "
                  f"stop handshake {stopped}, finished {viewer.is_finished()}")
        else:
            print("Viewer: did not run here: "
                  + ", ".join(m for m, ok in have.items() if not ok)
                  + " not installed (it draws with cv2 and plots the map with "
                    "matplotlib)")
        anchored, overlay_shape = None, None
        if have["cv2"]:
            from splslam_tpu_torch.viz.ar import ARState, render_ar_frame

            ar = ARState()
            anchored = ar.try_anchor(sysm_b)
            overlay_shape = render_ar_frame(sysm_b, sysm_b.last_image, ar).shape
            print(f"AR overlay on (b)'s final state: anchored {anchored} at "
                  f"{np.round(ar.anchor, 3) if anchored else None}, overlay "
                  f"{overlay_shape}")
        else:
            print("AR overlay: did not run here: cv2 not installed")
    print(f"phase 15 (a)-(c): {time.perf_counter() - t_phase:.1f} s")
    checks = {
        "(a) pixels equal to the arrays written": n_equal == len(frames),
        "(a) state OK, no frame lost": state_a == TrackingState.OK and lost_a == 0,
        f"(a) within {SLICE_POSE_GAP} m of phase 4": gap_a <= SLICE_POSE_GAP,
        "(a) one launch a frame":
            launches_a == len(frames) or torch.device(device).type != "cuda",
        "(b) every pair tracked once, the stale left dropped":
            g.n_tracked == len(frames) and len(sysm_b.trajectory) == len(frames),
        f"(b) within {SLICE_POSE_GAP} m of (a)": gap_b <= SLICE_POSE_GAP,
        "(b) one launch a frame":
            launches_b == len(frames) or torch.device(device).type != "cuda",
        "(c) viewer recorded while tracking": viewer is None or (
            n_png >= 3 and viewer.is_finished() and not viewer._warned),
        "(c) AR anchored, overlay drawn": not have["cv2"] or (
            anchored and overlay_shape == (st.height, st.width, 3)),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 15 (a)-(c) failed: {failed}")
    return launches_a + launches_b


def _gba_gaps(a: dict, b: dict, n_pts: int):
    """(largest pose difference, largest point-landmark difference, largest
    line-endpoint distance off b's line) between two sharded BA results."""
    import numpy as np

    X, Xr = a["xyz"], b["xyz"]
    e, er = X[n_pts:].reshape(-1, 2, 3), Xr[n_pts:].reshape(-1, 2, 3)
    d = er[:, 1] - er[:, 0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    off = e - er
    off = off - np.sum(off * d[:, None], -1)[..., None] * d[:, None]
    return (float(np.abs(a["Tcw"] - b["Tcw"]).max()),
            float(np.abs(X[:n_pts] - Xr[:n_pts]).max()),
            float(np.abs(off).max()))


def sharded_gba_phase(card, device="cuda"):
    """Phase 15 (d): edge-sharded global BA at the reference's size."""
    import numpy as np
    import torch

    from splslam_tpu_torch.convert import ba_problem_to_numpy
    from splslam_tpu_torch.graft_entry import make_gba_problem
    from splslam_tpu_torch.parallel.gba_sharded import solve_on_rank
    from splslam_tpu_torch.parallel.mesh import check_group, launch

    t_phase = time.perf_counter()
    n_pts = 16384
    camb, prob = make_gba_problem(device="cpu")
    pn = ba_problem_to_numpy(prob)
    E = int(pn.e_cam.shape[0])
    work = E * GBA_KW["rounds"] * GBA_KW["gn_iters"]   # bench_gba_scaling.py

    def report(name, out):
        later = out["ms"][1:]
        ms = float(np.median(later)) if later else out["ms"][0]
        how = (f"median of {len(later)} after the first, {out['ms'][0]:.2f} the "
               "first" if later else "one run")
        print(f"gba_sharded {name}: n_guarded {out['n_guarded']}, {ms:.2f} ms a "
              f"solve ({how}), {work / ms * 1e3:.0f} edges/s ({E} edges x "
              f"{GBA_KW['rounds']} rounds x {GBA_KW['gn_iters']} GN steps)")
        return ms

    runs = {}
    runs["card, world 1, NCCL"] = launch(solve_on_rank, 1, device, timeout_s=300,
                                         args=(camb, pn, GBA_KW, 4))[0]
    four = launch(solve_on_rank, 4, device, backend="gloo", share_cards=True,
                  timeout_s=300, args=(camb, pn, GBA_KW, 3))
    runs["card, 4 gloo ranks on one card"] = four[0]
    runs["CPU, world 1, gloo"] = launch(solve_on_rank, 1, "cpu", timeout_s=300,
                                        args=(camb, pn, GBA_KW, 1))[0]
    if torch.cuda.device_count() >= 4:
        runs["4 cards, 4 NCCL ranks"] = launch(solve_on_rank, 4, device,
                                              timeout_s=300,
                                              args=(camb, pn, GBA_KW, 3))[0]
    else:
        print(f"gba_sharded on 4 NCCL ranks, one card each: did not run: "
              f"{torch.cuda.device_count()} card(s) here")
    ms = {k: report(k, v) for k, v in runs.items()}
    w1 = runs["card, world 1, NCCL"]
    print("gba_sharded run-to-run spread on the card (world 1, 3 repeats "
          "against the first; pose max abs, landmark max and q99 distance): "
          + "; ".join(f"{a:.3e} / {b:.3e} / {c:.3e}" for a, b, c in w1["spread"])
          + "; 4 gloo ranks, 2 repeats: "
          + "; ".join(f"{a:.3e} / {b:.3e} / {c:.3e}" for a, b, c in four[0]["spread"])
          + f", on {card}")
    spread = lambda out: max(max(x) for x in out["spread"])
    repeat_bad = failed_gates("phase 15 (d) run-to-run", [
        ("world 1 NCCL: largest difference of 3 repeats to the first", spread(w1),
         "==", 0.0),
        ("world 1 NCCL: repeats equal to the bit", all(w1["equal"]), "==", True),
        ("4 gloo ranks: largest difference of 2 repeats to the first",
         max(spread(o) for o in four), "==", 0.0),
        ("4 gloo ranks: repeats equal to the bit",
         all(all(o["equal"]) for o in four), "==", True),
        ("world 1 NCCL: segment_sum kernel launches", w1["seg_launches"], ">", 0)])
    gaps = {"4 gloo ranks vs world 1": _gba_gaps(four[0], w1, n_pts),
            "world 1 card vs CPU": _gba_gaps(w1, runs["CPU, world 1, gloo"], n_pts)}
    if "4 cards, 4 NCCL ranks" in runs:
        gaps["4 NCCL ranks vs world 1"] = _gba_gaps(runs["4 cards, 4 NCCL ranks"],
                                                    w1, n_pts)
    for k, (dT, dX, dE) in gaps.items():
        print(f"gba_sharded {k}: pose {dT:.3e}, point landmarks {dX:.3e}, line "
              f"endpoints off-line {dE:.3e} (tolerance {GBA_POSE_ATOL} / "
              f"{GBA_XYZ_ATOL} / {GBA_XYZ_ATOL})")
    if torch.device(device).type == "cuda":
        # what NCCL does with two ranks on one card (an outcome, not a check)
        try:
            sums = launch(check_group, 2, device, backend="nccl", share_cards=True,
                          timeout_s=120)
            nccl2 = f"accepted (group sums {sums})"
        except RuntimeError as e:
            lines = [ln.strip() for ln in str(e).splitlines()]
            why = ([ln for ln in lines if "Duplicate GPU" in ln]
                   or [ln for ln in lines if "NCCL error" in ln] or lines[:1])
            nccl2 = "refused: " + why[0][:300]
        print(f"NCCL with two ranks on one card: {nccl2}")
    print(f"phase 15 (d): {time.perf_counter() - t_phase:.1f} s, world 1 "
          f"{ms['card, world 1, NCCL']:.2f} ms vs 4 gloo ranks "
          f"{ms['card, 4 gloo ranks on one card']:.2f} ms on {card}")
    checks = {
        "n_guarded 0 for every run": all(r["n_guarded"] == 0 for r in runs.values()),
        "4 ranks return the same states": all(
            np.array_equal(o["Tcw"], four[0]["Tcw"])
            and np.array_equal(o["xyz"], four[0]["xyz"]) for o in four),
        "states finite": all(np.isfinite(r["Tcw"]).all() and np.isfinite(r["xyz"]).all()
                             for r in runs.values()),
        "64 keyframes out": all(r["Tcw"].shape[0] == 64 for r in runs.values()),
        "within tolerance": all(dT <= GBA_POSE_ATOL and dX <= GBA_XYZ_ATOL
                                and dE <= GBA_XYZ_ATOL for dT, dX, dE in gaps.values()),
    }
    failed = [k for k, ok in checks.items() if not ok] + repeat_bad
    if failed:
        raise SystemExit(f"chip_smoke: phase 15 (d) failed: {failed}")


def fleet_phase(card, device="cuda"):
    """Phase 15 (e): `dryrun_multichip` on the cards there are. Returns the
    ranks' kernel launches."""
    import torch

    from splslam_tpu_torch.graft_entry import dryrun_multichip

    n = torch.cuda.device_count() if torch.device(device).type == "cuda" else 2
    t0 = time.perf_counter()
    out = dryrun_multichip(n, device)
    print(f"dryrun_multichip({n}): fleet poses {out['Tcw'].shape}, fleet inliers "
          f"{out['fleet_inliers']}, sharded BA {out['gba_keyframes']} keyframes, "
          f"n_guarded {out['n_guarded']}, kernel launches {out['launches']}, "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    if out["launches"] != n and torch.device(device).type == "cuda":
        raise SystemExit(f"chip_smoke: dryrun_multichip launched the kernel "
                         f"{out['launches']} times for {n} fleet rows")
    return out["launches"]


# ---- phase 16: the entry point, and the JAX package's proof suites ----

PROOF_W, PROOF_H = 320, 240   # the proof suites' frames (tests/test_e2e_*.py)
ENTRY_TCW_ATOL = 1e-5         # tests/test_torch_entry.py
# The JAX package's tour cells of tests/test_e2e_parity_matrix.py: ATE as %
# of the path, from its `_run_cell` on the CPU (JAX_PLATFORMS=cpu; `pytest -m
# slow -s` prints them to two decimals). The port's tour cells are held to
# these within TOUR_TOL_PP percentage points as well as to the suite's own
# 1.25% gate. The trajectories are chaotic under float reordering: the port
# on the CPU lands 0.017-0.085 points from these values; 0.25 is a fifth of
# the gate.
TOUR_JAX_PCT = {5: 0.5074735005035138, 7: 1.018809304200117, 9: 1.039589814319185}
TOUR_TOL_PP = 0.25
PHASE16_MATRIX_SEED = 5      # phase 16's corridor cell; the GPU tests run all six
PHASE16_PLACES = 120         # of the suite's 360, which the GPU tests run


def failed_gates(title, gates):
    """Print each gate (name, value, op, limit) beside its value; return
    the names of those that fail."""
    ops = {"<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
           "==": lambda a, b: a == b, ">": lambda a, b: a > b}
    bad = []
    for name, value, op, limit in gates:
        ok = bool(ops[op](value, limit))
        print(f"{title}: {name}: {value} {op} {limit} {'ok' if ok else 'FAILED'}")
        if not ok:
            bad.append(name)
    return bad


def _proof_settings(K, bf, **kw):
    from splslam_tpu_torch.slam.system import Settings

    return Settings(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                    cy=float(K[1, 2]), bf=float(bf), width=PROOF_W, height=PROOF_H,
                    n_features=600, n_levels=4, th_depth=40.0, fps=10, **kw)


def _track_all(st, frames, device):
    from splslam_tpu_torch.slam.system import Sensor, System

    sysm = System(st, Sensor.STEREO, device)
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    return sysm


def entry_case(device):
    """`graft_entry.entry(device)` on the reference's example arguments and
    on a rendered grid pair (whose line detector finds segments), against
    `entry("cpu")` on the same arguments: the inlier count and the 8-slot
    frame's valid lines equal, Tcw within ENTRY_TCW_ATOL. Returns (gates,
    frames built on `device`)."""
    import numpy as np
    import torch

    from splslam_tpu_torch import graft_entry
    from splslam_tpu_torch.io.synthetic import make_stereo_sequence
    from splslam_tpu_torch.slam.frame import build_frame_stereo

    _, _, grid, _ = make_stereo_sequence(n_frames=1, width=128, height=96,
                                         texture="grid", seed=1)
    gates = []
    for name, imgs in (("reference args", None), ("grid pair", grid[0])):
        out = {}
        for dev in (device, "cpu"):
            fn, args = graft_entry.entry(dev)
            if imgs is not None:
                args = tuple(torch.from_numpy(np.asarray(x, np.float32)).to(dev)
                             for x in imgs) + args[2:]
            Tcw, n_in = fn(*args)
            cam, spec, scales, _ = graft_entry._setup(dev)
            lines = build_frame_stereo(args[0], args[1], cam, spec, scales).lines
            out[dev] = (Tcw.cpu().numpy(), int(n_in), int(lines.valid.sum()),
                        lines.capacity)
        (Tg, ng, lg, cap), (Tc, nc, lc, _) = out[device], out["cpu"]
        gates += [(f"{name}: line slots", cap, "==", 8),
                  (f"{name}: Tcw finite", bool(np.isfinite(Tg).all()), "==", True),
                  (f"{name}: Tcw off the CPU's", float(np.abs(Tg - Tc).max()), "<=",
                   ENTRY_TCW_ATOL),
                  (f"{name}: n_inliers (CPU {nc})", ng, "==", nc),
                  (f"{name}: valid lines (CPU {lc})", lg, "==", lc)]
        if imgs is not None:
            gates.append((f"{name}: valid lines", lg, ">", 0))
    return gates, 4


def _paste_moving_object(frames, W=PROOF_W, H=PROOF_H, seed=7):
    """tests/test_e2e_robustness.py's moving patch: a 72x56 textured patch
    at the same pixels in both eyes, sweeping diagonally across the view."""
    import numpy as np

    patch = np.random.default_rng(seed).uniform(40, 215, size=(56, 72)).astype(np.float32)
    out = []
    n = len(frames)
    for i, (l, r) in enumerate(frames):
        l, r = np.asarray(l).copy(), np.asarray(r).copy()
        x = int((0.15 + 0.6 * ((1.7 * i / n) % 1.0)) * (W - 72))
        y = int((0.2 + 0.5 * ((1.1 * i / n) % 1.0)) * (H - 56))
        for img in (l, r):
            img[y:y + 56, x:x + 72] = patch
        out.append((l, r))
    return out


def dynamic_object_case(device):
    """tests/test_e2e_robustness.py::test_dynamic_object_does_not_break_tracking:
    60 corridor frames, clean and with the moving patch, mapping on. Returns
    (gates, frames built)."""
    from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence, path_length
    from splslam_tpu_torch.slam.system import TrackingState

    K, bf, frames, gt = make_stereo_sequence(n_frames=60, motion="forward",
                                             width=PROOF_W, height=PROOF_H, seed=11,
                                             scene="corridor", speed=0.5)
    path = path_length(gt)
    st = _proof_settings(K, bf, max_points=16384, max_keyframes=64, local_window=1024,
                         enable_local_mapping=True)
    clean = _track_all(st, frames, device)
    ate_clean = ate_rmse(clean.poses(), gt)
    sysm = _track_all(st, _paste_moving_object(frames), device)
    ate = ate_rmse(sysm.poses(), gt)
    print(f"dynamic object: path {path:.2f}, clean ATE {ate_clean:.5f} "
          f"({100 * ate_clean / path:.3f}%), patch ATE {ate:.5f} ({100 * ate / path:.3f}%), "
          f"{sysm.n_kfs} keyframes, health {sysm.health()}")
    return [("clean state", clean.get_tracking_state().name, "==", TrackingState.OK.name),
            ("patch state", sysm.get_tracking_state().name, "==", TrackingState.OK.name),
            ("patch ATE", ate, "<=", 0.02 * path),
            ("patch ATE", ate, "<=", ate_clean + 0.01 * path),
            ("mapping_state_revert", sysm.mapper.n_state_revert, "==", 0),
            ("mapping_guarded", sysm.mapper.n_guarded, "<=", 2)], 2 * len(frames)


def hundreds_of_keyframes_case(device):
    """tests/test_e2e_robustness.py::test_hundreds_of_keyframes_map: a
    400-frame palindromic lateral shuttle with a keyframe every 3 frames,
    then `_correct` of a measured Sim3 between the latest live keyframe and
    the nearest early one. Returns (gates, frames built)."""
    import numpy as np
    import torch

    from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence, path_length
    from splslam_tpu_torch.slam.loop_closing import compute_sim3_attempt
    from splslam_tpu_torch.slam.system import TrackingState

    K, bf, leg, gt_leg = make_stereo_sequence(n_frames=100, motion="lateral",
                                              width=PROOF_W, height=PROOF_H, seed=3)
    cycle = leg + leg[-2:0:-1]
    n_frames = 400
    frames = [cycle[i % len(cycle)] for i in range(n_frames)]
    gt_cycle = np.concatenate([gt_leg, gt_leg[-2:0:-1]], axis=0)
    gt = np.stack([gt_cycle[i % len(gt_cycle)] for i in range(n_frames)])
    st = _proof_settings(K, bf, max_points=65536, max_keyframes=256, local_window=1024,
                         enable_local_mapping=True, force_kf_every=3, min_kf_gap=1)
    sysm = _track_all(st, frames, device)
    steps = sysm.mapper.n_steps
    path = path_length(gt)
    ate = ate_rmse(sysm.poses(), gt)
    n_live = int(sysm.map.kfs.valid.sum())
    print(f"hundreds of keyframes: inserted {sysm.n_kfs}, live {n_live}, mapping "
          f"steps {steps}, ATE {ate:.5f} ({100 * ate / path:.3f}% of path), health "
          f"{sysm.health()}")
    gates = [("state", sysm.get_tracking_state().name, "==", TrackingState.OK.name),
             ("keyframes inserted", sysm.n_kfs, ">=", 100),
             ("mapping steps", steps, ">=", 90),
             ("mapping_state_revert", sysm.mapper.n_state_revert, "==", 0),
             ("mapping_guarded", sysm.mapper.n_guarded, "<=", max(3, steps // 25)),
             ("ATE", ate, "<=", 0.02 * path)]

    n = sysm.n_kfs
    live = np.nonzero(sysm.map.kfs.valid[:n].cpu().numpy())[0]
    Tcw_all = sysm.map.kfs.Tcw[:n].cpu().numpy()
    kf = int(live[-1])
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]
    d = [np.linalg.norm(centre(Tcw_all[c]) - centre(Tcw_all[kf]))
         for c in live[: len(live) // 2]]
    best = int(live[int(np.argmin(d))])
    K3 = sysm.cam.K.to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(kf)
    n_m, n_opt, n_proj, _, S12 = compute_sim3_attempt(sysm.map, kf, best, K3, True,
                                                      generator=gen)
    t0 = time.perf_counter()
    sysm.loop_closer._correct(kf, best, S12)
    wall = time.perf_counter() - t0
    ate2 = ate_rmse(sysm.poses_reconstructed(), gt)
    print(f"loop pair ({kf}, {best}) {min(d):.3f} apart: matches {int(n_m)}, Sim3 "
          f"inliers {int(n_opt)}, projected {int(n_proj)}; corrected {len(live)} live "
          f"keyframes in {wall:.1f} s, ATE after {ate2:.5f} ({100 * ate2 / path:.3f}%)")
    gates += [("Sim3 inliers", int(n_opt), ">=", 10),
              ("loop_guarded", sysm.loop_closer.n_guarded, "==", 0),
              ("poses finite after", bool(torch.isfinite(sysm.map.kfs.Tcw[:n]).all()),
               "==", True),
              ("ATE after the correction", ate2, "<=", 0.025 * path)]
    return gates, n_frames


def _place_views(n_places):
    """tests/test_bow_retrieval.py's places: views 0.55 units apart over the
    textured plane, and each revisited from a 0.1-unit offset + 1.5 deg yaw."""
    import numpy as np

    from splslam_tpu_torch.io.synthetic import PlaneScene, make_texture

    K = np.array([[200.0, 0, PROOF_W / 2], [0, 200.0, PROOF_H / 2], [0, 0, 1]], np.float32)
    scene = PlaneScene(make_texture(seed=42, size=8192), z0=3.0, z1=7.0,
                       px_per_unit=40.0)
    th = np.deg2rad(1.5)
    Ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                   [-np.sin(th), 0, np.cos(th)]], np.float32)
    originals, revisits = [], []
    for i in range(n_places):
        Twc = np.eye(4)
        Twc[0, 3] = 0.55 * i
        originals.append(scene.render(K, Twc, PROOF_H, PROOF_W))
        Twc2 = Twc.copy()
        Twc2[:3, :3] = Ry
        Twc2[0, 3] += 0.1
        Twc2[1, 3] += 0.05
        revisits.append(scene.render(K, Twc2, PROOF_H, PROOF_W))
    return originals, revisits


def _bow_query(voc, spec, img, device):
    import numpy as np
    import torch

    from splslam_tpu_torch.bow import vocabulary as V
    from splslam_tpu_torch.ops.orb import extract_orb

    f = extract_orb(torch.from_numpy(np.asarray(img, np.float32)).to(device), spec)
    return V.query_bow(voc.level_desc, voc.weights, voc.k, voc.depth, f.desc, f.valid)


def place_retrieval_case(device, n_places=360):
    """tests/test_bow_retrieval.py::test_top1_retrieval_precision_at_map_scale
    with the bundled 10^5-word vocabulary: top-1 of each revisit among the
    places by the L1 score. Returns (gates, frames built)."""
    import numpy as np

    from splslam_tpu_torch.bow import vocabulary as V
    from splslam_tpu_torch.ops.pyramid import PyramidSpec

    voc = V.load(V.default_vocab_path(), device)
    spec = PyramidSpec.create(PROOF_H, PROOF_W, n_features=500, n_levels=4)
    originals, revisits = _place_views(n_places)
    db = np.stack([_bow_query(voc, spec, im, device).cpu().numpy() for im in originals])
    q = np.stack([_bow_query(voc, spec, im, device).cpu().numpy() for im in revisits])
    scores = np.minimum(db[None, :, :], q[:, None, :]).sum(-1)
    off = scores.argmax(1) - np.arange(n_places)
    own = scores[np.arange(n_places), np.arange(n_places)]
    far = scores.copy()
    idx = np.arange(n_places)
    for d in range(-3, 4):
        ok = (idx + d >= 0) & (idx + d < n_places)
        far[idx[ok], idx[ok] + d] = -1
    sep = float(np.median(own / np.maximum(far.max(1), 1e-9)))
    print(f"place retrieval, {n_places} places ({voc.n_words} words): far misses "
          f"{int((np.abs(off) > 3).sum())}, top-1 within 1 {(np.abs(off) <= 1).mean():.4f}, "
          f"within 2 {(np.abs(off) <= 2).mean():.4f}, median own/far {sep:.3f}")
    return [("far misses", int((np.abs(off) > 3).sum()), "==", 0),
            ("top-1 within 2 places", float((np.abs(off) <= 2).mean()), ">=", 0.95),
            ("top-1 within 1 place", float((np.abs(off) <= 1).mean()), ">=", 0.70),
            ("median own/far score", sep, ">", 1.1)], 2 * n_places


def tracked_map_retrieval_case(device, n_frames=950):
    """tests/test_bow_retrieval.py::test_retrieval_on_tracked_300kf_map: a
    950-frame lateral track with a keyframe every 3 frames (mapping and
    loop closing off), then a revisit query every 10th keyframe scored
    against the keyframe rows by `reloc_scores`. Returns (gates, frames
    built)."""
    import numpy as np
    import torch

    from splslam_tpu_torch.io.synthetic import PlaneScene, make_texture
    from splslam_tpu_torch.slam.reloc import reloc_scores
    from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

    FX, BASE = 200.0, 0.12
    K = np.array([[FX, 0, PROOF_W / 2], [0, FX, PROOF_H / 2], [0, 0, 1]], np.float32)
    scene = PlaneScene(make_texture(seed=42, size=8192), z0=3.0, z1=7.0,
                       px_per_unit=40.0)
    st = Settings(fx=FX, fy=FX, cx=PROOF_W / 2, cy=PROOF_H / 2, bf=FX * BASE,
                  width=PROOF_W, height=PROOF_H, n_features=500, n_levels=4,
                  th_depth=60.0, fps=10, max_points=65536, max_keyframes=512,
                  local_window=1024, enable_local_mapping=False, force_kf_every=2,
                  min_kf_gap=1, enable_loop_closing=False)
    sysm = System(st, Sensor.STEREO, device)
    kf_x = {}
    for i in range(n_frames):
        Twc = np.eye(4)
        Twc[0, 3] = 0.04 * i
        Twc[1, 3] = 0.01 * np.sin(i * 0.3)
        Twc_r = Twc.copy()
        Twc_r[0, 3] += BASE
        n_before = sysm.n_kfs
        sysm.track_stereo(scene.render(K, Twc, PROOF_H, PROOF_W),
                          scene.render(K, Twc_r, PROOF_H, PROOF_W), i * 0.1)
        if sysm.n_kfs > n_before:
            kf_x[sysm.n_kfs - 1] = float(Twc[0, 3])
    sysm.drain()
    n_kfs = sysm.n_kfs
    th = np.deg2rad(1.5)
    Ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                   [-np.sin(th), 0, np.cos(th)]], np.float32)
    xs = np.array([kf_x.get(k, np.nan) for k in range(n_kfs)])
    exclude = torch.zeros((st.max_keyframes,), dtype=torch.bool, device=device)
    offs, n_far = [], 0
    for k in range(5, n_kfs - 5, 10):
        Twc = np.eye(4)
        Twc[:3, :3] = Ry
        Twc[0, 3] = xs[k] + 0.1
        Twc[1, 3] = 0.05
        q = _bow_query(sysm.vocab, sysm.spec, scene.render(K, Twc, PROOF_H, PROOF_W),
                       device)
        scores = reloc_scores(sysm.kf_bow.ids, sysm.kf_bow.vals, sysm.map.kfs.valid,
                              q, exclude).cpu().numpy()[:n_kfs]
        d = abs(xs[int(scores.argmax())] - xs[k])
        offs.append(d)
        n_far += d > 40 * BASE
    offs = np.array(offs)
    near = float((offs <= 16 * BASE).mean())
    print(f"tracked-map retrieval: {n_kfs} keyframes over {0.04 * n_frames:.1f} units, "
          f"{len(offs)} queries, top-1 within 1.9 units {near:.4f}, median off "
          f"{np.median(offs):.3f}, far misses {n_far}")
    return [("state", sysm.get_tracking_state().name, "==", TrackingState.OK.name),
            ("keyframes", n_kfs, ">=", 300),
            ("far misses", int(n_far), "==", 0),
            ("top-1 within 16 keyframes", near, ">=", 0.9)], n_frames + len(offs)


def matrix_cell_case(device, profile, seed):
    """One cell of tests/test_e2e_parity_matrix.py: "tour" (the two-plane
    scene, 300 frames, a keyframe every 4) gated at 1.25% of the path and
    held to the JAX package's value within TOUR_TOL_PP; "corridor"
    (forward, 220 frames at speed 0.6) gated at 1%. Returns (gates, frames
    built)."""
    from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence, path_length
    from splslam_tpu_torch.slam.system import TrackingState

    if profile == "tour":
        motion, scene, n, speed, force_kf, gate = "tour", "planes", 300, 1.0, 4, 1.25
    else:
        motion, scene, n, speed, force_kf, gate = "forward", "corridor", 220, 0.6, 0, 1.0
    K, bf, frames, gt = make_stereo_sequence(n_frames=n, motion=motion, width=PROOF_W,
                                             height=PROOF_H, lighting_drift=0.1,
                                             seed=seed, scene=scene, speed=speed)
    st = _proof_settings(K, bf, max_points=16384, max_keyframes=128, local_window=1024,
                         enable_local_mapping=True, force_kf_every=force_kf, min_kf_gap=1)
    sysm = _track_all(st, frames, device)
    path = path_length(gt)
    pct = 100 * ate_rmse(sysm.poses(), gt) / path
    print(f"matrix {profile} seed {seed}: path {path:.3f}, ATE {pct:.4f}% of path "
          f"(gate {gate}%), {sysm.n_kfs} keyframes, health {sysm.health()}")
    gates = [("state", sysm.get_tracking_state().name, "==", TrackingState.OK.name),
             ("ATE % of path", pct, "<=", gate)]
    if profile == "tour":
        gates.append((f"ATE % off the JAX package's {TOUR_JAX_PCT[seed]:.4f}",
                      abs(pct - TOUR_JAX_PCT[seed]), "<=", TOUR_TOL_PP))
    return gates, n


def _plane_frames(n=6):
    """tests/test_line_repeatability.py's grid-plane pairs: frame i at x =
    0.05 i and frame i+1 at x = 0.05 (i+1), 0.01 up, with their Tcw."""
    import numpy as np

    from splslam_tpu_torch.io.synthetic import PlaneScene, make_grid_texture

    K = np.array([[200.0, 0, PROOF_W / 2], [0, 200.0, PROOF_H / 2], [0, 0, 1]], np.float32)
    scene = PlaneScene(make_grid_texture(seed=0), z0=3.0, z1=None)
    out = []
    for i in range(n):
        C1, C2 = np.eye(4), np.eye(4)
        C1[0, 3] = 0.05 * i
        C2[0, 3] = 0.05 * (i + 1)
        C2[1, 3] = 0.01
        out.append((scene.render(K, C1, PROOF_H, PROOF_W), scene.render(K, C2, PROOF_H, PROOF_W),
                    np.linalg.inv(C1).astype(np.float32), np.linalg.inv(C2).astype(np.float32)))
    return out


def line_repeatability_case(device):
    """tests/test_line_repeatability.py: `extract_lines` (64 slots) on 6
    grid-plane pairs; the matcher-level re-association of
    `line_projection_match` (rows and columns whose match lies within 8 px
    and 0.15 rad of the projected line) and the geometric repeatability
    (midpoint within 12 px of the motion-predicted one, angle within 0.1
    rad, length within 50%). Returns (gates, frames built)."""
    import numpy as np
    import torch

    from splslam_tpu_torch.geometry.camera import Camera
    from splslam_tpu_torch.ops.lines import extract_lines
    from splslam_tpu_torch.slam.tracking import line_projection_match

    FX, W, H = 200.0, PROOF_W, PROOF_H
    cam = Camera.create(FX, FX, W / 2, H / 2, bf=24.0, width=W, height=H)
    host = lambda f: {k: getattr(f, k).cpu().numpy()
                      for k in ("valid", "seg", "angle", "midpoint", "length")}

    def unproj_plane(Tc, uv):
        Twc = np.linalg.inv(Tc)
        d = np.stack([(uv[:, 0] - W / 2) / FX, (uv[:, 1] - H / 2) / FX,
                      np.ones(len(uv))], -1) @ Twc[:3, :3].T
        t = (3.0 - Twc[2, 3]) / d[:, 2]
        return Twc[:3, 3][None] + d * t[:, None]

    rows, cols, reps = [], [], []
    for im1, im2, T1, T2 in _plane_frames():
        f1, f2 = (extract_lines(torch.from_numpy(im).to(device), capacity=64)
                  for im in (im1, im2))
        h1, h2 = host(f1), host(f2)
        v1, v2 = h1["valid"], h2["valid"]
        S, E = unproj_plane(T1, h1["seg"][:, :2]), unproj_plane(T1, h1["seg"][:, 2:4])
        xyz3 = np.stack([S, 0.5 * (S + E), E], 1).astype(np.float32)
        mt, _ = line_projection_match(
            cam, torch.from_numpy(T2).to(device), f2, torch.from_numpy(xyz3).to(device),
            f1.desc, f1.length, f1.valid, torch.zeros((64,), dtype=torch.bool,
                                                      device=device))
        mt = mt.cpu().numpy()
        good, goodcols = 0, set()
        for j in np.nonzero(v1)[0]:
            c = mt[j]
            if c < 0:
                continue
            pc = xyz3[j] @ T2[:3, :3].T + T2[:3, 3]
            uv = np.stack([FX * pc[:, 0] / pc[:, 2] + W / 2,
                           FX * pc[:, 1] / pc[:, 2] + H / 2], -1)
            d2 = uv[2] - uv[0]
            dv = d2 / max(np.linalg.norm(d2), 1e-6)
            perp = abs((h2["midpoint"][c] - uv[1]) @ np.array([-dv[1], dv[0]]))
            ang = np.abs(np.angle(np.exp(1j * (h2["angle"][c] - np.arctan2(d2[1], d2[0])))))
            if perp < 8.0 and min(ang, np.pi - ang) < 0.15:
                good += 1
                goodcols.add(int(c))
        rows.append(good / max(v1.sum(), 1))
        cols.append(len(goodcols) / max(v2.sum(), 1))

        m1, m2 = h1["midpoint"][v1], h2["midpoint"][v2]
        a1, a2 = h1["angle"][v1], h2["angle"][v2]
        l1, l2 = h1["length"][v1], h2["length"][v2]
        pred = m1 + np.array([-FX * 0.05 / 3.0, -FX * 0.01 / 3.0])
        hit = 0
        for j in range(len(m1)):
            ang = np.abs(np.angle(np.exp(1j * (a2 - a1[j]))))
            ok = ((np.linalg.norm(m2 - pred[j], axis=-1) < 12.0)
                  & (np.minimum(ang, np.pi - ang) < 0.1)
                  & (np.abs(l2 - l1[j]) < 0.5 * np.maximum(l2, l1[j])))
            hit += bool(ok.any())
        reps.append(hit / max(len(m1), 1))
    row, col, rep = (float(np.mean(x)) for x in (rows, cols, reps))
    print(f"line repeatability: matcher re-association row-side {row:.4f} col-side "
          f"{col:.4f}, geometric {rep:.4f}")
    return [("matcher re-association, rows", row, ">=", 0.50),
            ("matcher re-association, columns", col, ">=", 0.57),
            ("geometric repeatability", rep, ">=", 0.62)], 0


def proof_phase(card, device="cuda"):
    """Phase 16: `entry()` with its 8-slot line table on the card against
    the CPU, then one case of each proof suite the port holds to the JAX
    package's gates: the dynamic object (robustness), the place
    retrieval over PHASE16_PLACES places, the corridor cell of seed
    PHASE16_MATRIX_SEED (the parity matrix) and the line repeatability
    floors. Each gate prints beside its value; the kernel launches of the
    phase (one a frame built) are counted from 0 and returned."""
    from splslam_tpu_torch.ops import orb_kernel as OK

    t_phase = time.perf_counter()
    cases = [("entry", lambda: entry_case(device)),
             ("dynamic object", lambda: dynamic_object_case(device)),
             ("place retrieval", lambda: place_retrieval_case(device, PHASE16_PLACES)),
             (f"matrix corridor seed {PHASE16_MATRIX_SEED}",
              lambda: matrix_cell_case(device, "corridor", PHASE16_MATRIX_SEED)),
             ("line repeatability", lambda: line_repeatability_case(device))]
    total, bad = 0, []
    for title, run in cases:
        OK.orb_describe.launches = 0
        t0 = time.perf_counter()
        gates, built = run()
        launches = OK.orb_describe.launches
        total += launches
        bad += [f"{title}: {g}" for g in failed_gates(title, gates + [
            ("kernel launches, one a frame built", launches, "==", built)])]
        print(f"{title}: {time.perf_counter() - t0:.1f} s on {card}")
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s, kernel launches {total}")
    if bad:
        raise SystemExit(f"chip_smoke: phase 16 failed: {bad}")
    return total


def bench_short_sizes():
    """The four benches cut to phase 17's short run on the card (full
    widths, short sequences, one repeat)."""
    from splslam_tpu_torch.bench import components, mapping, mono, stereo

    return {
        stereo: dataclasses.replace(
            stereo.FULL, leg=16, n_frames=16, batch=8, warmup=8, per_frame=8,
            per_frame_skip=4, realistic_frames=17, realistic_warmup=0,
            realistic_trace_batches=1, trace_frames=1),
        mapping: dataclasses.replace(mapping.FULL, calls=1),
        mono: dataclasses.replace(mono.FULL, n_frames=12, warmup_frames=0),
        components: dataclasses.replace(components.FULL, trials=1, reloc_trials=2,
                                        latency_reps=5, warmup_frames=0),
    }


def bench_phase(card, device="cuda", sizes=None):
    """Phase 17: the port's bench (`bench_torch.py`'s four benches) in
    process at a short size, one repeat each: every row ok, and every row
    names this card. Returns the kernel launches of the phase, counted
    from 0."""
    import torch

    from splslam_tpu_torch.bench import common
    from splslam_tpu_torch.ops import orb_kernel as OK

    t_phase = time.perf_counter()
    dev = torch.device(device)
    info = common.device_info(dev)
    OK.orb_describe.launches = 0
    rows = []
    for mod, size in (sizes or bench_short_sizes()).items():
        name = mod.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        rows += mod.run(common.Bench(name, dev, repeats=1, info=info), size)
        print(f"bench {name}: {time.perf_counter() - t0:.1f} s on {card}")
    launches = OK.orb_describe.launches
    for r in rows:
        tr = r.get("trace") or {}
        print(f"  {r['metric']}: {r['value']} {r['unit']}, ok {r['ok']}, median "
              f"{r.get('median_ms')} ms, p90 {r.get('p90_ms')} ms, n {r.get('n')}, idle "
              f"share {tr.get('device_idle_share')}"
              + ("" if r["ok"] else f", checks {r['checks']}"))
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s, {len(rows)} rows, kernel "
          f"launches {launches}")
    on_card = (info == "cpu" if dev.type == "cpu" else
               isinstance(info, dict) and info["nvidia_smi"] == card
               and info["kind"] == torch.cuda.get_device_name(0))
    checks = {
        "every row ok": all(r["ok"] for r in rows),
        "every row names this device": on_card and all(r["device"] == info for r in rows),
        "the kernel launched": launches > 0 or dev.type != "cuda",
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: bench phase failed: {failed}: "
                         f"{[r['metric'] for r in rows if not r['ok']]}")
    return launches


def _line_ints(m):
    """The integer tables of a map (points, lines, keyframe rows) on the
    host."""
    t = {"n_pts": m.n_pts, "n_lns": m.n_lns, "pts.valid": m.pts.valid,
         "pts.n_obs": m.pts.n_obs, "kfs.lm_idx": m.kfs.lm_idx, "kfs.valid": m.kfs.valid,
         "lns.valid": m.lns.valid, "lns.n_obs": m.lns.n_obs,
         "lns.first_kf": m.lns.first_kf, "kfs.ll_idx": m.kfs.ll_idx}
    return {k: v.to("cpu", copy=True) for k, v in t.items()}


if __name__ == "__main__":
    sys.exit(main())
