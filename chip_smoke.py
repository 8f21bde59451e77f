"""Smoke run of the PyTorch/CUDA port (`splslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. report the card (nvidia-smi name and power limit), torch and CUDA
     versions; turn TF32 off for matmuls and cuDNN;
  2. build the hand-written kernel from this checkout's sources;
  3. hold the kernel against its plain PyTorch version at main-path
     shapes (the packed pyramid and 2000 corners of one 1241x376 frame):
     angle within 1e-3 rad, descriptor bits >= 99.5% equal; time both
     with CUDA events (median of 20 after 3 warm-ups);
  4. drive the port's main path, `System(..., device="cuda").track_stereo`,
     over 40 KITTI-sized synthetic stereo frames at the benchmark
     configuration (2000 features, 8 levels, 65536 points, 256 keyframes,
     2048-landmark local window; local mapping and relocalization off):
     the run must stay OK with no frame lost, keep ATE-RMSE within 1% of
     the path length, and launch the kernel at least twice per frame.

Prints a JSON line describing each kernel, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when no CUDA device is present. Uses no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

ANGLE_ATOL = 1e-3    # rad; the repo's kernel tolerance (tests/test_orb_pallas.py)
BIT_AGREE = 0.995    # descriptor bits; same source
N_FRAMES = 40
KITTI_W, KITTI_H = 1241, 376


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


def bit_agreement(d1, d2) -> float:
    import numpy as np

    b1 = np.unpackbits(d1.cpu().numpy().view(np.uint8))
    b2 = np.unpackbits(d2.cpu().numpy().view(np.uint8))
    return float((b1 == b2).mean())


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    from splslam_tpu.io.synthetic import ate_rmse, make_stereo_sequence, path_length
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.ops.orb import detect_and_pack
    from splslam_tpu_torch.ops.pyramid import PyramidSpec
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

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = OK.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain at main-path shapes ----
    K, bf, frames, gt = make_stereo_sequence(
        n_frames=N_FRAMES, width=KITTI_W, height=KITTI_H,
        fx=718.0, baseline=0.54, motion="forward", seed=3,
    )
    st = Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=KITTI_W, height=KITTI_H,
        n_features=2000, n_levels=8, th_depth=35.0, fps=10.0,
        max_points=65536, max_keyframes=256, local_window=2048,
        enable_local_mapping=False, enable_relocalization=False,
    )
    spec = PyramidSpec.create(KITTI_H, KITTI_W, st.n_levels, st.scale_factor,
                              st.n_features)
    img = torch.from_numpy(frames[0][0].astype(np.uint8)).cuda().float()
    _, packed, cy, cx = detect_and_pack(img, spec)
    ang_k, desc_k = OK.orb_describe(packed, cy, cx)
    ang_p, desc_p = OK.orb_describe_reference(packed, cy, cx)
    torch.cuda.synchronize()
    err = float((ang_k - ang_p).abs().max())
    agree = bit_agreement(desc_k, desc_p)
    words = float((desc_k == desc_p).float().mean())
    print(f"orb_describe vs plain at N={cy.shape[0]}, packed "
          f"{tuple(packed.shape)}: angle max abs err {err:.3e} rad, "
          f"desc bits agree {agree:.6f}, words equal {words:.6f}")
    if not (np.isfinite(err) and err <= ANGLE_ATOL and agree >= BIT_AGREE):
        raise SystemExit("chip_smoke: kernel disagrees with its plain version")
    k_ms = cuda_ms(lambda: OK.orb_describe(packed, cy, cx))
    p_ms = cuda_ms(lambda: OK.orb_describe_reference(packed, cy, cx))
    print(f"orb_describe: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
          f"(median of 20, N={cy.shape[0]}) on {card}")

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
        ">= 2 kernel launches per frame": launches >= 2 * N_FRAMES,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: main path failed: {failed}")

    print(json.dumps({"kernels": [{
        "name": "orb_describe",
        "route": "cuda",
        "source": "splslam_tpu_torch/csrc/orb_describe.cu",
        "replaces": "splslam_tpu/ops/orb_pallas.py:172",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
