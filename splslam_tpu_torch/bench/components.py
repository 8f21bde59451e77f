"""The reference report's component experiments (its Tables 5 and 6):
the port of bench_components.py.

- `mono_init_success_low_texture` (bench_components.py:45-118): the
  low-texture grid scene of 10 seeds, 14 frames of lateral motion each,
  monocular init with and without lines; the successes and the
  landmark and line counts are the values (Table 5 fr1_floor: SPL-SLAM
  9/10, ORB-SLAM 1/10).
- `reloc_solver_success_and_latency` (bench_components.py:121-246): 10
  problems with 30% contamination; the point solver (minimal PnP RANSAC,
  the EPnP analog) and the line solver (EPnL) each followed by the pose
  GN refinement. Success: within 2 degrees and 5 cm. Latency: the synced
  wall of one solve (its hypothesis draws and RANSAC, as the JAX bench's
  timed function), median of 100 (Table 6: 0.52 and 0.20 ms on a CPU).
  The RANSAC draws come from `torch.Generator`s seeded from the seed and
  the trial index.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from splslam_tpu_torch.bench.common import BASELINE_MS, Bench, cuts, launches, summary
from splslam_tpu_torch.geometry import se3
from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.io.synthetic import PlaneScene, make_texture
from splslam_tpu_torch.ops import orb_kernel
from splslam_tpu_torch.optim.pose_gn import LineObs, PointObs, pose_optimize
from splslam_tpu_torch.slam.reloc import (N_HYP, N_HYP_LINES, epnl_ransac, pnp_ransac,
                                          sample_minimal_sets)
from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

W, H = 320, 240             # bench_components.py:40
ROT_GATE_DEG = 2.0
T_GATE_M = 0.05
N_PT, N_LN = 128, 64        # bench_components.py:136


@dataclass(frozen=True)
class Size:
    trials: int = 10         # bench_components.py:41
    frames: int = 14
    reloc_trials: int = 10
    latency_reps: int = 100
    warmup_frames: int = 3   # of a throwaway init trial before the rows (0: none)


FULL = Size()
SMALL = Size(trials=1, frames=8, reloc_trials=2, latency_reps=5, warmup_frames=0)


def _low_texture_grid(seed):
    """bench_components.py:45: a low-contrast texture crossed by dark grid
    strokes."""
    t = make_texture(seed=seed, size=2048)
    t = 128.0 + (t - 128.0) * 0.12
    for i in range(0, 2048, 96):
        t[i:i + 7, :] = 30.0
        t[:, i:i + 7] = 30.0
    return t.astype(np.float32)


def init_settings(using_line: bool) -> Settings:
    """bench_components.py:77-84."""
    return Settings(
        fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, bf=0.0, width=W, height=H,
        n_features=500, n_levels=4, fps=10, max_points=8192, max_keyframes=32,
        local_window=512, enable_local_mapping=False, using_line=using_line,
        line_features=64)


def init_trial(b: Bench, seed: int, using_line: bool, n_frames: int) -> dict:
    """bench_components.py:59-90: success = state OK within the frames;
    the synced ms of the frame that initialized."""
    K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1]], np.float32)
    scene = PlaneScene(_low_texture_grid(seed), z0=3.0, z1=None, px_per_unit=60.0)
    phase = np.random.default_rng(seed).uniform(0, 3.0)
    sysm = b.setup("systems", System, init_settings(using_line), Sensor.MONOCULAR, b.device)
    for i in range(n_frames):
        Twc = np.eye(4)
        Twc[0, 3] = 0.06 * i
        Twc[1, 3] = 0.01 * np.sin(i + phase)
        img = scene.render(K, Twc, H, W)
        _, ms = b.timed(sysm.track_mono, img, i * 0.1)
        if sysm.get_tracking_state() == TrackingState.OK:
            return {"seed": seed, "ok": True, "frame": i, "init_ms": ms, "built": i + 1,
                    "points": int(sysm.map.pts.valid.sum()),
                    "lines": int(sysm.map.lns.valid.sum())}
    return {"seed": seed, "ok": False, "frame": None, "init_ms": None, "built": n_frames,
            "points": 0, "lines": 0}


def init_row(b: Bench, size: Size) -> dict:
    seeds = [100 + s + b.seed for s in range(size.trials)]
    reps = {True: [], False: []}
    orb_ok = True
    for _ in range(b.repeats):
        for using_line in (True, False):
            n0 = launches()
            trials = [init_trial(b, s, using_line, size.frames) for s in seeds]
            built = sum(t["built"] for t in trials)
            orb_ok &= launches() - n0 == (built if b.cuda else 0)
            reps[using_line].append(trials)

    def tally(trials):
        ok = [t for t in trials if t["ok"]]
        return {"success": f"{len(ok)}/{len(trials)}", "successes": len(ok),
                "mean_points": float(np.mean([t["points"] for t in ok])) if ok else 0.0,
                "mean_lines": float(np.mean([t["lines"] for t in ok])) if ok else 0.0,
                "init_frames": [t["frame"] for t in trials]}

    pl, po = tally(reps[True][0]), tally(reps[False][0])
    same = all(tally(r) == pl for r in reps[True]) and all(tally(r) == po for r in reps[False])
    init_ms = summary([[t["init_ms"] for t in r if t["ok"]] for r in reps[True]])
    trace = b.trace(f"low-texture init trial, seed {seeds[0]}, with lines",
                    lambda: init_trial(b, seeds[0], True, size.frames), None)
    checks = {
        "point+line succeeds in >= 9 of 10 (Table 5)": pl["successes"] >= 0.9 * size.trials,
        "point+line succeeds at least as often as points only":
            pl["successes"] >= po["successes"],
        "every repeat the same outcome": same,
        "one ORB launch a frame built": orb_ok,
    }
    return b.row(
        "mono_init_success_low_texture", pl["successes"], f"successes/{size.trials}", checks,
        point_line=pl, points_only=po, init_frame_ms_point_line=init_ms,
        reference="Table 5 fr1_floor: SPL-SLAM 9/10 (86 pts + 88 lines) vs ORB-SLAM 1/10",
        trace=trace)


def make_problem(seed: int, cam: Camera):
    """bench_components.py:137-169: 128 points and 64 lines seen from a
    random pose, 0.5 px noise, 30% of each contaminated."""
    r = np.random.default_rng(seed)
    X = r.uniform(-2, 2, (N_PT, 3))
    X[:, 2] = r.uniform(2, 6, N_PT)
    xi = r.uniform(-1, 1, 6) * np.array([.3, .3, .3, .1, .1, .1])
    T = se3.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()

    def proj(P):
        pc = P @ T[:3, :3].T + T[:3, 3]
        return np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)

    uv = proj(X)
    uv += r.normal(0, 0.5, uv.shape)
    out = r.random(N_PT) < 0.3
    uv[out] += r.uniform(-60, 60, (out.sum(), 2))
    S = r.uniform(-2, 2, (N_LN, 3))
    S[:, 2] = r.uniform(2, 6, N_LN)
    D = r.normal(0, 1, (N_LN, 3))
    D /= np.linalg.norm(D, axis=1)[:, None]
    E = S + 0.8 * D
    X3 = np.stack([S, 0.5 * (S + E), E], 1)
    uvs, uve = proj(S), proj(E)
    uvs += r.normal(0, 0.5, uvs.shape)
    uve += r.normal(0, 0.5, uve.shape)
    outl = r.random(N_LN) < 0.3
    uvs[outl] += r.uniform(-60, 60, (outl.sum(), 2))
    l = np.cross(np.concatenate([uvs, np.ones((N_LN, 1))], 1),
                 np.concatenate([uve, np.ones((N_LN, 1))], 1))
    l /= (np.linalg.norm(l[:, :2], axis=1)[:, None] + 1e-12)
    return T, X, uv, X3, l


def pose_error(T_est: np.ndarray, T_true: np.ndarray) -> tuple[float, float]:
    dR = T_est[:3, :3] @ T_true[:3, :3].T
    ang = float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
    return ang, float(np.linalg.norm(T_est[:3, 3] - dR @ T_true[:3, 3]))


class Solvers:
    """The two minimal solvers on one problem, on the bench's device."""

    def __init__(self, problem, cam: Camera, dev):
        T, X, uv, X3, l = problem
        self.cam = cam
        self.X, self.uv, self.X3, self.l = (torch.tensor(a, dtype=torch.float32, device=dev)
                                            for a in (X, uv, X3, l))
        self.pt_mask = torch.ones((N_PT,), dtype=torch.bool, device=dev)
        self.ln_mask = torch.ones((N_LN,), dtype=torch.bool, device=dev)
        self.ones = torch.ones((N_PT,), device=dev)

    def epnp(self, gen: torch.Generator):
        samples = sample_minimal_sets(gen, self.pt_mask, N_HYP, 6)
        return pnp_ransac(self.cam, self.uv, self.X, self.ones, self.pt_mask, samples)

    def epnl(self, gen: torch.Generator):
        samples = sample_minimal_sets(gen, self.ln_mask, N_HYP_LINES, 6)
        return epnl_ransac(self.cam, self.l, self.X3, self.ln_mask, samples)

    def refined(self, tag: str, gen: torch.Generator):
        """(Tcw, RANSAC inliers): the solver's pose after the pose GN
        refinement on its robust residuals (bench_components.py:194-211)."""
        if tag == "epnp_points":
            Te, n, _ = self.epnp(gen)
            obs = PointObs(self.X, self.uv, self.ones, self.pt_mask)
            return pose_optimize(Te, self.cam, obs).Tcw, n
        Te, n, _ = self.epnl(gen)
        lobs = LineObs(self.X3[:, 1], self.l, torch.full((N_LN,), 0.25, device=self.X.device),
                       self.ln_mask)
        return pose_optimize(Te, self.cam, PointObs.empty(1, self.X.device), lobs).Tcw, n


def reloc_row(b: Bench, size: Size) -> dict:
    cam = Camera.create(200.0, 200.0, W / 2, H / 2, bf=24.0, width=W, height=H)
    base = 1000 * b.seed
    probs = [make_problem(base + s, cam) for s in range(size.reloc_trials)]
    solvers = [Solvers(p, cam, b.device) for p in probs]

    def gen(i: int) -> torch.Generator:
        """The RANSAC draws of trial i."""
        return torch.Generator(device=b.device).manual_seed(base + i)

    results, same = {}, True
    for tag in ("epnp_points", "epnl_lines"):
        outcomes = []
        for _ in range(b.repeats):
            rep = []
            for i, (p, s) in enumerate(zip(probs, solvers)):
                Te, n = s.refined(tag, gen(i))
                ang, dt = pose_error(Te.cpu().numpy(), p[0])
                rep.append({"rot_deg": ang, "t_m": dt, "inliers": int(n),
                            "ok": ang < ROT_GATE_DEG and dt < T_GATE_M})
            outcomes.append(rep)
        same &= all([t["ok"] for t in r] == [t["ok"] for t in outcomes[0]] for r in outcomes)
        solve = solvers[0].epnp if tag == "epnp_points" else solvers[0].epnl
        g = gen(size.reloc_trials)
        b.setup("warm-up", solve, g)
        walls = []
        for _ in range(b.repeats):
            b.settle()
            walls.append([b.timed(solve, g)[1] for _ in range(size.latency_reps)])
        stats = summary(walls)
        n_ok = sum(t["ok"] for t in outcomes[0])
        key = "epnp_solve" if tag == "epnp_points" else "epnl_solve"
        results[tag] = {"success": f"{n_ok}/{size.reloc_trials}", "successes": n_ok,
                        "ms_per_solve": stats["median_ms"],
                        "vs_baseline": BASELINE_MS[key] / stats["median_ms"],
                        "latency": stats, "trials": outcomes[0]}
    trace = b.trace("one EPnP and one EPnL solve", lambda: (
        solvers[0].epnp(gen(0)), solvers[0].epnl(gen(0))), None)
    checks = {
        "EPnP succeeds on every problem (Table 6: 10/10)":
            results["epnp_points"]["successes"] == size.reloc_trials,
        "EPnL succeeds on every problem (Table 6: 10/10)":
            results["epnl_lines"]["successes"] == size.reloc_trials,
        "every repeat the same outcome": same,
    }
    return b.row(
        "reloc_solver_success_and_latency", results["epnl_lines"]["successes"],
        f"line-solver successes/{size.reloc_trials}", checks,
        epnp_points=results["epnp_points"], epnl_lines=results["epnl_lines"],
        reference="Table 6: EPnL 10/10 @ 0.20 ms vs EPnP 10/10 @ 0.52 ms (V2_03), "
                  "a single CPU solve",
        sample=f"the synced wall of one solve (hypothesis draws and RANSAC), "
               f"{size.latency_reps} a repeat",
        trace=trace)


def run(b: Bench, size: Size = FULL) -> list[dict]:
    b.reduced = cuts(size, FULL)
    if b.cuda:
        b.setup("kernel build", orb_kernel.build)
    if size.warmup_frames:
        b.setup("warm-up", init_trial, b, 100 + b.seed, True, size.warmup_frames)
    return [init_row(b, size), reloc_row(b, size)]
