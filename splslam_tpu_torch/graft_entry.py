"""Entry points of the port: the single-device VO step and the multi-device
dry run (counterpart of the repo root's `__graft_entry__.py`).

`entry()` returns the stereo VO forward step (frame build with an 8-slot
line table -> motion-model match -> pose GN -> local-map match -> pose
GN) with example arguments.

`dryrun_multichip(n)` runs one step of the fleet over n local ranks
(`parallel.mesh.launch`): each rank tracks its shard of an n-sequence
batch with `batched_track_step` and the fleet's inlier count is summed
over the mesh; then the edge-sharded global BA (`parallel.gba_sharded`)
solves a reference-sized problem (`make_gba_problem`) over the same mesh.

    python -m splslam_tpu_torch.graft_entry     # on the card(s)
"""

from __future__ import annotations

import numpy as np
import torch


def _setup(device, width=128, height=96, n_features=128, n_levels=2,
           local_m=256):
    from splslam_tpu_torch.geometry.camera import Camera
    from splslam_tpu_torch.ops.pyramid import PyramidSpec

    cam = Camera.create(fx=100.0, fy=100.0, cx=width / 2, cy=height / 2,
                        bf=12.0, width=width, height=height)
    spec = PyramidSpec.create(height, width, n_levels, 1.2, n_features)
    scales = torch.tensor(spec.scales, dtype=torch.float32, device=device)
    return cam, spec, scales, local_m


def _example_args(spec, local_m, batch: int | None = None):
    """Numpy arguments of the VO step (`entry`), with a leading
    `batch` axis when given; the images are the reference's draws."""
    n = spec.total_capacity
    h, w = spec.sizes[0]
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(0)

    def img():
        return rng.uniform(0, 255, lead + (h, w)).astype(np.float32)

    def b(shape, dtype=np.float32, fill=0):
        return np.full(lead + shape, fill, dtype)

    return (
        img(),                            # imgL
        img(),                            # imgR
        b((n,), np.int32),                # last_octave
        b((n,)),                          # last_angle
        b((n, 8), np.int32),              # last_desc (packed)
        b((n, 3)),                        # last_lm_xyz
        b((n,), np.int32, -1),            # last_lm_gid
        np.broadcast_to(np.eye(4, dtype=np.float32), lead + (4, 4)).copy(),
        b((local_m,), np.int32, -1),      # win ids
        b((local_m, 3)),                  # win xyz
        b((local_m, 8), np.int32),        # win desc
        b((local_m, 3)),                  # win normal
        b((local_m,)),                    # win dmin
        b((local_m,), fill=1),            # win dmax
        b((local_m,), bool),              # win ok
    )


def _fleet_step_fn(cam, spec, scales):
    """fn(imgL, imgR, *tracker state, *window), every argument with a
    leading batch axis B: B frames built at `build_frame_stereo`'s default
    line capacity (the line detector runs with 8 slots on the left image,
    as in the reference's entry), then tracked by `batched_track_step`.
    Returns (Tcw [B,4,4], n_inliers [B])."""
    from splslam_tpu_torch.parallel.mesh import _tree_map, batched_track_step
    from splslam_tpu_torch.slam.frame import build_frame_stereo
    from splslam_tpu_torch.slam.tracking import LocalWindow

    track = batched_track_step(cam, scales, 1.2, spec.n_levels)

    def fn(imgL, imgR, *state):
        frames = [build_frame_stereo(l, r, cam, spec, scales)
                  for l, r in zip(imgL, imgR)]
        cur = _tree_map(lambda *xs: torch.stack(xs), *frames)
        res = track(cur, *state[:6], LocalWindow(*state[6:]))
        return res.Tcw, res.n_inliers

    return fn


def entry(device="cuda"):
    """(fn, example_args): the single-device stereo VO forward step at
    128x96, 128 features, 2 levels, a 256-landmark window, and its
    arguments as tensors on `device`."""
    cam, spec, scales, local_m = _setup(device)
    step = _fleet_step_fn(cam, spec, scales)

    def fn(*args):
        Tcw, n_inliers = step(*(a[None] for a in args))
        return Tcw[0], n_inliers[0]

    return fn, tuple(torch.from_numpy(a).to(device)
                     for a in _example_args(spec, local_m))


def make_gba_problem(n_kfs=64, n_pts=16384, obs_per_kf=2048, n_lines=1024,
                     line_obs=4, seed=0, device="cuda"):
    """Reference-scale synthetic global BA problem (the reference's draws):
    `n_kfs` keyframes on a trajectory, sliding covisibility windows of
    `obs_per_kf` landmarks (~n_kfs*obs_per_kf point edges), plus `n_lines`
    3D segments observed as paired 1-dof line-endpoint edges (endpoint
    slots appended after the point landmarks, start/end rows
    interleaved). Returns (Camera, BAProblem on `device`)."""
    from splslam_tpu_torch.geometry.camera import Camera
    from splslam_tpu_torch.optim.ba import BAProblem
    from splslam_tpu_torch.optim.pose_gn import line_coefficients

    rng = np.random.default_rng(seed)
    camb = Camera.create(fx=100.0, fy=100.0, cx=64.0, cy=48.0, bf=10.0,
                         width=128, height=96)
    C, L = n_kfs, n_pts
    X = rng.uniform([-4, -3, 3], [4, 3, 8], (L, 3)).astype(np.float32)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    Tcw[:, 0, 3] = np.linspace(0, 2.0, C)
    Tcw[:, 1, 3] = 0.05 * np.sin(np.linspace(0, 6.0, C))
    # sliding landmark windows -> chained covisibility
    stride = max(1, (L - obs_per_kf) // max(C - 1, 1))
    e_cam = np.repeat(np.arange(C, dtype=np.int32), obs_per_kf)
    e_lm = np.concatenate(
        [(c * stride + np.arange(obs_per_kf)) % L for c in range(C)]
    ).astype(np.int32)
    pc = np.einsum("eij,ej->ei", Tcw[e_cam, :3, :3], X[e_lm]) \
        + Tcw[e_cam, :3, 3]
    z = np.maximum(pc[:, 2], 1e-3)
    uv = pc[:, :2] / z[:, None] * 100.0 + [64.0, 48.0]
    uv += rng.normal(0, 0.3, uv.shape)
    Ep = e_cam.shape[0]

    # line endpoints as extra landmark slots [L + 2q, L + 2q + 1]
    S3d = rng.uniform([-4, -3, 3], [4, 3, 8], (n_lines, 3))
    d = rng.normal(0, 1, (n_lines, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    E3d = S3d + 0.8 * d
    ends = np.stack([S3d, E3d], 1).astype(np.float32)      # [Q,2,3]
    le_cam, le_lm, le_seg, le_pair = [], [], [], []
    for q in range(n_lines):
        for k in range(line_obs):
            c = (q * line_obs + k) % C
            pcq = ends[q] @ Tcw[c, :3, :3].T + Tcw[c, :3, 3]
            if (pcq[:, 2] > 0.1).all():
                uvq = pcq[:, :2] / pcq[:, 2:] * 100.0 + [64.0, 48.0]
                seg = np.concatenate([uvq[0], uvq[1]])
                base = Ep + len(le_cam)
                le_cam += [c, c]
                le_lm += [L + 2 * q, L + 2 * q + 1]
                le_seg += [seg, seg]
                le_pair += [base + 1, base]
    El = len(le_cam)
    le_coef = line_coefficients(
        torch.from_numpy(np.array(le_seg, np.float32).reshape(El, 4))).numpy()
    ends0 = ends + rng.normal(0, 0.02, ends.shape).astype(np.float32)
    xyz = np.concatenate([
        X + rng.normal(0, 0.01, X.shape).astype(np.float32),
        ends0.reshape(-1, 3)])
    prob = BAProblem(
        Tcw=Tcw,
        cam_free=np.array([False] + [True] * (C - 1)),
        xyz=xyz,
        lm_ok=np.ones((L + 2 * n_lines,), bool),
        e_cam=np.concatenate([e_cam, np.array(le_cam, np.int32)]),
        e_lm=np.concatenate([e_lm, np.array(le_lm, np.int32)]),
        e_uv=np.concatenate([uv.astype(np.float32),
                             np.zeros((El, 2), np.float32)]),
        e_ur=np.full((Ep + El,), -1.0, np.float32),
        e_inv_sigma2=np.ones((Ep + El,), np.float32),
        e_ok=np.ones((Ep + El,), bool),
        e_coef=np.concatenate([np.zeros((Ep, 3), np.float32), le_coef]),
        e_line=np.concatenate([np.zeros((Ep,), bool), np.ones((El,), bool)]),
        e_pair=np.concatenate([np.full((Ep,), -1, np.int32),
                               np.array(le_pair, np.int32)]),
    )
    return camb, BAProblem(*(torch.from_numpy(np.ascontiguousarray(x))
                             .to(device) for x in prob))


def _fleet_rank(mesh) -> dict:
    """A rank of `dryrun_multichip`: track this rank's rows of the fleet,
    sum the fleet's inliers over the mesh, then the sharded global BA."""
    from splslam_tpu_torch.ops import orb_kernel
    from splslam_tpu_torch.parallel.gba_sharded import gba_sharded
    from splslam_tpu_torch.parallel.mesh import shard_batch

    cam, spec, scales, local_m = _setup(mesh.device)
    args = shard_batch(_example_args(spec, local_m, batch=mesh.size), mesh)
    Tcw, n_inliers = _fleet_step_fn(cam, spec, scales)(*args)
    total = mesh.allsum(n_inliers.sum().to(torch.int64))

    camb, prob = make_gba_problem(device=mesh.device)
    T, X, ng = gba_sharded(camb, prob, mesh, rounds=2, gn_iters=2, cg_iters=8)
    return dict(Tcw=Tcw.cpu().numpy(), fleet_inliers=int(total),
                gba_keyframes=int(T.shape[0]), n_guarded=int(ng),
                gba_finite=bool(torch.isfinite(T).all() & torch.isfinite(X).all()),
                launches=orb_kernel.orb_describe.launches)


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = 900.0) -> dict:
    """Data-parallel fleet tracking over an n-rank mesh with a summed
    fleet statistic, then the edge-sharded global BA at the reference's
    size (64 keyframes x 16,384 landmarks, ~139k edges with line pairs,
    two outlier rounds), each executed once. On "cuda" one card a rank
    (NCCL); raises when there are fewer cards than `n_devices`. On "cpu"
    n gloo ranks. Returns the fleet's poses [n,4,4], the summed inliers,
    the BA's keyframes and guard count, and the ORB kernel launches of
    all ranks."""
    from splslam_tpu_torch.parallel.mesh import launch

    if torch.device(device).type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"dryrun_multichip needs {n_devices} CUDA devices; got "
                f"{torch.cuda.device_count()}")
        from splslam_tpu_torch.ops import orb_kernel

        orb_kernel.build()   # once, before the ranks load it
    outs = launch(_fleet_rank, n_devices, device, timeout_s=timeout_s)
    out = dict(Tcw=np.concatenate([o["Tcw"] for o in outs]),
               fleet_inliers=outs[0]["fleet_inliers"],
               gba_keyframes=outs[0]["gba_keyframes"],
               n_guarded=outs[0]["n_guarded"],
               launches=sum(o["launches"] for o in outs))
    if out["Tcw"].shape != (n_devices, 4, 4) or not np.isfinite(out["Tcw"]).all():
        raise RuntimeError(f"dryrun_multichip: fleet poses {out['Tcw'].shape}")
    if out["gba_keyframes"] != 64 or not all(o["gba_finite"] for o in outs):
        raise RuntimeError("dryrun_multichip: global BA returned "
                           f"{out['gba_keyframes']} keyframes or non-finite states")
    if out["n_guarded"] != 0:
        raise RuntimeError(f"sharded GBA guard events: {out['n_guarded']}")
    return out


if __name__ == "__main__":
    fn, args = entry()
    Tcw, n_in = fn(*args)
    print(f"entry OK: Tcw {tuple(Tcw.shape)}, inliers {int(n_in)}")
    n = torch.cuda.device_count()
    if n > 1:
        dryrun_multichip(n)
        print(f"dryrun_multichip({n}) OK")
