"""Multi-device global bundle adjustment: edge-sharded PCG over a
`torch.distributed` mesh (port of splslam_tpu/parallel/gba_sharded.py).

The reference has no distributed backend (SURVEY §2.4); the scaling axis
of the BA back end is the EDGE TABLE. Camera and landmark states are
small (a few MB) and stay replicated on every rank; the observation
edges, the O(K*N) part, shard across ranks. Every Hessian-block and
gradient accumulation and every matrix-free Schur product in the PCG loop
is a local segment sum over the rank's edge shard, in the fixed order of
`ops/segsum.py` (prepared once per solve), followed by one `all_reduce`
over the mesh. At a fixed world size the all-reduce's order is fixed too,
so two runs give the same bits.

The single-device solver's semantics carry over (`optim.ba._edge_terms`,
`_gates`, `_huber_weight` are shared): line-endpoint edges with the joint
start+end chi2 gate, and multi-round outlier reclassification. The two
1-dof edges of one line observation may land on different ranks, so the
joint chi2 is a pair-keyed segment sum over the mesh (each pair keyed by
the smaller global row of its two edges): one [E]-sized all-reduce per
reclassification round.

Nothing is read back to the host inside the solve: the inverse is
`torch.linalg.inv_ex`, every guard a `torch.where`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from splslam_tpu_torch.geometry import se3
from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops.segsum import Segments, segment_sum
from splslam_tpu_torch.optim.ba import (
    BAProblem,
    _bsum,
    _edge_terms,
    _gates,
    _huber_weight,
    _segment,
)
from splslam_tpu_torch.parallel.mesh import Mesh


def _shard_cells(p: BAProblem, C: int, L: int):
    """(landmark cells, camera cells) of a shard's edges for `segment_sum`,
    and their gather indices: built once per solve."""
    lm_put, lm_get = _segment(p.e_lm, L)
    cam_put, cam_get = _segment(p.e_cam, C)
    return Segments(lm_put, L), Segments(cam_put, C), lm_get, cam_get


def _gn_step_sharded(cam: Camera, p: BAProblem, Tcw_all, xyz_all, active,
                     cg_iters: int, damping: float, mesh: Mesh, cells):
    """One GN step with edge-sharded accumulation. `p.e_*` are this rank's
    shard; states are replicated. `active` is the shard's round-level
    inlier mask; `cells` is `_shard_cells` of the shard. Returns (Tcw,
    xyz, n_guarded increment)."""
    C = Tcw_all.shape[0]
    L = xyz_all.shape[0]
    dev = Tcw_all.device
    _, huber_d2, _ = _gates(p)
    lm_cells, cam_cells, lm_get, cam_get = cells
    allsum = mesh.allsum

    def seg_lm(x):
        return segment_sum(lm_cells, x)

    def seg_cam(x):
        return segment_sum(cam_cells, x)

    r, J_c, J_p, chi2, z_ok = _edge_terms(Tcw_all, xyz_all, cam, p)
    w = (_huber_weight(chi2, huber_d2) * p.e_inv_sigma2
         * (active & z_ok).to(torch.float32))
    wf = w * p.cam_free[cam_get].to(torch.float32)
    Jcw = J_c * wf[:, None, None]
    Jpw = J_p * w[:, None, None]
    G = _bsum(Jcw[:, :, :, None], J_p[:, :, None, :], 1)          # [E,6,3]
    Hcc_e = _bsum(Jcw[:, :, :, None], J_c[:, :, None, :], 1)
    Hpp_e = _bsum(Jpw[:, :, :, None], J_p[:, :, None, :], 1)
    g_c = _bsum(Jcw, r[:, :, None], 1)
    g_p = _bsum(Jpw, r[:, :, None], 1)

    cam_sums = allsum(seg_cam(torch.cat([Hcc_e.reshape(-1, 36), g_c], -1)))
    Hcc, bc = cam_sums[:, :36].reshape(C, 6, 6), cam_sums[:, 36:]
    lm_sums = allsum(seg_lm(torch.cat([Hpp_e.reshape(-1, 9), g_p], -1)))
    Hpp, bp = lm_sums[:, :9].reshape(L, 3, 3), lm_sums[:, 9:]

    eye3 = torch.eye(3, device=dev)
    hdiag = torch.diagonal(Hpp, dim1=1, dim2=2)
    lm_active = p.lm_ok & (hdiag.sum(-1) > 0)
    dHpp = eye3[None] * torch.clamp(hdiag, min=1e-8)[:, None, :]
    Hpp_d = (Hpp + damping * dHpp + 1e-6 * eye3
             + torch.where(lm_active, 0.0, 1.0)[:, None, None] * eye3)
    iHpp = torch.linalg.inv_ex(Hpp_d).inverse
    # Freeze landmarks whose inverse overflowed or blew past the
    # legitimate damped bound: one non-finite or ~1e36 block would poison
    # every CG product into a whole-solve no-op.
    lm_sing = ~torch.all(torch.abs(iHpp.reshape(L, -1)) < 1e12, dim=-1)
    iHpp = torch.where(lm_sing[:, None, None], 0.0, iHpp)
    cdiag = torch.diagonal(Hcc, dim1=1, dim2=2)
    Hcc_d = Hcc + damping * torch.eye(6, device=dev)[None] \
        * torch.clamp(cdiag, min=1.0)[:, None, :]
    free_f = p.cam_free.to(torch.float32)[:, None]

    def W_u(u):                     # [L,3] -> [C,6], summed over the mesh
        return allsum(seg_cam(_bsum(G, u[lm_get][:, None, :], -1)))

    def Wt_v(v):                    # [C,6] -> [L,3], summed over the mesh
        return allsum(seg_lm(_bsum(G, v[cam_get][:, :, None], 1)))

    def S_matvec(v):
        Wv = W_u(_bsum(iHpp, Wt_v(v)[:, None, :], -1))
        Hv = _bsum(Hcc_d, v[:, None, :], -1)
        return (Hv - Wv) * free_f + v * (1.0 - free_f)

    rhs = -(bc - W_u(_bsum(iHpp, bp[:, None, :], -1))) * free_f
    Minv = 1.0 / (torch.clamp(torch.diagonal(Hcc_d, dim1=1, dim2=2), min=1e-3)
                  * free_f + (1.0 - free_f))
    x = torch.zeros((C, 6), device=dev)
    rvec = rhs - S_matvec(x)
    z = Minv * rvec
    pdir = z
    rz = torch.sum(rvec * z)
    for _ in range(cg_iters):
        Ap = S_matvec(pdir)
        alpha = rz / torch.clamp(torch.sum(pdir * Ap), min=1e-12)
        x = x + alpha * pdir
        rvec = rvec - alpha * Ap
        z = Minv * rvec
        rz_new = torch.sum(rvec * z)
        pdir = z + rz_new / torch.clamp(rz, min=1e-12) * pdir
        rz = rz_new
    ok = torch.all(torch.isfinite(x))
    dx_c = torch.where(ok, x, 0.0) * free_f

    dx_p = _bsum(iHpp, (-(bp + Wt_v(dx_c)))[:, None, :], -1)
    dxp_fin = torch.all(torch.isfinite(dx_p), dim=-1)
    n_bad = (~ok).to(torch.int32) + torch.sum(
        (lm_active & ~dxp_fin).to(torch.int32))
    dx_p = torch.where((lm_active & dxp_fin)[:, None], dx_p, 0.0)
    # Camera trust region (see optim/ba.py: outlier-dominated blocks can
    # draw near-gradient/lambda steps; these GN steps have no accept test,
    # so the cap is the only brake).
    C_all = -_bsum(Tcw_all[:, :3, :3].transpose(1, 2),
                   Tcw_all[:, :3, 3][:, None, :], -1)
    centroid = torch.sum(C_all * free_f, dim=0) \
        / torch.clamp(torch.sum(free_f), min=1.0)
    ext = 0.5 * (1.0 + torch.max(torch.linalg.norm(
        (C_all - centroid) * free_f, dim=-1)))
    tn_c = torch.linalg.norm(dx_c[:, :3], dim=-1, keepdim=True)
    rn_c = torch.linalg.norm(dx_c[:, 3:], dim=-1, keepdim=True)
    dx_c = dx_c * torch.minimum(
        torch.clamp(ext / torch.clamp(tn_c, min=1e-9), max=1.0),
        torch.clamp(0.5 / torch.clamp(rn_c, min=1e-9), max=1.0))
    return se3.se3_retract(Tcw_all, dx_c), xyz_all + dx_p, n_bad


def _pad_edges(p: BAProblem, mult: int) -> BAProblem:
    """Append invalid edge rows up to a multiple of `mult`."""
    pad = (-p.e_cam.shape[0]) % mult
    if not pad:
        return p

    def padE(x, fill):
        if x is None:
            return None
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    return p._replace(
        e_cam=padE(p.e_cam, 0), e_lm=padE(p.e_lm, 0), e_uv=padE(p.e_uv, 0.0),
        e_ur=padE(p.e_ur, -1.0), e_inv_sigma2=padE(p.e_inv_sigma2, 1.0),
        e_ok=padE(p.e_ok, False), e_coef=padE(p.e_coef, 0.0),
        e_line=padE(p.e_line, False), e_pair=padE(p.e_pair, -1))


def gba_sharded(cam: Camera, p: BAProblem, mesh: Mesh, *,
                rounds: int = 2, gn_iters: int = 4, cg_iters: int = 16,
                damping: float = 1e-3):
    """Run edge-sharded global BA on this rank of `mesh` with the
    single-device solver's full semantics (line edges, joint gates,
    outlier rounds). Every rank passes the whole problem, on its device;
    it keeps its contiguous shard of the edges, padded to an even shard
    per rank (invalid rows carry e_ok False). Returns (Tcw, xyz,
    n_guarded), the same on every rank; n_guarded is summed over the mesh
    as the reference sums it (world size x the replicated count)."""
    p = _pad_edges(p, 2 * mesh.size)
    E_tot = p.e_cam.shape[0]
    S = E_tot // mesh.size
    lo = mesh.rank * S

    def shard(x):
        return None if x is None else x[lo:lo + S]

    prob = p._replace(**{f: shard(getattr(p, f)) for f in (
        "e_cam", "e_lm", "e_uv", "e_ur", "e_inv_sigma2", "e_ok", "e_coef",
        "e_line", "e_pair")})
    dev = p.Tcw.device
    chi2_gate, _, _ = _gates(prob)

    def joint_chi2_sharded(chi2, valid):
        """Joint start+end chi2 per line pair across shards: each pair
        keyed by min(own, partner) global row; one summed segment sum
        replaces the single-device partner gather (reference joint gate
        chi2Fir+chi2End, Optimizer.cc:2753). A chi2 counts only while
        its edge is live (valid)."""
        if prob.e_line is None:
            return chi2
        gid = lo + torch.arange(S, device=dev)
        is_pair = prob.e_line & (prob.e_pair >= 0)
        key = torch.where(is_pair, torch.minimum(gid, prob.e_pair.long()),
                          E_tot)
        # Each pair's slot takes its two chi2 (0 + a + b: exact in any
        # order, on a rank and over the mesh); every other row adds 0.0.
        sums = mesh.allsum(torch.zeros((E_tot + 1,), device=dev).index_add_(
            0, key, torch.where(valid & is_pair, chi2, 0.0)))
        return torch.where(is_pair, sums[key.clamp(max=E_tot - 1)], chi2)

    T, X = prob.Tcw, prob.xyz
    cells = _shard_cells(prob, T.shape[0], X.shape[0])
    active = prob.e_ok
    ng = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(rounds):
        for _ in range(gn_iters):
            T, X, n_bad = _gn_step_sharded(cam, prob, T, X, active,
                                           cg_iters, damping, mesh, cells)
            ng = ng + n_bad
        # Round-end reclassification (reference two-phase schedule,
        # src/Optimizer.cc:2713-2764).
        _, _, _, chi2, z_ok = _edge_terms(T, X, cam, prob)
        active = (prob.e_ok & z_ok
                  & (joint_chi2_sharded(chi2, prob.e_ok & z_ok) <= chi2_gate))
    return T, X, mesh.allsum(ng)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def solve_on_rank(mesh: Mesh, cam: Camera, problem: BAProblem, kw: dict,
                  reps: int = 1) -> dict:
    """A rank function for `parallel.mesh.launch`: `gba_sharded` on
    `problem` (numpy or host leaves), moved to this rank's device, `reps`
    times. Returns host data: the first run's Tcw, xyz and n_guarded, the
    synced wall ms of each run, and for each later run its largest pose
    difference to the first and the largest and 99th-percentile landmark
    distance to it (the run-to-run spread), whether its Tcw, xyz and
    n_guarded equal the first run's to the bit (`equal`), and the
    `segment_sum` kernel launches of all the runs."""
    p = BAProblem(*(None if x is None else torch.as_tensor(np.asarray(x))
                    .to(mesh.device) for x in problem))
    first, ms, spread, equal = None, [], [], []
    launches = segment_sum.launches
    for _ in range(reps):
        _sync(mesh.device)
        t0 = time.perf_counter()
        T, X, ng = gba_sharded(cam, p, mesh, **kw)
        _sync(mesh.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = (T, X, ng)
            continue
        dist = torch.linalg.norm(X - first[1], dim=-1)
        spread.append((float((T - first[0]).abs().max()), float(dist.max()),
                       float(torch.quantile(dist.cpu(), 0.99))))
        equal.append(all(torch.equal(a, b) for a, b in zip((T, X, ng), first)))
    T, X, ng = first
    return dict(Tcw=T.cpu().numpy(), xyz=X.cpu().numpy(), n_guarded=int(ng),
                ms=ms, spread=spread, equal=equal,
                seg_launches=segment_sum.launches - launches,
                edges=int(problem.e_cam.shape[0]))
