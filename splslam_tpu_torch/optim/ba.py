"""Bundle adjustment (port of splslam_tpu/optim/ba.py): `ba_solve`, the
local window's Schur-complement Levenberg-Marquardt, `ba_solve_arbitrated`,
its dual point/line form, and
`ba_solve_pcg`, the whole map's matrix-free Schur Gauss-Newton with
preconditioned conjugate gradients.

The problem is an edge table (one row per observation: camera slot,
landmark slot, measurement, information, validity). Mono edges are
2-dof reprojection residuals (chi2 5.991); stereo edges add the
right-image u for a 3-dof residual (chi2 7.815). A map line rides as its
two endpoints, ordinary landmark slots; each observation of it is a pair
of 1-dof edges r = l . [u, v, 1] against the observed 2D line l, robust
at 3.841 each and classified by the pair's joint chi2 against 5.991
(reference EdgeSE3ProjectXYZLines, src/Optimizer.cc:2630-2753). Per-edge Jacobian
blocks are Huber-weighted and summed into one (camera band, landmark)
cell buffer; the camera system is reduced by the Schur complement on
the 3x3 landmark blocks and solved densely; landmarks follow by
back-substitution. Two rounds of five LM iterations, with a chi2
re-classification of the edges between rounds.

The LM accept/reject, the damping schedule and every guard are
`torch.where` selections on the device: the solve never reads a value
back to the host. Everything is float32; keep TF32 off on a GPU. The
global solver `ba_solve_pcg` takes the same point and line edges.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from splslam_tpu_torch.geometry import se3
from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops.consts import device_const
from splslam_tpu_torch.ops.segsum import Segments, segment_sum


def _triu_maps(n: int):
    """(pack, unpack) index lists between a row-major flattened symmetric
    [n,n] block and its upper-triangle vector of n(n+1)/2 entries."""
    pack, slot = [], {}
    for i in range(n):
        for j in range(i, n):
            slot[(i, j)] = len(pack)
            pack.append(i * n + j)
    unpack = [slot[(min(i, j), max(i, j))] for i in range(n) for j in range(n)]
    return pack, unpack


_TRIU6, _FULL6 = _triu_maps(6)
_TRIU3, _FULL3 = _triu_maps(3)


def _index(lst: list, device) -> torch.Tensor:
    """A constant index list as a tensor on `device`, sent there once: a
    Python list indexing a card tensor is copied to the card on every
    call, and that copy makes the host wait."""
    return device_const(("index", tuple(lst)), device,
                        lambda: np.asarray(lst, np.int64))


CHI2_MONO = 5.991    # 2-dof 95% (reference Optimizer.cc:2591)
CHI2_STEREO = 7.815  # 3-dof 95% (reference Optimizer.cc:2592)
CHI2_LINE = 3.841    # 1-dof 95% per line-endpoint edge
CHI2_POINT_JOINT = 5.991  # joint gate for an endpoint pair (:2753)
LM_DAMPING = 1e-4    # initial LM lambda, halved on accept, x4 on reject


class BAProblem(NamedTuple):
    """Fixed-shape BA window. Cameras are slots 0..C-1 (free slots
    first); `cam_free[c]` marks cameras that receive updates, fixed ones
    still contribute residuals. Landmarks are slots 0..L-1. Invalid edges
    have e_ok False and contribute nothing."""

    Tcw: torch.Tensor           # [C,4,4]
    cam_free: torch.Tensor      # [C] bool
    xyz: torch.Tensor           # [L,3]
    lm_ok: torch.Tensor         # [L] bool
    e_cam: torch.Tensor         # [E] int32
    e_lm: torch.Tensor          # [E] int32
    e_uv: torch.Tensor          # [E,2]
    e_ur: torch.Tensor          # [E] right-image u; < 0 => mono edge
    e_inv_sigma2: torch.Tensor  # [E]
    e_ok: torch.Tensor          # [E] bool
    e_coef: torch.Tensor | None = None  # [E,3] observed 2D line (line edges)
    e_line: torch.Tensor | None = None  # [E] bool — row is a line edge
    e_pair: torch.Tensor | None = None  # [E] int32 partner edge row (-1 none)


class BAResult(NamedTuple):
    Tcw: torch.Tensor        # [C,4,4] updated poses
    xyz: torch.Tensor        # [L,3] updated landmarks
    e_inlier: torch.Tensor   # [E] bool — survived the final chi2 gate
    chi2: torch.Tensor       # [E] final per-edge chi2
    total_chi2: torch.Tensor
    # Accepted LM iterations whose camera step came out non-finite and
    # was zeroed (transient; the e2e gates bound their rate).
    n_guarded: torch.Tensor
    # Cameras or landmarks that ended non-finite and were reverted to
    # their input (must be 0).
    n_state_revert: torch.Tensor
    # Single-landmark step zeroings on a singular 3x3 block (benign).
    n_lm_singular: torch.Tensor


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det, det floored at
    1e-20 in magnitude as the reference does)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    adj = torch.stack([torch.stack([A, B, Cc], dim=-1),
                       torch.stack([D, E, F], dim=-1),
                       torch.stack([G, H, I], dim=-1)], dim=-2)
    return adj * inv_det[..., None, None]


def solve_dense(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense Cholesky solve of the damped reduced camera system with the
    reference's armor: Jacobi pre-scaling (solve D A D y = D b, x = D y
    with D = diag(A)^-1/2, which keeps intermediates near 1) and a pivot
    floor relative to the scaled diagonal, max(d, 1e-10 |A_jj| + 1e-20),
    so a cancellation-driven pivot gives a bounded column instead of a
    breakdown. `torch.linalg.cholesky` has no such floor.

    The reference unrolls every scalar operation (n = 48: ~20k ops);
    here each column of L is one vector update, then two triangular
    solves. The sums run in another order than the reference's."""
    n = A.shape[0]
    dg = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(A)), min=1e-12))
    Dinv = 1.0 / dg
    A = A * Dinv[:, None] * Dinv[None, :]
    b = b * Dinv
    floor = 1e-10 * torch.abs(torch.diagonal(A)) + 1e-20
    L = torch.zeros_like(A)
    for j in range(n):
        col = A[j:, j] - L[j:, :j] @ L[j, :j]
        Ljj = torch.sqrt(torch.maximum(col[0], floor[j]))
        L[j, j] = Ljj
        L[j + 1:, j] = col[1:] * (1.0 / Ljj)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return x[:, 0] * Dinv


def _bsum(a, b, dim):
    return torch.sum(a * b, dim=dim)


def _edge_terms(Tcw_all, xyz_all, cam: Camera, p: BAProblem):
    """Residuals r [E,3], J_c [E,3,6], J_p [E,3,3], chi2 [E], depth-ok [E].
    Mono edges use rows 0..1 (row 2 zeroed through the stereo mask)."""
    Tcw = Tcw_all[p.e_cam.long()]
    X = xyz_all[p.e_lm.long()]
    R = Tcw[:, :3, :3]
    t = Tcw[:, :3, 3]
    pc = _bsum(R, X[:, None, :], -1) + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_ok = z > 1e-3
    zs = torch.where(z_ok, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    stereo = p.e_ur >= 0
    r = torch.stack([u - p.e_uv[:, 0], v - p.e_uv[:, 1],
                     torch.where(stereo, ur - p.e_ur, 0.0)], dim=-1)
    zeros = torch.zeros_like(x)
    srow = torch.stack([cam.fx * iz, zeros, -(cam.fx * x - cam.bf) * iz2],
                       dim=-1) * stereo[:, None].to(torch.float32)
    row_u = torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    duv_dpc = torch.stack([row_u, row_v, srow], dim=1)      # [E,3,3]
    if p.e_coef is not None:
        # line-endpoint edges: the 1-dof residual l . [u, v, 1] in row 0
        lx, ly = p.e_coef[:, 0], p.e_coef[:, 1]
        r_line = lx * u + ly * v + p.e_coef[:, 2]
        row_l = lx[:, None] * row_u + ly[:, None] * row_v
        is_l = p.e_line
        r = torch.where(is_l[:, None],
                        torch.stack([r_line, zeros, zeros], dim=-1), r)
        zl = torch.zeros_like(row_l)
        duv_dpc = torch.where(is_l[:, None, None],
                              torch.stack([row_l, zl, zl], dim=1), duv_dpc)
    # J_c = [duv_dpc | -duv_dpc hat(pc)], J_p = duv_dpc @ R.
    hatp = se3.hat(pc)
    J_rot = -_bsum(duv_dpc[:, :, :, None], hatp[:, None, :, :], 2)
    J_c = torch.cat([duv_dpc, J_rot], dim=-1)                # [E,3,6]
    J_p = _bsum(duv_dpc[:, :, :, None], R[:, None, :, :], 2)  # [E,3,3]
    chi2 = torch.sum(r * r, dim=-1) * p.e_inv_sigma2
    return r, J_c, J_p, chi2, z_ok


def _huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def _gates(p: BAProblem):
    """(classification gate [E], Huber delta^2 [E], joint-chi2 fn). Points
    classify and robustify per edge (5.991 mono / 7.815 stereo); a line
    endpoint edge robustifies at 3.841 and classifies by the joint chi2 of
    its pair against 5.991, the partner counting only while it is live."""
    gate = torch.where(p.e_ur >= 0, CHI2_STEREO, CHI2_MONO)
    if p.e_coef is None:
        return gate, gate, lambda chi2, valid: chi2
    huber = torch.where(p.e_line, CHI2_LINE, gate)
    gate = torch.where(p.e_line, CHI2_POINT_JOINT, gate)
    pv = p.e_pair >= 0
    pi = p.e_pair.clamp(min=0).long()

    def joint(chi2, valid):
        partner = torch.where(pv & valid[pi], chi2[pi], 0.0)
        return torch.where(p.e_line, chi2 + partner, chi2)

    return gate, huber, joint


def _finish(cam: Camera, p: BAProblem, gates, Tcw_all, xyz_all, ng, ngl) -> BAResult:
    """The solvers' common end. No outcome may poison the map: a camera or
    point that ends non-finite reverts to its input. Then the final chi2
    gate."""
    C = p.Tcw.shape[0]
    cam_fin = torch.all(torch.isfinite(Tcw_all.reshape(C, -1)), dim=-1)
    Tcw_all = torch.where(cam_fin[:, None, None], Tcw_all, p.Tcw)
    pt_fin = torch.all(torch.isfinite(xyz_all), dim=-1)
    xyz_all = torch.where(pt_fin[:, None], xyz_all, p.xyz)
    nsr = torch.sum((~cam_fin).to(torch.int32)) \
        + torch.sum((p.lm_ok & ~pt_fin).to(torch.int32))
    gate, _, joint = gates
    _, _, _, chi2, z_ok = _edge_terms(Tcw_all, xyz_all, cam, p)
    inlier = p.e_ok & (joint(chi2, p.e_ok & z_ok) <= gate) & z_ok
    total = torch.sum(torch.where(inlier, chi2, 0.0))
    return BAResult(Tcw_all, xyz_all, inlier, chi2, total,
                    n_guarded=ng.to(torch.int32), n_state_revert=nsr.to(torch.int32),
                    n_lm_singular=ngl.to(torch.int32))


def ba_solve(cam: Camera, p: BAProblem, *, rounds: int = 2, iters: int = 5,
             n_free: int | None = None) -> BAResult:
    """Solve the BA window. `n_free`: count of leading camera slots that
    are free (slots are packed free-first); defaults to all."""
    C = p.Tcw.shape[0]
    L = p.xyz.shape[0]
    Cf = C if n_free is None else n_free
    dev = p.Tcw.device
    gates = _gates(p)
    gate, huber, joint = gates
    eye3 = torch.eye(3, device=dev)
    triu6, full6 = _index(_TRIU6, dev), _index(_FULL6, dev)
    triu3, full3 = _index(_TRIU3, dev), _index(_FULL3, dev)

    # Every per-edge block goes into one (camera band, landmark) cell:
    # free cameras are bands 0..Cf-1, everything else (fixed, frozen,
    # invalid) band Cf, which still feeds the landmark blocks. A camera
    # observes a landmark at most once, so a free band's cell holds one
    # edge and the Schur cross blocks W are read off directly. Band Cf
    # holds many edges a landmark (and a keyframe row can hold one landmark
    # twice after a fuse remap), so the cells are summed in a fixed order:
    # the landmark blocks decide the LM accept test, which must not flip
    # between runs. Edges that are not e_ok carry no weight and are left
    # out.
    free_edge = (p.e_cam < Cf) & p.cam_free[p.e_cam.clamp(min=0).long()]
    ec = torch.where(free_edge, p.e_cam, Cf)
    n_cells = (Cf + 1) * L
    cells = Segments(
        torch.where(p.e_ok, (ec * L + p.e_lm).long(), n_cells), n_cells,
        max_rows=4 * C)

    def assemble(Tcw_all, xyz_all, active):
        """One linearization: the normal-equation pieces, the robust cost
        (an active edge pushed behind the camera pays a large penalty
        instead of vanishing), raw chi2 and depth-ok."""
        r, J_c, J_p, chi2, z_ok = _edge_terms(Tcw_all, xyz_all, cam, p)
        live = active & z_ok
        w = _huber_weight(chi2, huber) * p.e_inv_sigma2 * live.to(torch.float32)
        rw = r * w[:, None]
        g_c = _bsum(J_c, rw[:, :, None], 1)
        g_p = _bsum(J_p, rw[:, :, None], 1)
        Jcw = J_c * w[:, None, None]
        Hcc_e = _bsum(Jcw[:, :, :, None], J_c[:, :, None, :], 1)
        Hpp_e = _bsum(J_p[:, :, :, None] * w[:, None, None, None],
                      J_p[:, :, None, :], 1)
        Hcp_e = _bsum(Jcw[:, :, :, None], J_p[:, :, None, :], 1)
        payload = torch.cat([Hcc_e.reshape(-1, 36)[:, triu6], g_c,
                             Hpp_e.reshape(-1, 9)[:, triu3], g_p,
                             Hcp_e.reshape(-1, 18)], dim=-1)     # [E,54]
        acc = segment_sum(cells, payload).reshape(Cf + 1, L, 54)
        acc_c = torch.sum(acc[:Cf, :, :27], dim=1)
        Hcc = acc_c[:, full6].reshape(Cf, 6, 6)
        bc = acc_c[:, 21:]
        acc_p = torch.sum(acc[:, :, 27:36], dim=0)
        Hpp = acc_p[:, full3].reshape(L, 3, 3)
        bp = acc_p[:, 6:]
        W2 = acc[:Cf, :, 36:].reshape(Cf, L, 6, 3).permute(0, 2, 1, 3) \
            .reshape(Cf * 6, L * 3)
        rho = torch.where(chi2 <= huber, chi2,
                          2.0 * torch.sqrt(huber * torch.clamp(chi2, min=0.0))
                          - huber)
        penalty = torch.maximum(2.0 * torch.sqrt(huber * 1e8), rho)
        cost = torch.sum(torch.where(live, rho,
                                     torch.where(active, penalty, 0.0)))
        return (Hcc, bc, Hpp, bp, W2), cost, chi2, z_ok

    def gn_step(Tcw_all, xyz_all, sys, lam):
        """Propose an LM step from a cached linearization."""
        Hcc, bc, Hpp, bp, W2 = sys
        hdiag = torch.diagonal(Hpp, dim1=1, dim2=2)
        lm_active = p.lm_ok & (hdiag.sum(-1) > 0)
        dHpp = eye3[None] * torch.clamp(hdiag, min=1e-8)[:, None, :]
        Hpp_d = (Hpp + lam * dHpp + 1e-6 * eye3
                 + torch.where(lm_active, 0.0, 1.0)[:, None, None] * eye3)
        iHpp = _inv3(Hpp_d)
        # A non-finite or astronomically large block inverse is frozen
        # for this iteration (NaN compares False, so it is caught too).
        lm_sing = ~torch.all(torch.abs(iHpp.reshape(L, -1)) < 1e12, dim=-1)
        iHpp = torch.where(lm_sing[:, None, None], 0.0, iHpp)

        # Schur: S = Hcc - W iHpp W^T ; rhs = bc - W iHpp bp.
        W2v = W2.reshape(Cf * 6, L, 3)
        WiH2 = torch.sum(W2v[:, :, :, None] * iHpp[None], dim=2) \
            .reshape(Cf * 6, L * 3)
        S = WiH2 @ W2.T
        S_full = torch.zeros((Cf, 6, Cf, 6), device=dev)
        ar = torch.arange(Cf, device=dev)
        S_full[ar, :, ar, :] = Hcc
        A = S_full.reshape(Cf * 6, Cf * 6) - S
        rhs = bc.reshape(-1) - WiH2 @ bp.reshape(-1)
        A = A + lam * torch.diag(torch.clamp(torch.diagonal(A), min=1.0))
        dx_c = -solve_dense(A, rhs).reshape(Cf, 6)
        ok = torch.all(torch.isfinite(dx_c))
        dx_c = torch.where(ok, dx_c, 0.0)

        # Back-substitute landmarks: Hpp dx_p = -bp - W^T dx_c.
        Wt_dxc = (W2.T @ dx_c.reshape(-1)).reshape(L, 3)
        dx_p = _bsum(iHpp, (-(bp + Wt_dxc))[:, None, :], -1)
        dxp_fin = torch.all(torch.isfinite(dx_p), dim=-1)
        n_bad = (~ok).to(torch.int32)
        n_bad_lm = torch.sum(((lm_active & ~dxp_fin) | (p.lm_ok & lm_sing))
                             .to(torch.int32))
        dx_p = torch.where((lm_active & dxp_fin)[:, None], dx_p, 0.0)
        # Trust regions: a landmark step at most half the point's
        # distance to the free cameras' centroid (plus 0.5); a camera step
        # at most half the window's extent in translation, 0.5 rad in
        # rotation.
        Rf = Tcw_all[:Cf, :3, :3]
        C_f = -_bsum(Rf.transpose(1, 2), Tcw_all[:Cf, :3, 3][:, None, :], -1)
        centroid = torch.mean(C_f, dim=0)
        max_step = 0.5 * (1.0 + torch.linalg.norm(xyz_all - centroid, dim=-1,
                                                  keepdim=True))
        stepn = torch.linalg.norm(dx_p, dim=-1, keepdim=True)
        dx_p = dx_p * torch.clamp(max_step / torch.clamp(stepn, min=1e-9),
                                  max=1.0)
        ext = 0.5 * (1.0 + torch.max(torch.linalg.norm(C_f - centroid, dim=-1)))
        tn_c = torch.linalg.norm(dx_c[:, :3], dim=-1, keepdim=True)
        rn_c = torch.linalg.norm(dx_c[:, 3:], dim=-1, keepdim=True)
        dx_c = dx_c * torch.minimum(
            torch.clamp(ext / torch.clamp(tn_c, min=1e-9), max=1.0),
            torch.clamp(0.5 / torch.clamp(rn_c, min=1e-9), max=1.0))
        dx_c = dx_c * p.cam_free[:Cf, None].to(torch.float32)
        Tcw_f = se3.se3_retract(Tcw_all[:Cf], dx_c)
        Tcw_new = torch.cat([Tcw_f, Tcw_all[Cf:]], dim=0)
        return Tcw_new, xyz_all + dx_p, n_bad, n_bad_lm

    Tcw_all, xyz_all = p.Tcw, p.xyz
    active = p.e_ok
    lam = torch.full((), LM_DAMPING, dtype=torch.float32, device=dev)
    ng = torch.zeros((), dtype=torch.int32, device=dev)
    ngl = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(rounds):
        # Linearize at the round's entry; afterwards only at accepted
        # candidates. A rejected step retries the cached system with 4x
        # the damping.
        sys, cost, chi2, z_ok = assemble(Tcw_all, xyz_all, active)
        for _ in range(iters):
            cT, cX, n_bad, n_bad_lm = gn_step(Tcw_all, xyz_all, sys, lam)
            sys_n, cost_n, chi2_n, zok_n = assemble(cT, cX, active)
            accept = cost_n < cost
            Tcw_all = torch.where(accept, cT, Tcw_all)
            xyz_all = torch.where(accept, cX, xyz_all)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-6, 1e6)
            sys = tuple(torch.where(accept, a, b) for a, b in zip(sys_n, sys))
            cost = torch.where(accept, cost_n, cost)
            chi2 = torch.where(accept, chi2_n, chi2)
            z_ok = torch.where(accept, zok_n, z_ok)
            # Only accepted damage counts: a rejected non-finite
            # candidate leaves the state unharmed.
            ng = ng + torch.where(accept, n_bad, 0)
            ngl = ngl + torch.where(accept, n_bad_lm, 0)
        active = p.e_ok & (joint(chi2, p.e_ok & z_ok) <= gate) & z_ok

    return _finish(cam, p, gates, Tcw_all, xyz_all, ng, ngl)


def ba_solve_arbitrated(cam: Camera, p: BAProblem, *, rounds: int = 2,
                        iters: int = 5, n_free: int | None = None) -> BAResult:
    """Dual point-BA and line-BA with per-keyframe pose arbitration, then a
    joint pass (reference LocalBundleAdjustmentmain, src/Optimizer.cc:
    2875-2902): the problem is solved with only its point edges and with
    only its line edges; each camera starts the joint solve from the pose
    of the modality with the lower unit error (inlier chi2 / inlier
    count, src/Optimizer.cc:3471-3593), a modality with no surviving edge
    on a camera never winning it. Landmarks start from the solve that
    moved them. The per-camera sums run in a fixed order."""
    if p.e_line is None:
        return ba_solve(cam, p, rounds=rounds, iters=iters, n_free=n_free)
    C = p.Tcw.shape[0]
    kw = dict(rounds=rounds, iters=iters, n_free=n_free)
    resP = ba_solve(cam, p._replace(e_ok=p.e_ok & ~p.e_line), **kw)
    resL = ba_solve(cam, p._replace(e_ok=p.e_ok & p.e_line), **kw)
    cells = Segments(p.e_cam.long(), C)

    def unit_error(res, mask):
        ok = (res.e_inlier & mask).to(torch.float32)
        sums = segment_sum(cells, torch.stack([res.chi2 * ok, ok], dim=1))
        num, den = sums[:, 0], sums[:, 1]
        return torch.where(den > 0, num / torch.clamp(den, min=1.0), math.inf), den

    uP, _ = unit_error(resP, ~p.e_line)
    uL, nL = unit_error(resL, p.e_line)
    pick_line = (uL < uP) & (nL > 0)
    Tcw0 = torch.where(pick_line[:, None, None], resL.Tcw, resP.Tcw)
    Lm = p.xyz.shape[0]
    line_lm = torch.zeros((Lm + 1,), dtype=torch.bool, device=p.xyz.device)
    line_lm.index_fill_(0, torch.where(p.e_line, p.e_lm.long(), Lm), True)
    xyz0 = torch.where(line_lm[:Lm, None], resL.xyz, resP.xyz)
    res = ba_solve(cam, p._replace(Tcw=Tcw0, xyz=xyz0), **kw)
    return res._replace(
        n_guarded=res.n_guarded + resP.n_guarded + resL.n_guarded,
        n_state_revert=res.n_state_revert + resP.n_state_revert + resL.n_state_revert,
        n_lm_singular=res.n_lm_singular + resP.n_lm_singular + resL.n_lm_singular,
    )


# ----------------------------------------------------------------------
# Global BA: matrix-free Schur + preconditioned conjugate gradients.
#
# The cell buffer of `ba_solve` is O(C*L) memory: fine for the local
# window, impossible for the whole map. Here the reduced camera system
# S = Hcc - W iHpp W^T is never formed: S v goes through the edge table
# with two segment sums,
#   (W^T v)_l = sum_{e: lm(e)=l}  G_e^T v_cam(e)     (G_e = Jc^T w Jp, 6x3)
#   (W  u)_c = sum_{e: cam(e)=c} G_e  u_lm(e)
# ----------------------------------------------------------------------
def _segment(e: torch.Tensor, n: int):
    """An edge index column as (scatter index, gather index) into n
    slots. A negative index counts from the end and an index past the end
    is dropped by the sums (it lands in a spare slot n) and clamped by the
    gathers, as the reference's scatter and gather do."""
    e = torch.where(e < 0, e + n, e).long()
    inside = (e >= 0) & (e < n)
    return torch.where(inside, e, n), e.clamp(0, n - 1)


def ba_solve_pcg(cam: Camera, p: BAProblem, *, rounds: int = 2,
                 gn_iters: int = 4, cg_iters: int = 24,
                 damping: float = 1e-3) -> BAResult:
    """Global bundle adjustment (reference Optimizer::BundleAdjustment,
    src/Optimizer.cc:219-408) for problems too large for the dense-Schur
    local solver. Every camera slot with cam_free is optimized; landmarks
    always are. `rounds` x `gn_iters` damped Gauss-Newton steps (no accept
    test; the two trust regions are the brake), each solved by `cg_iters`
    Jacobi-preconditioned CG iterations of fixed count, with a chi2
    re-classification of the edges after every round (a line endpoint
    edge by its pair's joint chi2, see `_gates`). Nothing is read back
    to the host.

    The segment sums over cameras and landmarks run in the fixed order of
    `ops/segsum.py`, prepared once per solve (the edge table is point and
    line edges in one: the line block is camera-major on its own, so the
    whole is not sorted by camera), so two runs give the same bits."""
    C = p.Tcw.shape[0]
    L = p.xyz.shape[0]
    dev = p.Tcw.device
    gates = _gates(p)
    gate, huber, joint = gates
    free_f = p.cam_free.to(torch.float32)[:, None]
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    lm_put, lm_get = _segment(p.e_lm, L)
    cam_put, cam_get = _segment(p.e_cam, C)
    e_free = p.cam_free[cam_get].to(torch.float32)
    p = p._replace(e_cam=cam_get, e_lm=lm_get)      # what the edge terms gather
    lm_cells, cam_cells = Segments(lm_put, L), Segments(cam_put, C)

    def seg_lm(x):
        return segment_sum(lm_cells, x)

    def seg_cam(x):
        return segment_sum(cam_cells, x)

    def gn_step(Tcw_all, xyz_all, active):
        r, J_c, J_p, chi2, z_ok = _edge_terms(Tcw_all, xyz_all, cam, p)
        w = _huber_weight(chi2, huber) * p.e_inv_sigma2 \
            * (active & z_ok).to(torch.float32)
        wf = w * e_free
        Jcw = J_c * wf[:, None, None]
        Jpw = J_p * w[:, None, None]
        G = _bsum(Jcw[:, :, :, None], J_p[:, :, None, :], 1)        # [E,6,3]
        Hcc_e = _bsum(Jcw[:, :, :, None], J_c[:, :, None, :], 1)
        Hpp_e = _bsum(Jpw[:, :, :, None], J_p[:, :, None, :], 1)
        g_c = _bsum(Jcw, r[:, :, None], 1)
        g_p = _bsum(Jpw, r[:, :, None], 1)

        cam_sums = seg_cam(torch.cat([Hcc_e.reshape(-1, 36), g_c], dim=-1))
        Hcc, bc = cam_sums[:, :36].reshape(C, 6, 6), cam_sums[:, 36:]
        lm_sums = seg_lm(torch.cat([Hpp_e.reshape(-1, 9), g_p], dim=-1))
        Hpp, bp = lm_sums[:, :9].reshape(L, 3, 3), lm_sums[:, 9:]

        hdiag = torch.diagonal(Hpp, dim1=1, dim2=2)
        lm_active = p.lm_ok & (hdiag.sum(-1) > 0)
        dHpp = eye3[None] * torch.clamp(hdiag, min=1e-8)[:, None, :]
        Hpp_d = (Hpp + damping * dHpp + 1e-6 * eye3
                 + torch.where(lm_active, 0.0, 1.0)[:, None, None] * eye3)
        iHpp = _inv3(Hpp_d)
        # A non-finite or astronomically large block inverse is frozen:
        # one such block would poison every CG product.
        lm_sing = ~torch.all(torch.abs(iHpp.reshape(L, -1)) < 1e12, dim=-1)
        iHpp = torch.where(lm_sing[:, None, None], 0.0, iHpp)

        cdiag = torch.diagonal(Hcc, dim1=1, dim2=2)
        Hcc_d = Hcc + damping * eye6[None] * torch.clamp(cdiag, min=1.0)[:, None, :]

        def W_u(u):                     # [L,3] -> [C,6]
            return seg_cam(_bsum(G, u[lm_get][:, None, :], -1))

        def Wt_v(v):                    # [C,6] -> [L,3]
            return seg_lm(_bsum(G, v[cam_get][:, :, None], 1))

        def S_matvec(v):
            """S v on the free cameras; frozen rows pass through."""
            Wv = W_u(_bsum(iHpp, Wt_v(v)[:, None, :], -1))
            Hv = _bsum(Hcc_d, v[:, None, :], -1)
            return (Hv - Wv) * free_f + v * (1.0 - free_f)

        # rhs = -(bc - W iHpp bp)
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

        # Back-substitute landmarks.
        dx_p = _bsum(iHpp, (-(bp + Wt_v(dx_c)))[:, None, :], -1)
        dxp_fin = torch.all(torch.isfinite(dx_p), dim=-1)
        n_bad = (~ok).to(torch.int32)
        n_bad_lm = torch.sum(((lm_active & ~dxp_fin) | (p.lm_ok & lm_sing))
                             .to(torch.int32))
        dx_p = torch.where((lm_active & dxp_fin)[:, None], dx_p, 0.0)
        # Trust regions, as the local solver's: a landmark step at most
        # half the point's distance to the free cameras' centroid (plus
        # 0.5); a camera step at most half the free cameras' extent in
        # translation, 0.5 rad in rotation.
        C_all = -_bsum(Tcw_all[:, :3, :3].transpose(1, 2),
                       Tcw_all[:, :3, 3][:, None, :], -1)
        centroid = torch.sum(C_all * free_f, dim=0) \
            / torch.clamp(torch.sum(free_f), min=1.0)
        max_step = 0.5 * (1.0 + torch.linalg.norm(xyz_all - centroid, dim=-1,
                                                  keepdim=True))
        stepn = torch.linalg.norm(dx_p, dim=-1, keepdim=True)
        dx_p = dx_p * torch.clamp(max_step / torch.clamp(stepn, min=1e-9),
                                  max=1.0)
        ext = 0.5 * (1.0 + torch.max(torch.linalg.norm(
            (C_all - centroid) * free_f, dim=-1)))
        tn_c = torch.linalg.norm(dx_c[:, :3], dim=-1, keepdim=True)
        rn_c = torch.linalg.norm(dx_c[:, 3:], dim=-1, keepdim=True)
        dx_c = dx_c * torch.minimum(
            torch.clamp(ext / torch.clamp(tn_c, min=1e-9), max=1.0),
            torch.clamp(0.5 / torch.clamp(rn_c, min=1e-9), max=1.0))
        return se3.se3_retract(Tcw_all, dx_c), xyz_all + dx_p, n_bad, n_bad_lm

    Tcw_all, xyz_all = p.Tcw, p.xyz
    active = p.e_ok
    ng = torch.zeros((), dtype=torch.int32, device=dev)
    ngl = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(rounds):
        for _ in range(gn_iters):
            Tcw_all, xyz_all, n_bad, n_bad_lm = gn_step(Tcw_all, xyz_all, active)
            ng = ng + n_bad
            ngl = ngl + n_bad_lm
        _, _, _, chi2, z_ok = _edge_terms(Tcw_all, xyz_all, cam, p)
        active = p.e_ok & (joint(chi2, p.e_ok & z_ok) <= gate) & z_ok
    return _finish(cam, p, gates, Tcw_all, xyz_all, ng, ngl)
