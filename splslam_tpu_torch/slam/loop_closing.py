"""Loop closing: detection, Sim3 verification, correction, global BA
(port of splslam_tpu/slam/loop_closing.py).

The reference LoopClosing thread (src/LoopClosing.cc):
- `DetectLoop` (:103-229): the BoW score of the new keyframe against the
  database, a minimum score from its covisible group, and the temporal
  consistency of covisibility groups (a candidate's group must be
  re-detected in CONSISTENCY_TH consecutive keyframes);
- `ComputeSim3` (:231-402): descriptor match between the keyframes, Sim3
  RANSAC, GN refinement and a projection-count verification;
- `CorrectLoop` (:404-587): `OptimizeEssentialGraph` over the spanning
  trees, the covisibility and the loop edges (`optim/sim3.py::
  pose_graph_sim3`), the landmarks moved with their owning keyframes,
  loop-point fusion (`loop_search_and_fuse`), then global BA
  (`RunGlobalBundleAdjustment` :647, here the matrix-free PCG solver
  `optim/ba.py::ba_solve_pcg`, with the map lines' endpoint edges).

The reference kills the pipeline after verification (ComputeSim3 returns
false, :390-392), and that is the default here: with
`enable_loop_correction=False` a verified loop is recorded in
`LoopCloser.verified_loops` and nothing is corrected; `True` runs
`_correct`.

The essential graph is assembled on the host from one copy of the live
keyframe poses and the two covisibility matrices; everything else stays
on the device, and `_correct` reads back only the solver counters and
the corrected poses for the host pose log. Map tables are updated in
place.
"""

from __future__ import annotations

import numpy as np
import torch

from splslam_tpu_torch import trace as T
from splslam_tpu_torch.bow.vocabulary import densify_bow_row, score_rows
from splslam_tpu_torch.geometry import se3
from splslam_tpu_torch.ops import match as M
from splslam_tpu_torch.optim import sim3 as S3
from splslam_tpu_torch.optim.ba import BAProblem, ba_solve_pcg
from splslam_tpu_torch.slam import reloc
from splslam_tpu_torch.slam.map import (MapState, covisibility_counts,
                                        predict_octave)
from splslam_tpu_torch.slam.mapping_ops import (_scatter_set_last, _topk_covisible,
                                                _unique_ids, add_line_edges)

MIN_MATCHES = 20        # reference :262 nmatches >= 20
MIN_SIM3_INLIERS = 20   # reference :345 OptimizeSim3 >= 20
MIN_PROJ_MATCHES = 40   # reference :388 >= 40 after Scw projection
CONSISTENCY_TH = 3      # reference mnCovisibilityConsistencyTh
N_HYP_SIM3 = 128        # Sim3 hypotheses an attempt
MAX_LOOP_LMS = 4096     # loop-area landmarks projected by SearchAndFuse


def _covisible_mask(st: MapState, kf: int) -> torch.Tensor:
    """[K] bool: keyframes sharing >= 15 landmarks with `kf` (its
    covisibility group), with the reference's membership rule for
    landmark 0 (`map.landmark_membership`)."""
    return (covisibility_counts(st, st.kfs.lm_idx[kf]) >= 15) & st.kfs.valid


def compute_sim3_attempt(st: MapState, kf: int, cand: int, K3: torch.Tensor,
                         fix_scale: bool, *,
                         generator: torch.Generator | None = None,
                         samples: torch.Tensor | None = None):
    """Match the landmarks of `kf` and `cand`, Sim3 RANSAC + GN (free
    scale; the scale is clamped to 1 afterwards when `fix_scale`), then
    project cand's landmarks into kf with S12 and count descriptor-gated
    hits (reference SearchByProjection with Scw, :365-388). The 3-point
    sets are `samples` if given, else drawn from `generator`. Returns
    (n_matches, n_sim3_inliers, n_proj, n_guarded, (s,R,t) S12
    cam_kf <- cam_cand), all on the device."""
    kfs = st.kfs
    d1, d2 = kfs.desc[kf], kfs.desc[cand]
    lm1, lm2 = kfs.lm_idx[kf], kfs.lm_idx[cand]
    ok1 = kfs.fvalid[kf] & (lm1 >= 0) & st.pts.valid[lm1.clamp(min=0).long()]
    ok2 = kfs.fvalid[cand] & (lm2 >= 0) & st.pts.valid[lm2.clamp(min=0).long()]
    dist = M.hamming(d1, d2)
    mt, _ = M.nn_match(M.masked_distances(dist, ok1, ok2), max_dist=M.TH_LOW,
                       ratio=0.75, mutual=True)
    matched = mt >= 0
    n_matches = torch.sum(matched.to(torch.int32))
    col = mt.clamp(min=0).long()

    T1, T2 = kfs.Tcw[kf], kfs.Tcw[cand]
    xyz2 = st.pts.xyz[lm2.clamp(min=0).long()]
    X1 = st.pts.xyz[lm1.clamp(min=0).long()] @ T1[:3, :3].T + T1[:3, 3]
    Xc = xyz2 @ T2[:3, :3].T + T2[:3, 3]             # cand's points, cand cam
    X2 = Xc[col]
    uv1 = kfs.xy[kf]
    uv2 = kfs.xy[cand][col]
    is1 = 1.0 / kfs.sigma2[kf]
    is2 = 1.0 / kfs.sigma2[cand][col]

    if samples is None:
        samples = reloc.sample_minimal_sets(generator, matched, N_HYP_SIM3, 3)
    (s, R, t), _, inl = S3.sim3_ransac(X1, X2, uv1, uv2, is1, is2, matched,
                                       K3, samples)
    (s, R, t), n_opt, _, n_guarded = S3.optimize_sim3(
        s, R, t, X1, X2, uv1, uv2, is1, is2, inl, K3)
    if fix_scale:
        s = torch.ones_like(s)

    p1 = s * (Xc @ R.T) + t
    zs = torch.clamp(p1[:, 2], min=1e-6)
    uvp = torch.stack([K3[0, 0] * p1[:, 0] / zs + K3[0, 2],
                       K3[1, 1] * p1[:, 1] / zs + K3[1, 2]], dim=-1)
    win = M.window_mask(uvp, uv1, 8.0)
    dist2 = M.masked_distances(dist.T, ok2 & (p1[:, 2] > 0), ok1, win)
    mt2, _ = M.nn_match(dist2, max_dist=M.TH_LOW)
    n_proj = torch.sum((mt2 >= 0).to(torch.int32))
    return n_matches, n_opt, n_proj, n_guarded, (s, R, t)


def _host(t: torch.Tensor) -> np.ndarray:
    """A device-to-host copy of the loop paths (`trace.read`); it waits
    for the device. Every such copy goes through here: detection's
    covisibility and scores, verification's counts, and the correction's
    essential-graph inputs, solver counters and host pose log."""
    return T.read(t)


def _membership_counts(idx: torch.Tensor, ok: torch.Tensor, P: int) -> torch.Tensor:
    """[K,K] int32 counts of shared ids between the rows of `idx` [K,N]
    (entries with `ok`), as one product of 0/1 membership matrices. The
    float32 product is exact below 2^24 shared ids."""
    Mb = torch.zeros((idx.shape[0], P + 1), device=idx.device)
    Mb.scatter_(1, torch.where(ok, idx, P).long(), 1.0)
    Mb = Mb[:, :P]
    return (Mb @ Mb.T).to(torch.int32)


def _covis_matrix(st: MapState) -> torch.Tensor:
    """[K,K] shared-landmark counts between every keyframe pair (the
    covisibility-graph weights, reference KeyFrame::GetCovisiblesByWeight).
    Landmark 0 counts like any other here."""
    lm = st.kfs.lm_idx
    ok = (lm >= 0) & st.kfs.fvalid & st.kfs.valid[:, None] \
        & st.pts.valid[lm.clamp(min=0).long()]
    return _membership_counts(lm, ok, st.pts.xyz.shape[0])


def _covis_matrix_lines(st: MapState) -> torch.Tensor:
    """[K,K] shared map-line counts (the line covisibility graph the
    reference keeps beside the point one for its second spanning tree,
    include/KeyFrame.h:300-301)."""
    ll = st.kfs.ll_idx
    ok = (ll >= 0) & st.kfs.lvalid & st.kfs.valid[:, None] \
        & st.lns.valid[ll.clamp(min=0).long()]
    return _membership_counts(ll, ok, st.lns.xyz.shape[0])


def _build_pose_graph_edges(st: MapState, n_kfs: int, loop_i: int, loop_j: int,
                            S_loop, past_loops: list[tuple[int, int]] | None = None,
                            covis_min: int = 100) -> S3.PoseGraphEdges:
    """The essential graph (reference Optimizer::OptimizeEssentialGraph,
    src/Optimizer.cc:1019-1189): dual spanning trees (each keyframe's
    point-parent and line-parent, its most covisible PRIOR keyframe in
    that modality; the first index wins a tie), the sequential chain as a
    connectivity backbone, covisibility edges of weight >= covis_min, past
    loop edges and the new loop edge. Relative Sim3 measurements come from
    the current poses; the new loop edge carries the measured one. Loop
    edges weigh `n_kfs`, the others 1.

    Assembled on the host with numpy (one copy of the live poses and the
    two count matrices), returned on the map's device."""
    dev = st.kfs.Tcw.device
    n = n_kfs
    Tcw = _host(st.kfs.Tcw[:n])
    inv = np.linalg.inv(Tcw)
    chain = np.stack([np.arange(1, n), np.arange(0, n - 1)], 1)
    C = _host(_covis_matrix(st)[:n, :n])
    CL = _host(_covis_matrix_lines(st)[:n, :n])
    lower = np.tril(np.ones((n, n), bool), -1)             # j < i strictly
    tree_pairs = []
    for Cm in (C, CL):
        prior = np.where(lower, Cm, -1)
        parent = np.argmax(prior[1:], axis=1)
        has = prior[np.arange(1, n), parent] > 0
        tree_pairs.append(np.stack([np.arange(1, n)[has], parent[has]], 1))
    ci, cj = np.nonzero(lower & (C >= covis_min))
    base = np.concatenate([chain] + tree_pairs + [np.stack([ci, cj], 1)], 0)
    base = np.unique(base[:, 0] * n + base[:, 1])          # they overlap freely
    bi, bj = base // n, base % n
    pl = np.asarray(
        [(i, j) for (i, j) in (past_loops or [])
         if i < n and j < n and (i, j) != (loop_i, loop_j)], np.int64,
    ).reshape(-1, 2)
    ei = np.concatenate([bi, pl[:, 0], [loop_i]])
    ej = np.concatenate([bj, pl[:, 1], [loop_j]])
    w = np.concatenate([np.ones(len(bi)), np.full(len(pl) + 1, float(n))])
    rel = Tcw[ei] @ inv[ej]
    ss = torch.ones(len(ei))
    Rs = torch.from_numpy(rel[:, :3, :3].astype(np.float32))
    ts = torch.from_numpy(rel[:, :3, 3].astype(np.float32))
    # The loop measurement joins on the device: reading it back would wait
    # for the verification that produced it.
    s, R, t = (torch.as_tensor(x, dtype=torch.float32).to(dev) for x in S_loop)
    to = lambda x: x.to(dev, non_blocking=True)
    return S3.PoseGraphEdges(
        i=to(torch.from_numpy(ei.astype(np.int32))),
        j=to(torch.from_numpy(ej.astype(np.int32))),
        s=torch.cat([to(ss[:-1]), s.reshape(1)]),
        R=torch.cat([to(Rs[:-1]), R.reshape(1, 3, 3)]),
        t=torch.cat([to(ts[:-1]), t.reshape(1, 3)]),
        weight=to(torch.from_numpy(w.astype(np.float32))),
    )


def _apply_pose_graph(st: MapState, s_f, R_f, t_f, valid_k) -> MapState:
    """Write the optimized Sim3 poses back as Tcw' = [R | t/s] (the
    reference divides the translation by the scale, LoopClosing.cc:560-566)
    and move each landmark and map line with the correction of its owning
    keyframe (`first_kf`, reference :520-556): into the OLD camera frame,
    then back out through the corrected similarity,
    X' = R_f^T (pc/s - t/s). Lines move like points, their three rows
    together.

    s_f / R_f / t_f may be a K-bucketed leading slice of the keyframe
    table: rows past K are untouched, and `first_kf` always lies below the
    live count. In place on `st`."""
    kfs = st.kfs
    K = s_f.shape[0]
    old_Tcw = kfs.Tcw[:K].clone()      # read before the tables are written
    new_Tcw = torch.where(valid_k[:, None, None],
                          se3.rt_to_mat(R_f, t_f / s_f[:, None]), old_Tcw)

    def moved(xyz, first_kf, valid):
        """xyz [M,r,3] through the owning keyframe's correction."""
        ref = first_kf.clamp(0, K - 1).long()
        To, Tn = old_Tcw[ref], new_Tcw[ref]
        pc = xyz @ To[:, :3, :3].transpose(1, 2) + To[:, None, :3, 3]
        inv_s = (1.0 / s_f[ref])[:, None, None]
        xw = (pc * inv_s - Tn[:, None, :3, 3]) @ Tn[:, :3, :3]
        return torch.where((valid & valid_k[ref])[:, None, None], xw, xyz)

    pts, lns = st.pts, st.lns
    pts.xyz.copy_(moved(pts.xyz[:, None, :], pts.first_kf, pts.valid)[:, 0])
    lns.xyz.copy_(moved(lns.xyz, lns.first_kf, lns.valid))
    kfs.Tcw[:K] = new_Tcw
    return st


def loop_search_and_fuse(st: MapState, cur_kfs: torch.Tensor,
                         loop_lms: torch.Tensor, cam, scales: torch.Tensor,
                         scale_factor: float = 1.2, n_levels: int = 8) -> MapState:
    """SearchAndFuse (reference src/LoopClosing.cc:589-645): project the
    loop area's landmarks `loop_lms` [F] (-1 pads) into every keyframe of
    the current covisible group `cur_kfs` [G] (-1 pads) with its corrected
    pose. A hit on a feature that already has a landmark replaces that
    landmark with the loop point (the loop side wins, reference
    matcher.Fuse + pMP->Replace); a hit on a free feature adds the
    observation. Where several rows write one target the highest row wins,
    as a sequential scatter. In place on `st`."""
    pts, kfs = st.pts, st.kfs
    P = pts.xyz.shape[0]
    dev = loop_lms.device
    remap = torch.arange(P, dtype=torch.int32, device=dev)
    li = loop_lms.clamp(min=0).long()
    lm_ok_row = (loop_lms >= 0) & pts.valid[li]
    xyz = pts.xyz[li]
    desc = pts.desc[li]
    dmin, dmax = pts.dmin[li], pts.dmax[li]

    for g in range(cur_kfs.shape[0]):
        kf_ok = cur_kfs[g] >= 0
        kf = cur_kfs[g:g + 1].clamp(min=0).long()   # a 1-d index stays on the device
        T = kfs.Tcw[kf][0]
        row_lm = kfs.lm_idx[kf][0]
        pc = xyz @ T[:3, :3].T + T[:3, 3]
        zs = torch.clamp(pc[:, 2], min=1e-6)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        inimg = ((u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
                 & (pc[:, 2] > 1e-3))
        O = -T[:3, :3].T @ T[:3, 3]
        dist3 = torch.linalg.norm(xyz - O, dim=-1)
        band_ok = (dist3 > 0.8 * dmin) & (dist3 < 1.2 * dmax)
        rows_ok = lm_ok_row & inimg & band_ok & kf_ok
        pred = predict_octave(dist3, dmax, scale_factor, n_levels)
        radius = 4.0 * scales[pred.long()]      # reference Fuse radius th=4
        wmask = M.window_mask(torch.stack([u, v], dim=-1), kfs.xy[kf][0], radius)
        omask = M.octave_mask(pred, kfs.octave[kf][0], -1, 1)
        dmat = M.masked_distances(M.hamming(desc, kfs.desc[kf][0]), rows_ok,
                                  kfs.fvalid[kf][0], wmask & omask)
        mt, _ = M.nn_match(dmat, max_dist=M.TH_LOW)
        hit = mt >= 0
        col = mt.clamp(min=0).long()
        tgt = row_lm[col]
        # replace: the existing landmark forwards to the loop point
        both = hit & (tgt >= 0) & (tgt != loop_lms)
        remap = _scatter_set_last(remap, tgt.clamp(min=0).long(), both, loop_lms)
        # a free feature gains the loop observation
        row = _scatter_set_last(row_lm, col, hit & (tgt < 0), loop_lms)
        kfs.lm_idx[kf] = torch.where(kf_ok, row, row_lm)[None]

    remap = remap[remap.long()]
    remap = remap[remap.long()]
    merged = remap != torch.arange(P, dtype=torch.int32, device=dev)
    lm_idx = kfs.lm_idx
    kfs.lm_idx.copy_(torch.where(lm_idx >= 0, remap[lm_idx.clamp(min=0).long()], -1))
    gains = torch.zeros_like(pts.n_obs).index_add_(
        0, remap.long(), pts.n_obs * merged.to(torch.int32))
    pts.valid.logical_and_(~merged)
    pts.n_obs.add_(gains)
    return st


def _k_bucket(cap: int, n: int) -> int:
    """The keyframe-axis bucket of the correction solvers: the next power
    of two >= the live count, floor 32, at most the table's capacity."""
    return min(cap, max(32, 1 << (max(int(n), 1) - 1).bit_length()))


class LoopCloser:
    """Host orchestration of the loop-closing pipeline."""

    def __init__(self, system):
        self.sys = system
        self.consistent: list[tuple[set, int]] = []
        self.last_loop_kf = -100
        self.verified_loops: list[tuple[int, int]] = []
        # corrected loops, kept for every later essential graph (reference
        # KeyFrame::AddLoopEdge, src/LoopClosing.cc:575-578)
        self.loop_edges: list[tuple[int, int]] = []
        self.corrections = 0
        # correction-path solver guards (essential graph, global BA): 0 on
        # a healthy run, so that a silently zeroed correction shows
        self.n_guarded = 0
        # Degenerate speculative Sim3 verifications (a singular GN step
        # zeroed, then rejected by the count gates); observable, not fatal.
        self.n_guarded_verify = 0

    def on_keyframe(self, kf: int):
        sys = self.sys
        if sys.vocab is None or sys.n_kfs < 6:
            return
        if kf < self.last_loop_kf + 10:  # reference :117 mLastLoopKFid + 10
            return
        cov = _host(_covisible_mask(sys.map, kf))
        cov[kf] = True
        ids, vals = sys.kf_bow
        query = densify_bow_row(ids, vals, kf, sys.bow_n_words)
        # minScore: the lowest BoW similarity within the covisible group
        # (reference :121-135).
        cov_idx = [c for c in range(sys.n_kfs) if cov[c] and c != kf]
        if not cov_idx:
            return
        rows = torch.tensor(cov_idx, device=ids.device)
        min_score = float(_host(score_rows(ids[rows], vals[rows], query).min()))
        scores = _host(reloc.reloc_scores(
            ids, vals, sys.map.kfs.valid, query,
            torch.from_numpy(cov).to(ids.device)))[: sys.n_kfs]
        # Ties go to the higher index, as the reference's host argsort.
        cands = [c for c in np.argsort(scores)[::-1]
                 if scores[c] >= max(min_score, 1e-3)]
        if not cands:
            self.consistent = []
            return

        # Temporal consistency over covisibility groups (reference
        # :152-211): a candidate is ready when its group intersects a group
        # detected in each of the last CONSISTENCY_TH keyframes.
        new_groups: list[tuple[set, int]] = []
        ready: list[int] = []
        for c in cands[:5]:
            grp = set(np.nonzero(
                _host(_covisible_mask(sys.map, int(c))))[0].tolist())
            grp |= {int(c)}
            best = 0
            for prev_grp, cnt in self.consistent:
                if grp & prev_grp:
                    best = max(best, cnt + 1)
            new_groups.append((grp, best))
            if best + 1 >= CONSISTENCY_TH:
                ready.append(int(c))
        self.consistent = new_groups

        for c in ready[:2]:
            if self._verify_and_close(kf, c):
                break

    def _verify_and_close(self, kf: int, cand: int) -> bool:
        sys = self.sys
        K3 = torch.tensor([[sys.cam.fx, 0.0, sys.cam.cx],
                           [0.0, sys.cam.fy, sys.cam.cy], [0.0, 0.0, 1.0]],
                          dtype=torch.float32).to(sys.device)
        gen = torch.Generator(device=sys.device)
        gen.manual_seed(kf)
        # the scale is fixed for stereo, free for monocular (reference
        # Sim3Solver mbFixScale)
        n_m, n_opt, n_proj, n_grd, S12 = compute_sim3_attempt(
            sys.map, kf, cand, K3, sys.sensor.name != "MONOCULAR", generator=gen)
        n_m, n_opt, n_proj, n_grd = (int(x) for x in _host(torch.stack(
            [n_m, n_opt, n_proj, n_grd])))
        self.n_guarded_verify += n_grd
        if (n_m < MIN_MATCHES or n_opt < MIN_SIM3_INLIERS
                or n_proj < MIN_PROJ_MATCHES):
            return False
        self.verified_loops.append((kf, cand))
        self.last_loop_kf = kf
        # The reference kills the pipeline here (src/LoopClosing.cc:390-392);
        # the correction runs only when it is asked for.
        if sys.settings.enable_loop_correction:
            self._correct(kf, cand, S12)
        return True

    @T.span("loop.correct")
    def _correct(self, kf: int, cand: int, S12):
        """CorrectLoop (reference :404-587, :647-751): pose-graph
        optimization, landmark correction, SearchAndFuse, global BA. `S12`
        (s, R, t) maps cand's camera frame into kf's: the loop edge's
        measurement with i = kf, j = cand."""
        sys = self.sys
        n = sys.n_kfs
        dev = sys.device
        edges = _build_pose_graph_edges(sys.map, n, kf, cand, S12,
                                        past_loops=self.loop_edges)
        # The dense [K,7,K,7] system is solved at the keyframe bucket, not
        # at the table's capacity; edge indices all lie below n <= K.
        K = _k_bucket(sys.map.kfs.Tcw.shape[0], n)
        Tcw = sys.map.kfs.Tcw[:K]
        live = torch.arange(K, device=dev) < n
        free = live & (torch.arange(K, device=dev) != 0)
        s_f, R_f, t_f, n_grd = S3.pose_graph_sim3(
            torch.ones((K,), device=dev), Tcw[:, :3, :3], Tcw[:, :3, 3], free,
            edges, iters=15, fix_scale=sys.sensor.name != "MONOCULAR")
        sys.map = _apply_pose_graph(sys.map, s_f, R_f, t_f, live)

        # SearchAndFuse: the loop area's landmarks (sorted, unique, at most
        # MAX_LOOP_LMS, -1 padded; a fixed shape) into the corrected
        # current group.
        def group(k):
            ids, _ = _topk_covisible(sys.map, k, 7)
            return torch.cat([torch.full((1,), k, dtype=torch.int32, device=dev),
                              ids])
        cur_group, loop_group = group(kf), group(cand)
        rows = sys.map.kfs.lm_idx[loop_group.clamp(min=0).long()]
        loop_lms = _unique_ids(
            torch.where((loop_group >= 0)[:, None], rows, -1).reshape(-1),
            MAX_LOOP_LMS)
        sys.map = loop_search_and_fuse(
            sys.map, cur_group, loop_lms, sys.cam, sys.scales,
            sys.settings.scale_factor, sys.settings.n_levels)
        self.loop_edges.append((kf, cand))
        self.corrections += 1
        sys.mapper.big_change_idx += 1
        # Global BA after the correction (the reference starts its GBA
        # thread from CorrectLoop, src/LoopClosing.cc:581); it refreshes the
        # host pose log and bumps `map_version`.
        self.run_global_ba(rounds=1)
        self.n_guarded += int(_host(n_grd))
        sys.map_version += 1
        if sys.step is not None:
            sys.step = sys.step._replace(
                lm_xyz=sys.map.pts.xyz[sys.step.lm_gid.clamp(min=0).long()],
                ll_xyz3=sys.map.lns.xyz[sys.step.ll_gid.clamp(min=0).long()])

    def run_global_ba(self, rounds: int = 2, with_lines: bool = True):
        """Full-map bundle adjustment (reference RunGlobalBundleAdjustment)
        with the matrix-free PCG solver, over the keyframe bucket and the
        whole point table. With `with_lines` and a line table in use, every
        valid map line joins as paired 1-dof endpoint edges over the
        bucket's keyframes (`add_line_edges`; the reference's GBA has no
        line blocks, the JAX package's does); a line with at least 2 live
        observations (counted over the whole keyframe table) and a finite
        result takes the optimized endpoints, its midpoint their mean.
        Every other line follows its owning keyframe's pose change,
        X' = Tnew^-1 Told X."""
        sys = self.sys
        st = sys.map
        dev = sys.device
        kfs = st.kfs
        K = _k_bucket(kfs.Tcw.shape[0], sys.n_kfs)
        N = kfs.lm_idx.shape[1]
        lm_rows = kfs.lm_idx[:K]
        kf_valid = kfs.valid[:K]
        e_ok = ((lm_rows >= 0) & kfs.fvalid[:K]
                & st.pts.valid[lm_rows.clamp(min=0).long()] & kf_valid[:, None])
        ar = torch.arange(K, dtype=torch.int32, device=dev)
        old_Tcw = kfs.Tcw[:K].clone()
        prob = BAProblem(
            Tcw=old_Tcw,
            cam_free=kf_valid & (ar != 0),
            xyz=st.pts.xyz,
            lm_ok=st.pts.valid,
            e_cam=ar[:, None].expand(K, N).reshape(-1),
            e_lm=lm_rows.clamp(min=0).reshape(-1),
            e_uv=kfs.xy[:K].reshape(-1, 2),
            e_ur=torch.where(e_ok, kfs.u_right[:K], -1.0).reshape(-1),
            e_inv_sigma2=(1.0 / kfs.sigma2[:K]).reshape(-1),
            e_ok=e_ok.reshape(-1),
        )
        lns = st.lns
        P, Q = st.pts.xyz.shape[0], lns.xyz.shape[0]
        use_lines = with_lines and kfs.ll_idx.shape[1] > 1
        if use_lines:
            prob = add_line_edges(
                st, torch.where(kf_valid, ar, -1),
                torch.where(lns.valid, torch.arange(Q, dtype=torch.int32, device=dev),
                            -1), prob)
        res = ba_solve_pcg(sys.cam, prob, rounds=rounds)
        lref = lns.first_kf.clamp(0, K - 1).long()
        To, Tn = old_Tcw[lref], res.Tcw[lref]
        pc = lns.xyz @ To[:, :3, :3].transpose(1, 2) + To[:, None, :3, 3]
        lxw = (pc - Tn[:, None, :3, 3]) @ Tn[:, :3, :3]
        new_lxyz = torch.where((lns.valid & kfs.valid[lref])[:, None, None], lxw,
                               lns.xyz)
        if use_lines:
            ll = kfs.ll_idx
            obs_ok = ((ll >= 0) & kfs.lvalid & kfs.valid[:, None]
                      & lns.valid[ll.clamp(min=0).long()])
            cnt = torch.zeros((Q + 1,), dtype=torch.int32, device=dev).index_add_(
                0, torch.where(obs_ok, ll, Q).reshape(-1).long(),
                torch.ones(ll.numel(), dtype=torch.int32, device=dev))[:Q]
            ends = res.xyz[P:P + 2 * Q].reshape(Q, 2, 3)
            opt = torch.stack([ends[:, 0], 0.5 * (ends[:, 0] + ends[:, 1]), ends[:, 1]],
                              dim=1)
            adopt = lns.valid & (cnt >= 2) & torch.isfinite(opt).all(dim=2).all(dim=1)
            new_lxyz = torch.where(adopt[:, None, None], opt, new_lxyz)
        lns.xyz.copy_(new_lxyz)
        kfs.Tcw[:K] = res.Tcw
        st.pts.xyz.copy_(res.xyz[:P])
        # One copy back: the solver's guard counter and the live poses for
        # the host pose log.
        n = sys.n_kfs
        host = _host(torch.cat([res.n_guarded.float().reshape(1),
                                res.Tcw[:n].reshape(-1)]))
        self.n_guarded += int(host[0])
        for k, T in enumerate(host[1:].reshape(n, 4, 4)):
            sys.kf_pose_host[k] = T.copy()
        # A whole-map pose rewrite: mapping results still in flight carry
        # stale poses (see System.map_version).
        sys.map_version += 1
        return res
