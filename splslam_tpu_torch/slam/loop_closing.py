"""Loop detection and Sim3 verification (port of
splslam_tpu/slam/loop_closing.py, detection side).

The reference LoopClosing thread (src/LoopClosing.cc):
- `DetectLoop` (:103-229): the BoW score of the new keyframe against the
  database, a minimum score from its covisible group, and the temporal
  consistency of covisibility groups (a candidate's group must be
  re-detected in CONSISTENCY_TH consecutive keyframes);
- `ComputeSim3` (:231-402): descriptor match between the keyframes, Sim3
  RANSAC, GN refinement and a projection-count verification.

The reference kills the pipeline after verification (ComputeSim3 returns
false, :390-392); so does this port: a verified loop is recorded in
`LoopCloser.verified_loops` and nothing is corrected. Loop correction
(pose graph, SearchAndFuse, global BA) belongs to a later slice, and
`enable_loop_correction=True` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from splslam_tpu_torch.bow.vocabulary import densify_bow_row, score_rows
from splslam_tpu_torch.ops import match as M
from splslam_tpu_torch.optim import sim3 as S3
from splslam_tpu_torch.slam import reloc
from splslam_tpu_torch.slam.map import MapState, covisibility_counts

MIN_MATCHES = 20        # reference :262 nmatches >= 20
MIN_SIM3_INLIERS = 20   # reference :345 OptimizeSim3 >= 20
MIN_PROJ_MATCHES = 40   # reference :388 >= 40 after Scw projection
CONSISTENCY_TH = 3      # reference mnCovisibilityConsistencyTh
N_HYP_SIM3 = 128        # Sim3 hypotheses an attempt
CORRECTION_LATER = "loop correction (pose graph, global BA): later slice"


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


class LoopCloser:
    """Host orchestration of loop detection and verification."""

    def __init__(self, system):
        self.sys = system
        self.consistent: list[tuple[set, int]] = []
        self.last_loop_kf = -100
        self.verified_loops: list[tuple[int, int]] = []
        self.loop_edges: list[tuple[int, int]] = []  # corrected loops
        self.corrections = 0
        self.n_guarded = 0         # correction-path solver guards (0 here)
        # Degenerate speculative Sim3 verifications (a singular GN step
        # zeroed, then rejected by the count gates); observable, not fatal.
        self.n_guarded_verify = 0

    def on_keyframe(self, kf: int):
        sys = self.sys
        if sys.vocab is None or sys.n_kfs < 6:
            return
        if kf < self.last_loop_kf + 10:  # reference :117 mLastLoopKFid + 10
            return
        cov = _covisible_mask(sys.map, kf).cpu().numpy()
        cov[kf] = True
        ids, vals = sys.kf_bow
        query = densify_bow_row(ids, vals, kf, sys.bow_n_words)
        # minScore: the lowest BoW similarity within the covisible group
        # (reference :121-135).
        cov_idx = [c for c in range(sys.n_kfs) if cov[c] and c != kf]
        if not cov_idx:
            return
        rows = torch.tensor(cov_idx, device=ids.device)
        min_score = float(score_rows(ids[rows], vals[rows], query).min())
        scores = reloc.reloc_scores(
            ids, vals, sys.map.kfs.valid, query,
            torch.from_numpy(cov).to(ids.device)).cpu().numpy()[: sys.n_kfs]
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
                _covisible_mask(sys.map, int(c)).cpu().numpy())[0].tolist())
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
        # stereo: the scale is fixed (reference Sim3Solver mbFixScale)
        n_m, n_opt, n_proj, n_grd, _ = compute_sim3_attempt(
            sys.map, kf, cand, K3, True, generator=gen)
        self.n_guarded_verify += int(n_grd)
        if (int(n_m) < MIN_MATCHES or int(n_opt) < MIN_SIM3_INLIERS
                or int(n_proj) < MIN_PROJ_MATCHES):
            return False
        self.verified_loops.append((kf, cand))
        self.last_loop_kf = kf
        # The reference kills the pipeline here (src/LoopClosing.cc:390-392);
        # correction is a later slice, which System refuses to enable.
        return True
