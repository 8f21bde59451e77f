"""Tests that need a CUDA device: the hand-written `orb_describe` kernel
against its plain PyTorch version (main-path shapes, edge-case slots,
rejected inputs), and the port on the GPU against the
port on the CPU (tracking alone, tracking with local mapping, one
mapping step from identical maps, the BoW transform and keyframe rows,
a kidnap with relocalization, and the loop correction: `pose_graph_sim3`,
`loop_search_and_fuse`, `ba_solve_pcg` and `_correct` from one loop map
built on the CPU), and the monocular point+line path: the line detector,
the ORB kernel at B = 1 inside `build_frame_mono`, a short `track_mono`
run, and a keyframe insertion and a mono frame step that wait for
nothing; a stereo frame step that waits for nothing; and the point+line
back end from one CPU-built mono line map: a line mapping step and
global BA with line edges card against CPU, and a line mapping step and
a line relocalization attempt that wait for nothing; an RGB-D frame step,
with and without localization mode's temporal points, card against CPU
from one CPU-built state and waiting for nothing, one B = 1 launch a
built RGB-D frame, and `device_trace` recording the card's kernels;
batched tracking: `vo_batch_step` (stereo) and `vo_batch_step_mono` card
against CPU from one CPU-built state with integers equal and one launch
a frame, a stereo batch that waits for nothing, `track_stereo_batch`
with deferred stats from pinned staging against the CPU run; and
`make_synthetic_map` with one `mapping_step`, card against CPU; the last
module slice: `gba_sharded` at `make_gba_problem()`'s size at world 1 over
NCCL against world 1 on the CPU, and 4 gloo ranks sharing the card
against world 1 (poses 1e-4, point landmarks 5e-4, line endpoints 5e-4
off the other run's line: tests/test_torch_parallel.py's tolerance), and
a KITTI folder read by the native prefetcher into `track_stereo` on the
card against the same arrays from memory (poses within 1e-5 m). Then
`graft_entry.entry` card against CPU, and the JAX package's four proof
suites, which it marks `slow`, at their full size with their gates
unchanged: tests/test_e2e_robustness.py (a moving object; a map of 100
keyframes corrected by `_correct`), tests/test_bow_retrieval.py (360
places; a tracked 300-keyframe map), tests/test_e2e_parity_matrix.py
(3 seeds x 2 profiles; each tour cell also within
`chip_smoke.TOUR_TOL_PP` of the JAX package's recorded value) and
tests/test_line_repeatability.py. Their cases live in chip_smoke.py,
whose phase 16 runs one of each.
Every test skips on a host without a card.

This file imports no JAX (a GPU host need not have it, and
tests/conftest.py imports it), so on a GPU host run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Tolerances: angle 1e-3 rad and descriptor bits >= 99.5% equal (the
repo's kernel tolerance, tests/test_orb_pallas.py); keypoint tables
exact; poses within 1e-3 of the CPU run (float32 sums in another order
on the GPU). One mapping step: the integer tables after cull, triangulate
and fuse exact; after local BA, keyframe poses within 1e-3, 99% of the
window's landmarks within 1e-3 (a landmark seen by two keyframes slides
along its ray) and inlier masks >= 99% equal (the cell sums run in one
fixed order on both devices; the products and reductions around them do
not). Loop correction: the fuse's integer tables exact; pose graph within
1e-4; global BA poses within 1e-3, 99% of the landmarks within 1e-3 and
inlier masks >= 99% equal (its segment sums run in one fixed order on
both devices, the products around them do not); `_correct` reads nothing
back to the host apart from its listed copies (`loop_closing._host`).
Repeatability: the `segment_sum` kernel equal to its plain version at the
solvers' shapes, and `ba_solve_pcg` (global BA with and without line
edges), `pose_graph_sim3` and `gba_sharded` (world 1 over NCCL, 4 gloo
ranks) twice from identical copies: every output equal to the bit. BoW word ids and row ids exact (integer
popcounts). Kidnap: the same tracking states and lost frames, the same
relocalization keyframe, poses within 1e-3 (with the RANSAC draws made
equal: each device's own generator draws another stream, and the
relocalized pose follows the inlier set the draw finds). Lines: validity
and octaves exact, endpoints within 1e-2 px (atan2/cos/sin and fused
multiply-adds differ on the card), LBD bits >= 99.5% equal. Mono run:
the same init frame, model and keyframes, poses within 2e-2 (the
tolerance of the port against the JAX package, tests/test_torch_mono.py),
the RANSAC hypotheses drawn on the CPU for both devices."""

import json

import numpy as np
import pytest
import torch

from splslam_tpu_torch.bow import vocabulary as TV
from splslam_tpu_torch.io.synthetic import (ate_rmse, make_loop_circuit,
                                            make_stereo_sequence)
from splslam_tpu_torch.ops import orb as TO
from splslam_tpu_torch.ops import orb_kernel as OK
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.slam import mapping_ops as TMO
from splslam_tpu_torch.slam import reloc as TR
from splslam_tpu_torch.slam import system as TS

pytestmark = pytest.mark.gpu

ANGLE_ATOL = 1e-3
BIT_AGREE = 0.995


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bit_agreement(d1, d2) -> float:
    b1 = np.unpackbits(d1.cpu().numpy().view(np.uint8))
    b2 = np.unpackbits(d2.cpu().numpy().view(np.uint8))
    return float((b1 == b2).mean())


def edge_case_inputs(n_levels, n_images, seed):
    """Random float32 pyramid levels at a small spec and slots that reach
    every corner of the kernel's geometry: (0,0); y < 19 on every level,
    whose patch starts in the previous level (or is clamped to the top);
    a valid slot on the bottom border (y = H-20, whose patch ends one row
    into the next level); the right and bottom edges, columns past the
    level's width, points outside the level and fractional coordinates;
    the rest random. At 8 levels the smallest levels are shorter than a
    patch, so one patch spans three levels. Returns (spec, levels as
    numpy [image][level], xy f32 [n_images, N, 2])."""
    H, W, nf = {1: (48, 100, 16), 4: (120, 160, 40), 8: (96, 128, 64)}[n_levels]
    spec = PyramidSpec.create(H, W, n_levels, 1.2, nf)
    rng = np.random.default_rng(seed)
    levels = [[rng.uniform(0, 255, hw).astype(np.float32) for hw in spec.sizes]
              for _ in range(n_images)]
    xy = np.empty((n_images, spec.total_capacity, 2), np.float32)
    for b in range(n_images):
        i0 = 0
        for lv, budget in enumerate(spec.budgets):
            h, w = spec.sizes[lv]
            fixed = [(0, 0), (w / 2, 5), (w / 3, h - 20), (w - 1, h - 1),
                     (w - 1, h / 2), (10.7, 18.9), (w + 30, h + 30), (-3, -2)]
            pts = np.stack([rng.uniform(0, w, budget),
                            rng.uniform(0, h, budget)], -1)
            m = min(budget, len(fixed))
            pts[:m] = fixed[:m]
            xy[b, i0:i0 + budget] = pts
            i0 += budget
    return spec, levels, xy


def assert_describe_agrees(levels, xy, spec):
    before = OK.orb_describe.launches
    a_k, d_k = OK.orb_describe(levels, xy, spec)
    a_p, d_p = OK.orb_describe_reference(levels, xy, spec)
    torch.cuda.synchronize()
    assert OK.orb_describe.launches == before + 1
    assert a_k.shape == a_p.shape and d_k.shape == d_p.shape
    assert float((a_k - a_p).abs().max()) <= ANGLE_ATOL
    assert bit_agreement(d_k, d_p) >= BIT_AGREE


def test_kernel_matches_plain_at_main_path_shapes(cuda):
    """KITTI 1241x376, 2000 features, 8 levels, both images of a stereo
    frame in one launch."""
    _, _, frames, _ = make_stereo_sequence(
        n_frames=1, width=1241, height=376, fx=718.0, baseline=0.54,
        motion="forward", seed=3)
    spec = PyramidSpec.create(376, 1241, 8, 1.2, 2000)
    found = [TO.detect(torch.from_numpy(f.astype(np.uint8)).to(cuda).float(),
                       spec) for f in frames[0]]
    xy = torch.stack([torch.cat([d[1] for d in det]) for _, det in found])
    assert tuple(xy.shape) == (2, 2000, 2)
    assert_describe_agrees([lv for lv, _ in found], xy, spec)


@pytest.mark.parametrize("n_levels,n_images", [(1, 1), (1, 2), (4, 1), (4, 2),
                                               (8, 1), (8, 2)])
def test_kernel_edge_slots(cuda, n_levels, n_images):
    """Straddling, clamped and out-of-level slots, ragged level budgets,
    patches over two and three levels and over the zero rows."""
    spec, levels, xy = edge_case_inputs(n_levels, n_images, seed=n_levels)
    levels = [[torch.from_numpy(x).to(cuda) for x in pyr] for pyr in levels]
    assert_describe_agrees(levels, torch.from_numpy(xy).to(cuda), spec)


def test_kernel_rejects_what_it_does_not_take(cuda):
    spec, levels, xy = edge_case_inputs(4, 2, seed=0)
    lv = [[torch.from_numpy(x).to(cuda) for x in pyr] for pyr in levels]
    xy = torch.from_numpy(xy).to(cuda)
    bad = [
        ([[x.double() for x in pyr] for pyr in lv], xy),        # dtype
        ([pyr[:-1] for pyr in lv], xy),                         # level count
        ([[x[:, :-1] for x in pyr] for pyr in lv], xy),         # shape
        ([[x.t().contiguous().t() for x in pyr] for pyr in lv], xy),  # strides
        ([[x.cpu() for x in pyr] for pyr in lv], xy),           # device
        (lv, xy.to(torch.int32)),                               # xy dtype
        (lv, xy[:, :-1].contiguous()),                          # slot count
        (lv, xy.transpose(0, 1).contiguous().transpose(0, 1)),  # xy strides
        (lv[:1], xy),                                           # batch
        (lv + lv[:1], torch.cat([xy, xy[:1]])),                 # B = 3
    ]
    for levels_arg, xy_arg in bad:
        with pytest.raises(ValueError):
            OK.orb_describe(levels_arg, xy_arg, spec)


def test_extract_orb_gpu_matches_cpu(cuda):
    _, _, frames, _ = make_stereo_sequence(n_frames=1, motion="forward",
                                           width=320, height=240)
    img = torch.from_numpy(frames[0][0].astype(np.uint8)).float()
    spec = PyramidSpec.create(240, 320, 4, 1.2, 600)
    fc = TO.extract_orb(img, spec)
    fg = TO.extract_orb(img.to(cuda), spec)
    for name in ("xy", "response", "octave", "valid"):
        torch.testing.assert_close(getattr(fg, name).cpu(), getattr(fc, name),
                                   rtol=0, atol=0, msg=name)
    assert float((fg.angle.cpu() - fc.angle).abs().max()) <= ANGLE_ATOL
    assert bit_agreement(fg.desc, fc.desc) >= BIT_AGREE


def _settings(K, bf, **kw):
    return TS.Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=600, n_levels=4, th_depth=40.0, fps=10,
        max_points=8192, max_keyframes=64, local_window=1024, **kw,
    )


def test_system_gpu_matches_cpu(cuda):
    K, bf, frames, gt = make_stereo_sequence(n_frames=20, motion="forward",
                                             width=320, height=240)
    st = _settings(K, bf, enable_local_mapping=False)
    runs = []
    for dev in ("cpu", cuda):
        sysm = TS.System(st, TS.Sensor.STEREO, dev)
        before = OK.orb_describe.launches
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
        assert sysm.get_tracking_state() == TS.TrackingState.OK
        runs.append((sysm, OK.orb_describe.launches - before))
    (sc, lc), (sg, lg) = runs
    assert lc == 0 and lg == len(frames)  # one launch per stereo frame
    assert sg.n_kfs == sc.n_kfs
    pc, pg = sc.poses(), sg.poses()
    np.testing.assert_allclose(pg[:, :3, :4], pc[:, :3, :4], atol=1e-3)
    assert ate_rmse(pg, gt) < 0.05


def test_mapping_system_gpu_matches_cpu(cuda):
    """20 frames with local mapping, keyframes every 4 frames."""
    K, bf, frames, gt = make_stereo_sequence(n_frames=20, motion="forward",
                                             width=320, height=240)
    st = _settings(K, bf, force_kf_every=4)
    runs = []
    for dev in ("cpu", cuda):
        sysm = TS.System(st, TS.Sensor.STEREO, dev)
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
        assert sysm.get_tracking_state() == TS.TrackingState.OK
        assert sysm.health()["mapping_state_revert"] == 0
        runs.append(sysm)
    sc, sg = runs
    assert sg.n_kfs == sc.n_kfs >= 4
    assert sg.mapper.n_steps == sc.mapper.n_steps == sc.n_kfs - 1
    np.testing.assert_array_equal(sg.map.kfs.frame_id.cpu().numpy(),
                                  sc.map.kfs.frame_id.numpy())
    np.testing.assert_allclose(sg.poses()[:, :3, :4], sc.poses()[:, :3, :4], atol=1e-3)
    assert ate_rmse(sg.poses(), gt) < 0.05


def _int_tables(m):
    return {"n_pts": m.n_pts, "pts.valid": m.pts.valid, "pts.recent": m.pts.recent,
            "pts.n_obs": m.pts.n_obs, "pts.first_kf": m.pts.first_kf,
            "pts.desc": m.pts.desc, "kfs.lm_idx": m.kfs.lm_idx, "kfs.valid": m.kfs.valid}


def test_mapping_step_gpu_matches_cpu(cuda):
    """One mapping step on the GPU and on the CPU from identical maps (the
    CPU port's map after 13 frames, stepped again on its last keyframe)."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=13, motion="forward",
                                            width=320, height=240)
    sysm = TS.System(_settings(K, bf, force_kf_every=4), TS.Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    kf = sysm.n_kfs - 1
    out = {}
    for key, dev in (("cpu", "cpu"), ("gpu", cuda)):
        m = sysm.map.to(dev)
        m = m._replace(kfs=type(m.kfs)(*[x[:32] for x in m.kfs]))
        m, _ = TMO.map_upkeep(m, kf, sysm.cam, sysm.scales.to(dev), 1.2, 4)
        ints = {k: v.to("cpu", copy=True) for k, v in _int_tables(m).items()}
        m, prob, res = TMO.local_ba(m, kf, sysm.cam, 1.2, 4)
        out[key] = (ints, m, prob, res)
    (ic, _, pc, rc), (ig, _, pg, rg) = out["cpu"], out["gpu"]
    for k in ic:
        torch.testing.assert_close(ig[k], ic[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(pg.e_ok.cpu(), pc.e_ok, rtol=0, atol=0)
    np.testing.assert_allclose(rg.Tcw.cpu().numpy(), rc.Tcw.numpy(), atol=1e-3)
    d = (rg.xyz.cpu() - rc.xyz).norm(dim=-1)[pc.lm_ok]
    assert float(torch.quantile(d, 0.99)) <= 1e-3
    agree = (rg.e_inlier.cpu() == rc.e_inlier)[pc.e_ok].float().mean()
    assert float(agree) >= 0.99
    assert int(rg.n_state_revert) == int(rc.n_state_revert) == 0


def test_bow_rows_gpu_match_cpu(cuda):
    """The 10^5-word tree descent and keyframe rows of real ORB features."""
    _, _, frames, _ = make_stereo_sequence(n_frames=8, motion="forward",
                                           width=320, height=240)
    spec = PyramidSpec.create(240, 320, 4, 1.2, 600)
    out = {}
    for dev in ("cpu", cuda):
        v = TV.load(TV.default_vocab_path(), dev)
        table = TV.BowTable.empty(3, spec.total_capacity, v.n_words, dev)
        words = []
        for row, i in enumerate((0, 4, 7)):
            f = TO.extract_orb(torch.from_numpy(frames[i][0]).to(dev).float(), spec)
            words.append(TV.transform_words(v, f.desc, f.valid).cpu())
            TV.update_bow_row(table.ids, table.vals, v.level_desc, v.weights,
                              v.k, v.depth, f.desc, f.valid, row)
        out[str(dev)] = (words, table.ids.cpu(), table.vals.cpu())
    (wc, ic, vc), (wg, ig, vg) = out["cpu"], out[str(cuda)]
    for a, b in zip(wg, wc):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ig, ic, rtol=0, atol=0)
    torch.testing.assert_close(vg, vc, rtol=0, atol=1e-6)


def test_kidnap_gpu_matches_cpu(cuda, tmp_path, monkeypatch):
    """tests/test_reloc.py's kidnap (15 frames, 3 blank, frame 6 twice)
    with the defaults: relocalization and loop detection on. Then the map
    is saved and loaded into a fresh System, which relocalizes frame 6.
    The RANSAC draws are made equal on both devices (drawn from a CPU
    generator with the device generator's seed), so the poses differ only
    by float arithmetic."""
    draw = TR.sample_minimal_sets

    def host_draw(generator, mask, n_hyp, m):
        gen = torch.Generator().manual_seed(generator.initial_seed())
        return draw(gen, mask.cpu(), n_hyp, m).to(mask.device)

    monkeypatch.setattr(TR, "sample_minimal_sets", host_draw)
    K, bf, frames, gt = make_stereo_sequence(n_frames=15, motion="forward",
                                             width=320, height=240)
    blank = np.full((240, 320), 128.0, np.float32)
    runs = []
    for dev in ("cpu", cuda):
        sysm = TS.System(_settings(K, bf), TS.Sensor.STEREO, dev)
        won = []
        attempt = sysm._try_relocalize

        def recorded(step_state, ts, sysm=sysm, attempt=attempt, won=won):
            ok = attempt(step_state, ts)
            if ok:
                won.append((sysm.ref_kf, sysm.last_Tcw_np.copy()))
            return ok

        sysm._try_relocalize = recorded
        states = []
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
        states.append(sysm.get_tracking_state())
        for j in range(3):
            sysm.track_stereo(blank, blank, 1.5 + j * 0.1)
        states.append(sysm.get_tracking_state())
        for j in range(2):
            sysm.track_stereo(frames[6][0], frames[6][1], 2.0 + j * 0.1)
        states.append(sysm.get_tracking_state())
        path = str(tmp_path / f"{dev}.npz")
        sysm.save_map(path)
        loaded = TS.System(_settings(K, bf), TS.Sensor.STEREO, dev)
        loaded.load_map(path)
        loaded.track_stereo(frames[6][0], frames[6][1], 3.0)
        states.append(loaded.get_tracking_state())
        won.append((loaded.ref_kf, loaded.last_Tcw_np.copy()))
        runs.append((sysm, states, won))
    (sc, stc, wc), (sg, stg, wg) = runs
    assert stc == stg == [TS.TrackingState.OK, TS.TrackingState.LOST,
                          TS.TrackingState.OK, TS.TrackingState.OK]
    assert [e.lost for e in sg.trajectory] == [e.lost for e in sc.trajectory]
    assert [k for k, _ in wg] == [k for k, _ in wc]
    for (_, a), (_, b) in zip(wg, wc):
        np.testing.assert_allclose(a, b, atol=1e-3)
    np.testing.assert_allclose(sg.poses()[:, :3, :4], sc.poses()[:, :3, :4], atol=1e-3)
    assert np.linalg.norm(sg.poses()[-1][:3, 3] - gt[6][:3, 3]) < 0.05


def test_reloc_and_sim3_attempts_do_not_sync(cuda):
    """No value of a relocalization attempt, a BoW row or a Sim3
    verification is read back to the host inside the call (the accept
    decisions read it once, afterwards)."""
    from splslam_tpu_torch.slam import loop_closing as TLC

    K, bf, frames, _ = make_stereo_sequence(n_frames=9, motion="forward",
                                            width=320, height=240)
    sysm = TS.System(_settings(K, bf, force_kf_every=2), TS.Sensor.STEREO, cuda)
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    assert sysm.n_kfs >= 3
    frame, kfs, v = sysm.step.frame, sysm.map.kfs, sysm.vocab
    lm = kfs.lm_idx[0]
    xyz = sysm.map.pts.xyz[lm.clamp(min=0).long()]
    K3 = torch.tensor([[sysm.cam.fx, 0.0, sysm.cam.cx], [0.0, sysm.cam.fy, sysm.cam.cy],
                       [0.0, 0.0, 1.0]], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = TR.reloc_attempt(sysm.cam, frame, kfs.desc[0], kfs.fvalid[0], lm, xyz,
                               generator=gen)
        TV.query_bow(v.level_desc, v.weights, v.k, v.depth, frame.feat.desc,
                     frame.feat.valid)
        TV.update_bow_row(sysm.kf_bow.ids, sysm.kf_bow.vals, v.level_desc,
                          v.weights, v.k, v.depth, frame.feat.desc,
                          frame.feat.valid, sysm.n_kfs)
        sim = TLC.compute_sim3_attempt(sysm.map, sysm.n_kfs - 1, 0, K3, True,
                                       generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out[1]) >= 50 and int(sim[0]) >= TLC.MIN_MATCHES


# ---------------------------------------------------------------------
# loop correction and global BA, card against CPU from one CPU-built map
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def loop_map():
    """The CPU port's run of the loop circuit (correction off): the System,
    its verified loop and the measured Sim3."""
    from splslam_tpu_torch.slam import loop_closing as TLC

    if not torch.cuda.is_available():     # before the 30 s CPU run
        pytest.skip("needs a CUDA device")
    K, bf, frames, gt = make_loop_circuit()
    st = TS.Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=500, n_levels=4, th_depth=60.0, fps=5, max_points=16384,
        max_keyframes=64, local_window=1024)
    sysm = TS.System(st, TS.Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.2)
    sysm.drain()
    kf, cand = sysm.loop_closer.verified_loops[0]
    gen = torch.Generator().manual_seed(kf)
    *_, S12 = TLC.compute_sim3_attempt(sysm.map, kf, cand, torch.from_numpy(K), True,
                                       generator=gen)
    return sysm, kf, cand, S12, st


def _stub(sysm, dev):
    """The host state `_correct` reads, with a copy of the map on `dev`."""
    import types

    return types.SimpleNamespace(
        map=sysm.map.to(dev), n_kfs=sysm.n_kfs, device=torch.device(dev),
        sensor=sysm.sensor, cam=sysm.cam, scales=sysm.scales.to(dev),
        settings=sysm.settings, mapper=types.SimpleNamespace(big_change_idx=0),
        kf_pose_host={}, map_version=0, step=None)


def test_pose_graph_sim3_gpu_matches_cpu(cuda, loop_map):
    from splslam_tpu_torch.optim import sim3 as TS3
    from splslam_tpu_torch.slam import loop_closing as TLC

    sysm, kf, cand, S12, _ = loop_map
    n = sysm.n_kfs
    edges = TLC._build_pose_graph_edges(sysm.map, n, kf, cand, S12)
    K = TLC._k_bucket(sysm.map.kfs.Tcw.shape[0], n)
    out = []
    for dev in ("cpu", cuda):
        Tcw = sysm.map.kfs.Tcw[:K].to(dev)
        free = (torch.arange(K, device=dev) < n) & (torch.arange(K, device=dev) != 0)
        out.append(TS3.pose_graph_sim3(
            torch.ones((K,), device=dev), Tcw[:, :3, :3], Tcw[:, :3, 3], free,
            TS3.PoseGraphEdges(*[x.to(dev) for x in edges]), iters=15,
            fix_scale=True))
    (sc, Rc, tc, gc), (sg, Rg, tg, gg) = out
    assert int(gc) == int(gg) == 0
    err = max(float((Rg.cpu() - Rc).abs().max()), float((tg.cpu() - tc).abs().max()))
    print(f"pose_graph_sim3 card vs CPU: {edges.i.shape[0]} edges, K {K}, "
          f"max abs err {err:.3e}")
    assert err <= 1e-4
    assert torch.equal(sg.cpu(), sc)


def _loop_inputs(sysm, kf, cand, dev):
    from splslam_tpu_torch.slam import loop_closing as TLC

    m = sysm.map.to(dev)
    group = lambda k: torch.cat([torch.full((1,), k, dtype=torch.int32, device=dev),
                                 TMO._topk_covisible(m, k, 7)[0]])
    cur, loop = group(kf), group(cand)
    rows = m.kfs.lm_idx[loop.clamp(min=0).long()]
    ids = torch.unique(torch.where((loop >= 0)[:, None], rows, -1))
    ids = ids[ids >= 0][:TLC.MAX_LOOP_LMS]
    pad = torch.full((TLC.MAX_LOOP_LMS - ids.shape[0],), -1, dtype=torch.int32,
                     device=dev)
    return m, cur, torch.cat([ids.to(torch.int32), pad])


def test_loop_search_and_fuse_gpu_matches_cpu(cuda, loop_map):
    from splslam_tpu_torch.slam import loop_closing as TLC

    sysm, kf, cand, _, st = loop_map
    out = []
    for dev in ("cpu", cuda):
        m, cur, loop_lms = _loop_inputs(sysm, kf, cand, dev)
        n0 = int(m.pts.valid.sum())
        m = TLC.loop_search_and_fuse(m, cur, loop_lms, sysm.cam, sysm.scales.to(dev),
                                     st.scale_factor, st.n_levels)
        out.append((m, n0, loop_lms.cpu()))
    (mc, n0, lc), (mg, _, lg) = out
    assert torch.equal(lg, lc)
    for name, a, b in (("lm_idx", mg.kfs.lm_idx, mc.kfs.lm_idx),
                       ("valid", mg.pts.valid, mc.pts.valid),
                       ("n_obs", mg.pts.n_obs, mc.pts.n_obs)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0, msg=name)
    assert int(mc.pts.valid.sum()) < n0


def test_ba_solve_pcg_gpu_matches_cpu(cuda, loop_map):
    from splslam_tpu_torch.slam import loop_closing as TLC

    sysm = loop_map[0]
    out = []
    for dev in ("cpu", cuda):
        stub = _stub(sysm, dev)
        lc = TLC.LoopCloser(stub)
        res = lc.run_global_ba(rounds=1)
        out.append((stub, lc, res))
    (sc, lcc, rc), (sg, lcg, rg) = out
    assert lcc.n_guarded == lcg.n_guarded == 0
    assert int(rc.n_state_revert) == int(rg.n_state_revert) == 0
    pose_err = float((rg.Tcw.cpu() - rc.Tcw).abs().max())
    ok = sc.map.pts.valid
    d = (rg.xyz.cpu() - rc.xyz).norm(dim=-1)[ok]
    e_ok = rc.e_inlier | rg.e_inlier.cpu()
    agree = float((rg.e_inlier.cpu() == rc.e_inlier)[e_ok].float().mean())
    print(f"ba_solve_pcg card vs CPU: {int(ok.sum())} landmarks, pose max abs err "
          f"{pose_err:.3e}, landmark err q99 {float(torch.quantile(d, 0.99)):.3e} "
          f"max {float(d.max()):.3e}, inlier agreement {agree:.5f}")
    assert pose_err <= 1e-3
    assert float(torch.quantile(d, 0.99)) <= 1e-3
    assert agree >= 0.99
    for k in range(sysm.n_kfs):
        np.testing.assert_allclose(sg.kf_pose_host[k], sc.kf_pose_host[k], atol=1e-3)


SEGSUM_SHAPES = {   # rows, cells, width: the solvers' sums on the card
    "pcg_cameras": (64000, 32, 6),        # chip_smoke phase 8's CG products
    "pcg_landmarks": (64000, 16384, 3),
    "pcg_camera_blocks": (64000, 32, 42),
    "pose_graph_blocks": (4 * 600, 64 * 64, 49),
    "local_ba_cells": (20000, 9 * 4096, 54),
    "one_cell_and_sentinels": (100000, 5, 2),
}


@pytest.mark.parametrize("shape", list(SEGSUM_SHAPES))
def test_segment_sum_kernel_matches_plain(cuda, shape):
    """Kernel and plain version equal at the solvers' shapes, and the
    kernel equal to itself on a second launch."""
    from splslam_tpu_torch.ops import segsum as SS

    E, n, W = SEGSUM_SHAPES[shape]
    g = torch.Generator().manual_seed(E + n + W)
    if shape == "one_cell_and_sentinels":
        cell = torch.full((E,), 3)
        cell[::7] = n                     # the sentinel: dropped
        cell[::11] = -1                   # below 0: dropped
    else:
        cell = torch.randint(0, n + 1, (E,), generator=g)
    rows = torch.randn((E, W), generator=g) * 10.0 ** torch.randint(
        -3, 4, (E, 1), generator=g)
    seg = SS.Segments(cell.to(cuda), n)
    before = SS.segment_sum.launches
    a = SS.segment_sum(seg, rows.to(cuda))
    b = SS.segment_sum(seg, rows.to(cuda))
    ref = SS.segment_sum_reference(seg, rows.to(cuda))
    torch.cuda.synchronize()
    assert SS.segment_sum.launches == before + 4      # two launches a sum
    assert torch.equal(a, b) and torch.equal(a, ref)
    assert torch.equal(ref.cpu(), SS.segment_sum(SS.Segments(cell, n), rows))
    with pytest.raises(ValueError):
        SS.segment_sum(seg, rows.to(cuda).double())
    with pytest.raises(ValueError):
        SS.segment_sum(seg, rows.to(cuda).repeat(1, 2)[:, ::2])


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("with_lines", [False, True])
def test_global_ba_repeats_to_the_bit(cuda, with_lines, request):
    """`run_global_ba` twice on the card from identical copies of a map
    (the loop map; with lines, the mono line map): every output of the
    solve and every table it writes equal to the bit."""
    from splslam_tpu_torch.slam import loop_closing as TLC

    sysm = request.getfixturevalue("line_map" if with_lines else "loop_map")[0]
    runs = []
    for _ in range(2):
        stub = _stub(sysm, cuda)
        res = TLC.LoopCloser(stub).run_global_ba(rounds=1, with_lines=with_lines)
        runs.append((res, stub))
    (r1, s1), (r2, s2) = runs
    assert _equal(r1, r2)
    assert _equal((s1.map.kfs.Tcw, s1.map.pts.xyz, s1.map.lns.xyz),
                  (s2.map.kfs.Tcw, s2.map.pts.xyz, s2.map.lns.xyz))
    for k in s1.kf_pose_host:
        np.testing.assert_array_equal(s1.kf_pose_host[k], s2.kf_pose_host[k])


def test_pose_graph_sim3_repeats_to_the_bit(cuda, loop_map):
    from splslam_tpu_torch.optim import sim3 as TS3
    from splslam_tpu_torch.slam import loop_closing as TLC

    sysm, kf, cand, S12, _ = loop_map
    n = sysm.n_kfs
    edges = TS3.PoseGraphEdges(*[x.to(cuda) for x in TLC._build_pose_graph_edges(
        sysm.map, n, kf, cand, S12)])
    K = TLC._k_bucket(sysm.map.kfs.Tcw.shape[0], n)
    Tcw = sysm.map.kfs.Tcw[:K].to(cuda)
    free = (torch.arange(K, device=cuda) < n) & (torch.arange(K, device=cuda) != 0)
    a, b = (TS3.pose_graph_sim3(torch.ones((K,), device=cuda), Tcw[:, :3, :3].clone(),
                                Tcw[:, :3, 3].clone(), free, edges, iters=15,
                                fix_scale=True) for _ in range(2))
    assert _equal(a, b)


def test_correct_does_not_sync_outside_its_host_copies(cuda, loop_map, monkeypatch):
    """`_correct` on the card under `set_sync_debug_mode("warn")`, every
    warning collected and none allowed: only the copies made through
    `loop_closing._host` (the essential graph's inputs, the solver
    counters, the pose log) may wait for the device. The result follows
    the CPU's."""
    import warnings

    from splslam_tpu_torch.slam import loop_closing as TLC

    sysm, kf, cand, S12, _ = loop_map
    cpu = _stub(sysm, "cpu")
    TLC.LoopCloser(cpu)._correct(kf, cand, S12)
    gpu = _stub(sysm, cuda)
    S12g = tuple(x.to(cuda) for x in S12)
    host, n_host = TLC._host, []

    def listed(t):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            n_host.append(t.numel())
            return host(t)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(TLC, "_host", listed)
    lc = TLC.LoopCloser(gpu)
    lc._correct(kf, cand, S12g)            # warm-up: lazy initialisations
    gpu = _stub(sysm, cuda)
    lc = TLC.LoopCloser(gpu)
    n_host.clear()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            lc._correct(kf, cand, S12g)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    assert not syncs, syncs
    assert len(n_host) == 5                # poses, two count matrices, 2 counters
    assert lc.n_guarded == 0 and lc.loop_edges == [(kf, cand)]
    assert gpu.map_version == cpu.map_version == 2
    n = sysm.n_kfs
    pose_err = float((gpu.map.kfs.Tcw[:n].cpu() - cpu.map.kfs.Tcw[:n]).abs().max())
    diff = int((gpu.map.kfs.lm_idx.cpu() != cpu.map.kfs.lm_idx).sum())
    print(f"_correct card vs CPU: pose max abs err {pose_err:.3e}, lm_idx entries "
          f"differing {diff}, host copies {n_host}")
    assert pose_err <= 1e-3
    assert int(gpu.map.pts.valid.sum()) < int(sysm.map.pts.valid.sum())
    assert diff <= 0.001 * gpu.map.kfs.lm_idx.numel()


# ---------------------------------------------------------------------
# the monocular point+line path
# ---------------------------------------------------------------------
LINE_SEG_ATOL = 1e-2


def _grid_frames(n, w=320, h=240):
    return make_stereo_sequence(n_frames=n, motion="lateral", width=w, height=h,
                                texture="grid")


@pytest.mark.parametrize("backend", ["grow", "fld"])
def test_extract_lines_gpu_matches_cpu(cuda, backend):
    from splslam_tpu_torch.ops.lines import extract_lines

    _, _, frames, _ = _grid_frames(1, 640, 480)
    img = torch.from_numpy(frames[0][0].astype(np.float32))
    fc = extract_lines(img, capacity=128, backend=backend)
    fg = extract_lines(img.to(cuda), capacity=128, backend=backend)
    v = fc.valid
    torch.testing.assert_close(fg.valid.cpu(), v, rtol=0, atol=0)
    torch.testing.assert_close(fg.octave.cpu(), fc.octave, rtol=0, atol=0)
    err = float((fg.seg.cpu()[v] - fc.seg[v]).abs().max())
    print(f"extract_lines ({backend}) card vs CPU: {int(v.sum())} lines, endpoint "
          f"max abs err {err:.3e} px, bits agree {bit_agreement(fg.desc[v.to(cuda)], fc.desc[v]):.5f}")
    assert err <= LINE_SEG_ATOL and int(v.sum()) >= 30
    assert bit_agreement(fg.desc[v.to(cuda)], fc.desc[v]) >= BIT_AGREE


def test_build_frame_mono_runs_the_kernel_at_b1(cuda):
    """One B = 1 launch a monocular frame; its keypoints, angles and
    descriptors as the plain version's (the CPU build)."""
    from splslam_tpu_torch.slam.frame import build_frame_mono

    K, _, frames, _ = _grid_frames(1)
    img = torch.from_numpy(frames[0][0].astype(np.float32))
    spec = PyramidSpec.create(240, 320, 4, 1.2, 600)
    cam = _settings(K, 0.0).camera()
    fc = build_frame_mono(img, cam, spec, with_lines=True, line_capacity=64)
    before = OK.orb_describe.launches
    fg = build_frame_mono(img.to(cuda), cam, spec, with_lines=True, line_capacity=64)
    assert OK.orb_describe.launches - before == 1
    for name in ("xy", "octave", "valid"):
        torch.testing.assert_close(getattr(fg.feat, name).cpu(), getattr(fc.feat, name),
                                   rtol=0, atol=0, msg=name)
    assert float((fg.feat.angle.cpu() - fc.feat.angle).abs().max()) <= ANGLE_ATOL
    assert bit_agreement(fg.feat.desc, fc.feat.desc) >= BIT_AGREE
    torch.testing.assert_close(fg.lines.valid.cpu(), fc.lines.valid, rtol=0, atol=0)


def test_track_mono_gpu_matches_cpu(cuda, monkeypatch):
    from splslam_tpu_torch.slam import mono as TM

    draw = TM.draw_init_samples
    monkeypatch.setattr(TM, "draw_init_samples",
                        lambda mask, n_hyp=TM.N_HYP: draw(mask.cpu(), n_hyp).to(mask.device))
    K, _, frames, gt = _grid_frames(14)
    st = _settings(K, 0.0, using_line=True, line_features=64,
                   enable_local_mapping=False, enable_relocalization=False,
                   enable_loop_closing=False)
    runs = []
    for dev in ("cpu", cuda):
        sysm = TS.System(st, TS.Sensor.MONOCULAR, dev)
        before = OK.orb_describe.launches
        for i, (l, _) in enumerate(frames):
            sysm.track_mono(l, i * 0.1)
        assert sysm.get_tracking_state() == TS.TrackingState.OK
        runs.append((sysm, OK.orb_describe.launches - before))
    (sc, lc), (sg, lg) = runs
    assert lc == 0 and lg == len(frames)     # one B = 1 launch a frame
    assert [e.ts for e in sg.trajectory[:2]] == [e.ts for e in sc.trajectory[:2]]
    assert sg.init_used_h == sc.init_used_h and sg.n_kfs == sc.n_kfs
    torch.testing.assert_close(sg.map.kfs.frame_id.cpu(), sc.map.kfs.frame_id)
    pc, pg = sc.poses(), sg.poses()
    print(f"track_mono card vs CPU: pose max abs err {np.abs(pg - pc).max():.3e}, "
          f"map lines {int(sg.map.lns.valid.sum())} / {int(sc.map.lns.valid.sum())}")
    np.testing.assert_allclose(pg[:, :3, :4], pc[:, :3, :4], atol=2e-2)
    idx = [int(round(e.ts / 0.1)) for e in sg.trajectory if not e.lost]
    assert ate_rmse(pg, gt[idx], align_scale=True) < 0.15


def test_insert_keyframe_does_not_sync(cuda):
    """A keyframe row is written through 1-d index tensors: no value is
    read back to the host (`set_sync_debug_mode("error")`), and the rows
    are the CPU's."""
    from splslam_tpu_torch.slam import map as TMap

    K, bf, frames, _ = make_stereo_sequence(n_frames=3, motion="forward",
                                            width=320, height=240)
    sysm = TS.System(_settings(K, bf, enable_local_mapping=False,
                               enable_relocalization=False, enable_loop_closing=False),
                     TS.Sensor.STEREO, cuda)
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    step = sysm.step
    mc = sysm.map.to("cpu")
    st_c, kc = TMap.insert_keyframe(mc, step.frame._replace(
        feat=type(step.frame.feat)(*[x.cpu() for x in step.frame.feat]),
        u_right=step.frame.u_right.cpu(), depth=step.frame.depth.cpu(),
        lines=type(step.frame.lines)(*[x.cpu() for x in step.frame.lines])),
        step.Tcw.cpu(), step.lm_gid.cpu(), step.ll_gid.cpu(), 7, 0.7)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st_g, kg = TMap.insert_keyframe(sysm.map, step.frame, step.Tcw, step.lm_gid,
                                        step.ll_gid, 7, 0.7)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(kg) == int(kc) == sysm.n_kfs
    for a, b in ((st_g.kfs, st_c.kfs), (st_g.pts, st_c.pts)):
        for f in a._fields:
            torch.testing.assert_close(getattr(a, f).cpu(), getattr(b, f), msg=f)
    assert int(st_g.n_kfs) == int(st_c.n_kfs) == sysm.n_kfs + 1


def test_mono_frame_step_does_not_sync(cuda):
    """After the bootstrap, one monocular point+line frame (ORB at B = 1,
    the line detector, both matchers, four pose solves, the counter
    updates) reads nothing back to the host: no Python scalar written
    into a card tensor, no per-call upload of a host table, no checked
    inverse."""
    from splslam_tpu_torch.slam import pipeline as PL

    K, _, frames, _ = _grid_frames(8)
    st = _settings(K, 0.0, using_line=True, line_features=64,
                   enable_local_mapping=False, enable_relocalization=False,
                   enable_loop_closing=False)
    sysm = TS.System(st, TS.Sensor.MONOCULAR, cuda)
    for i, (l, _) in enumerate(frames[:-1]):
        sysm.track_mono(l, i * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    img = torch.from_numpy(frames[-1][0].astype(np.uint8)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, step, stats = PL.vo_frame_step_mono(
            img, sysm.map, sysm.step, sysm.th_depth_m, sysm.ref_kf, sysm.cam,
            sysm.spec, sysm.scales, m_local=st.local_window,
            scale_factor=st.scale_factor, n_levels=st.n_levels, with_lines=True,
            line_capacity=sysm.line_cap, line_cfg=sysm.line_cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(stats).all())
    assert int(stats[PL.S_N_IN]) > 15


def test_stereo_frame_step_does_not_sync(cuda):
    """One stereo frame (ORB on both images in one launch, the stereo
    match with the System's cached scale table, tracking, the counter
    updates) reads nothing back to the host."""
    from splslam_tpu_torch.slam import pipeline as PL

    K, bf, frames, _ = make_stereo_sequence(n_frames=4, motion="forward",
                                            width=320, height=240)
    st = _settings(K, bf, enable_local_mapping=False, enable_relocalization=False,
                   enable_loop_closing=False)
    sysm = TS.System(st, TS.Sensor.STEREO, cuda)
    for i, (l, r) in enumerate(frames[:-1]):
        sysm.track_stereo(l, r, i * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    imgs = torch.from_numpy(np.stack(frames[-1]).astype(np.uint8)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, step, stats = PL.vo_frame_step(
            imgs, sysm.map, sysm.step, sysm.th_depth_m, sysm.ref_kf, sysm.cam,
            sysm.spec, sysm.scales, m_local=st.local_window,
            scale_factor=st.scale_factor, n_levels=st.n_levels,
            line_capacity=sysm.line_cap, line_cfg=sysm.line_cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(stats).all())
    assert int(stats[PL.S_N_IN]) > 100


# ---------------------------------------------------------------------
# point+line mapping, relocalization and global BA, card against CPU
# from one CPU-built monocular line map
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def line_map():
    """The CPU port's mono+lines run with the JAX defaults (local mapping
    with its line stages, relocalization, loop detection) on 20 grid
    frames with 128 line slots (tests/test_torch_mono_lines.py's run):
    the System and the state that entered its last mapping step (a CPU
    copy), with that step's keyframe and arguments."""
    import copy

    if not torch.cuda.is_available():     # before the CPU run
        pytest.skip("needs a CUDA device")
    K, _, frames, _ = _grid_frames(20)
    st = _settings(K, 0.0, using_line=True, line_features=128)
    sysm = TS.System(st, TS.Sensor.MONOCULAR, "cpu")
    calls = []
    step = TMO.mapping_step

    def capture(m, kf, *args, **kw):
        calls.append((m.to("cpu"), kf, copy.copy(kw)))
        return step(m, kf, *args, **kw)

    TMO.mapping_step = capture
    try:
        for i, (l, _) in enumerate(frames):
            sysm.track_mono(l, i * 0.1)
        sysm.drain()
    finally:
        TMO.mapping_step = step
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    assert calls and calls[-1][2]["with_lines"]
    assert int(sysm.map.lns.valid.sum()) >= 3
    return sysm, calls[-1]


def _line_int_tables(m):
    t = _int_tables(m)
    t.update({"n_lns": m.n_lns, "lns.valid": m.lns.valid, "lns.n_obs": m.lns.n_obs,
              "lns.first_kf": m.lns.first_kf, "lns.desc": m.lns.desc,
              "kfs.ll_idx": m.kfs.ll_idx})
    return t


def test_line_mapping_step_gpu_matches_cpu(cuda, line_map):
    """The captured line mapping step on the card and on the CPU from
    identical maps: the integer tables after cull, triangulate and fuse
    (points and lines) exact, the window's edge table exact; after the
    dual point/line BA no revert, inlier masks >= 99% equal and keyframe
    poses within 2e-2 (its line-only pass is nearly singular on such a
    map, tests/test_torch_line_mapping.py); then the whole step's
    integer tables."""
    sysm, (m0, kf, kw) = line_map
    out = {}
    for key, dev in (("cpu", "cpu"), ("gpu", cuda)):
        m = m0.to(dev)
        m = m._replace(kfs=type(m.kfs)(*[x[:kw["k_bucket"]] for x in m.kfs]))
        m, _ = TMO.map_upkeep(m, kf, sysm.cam, sysm.scales.to(dev), 1.2, 4,
                              kw["th_obs"], True)
        ints = {k: v.to("cpu", copy=True) for k, v in _line_int_tables(m).items()}
        m, prob, res = TMO.local_ba(m, kf, sysm.cam, 1.2, 4, with_lines=True)
        step_m, stats = TMO.mapping_step(m0.to(dev), kf, sysm.cam, sysm.scales.to(dev),
                                         **kw)
        out[key] = (ints, prob, res, {k: v.to("cpu", copy=True)
                                      for k, v in _line_int_tables(step_m).items()},
                    stats.cpu())
    (ic, pc, rc, sc, stc), (ig, pg, rg, sg, stg) = out["cpu"], out["gpu"]
    for k in ic:
        torch.testing.assert_close(ig[k], ic[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(pg.e_ok.cpu(), pc.e_ok, rtol=0, atol=0)
    torch.testing.assert_close(pg.e_lm.cpu(), pc.e_lm, rtol=0, atol=0)
    assert int(pc.e_ok[pc.e_line].sum()) >= 6
    assert int(rg.n_state_revert) == int(rc.n_state_revert) == 0
    pose_err = float((rg.Tcw.cpu() - rc.Tcw).abs().max())
    agree = float((rg.e_inlier.cpu() == rc.e_inlier)[pc.e_ok].float().mean())
    differ = {k: int((sg[k] != sc[k]).sum()) for k in sc}
    print(f"line mapping step card vs CPU: pose max abs err {pose_err:.3e}, inlier "
          f"agreement {agree:.5f}; whole step, integer entries differing: {differ}")
    assert pose_err <= 2e-2 and agree >= 0.99
    for k in sc:
        torch.testing.assert_close(sg[k], sc[k], rtol=0, atol=0, msg=k)


def test_global_ba_with_lines_gpu_matches_cpu(cuda, line_map):
    """`run_global_ba(with_lines=True)` on the final line map, card against
    CPU: poses within 1e-3, 99% of the landmarks within 1e-3, inlier masks
    >= 99% equal, the adopted lines' endpoints within 1e-2 off the CPU's
    line (the products and reductions around the fixed-order segment sums
    round otherwise on the card)."""
    from splslam_tpu_torch.slam import loop_closing as TLC

    sysm = line_map[0]
    out = []
    for dev in ("cpu", cuda):
        stub = _stub(sysm, dev)
        lc = TLC.LoopCloser(stub)
        res = lc.run_global_ba(rounds=1, with_lines=True)
        out.append((stub, lc, res))
    (sc, lcc, rc), (sg, lcg, rg) = out
    assert int(rc.n_state_revert) == int(rg.n_state_revert) == 0
    pose_err = float((rg.Tcw.cpu() - rc.Tcw).abs().max())
    ok = sc.map.pts.valid
    P = ok.shape[0]
    d = (rg.xyz[:P].cpu() - rc.xyz[:P]).norm(dim=-1)[ok]
    agree = float((rg.e_inlier.cpu() == rc.e_inlier)[rc.e_inlier | rg.e_inlier.cpu()]
                  .float().mean())
    lv = sc.map.lns.valid
    jx, tx = sc.map.lns.xyz[lv], sg.map.lns.xyz.cpu()[lv]
    dv = jx[:, 2] - jx[:, 0]
    dv = dv / dv.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    off = tx - jx
    off = off - (off * dv[:, None]).sum(-1, keepdim=True) * dv[:, None]
    print(f"global BA with lines card vs CPU: pose max abs err {pose_err:.3e}, "
          f"landmark err q99 {float(torch.quantile(d, 0.99)):.3e}, inlier agreement "
          f"{agree:.5f}, line endpoints off-line max {float(off.abs().max()):.3e}")
    assert pose_err <= 1e-3 and float(torch.quantile(d, 0.99)) <= 1e-3
    assert agree >= 0.99 and float(off.abs().max()) <= 1e-2
    assert torch.isfinite(sg.map.lns.xyz).all()


def test_line_mapping_step_and_reloc_do_not_sync(cuda, line_map):
    """A mapping step with its line stages and a relocalization attempt
    with its line branch (line match, EPnL seed, line rows in the pose
    solves) read nothing back to the host."""
    sysm, (m0, kf, kw) = line_map
    frame = sysm.step.frame
    frame = type(frame)(feat=type(frame.feat)(*[x.to(cuda) for x in frame.feat]),
                        u_right=frame.u_right.to(cuda), depth=frame.depth.to(cuda),
                        lines=type(frame.lines)(*[x.to(cuda) for x in frame.lines]))
    m = m0.to(cuda)
    st = sysm.map.to(cuda)
    c = sysm.ref_kf
    kfs = st.kfs
    lm, ll = kfs.lm_idx[c], kfs.ll_idx[c]
    scales = sysm.scales.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m, stats = TMO.mapping_step(m, kf, sysm.cam, scales, **kw)
        out = TR.reloc_attempt(sysm.cam, frame, kfs.desc[c], kfs.fvalid[c], lm,
                               st.pts.xyz[lm.clamp(min=0).long()], kfs.ldesc[c], ll,
                               st.lns.xyz[ll.clamp(min=0).long()], generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(stats).all()) and int(stats[TMO.MSTAT_REVERT]) == 0
    assert int(out[1]) >= 50


# ---------------------------------------------------------------------
# RGB-D and localization mode: one frame step on the card and on the
# CPU from identical copies of a CPU-built state
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def rgbd_state():
    """A CPU RGB-D System after 11 frames of tests/test_torch_rgbd.py's
    forward sequence (relocalization and loop detection off), and the
    next frame."""
    from splslam_tpu_torch.io.synthetic import make_rgbd_sequence

    if not torch.cuda.is_available():     # before the CPU run
        pytest.skip("needs a CUDA device")
    K, bf, frames, _ = make_rgbd_sequence(n_frames=12, motion="forward", width=320,
                                          height=240)
    st = _settings(K, bf, enable_local_mapping=False, enable_relocalization=False,
                   enable_loop_closing=False)
    sysm = TS.System(st, TS.Sensor.RGBD, "cpu")
    for i, (img, depth) in enumerate(frames[:-1]):
        sysm.track_rgbd(img, depth, i * 0.1)
    sysm.drain()
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    img, depth = frames[-1]
    return sysm, (np.asarray(img).astype(np.uint8), np.asarray(depth, np.float32))


def _step_to(step, device):
    from splslam_tpu_torch import convert

    return convert.step_state_from_numpy(convert.step_state_to_numpy(step), device)


def _rgbd_step(sysm, img, depth, step, map_state, loc_mode=False):
    from splslam_tpu_torch.slam import pipeline as PL

    st = sysm.settings
    return PL.vo_frame_step_rgbd(
        img, depth, map_state, step, sysm.th_depth_m, sysm.ref_kf, sysm.cam, sysm.spec,
        sysm.scales.to(img.device), m_local=st.local_window,
        scale_factor=st.scale_factor, n_levels=st.n_levels,
        depth_factor=st.depth_map_factor, line_capacity=sysm.line_cap,
        line_cfg=sysm.line_cfg, loc_mode=loc_mode)


@pytest.mark.parametrize("loc_mode", [False, True])
def test_rgbd_frame_step_gpu_matches_cpu(cuda, rgbd_state, loc_mode):
    """`vo_frame_step_rgbd`, and with localization mode's temporal points,
    from identical copies of one state: counts and landmark ids equal,
    pose within 1e-4; one B = 1 kernel launch on the card."""
    from splslam_tpu_torch.slam import pipeline as PL

    sysm, (img, depth) = rgbd_state
    outs = []
    for dev in ("cpu", cuda):
        before = OK.orb_describe.launches
        _, step, stats = _rgbd_step(sysm, torch.from_numpy(img).to(dev),
                                    torch.from_numpy(depth).to(dev),
                                    _step_to(sysm.step, dev), sysm.map.to(dev), loc_mode)
        outs.append((step, stats.cpu(), OK.orb_describe.launches - before))
    (sc, tc, lc), (sg, tg, lg) = outs
    print(f"rgbd step (loc_mode={loc_mode}) card vs CPU: pose max abs err "
          f"{float((tg[:16] - tc[:16]).abs().max()):.3e}, counts {tg[16:].tolist()}")
    assert (lc, lg) == (0, 1)
    torch.testing.assert_close(tg[16:], tc[16:], rtol=0, atol=0)
    torch.testing.assert_close(tg[:16], tc[:16], rtol=0, atol=1e-4)
    torch.testing.assert_close(sg.lm_gid.cpu(), sc.lm_gid, rtol=0, atol=0)
    assert int(tc[PL.S_N_IN]) > 100 and int(sc.lm_gid.min()) >= -1


@pytest.mark.parametrize("loc_mode", [False, True])
def test_rgbd_frame_step_does_not_sync(cuda, rgbd_state, loc_mode):
    """One RGB-D frame (ORB at B = 1, the depth lookup, tracking, with or
    without the temporal points, the counter updates) reads nothing back
    to the host."""
    from splslam_tpu_torch.slam import pipeline as PL

    sysm, (img, depth) = rgbd_state
    img, depth = torch.from_numpy(img).to(cuda), torch.from_numpy(depth).to(cuda)
    step, m = _step_to(sysm.step, cuda), sysm.map.to(cuda)
    sysm.scales = sysm.scales.to(cuda)
    try:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, stats = _rgbd_step(sysm, img, depth, step, m, loc_mode)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        sysm.scales = sysm.scales.cpu()
    assert bool(torch.isfinite(stats).all()) and int(stats[PL.S_N_IN]) > 100


def test_build_frame_rgbd_runs_the_kernel_once(cuda, rgbd_state):
    """One B = 1 launch an RGB-D frame; keypoints and depth as the CPU
    build's."""
    from splslam_tpu_torch.slam.frame import build_frame_rgbd

    sysm, (img, depth) = rgbd_state
    args = (sysm.cam, sysm.spec, sysm.settings.depth_map_factor, sysm.line_cap)
    fc = build_frame_rgbd(torch.from_numpy(img).float(), torch.from_numpy(depth), *args)
    before = OK.orb_describe.launches
    fg = build_frame_rgbd(torch.from_numpy(img).to(cuda).float(),
                          torch.from_numpy(depth).to(cuda), *args)
    assert OK.orb_describe.launches - before == 1
    for name in ("xy", "octave", "valid"):
        torch.testing.assert_close(getattr(fg.feat, name).cpu(), getattr(fc.feat, name),
                                   rtol=0, atol=0, msg=name)
    torch.testing.assert_close(fg.depth.cpu(), fc.depth, rtol=1e-6, atol=0)
    assert bit_agreement(fg.feat.desc, fc.feat.desc) >= BIT_AGREE


def test_device_trace_records_the_card(cuda, tmp_path):
    """`device_trace` on the card: its TensorBoard trace holds the kernel
    that ran inside the block."""
    spec, levels, xy = edge_case_inputs(4, 1, seed=0)
    levels = [[torch.from_numpy(x).to(cuda) for x in pyr] for pyr in levels]
    xy = torch.from_numpy(xy).to(cuda)
    with TS.device_trace(str(tmp_path)):
        OK.orb_describe(levels, xy, spec)
        torch.cuda.synchronize()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" and "orb_describe" in e.get("name", "")
               for e in events)


# ---------------------------------------------------------------------
# batched tracking and the synthetic map, card against CPU
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def batch_state():
    """A CPU stereo System after 9 forward frames with local mapping and a
    keyframe every 4 frames (relocalization and loop closing off), and the
    next 4 frames as a uint8 [4,2,H,W] batch."""
    if not torch.cuda.is_available():     # before the CPU run
        pytest.skip("needs a CUDA device")
    K, bf, frames, _ = make_stereo_sequence(n_frames=13, motion="forward",
                                            width=320, height=240)
    st = _settings(K, bf, force_kf_every=4, enable_relocalization=False,
                   enable_loop_closing=False)
    sysm = TS.System(st, TS.Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames[:9]):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    assert sysm.get_tracking_state() == TS.TrackingState.OK and sysm.n_kfs >= 2
    imgs = np.stack([np.stack(f) for f in frames[9:13]]).astype(np.uint8)
    return sysm, imgs


def _batch_step(sysm, imgs, step, m, scales):
    from splslam_tpu_torch.slam import pipeline as PL

    st = sysm.settings
    return PL.vo_batch_step(
        imgs, m, step, sysm.th_depth_m, sysm.ref_kf, sysm.cam, sysm.spec,
        scales, m_local=st.local_window,
        scale_factor=st.scale_factor, n_levels=st.n_levels,
        line_capacity=sysm.line_cap, line_cfg=sysm.line_cfg)


def test_vo_batch_step_gpu_matches_cpu(cuda, batch_state):
    """`vo_batch_step` from identical copies of one state: every row's
    counts, the landmark ids and the point counters equal, poses within
    1e-3; one kernel launch a frame on the card."""
    from splslam_tpu_torch.slam import pipeline as PL

    sysm, imgs = batch_state
    outs = []
    for dev in ("cpu", cuda):
        before = OK.orb_describe.launches
        m, step, stats = _batch_step(sysm, torch.from_numpy(imgs).to(dev),
                                     _step_to(sysm.step, dev), sysm.map.to(dev),
                                     sysm.scales.to(dev))
        outs.append((m, step, stats.cpu(), OK.orb_describe.launches - before))
    (mc, sc, tc, lc), (mg, sg, tg, lg) = outs
    print(f"vo_batch_step card vs CPU: pose max abs err "
          f"{float((tg[:, :16] - tc[:, :16]).abs().max()):.3e}, n_in "
          f"{tg[:, PL.S_N_IN].tolist()}")
    assert (lc, lg) == (0, len(imgs))
    assert tg.shape == (len(imgs), PL.STATS_LEN)
    torch.testing.assert_close(tg[:, 16:], tc[:, 16:], rtol=0, atol=0)
    torch.testing.assert_close(tg[:, :16], tc[:, :16], rtol=0, atol=1e-3)
    torch.testing.assert_close(sg.lm_gid.cpu(), sc.lm_gid, rtol=0, atol=0)
    for name in ("n_visible", "n_found"):
        torch.testing.assert_close(getattr(mg.pts, name).cpu(), getattr(mc.pts, name),
                                   rtol=0, atol=0, msg=name)
    assert int(tc[:, PL.S_N_IN].min()) > 100


def test_vo_batch_step_does_not_sync(cuda, batch_state):
    """A batch of 4 stereo frames (4 ORB launches, the frozen windows,
    tracking, the counters) reads nothing back to the host."""
    from splslam_tpu_torch.slam import pipeline as PL

    sysm, imgs = batch_state
    imgs = torch.from_numpy(imgs).to(cuda)
    step, m, scales = _step_to(sysm.step, cuda), sysm.map.to(cuda), sysm.scales.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, stats = _batch_step(sysm, imgs, step, m, scales)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(stats).all())
    assert int(stats[:, PL.S_N_IN].min()) > 100


def test_track_stereo_batch_gpu_matches_cpu(cuda):
    """`track_stereo_batch` with the stats deferred two batches, staged by
    `upload_batch` (pinned memory on the card): the CPU run's keyframes and
    mapping steps, poses within 1e-3, one launch a frame built."""
    K, bf, frames, gt = make_stereo_sequence(n_frames=16, motion="forward",
                                             width=320, height=240)
    st = _settings(K, bf, force_kf_every=4, batch_defer_stats=True,
                   batch_defer_depth=2)
    runs = []
    for dev in ("cpu", cuda):
        sysm = TS.System(st, TS.Sensor.STEREO, dev)
        before = OK.orb_describe.launches
        for i in range(0, len(frames), 4):
            staged = sysm.upload_batch(frames[i:i + 4])
            assert staged.device.type == torch.device(dev).type
            sysm.track_stereo_batch(staged, [j * 0.1 for j in range(i, i + 4)])
        assert sysm.get_tracking_state() == TS.TrackingState.OK
        runs.append((sysm, OK.orb_describe.launches - before))
    (sc, lc), (sg, lg) = runs
    assert lc == 0 and lg == len(frames)
    assert sg.n_kfs == sc.n_kfs >= 3 and sg.mapper.n_steps == sc.mapper.n_steps
    torch.testing.assert_close(sg.map.kfs.frame_id.cpu(), sc.map.kfs.frame_id)
    np.testing.assert_allclose(sg.poses()[:, :3, :4], sc.poses()[:, :3, :4], atol=1e-3)
    assert ate_rmse(sg.poses(), gt) < 0.05


def test_vo_batch_step_mono_gpu_matches_cpu(cuda):
    """`vo_batch_step_mono` with lines from identical copies of a CPU-built
    state after the two-view init: counts and landmark ids equal, poses
    within 1e-3, one B = 1 launch a frame."""
    from splslam_tpu_torch.slam import pipeline as PL

    K, _, frames, _ = _grid_frames(14)
    st = _settings(K, 0.0, using_line=True, line_features=64,
                   enable_local_mapping=False, enable_relocalization=False,
                   enable_loop_closing=False)
    sysm = TS.System(st, TS.Sensor.MONOCULAR, "cpu")
    for i, (l, _) in enumerate(frames[:10]):
        sysm.track_mono(l, i * 0.1)
    sysm.drain()
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    imgs = np.stack([l for l, _ in frames[10:14]]).astype(np.uint8)
    outs = []
    for dev in ("cpu", cuda):
        before = OK.orb_describe.launches
        _, step, stats = PL.vo_batch_step_mono(
            torch.from_numpy(imgs).to(dev), sysm.map.to(dev), _step_to(sysm.step, dev),
            sysm.th_depth_m, sysm.ref_kf, sysm.cam, sysm.spec, sysm.scales.to(dev),
            m_local=st.local_window, scale_factor=st.scale_factor,
            n_levels=st.n_levels, line_capacity=sysm.line_cap, line_cfg=sysm.line_cfg)
        outs.append((step, stats.cpu(), OK.orb_describe.launches - before))
    (sc, tc, lc), (sg, tg, lg) = outs
    assert (lc, lg) == (0, len(imgs))
    torch.testing.assert_close(tg[:, 16:], tc[:, 16:], rtol=0, atol=0)
    torch.testing.assert_close(tg[:, :16], tc[:, :16], rtol=0, atol=1e-3)
    torch.testing.assert_close(sg.lm_gid.cpu(), sc.lm_gid, rtol=0, atol=0)
    torch.testing.assert_close(sg.ll_gid.cpu(), sc.ll_gid, rtol=0, atol=0)
    assert int(tc[:, PL.S_N_IN].min()) > 50


def test_synthetic_map_mapping_step_gpu_matches_cpu(cuda):
    """`make_synthetic_map` built on the card equals the CPU build; one
    mapping step on each (cull, triangulate, fuse, local BA, keyframe
    culling): the integer tables equal, keyframe poses within 1e-3, 99% of
    the landmarks within 1e-3."""
    from splslam_tpu_torch.geometry.camera import Camera
    from splslam_tpu_torch.io.synth_map import make_synthetic_map

    kw = dict(n_kfs=6, n_feat=500, p_cap=16384, k_cap=32, width=640, height=480,
              fx=500.0)
    cam = Camera.create(500.0, 500.0, 320.0, 240.0, bf=500.0 * 0.54, width=640,
                        height=480)
    scales = torch.tensor([1.2 ** i for i in range(8)], dtype=torch.float32)
    out = {}
    for dev in ("cpu", cuda):
        m, _, _, _ = make_synthetic_map(**kw, device=dev)
        assert m.pts.xyz.device.type == torch.device(dev).type
        built = {k: v.to("cpu", copy=True) for k, v in _int_tables(m).items()}
        m, stats = TMO.mapping_step(m, kw["n_kfs"] - 1, cam, scales.to(dev), k_bucket=32)
        out[dev] = (built, {k: v.to("cpu", copy=True) for k, v in _int_tables(m).items()},
                    m.kfs.Tcw.cpu(), m.pts.xyz.cpu(), stats.cpu())
    (bc, ic, Tc, xc, sc), (bg, ig, Tg, xg, sg) = out["cpu"], out[cuda]
    for k in bc:
        torch.testing.assert_close(bg[k], bc[k], rtol=0, atol=0, msg=k)
    for k in ic:
        torch.testing.assert_close(ig[k], ic[k], rtol=0, atol=0, msg=k)
    np.testing.assert_allclose(Tg.numpy(), Tc.numpy(), atol=1e-3)
    valid = ic["pts.valid"]
    d = (xg - xc).norm(dim=-1)[valid]
    assert float(torch.quantile(d, 0.99)) <= 1e-3
    assert int(sc[0]) > int(bc["n_pts"]) and int(sg[TMO.MSTAT_REVERT]) == 0


# ---------------------------------------------------------------------
# the last module slice: sharded global BA, the prefetcher
# ---------------------------------------------------------------------
GBA_KW = dict(rounds=2, gn_iters=2, cg_iters=8)     # dryrun_multichip's


def _gba_gaps(a, b, n_pts):
    """(pose, point landmark, line endpoint off b's line) largest gaps."""
    X, Xr = a["xyz"], b["xyz"]
    e, er = X[n_pts:].reshape(-1, 2, 3), Xr[n_pts:].reshape(-1, 2, 3)
    d = er[:, 1] - er[:, 0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    off = e - er
    off = off - np.sum(off * d[:, None], -1)[..., None] * d[:, None]
    return (np.abs(a["Tcw"] - b["Tcw"]).max(), np.abs(X[:n_pts] - Xr[:n_pts]).max(),
            np.abs(off).max())


@pytest.fixture(scope="module")
def gba_runs():
    """`make_gba_problem()` solved by `gba_sharded` at world 1 on the card
    (NCCL) and on the CPU (gloo), and by 4 gloo ranks sharing the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from splslam_tpu_torch.convert import ba_problem_to_numpy
    from splslam_tpu_torch.graft_entry import make_gba_problem
    from splslam_tpu_torch.parallel.gba_sharded import solve_on_rank
    from splslam_tpu_torch.parallel.mesh import launch

    cam, p = make_gba_problem(device="cpu")
    pn = ba_problem_to_numpy(p)
    return dict(
        card=launch(solve_on_rank, 1, "cuda", timeout_s=300,
                    args=(cam, pn, GBA_KW, 2))[0],
        cpu=launch(solve_on_rank, 1, "cpu", timeout_s=300, args=(cam, pn, GBA_KW))[0],
        four=launch(solve_on_rank, 4, "cuda", backend="gloo", share_cards=True,
                    timeout_s=300, args=(cam, pn, GBA_KW, 2)),
        n_pts=16384)


def test_gba_sharded_world1_nccl_matches_cpu(cuda, gba_runs):
    """tests/test_torch_parallel.py's tolerance: poses 1e-4, point
    landmarks 5e-4, line endpoints 5e-4 off the CPU's line."""
    card, cpu = gba_runs["card"], gba_runs["cpu"]
    assert card["n_guarded"] == cpu["n_guarded"] == 0
    assert card["Tcw"].shape == (64, 4, 4) and np.isfinite(card["xyz"]).all()
    dT, dX, dE = _gba_gaps(card, cpu, gba_runs["n_pts"])
    assert dT <= 1e-4 and dX <= 5e-4 and dE <= 5e-4, (dT, dX, dE)


def test_gba_sharded_four_gloo_ranks_share_the_card(cuda, gba_runs):
    four, card = gba_runs["four"], gba_runs["card"]
    for o in four:
        assert o["n_guarded"] == 0
        np.testing.assert_array_equal(o["Tcw"], four[0]["Tcw"])
    dT, dX, dE = _gba_gaps(four[0], card, gba_runs["n_pts"])
    assert dT <= 1e-4 and dX <= 5e-4 and dE <= 5e-4, (dT, dX, dE)


def test_gba_sharded_repeats_to_the_bit(cuda, gba_runs):
    """Each run above solved twice: at world 1 over NCCL and on each of
    the 4 gloo ranks, the second solve equal to the first to the bit."""
    assert gba_runs["card"]["equal"] == [True]
    assert [o["equal"] for o in gba_runs["four"]] == [[True]] * 4
    assert gba_runs["card"]["spread"] == [(0.0, 0.0, 0.0)]


def test_prefetch_loader_track_stereo_gpu_matches_in_memory(cuda, tmp_path):
    """A KITTI folder of 8-bit PNGs read by the native prefetcher into
    `track_stereo` on the card: the pixels written, one launch a frame,
    and the poses of the same arrays tracked from memory within 1e-5 m."""
    from chip_smoke import write_kitti_folder
    from splslam_tpu_torch.io.datasets import load_kitti_stereo
    from splslam_tpu_torch.io.native import PrefetchLoader

    K, bf, frames, _ = make_stereo_sequence(n_frames=10, motion="forward",
                                            width=320, height=240)
    pixels = write_kitti_folder(str(tmp_path), frames)
    left, right, ts = load_kitti_stereo(str(tmp_path))
    st = _settings(K, bf, enable_local_mapping=False, enable_relocalization=False,
                   enable_loop_closing=False)
    loaded = TS.System(st, TS.Sensor.STEREO, cuda)
    OK.orb_describe.launches = 0
    with PrefetchLoader(left, 320, 240) as dl_l, PrefetchLoader(right, 320, 240) as dl_r:
        for i, t in enumerate(ts):
            l, r = dl_l[i], dl_r[i]
            np.testing.assert_array_equal(l, pixels[i][0])
            np.testing.assert_array_equal(r, pixels[i][1])
            loaded.track_stereo(l, r, t)
    assert OK.orb_describe.launches == len(frames)
    memory = TS.System(st, TS.Sensor.STEREO, cuda)
    for i, (l, r) in enumerate(pixels):
        memory.track_stereo(l, r, i * 0.1)
    assert loaded.get_tracking_state() == memory.get_tracking_state()
    a, b = loaded.poses(), memory.poses()
    assert np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1).max() <= 1e-5


# ---- the JAX package's proof suites on the card (chip_smoke's cases) ----
# tests/test_e2e_robustness.py, tests/test_bow_retrieval.py,
# tests/test_e2e_parity_matrix.py and tests/test_line_repeatability.py, each
# at its full size with its gates unchanged; the tour cells are held to the
# JAX package's recorded value as well (chip_smoke.TOUR_JAX_PCT).


def _passes(case, *args):
    import chip_smoke

    gates, _ = case(*args)
    assert not chip_smoke.failed_gates(case.__name__, gates), gates


def test_dynamic_object_does_not_break_tracking(cuda):
    import chip_smoke

    _passes(chip_smoke.dynamic_object_case, cuda)


def test_hundreds_of_keyframes_map(cuda):
    import chip_smoke

    _passes(chip_smoke.hundreds_of_keyframes_case, cuda)


def test_top1_retrieval_precision_at_map_scale(cuda):
    import chip_smoke

    _passes(chip_smoke.place_retrieval_case, cuda)


def test_retrieval_on_tracked_300kf_map(cuda):
    import chip_smoke

    _passes(chip_smoke.tracked_map_retrieval_case, cuda)


@pytest.mark.parametrize("seed", [5, 7, 9])
def test_matrix_tour_planes(cuda, seed):
    import chip_smoke

    _passes(chip_smoke.matrix_cell_case, cuda, "tour", seed)


@pytest.mark.parametrize("seed", [5, 7, 9])
def test_matrix_forward_corridor(cuda, seed):
    import chip_smoke

    _passes(chip_smoke.matrix_cell_case, cuda, "corridor", seed)


def test_line_repeatability_floors(cuda):
    import chip_smoke

    _passes(chip_smoke.line_repeatability_case, cuda)


def test_entry_gpu_matches_cpu(cuda):
    import chip_smoke

    _passes(chip_smoke.entry_case, cuda)
