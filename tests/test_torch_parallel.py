"""The port's multi-device modules (`splslam_tpu_torch/parallel`,
`splslam_tpu_torch/graft_entry.py`) against the JAX package's, on the
CPU: the port's ranks are spawned processes joined by gloo through a
`file://` store (`parallel.mesh.launch`, one torch thread a rank), the
JAX side runs on 4 of tests/conftest.py's virtual host devices.

- `gba_sharded` over 4 ranks against the JAX `gba_sharded` on
  `Mesh(jax.devices()[:4])`, on tests/test_ba.py's 6-camera point problem
  and its 5-camera line-pair problem with two outlier rounds
  (tests/test_ba.py:214-262), the same numpy inputs on both sides; and
  the port at world 1 against world 4. Tolerances: `ba_solve_pcg`'s
  (tests/test_torch_ba.py): poses within 1e-4, point landmarks within
  5e-4, line endpoints within 5e-4 off the other run's line (a 1-dof line
  edge leaves an endpoint free to slide along its line; the sums run in
  another order per shard); `n_guarded` equal.
- `make_gba_problem` against `__graft_entry__.make_gba_problem` at a
  small size: integer arrays equal, floats within 1e-6.
- `shard_batch` rows; `batched_track_step` equal row by row to single
  `track_step` calls and, on tests/test_torch_tracking.py's captured
  tracking state, to the JAX `batched_track_step` (ids and counts exact,
  poses within 1e-4; the port's packed descriptors against the
  reference's +-1 bit planes).
- `dryrun_multichip(4, device="cpu")`; `launch` fails within its limit
  when one rank raises while the others wait in a collective.

Every multi-rank call has a time limit of LIMIT_S."""

import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import test_ba as JBA
from test_torch_tracking import _jax_window, ref  # noqa: F401 (module fixture)
from splslam_tpu.parallel import gba_sharded as JGS
from splslam_tpu.parallel import mesh as JM
from splslam_tpu_torch import convert, graft_entry
from splslam_tpu_torch.geometry.camera import Camera as TCam
from splslam_tpu_torch.graft_entry import dryrun_multichip, make_gba_problem
from splslam_tpu_torch.parallel import mesh as TM
from splslam_tpu_torch.parallel.gba_sharded import solve_on_rank
from splslam_tpu_torch.slam import tracking as TT

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import __graft_entry__ as JG  # noqa: E402

TCAM = TCam.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0,
                   width=640, height=480)
ATOL = 1e-4
XYZ_ATOL = 5e-4
LIMIT_S = 180.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(kind):
    """(JAX camera, JAX BAProblem, solver kwargs, point landmark count)."""
    if kind == "points":
        cam, prob, _, Xg = JBA._make_problem(n_cams=6, n_pts=100)
        return cam, prob, dict(gn_iters=6, cg_iters=24), Xg.shape[0]
    cam, prob, Tg, Xg = JBA._make_problem(n_cams=5, n_pts=80, noise=0.1)
    prob, _ = JBA._add_line_edges_synthetic(cam, prob, Tg)
    prob = prob._replace(
        cam_free=jnp.asarray([False] + [True] * (Tg.shape[0] - 1)))
    return cam, prob, dict(rounds=2, gn_iters=4, cg_iters=24), Xg.shape[0]


@pytest.fixture(scope="module")
def solved():
    """kind -> (numpy problem, point count, JAX (Tcw, xyz, n_guarded) on 4
    devices, the port's 4 rank results, the port's world-1 result)."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cam, prob, kw, n_pts = _problem(kind)
            mesh = JMesh(np.array(jax.devices()[:4]), ("data",))
            jr = jax.device_get(JGS.gba_sharded(cam, prob, mesh, **kw))
            pn = jax.device_get(prob)
            w4 = TM.launch(solve_on_rank, 4, "cpu", timeout_s=LIMIT_S,
                           args=(TCAM, pn, kw))
            w1 = TM.launch(solve_on_rank, 1, "cpu", timeout_s=LIMIT_S,
                           args=(TCAM, pn, kw))[0]
            cache[kind] = (pn, n_pts, jr, w4, w1)
        return cache[kind]

    return get


def _assert_close(T, X, T_ref, X_ref, n_pts):
    np.testing.assert_allclose(T, T_ref, atol=ATOL)
    np.testing.assert_allclose(X[:n_pts], X_ref[:n_pts], atol=XYZ_ATOL)
    if X.shape[0] > n_pts:
        e, er = X[n_pts:].reshape(-1, 2, 3), X_ref[n_pts:].reshape(-1, 2, 3)
        d = er[:, 1] - er[:, 0]
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        off = e - er
        along = np.sum(off * d[:, None], -1)
        np.testing.assert_allclose(off - along[..., None] * d[:, None], 0,
                                   atol=XYZ_ATOL)


@pytest.mark.parametrize("kind", ["points", "lines"])
def test_gba_sharded_matches_jax(solved, kind):
    pn, n_pts, (jT, jX, jng), w4, _ = solved(kind)
    for o in w4[1:]:                 # states are replicated on every rank
        np.testing.assert_array_equal(o["Tcw"], w4[0]["Tcw"])
        np.testing.assert_array_equal(o["xyz"], w4[0]["xyz"])
        assert o["n_guarded"] == w4[0]["n_guarded"]
    assert w4[0]["n_guarded"] == int(jng) == 0
    _assert_close(w4[0]["Tcw"], w4[0]["xyz"], jT, jX, n_pts)
    # the solve moved the states well past the tolerance
    assert np.abs(jT - pn.Tcw).max() > 100 * ATOL
    assert np.abs(jX - pn.xyz).max() > 100 * XYZ_ATOL


@pytest.mark.parametrize("kind", ["points", "lines"])
def test_gba_sharded_world1_matches_world4(solved, kind):
    _, n_pts, _, w4, w1 = solved(kind)
    assert w1["n_guarded"] == w4[0]["n_guarded"] == 0
    assert w1["edges"] == w4[0]["edges"]
    _assert_close(w4[0]["Tcw"], w4[0]["xyz"], w1["Tcw"], w1["xyz"], n_pts)


def test_make_gba_problem_matches_jax():
    kw = dict(n_kfs=8, n_pts=512, obs_per_kf=128, n_lines=16, line_obs=4,
              seed=3)
    jcam, jp = jax.device_get(JG.make_gba_problem(**kw))
    tcam, tp = make_gba_problem(**kw, device="cpu")
    assert tuple(tcam) == tuple(TCam.create(
        fx=jcam.fx, fy=jcam.fy, cx=jcam.cx, cy=jcam.cy, bf=jcam.bf,
        width=jcam.width, height=jcam.height))
    n = 0
    for f, a in zip(tp._fields, tp):
        b = np.asarray(getattr(jp, f))
        a = a.numpy()
        assert a.shape == b.shape, f
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)
        n += 1
    assert n == 13 and tp.e_line.sum() > 0
    assert tp.e_cam.dtype == torch.int32 and tp.cam_free.dtype == torch.bool


def test_entry_takes_the_reference_inputs():
    """`entry(device="cpu")`: the VO step's arguments are the reference's
    (the same image draws; packed descriptors in place of +-1 bit planes,
    no `last_xy`), and the step runs: random images, an empty window."""
    fn, args = graft_entry.entry("cpu")
    _, jspec, _, jm = JG._setup()
    jargs = JG._example_args(jspec, jm)
    assert len(args) == len(jargs) - 1 and all(a.device.type == "cpu" for a in args)
    np.testing.assert_array_equal(args[0].numpy(), jargs[0])
    np.testing.assert_array_equal(args[1].numpy(), jargs[1])
    assert args[4].shape == (jargs[5].shape[0], 8) and args[4].dtype == torch.int32
    Tcw, n_in = fn(*args)
    assert Tcw.shape == (4, 4) and bool(torch.isfinite(Tcw).all())
    assert int(n_in) == 0


def test_shard_batch_rows():
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    ids = np.arange(8, dtype=np.int32)
    tree = (x, TT.LineWindow(ids, x, ids, x[:, 0], ids > 3), {"k": ids})
    parts = [TM.shard_batch(tree, TM.Mesh(None, r, 4, torch.device("cpu")))
             for r in range(4)]
    for r, (px, pw, pd) in enumerate(parts):
        np.testing.assert_array_equal(px.numpy(), x[2 * r:2 * r + 2])
        assert isinstance(pw, TT.LineWindow)
        np.testing.assert_array_equal(pw.ok.numpy(), ids[2 * r:2 * r + 2] > 3)
        assert pd["k"].dtype == torch.int32
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in parts]).numpy(), x)
    with pytest.raises(ValueError, match="does not divide"):
        TM.shard_batch(x[:6], TM.Mesh(None, 0, 4, torch.device("cpu")))


_TRACK_FIELDS = ("lm_gid", "inlier", "n_mm_matches", "n_inliers", "visible_ids",
                 "found_ids", "ll_gid", "ln_inlier", "n_ln_inliers")


def test_batched_track_step_matches_single_and_jax(ref):  # noqa: F811
    """Two rows on the captured state: the motion-model prediction and the
    last pose itself."""
    s = ref.step
    T_pred = np.stack([np.array(jnp.asarray(s.velocity) @ jnp.asarray(s.Tcw)),
                       np.array(s.Tcw)]).astype(np.float32)
    jwin = jax.device_get(_jax_window(ref))
    rep = lambda x: np.stack([np.asarray(x)] * 2)          # noqa: E731
    jf = jax.jit(JM.batched_track_step(ref.jcam, jnp.asarray(ref.scales), 1.2, 4))
    jr = jax.device_get(jf(
        jax.tree.map(rep, ref.frame), rep(s.frame.feat.xy),
        rep(s.frame.feat.octave), rep(s.frame.feat.angle),
        rep(s.frame.feat.bits), rep(s.lm_xyz), rep(s.lm_gid), T_pred,
        jax.tree.map(rep, jwin)))

    ts = convert.step_state_from_numpy(s, "cpu")
    tf = convert.frame_from_numpy(ref.frame, "cpu")
    twin = convert.local_window_from_numpy(jwin, "cpu")
    scales = torch.from_numpy(ref.scales)
    trep = lambda x: torch.stack([x, x])                    # noqa: E731
    tr = TM.batched_track_step(ref.tcam, scales, 1.2, 4)(
        TM._tree_map(trep, tf), trep(ts.frame.feat.octave),
        trep(ts.frame.feat.angle), trep(ts.frame.feat.desc), trep(ts.lm_xyz),
        trep(ts.lm_gid), torch.from_numpy(T_pred), TM._tree_map(trep, twin))
    assert tr.Tcw.shape == (2, 4, 4)
    for b in range(2):
        one = TT.track_step(
            ref.tcam, scales, tf, ts.frame.feat.octave, ts.frame.feat.angle,
            ts.frame.feat.desc, ts.lm_xyz, ts.lm_gid,
            torch.from_numpy(T_pred[b]), twin, scale_factor=1.2, n_levels=4)
        for f in TT.TrackResult._fields:
            np.testing.assert_array_equal(getattr(tr, f)[b].numpy(),
                                          getattr(one, f).numpy(), err_msg=f)
        for f in _TRACK_FIELDS:
            np.testing.assert_array_equal(getattr(tr, f)[b].numpy(),
                                          np.asarray(getattr(jr, f))[b],
                                          err_msg=f)
        np.testing.assert_allclose(tr.Tcw[b].numpy(), jr.Tcw[b], atol=ATOL)
        assert int(jr.n_inliers[b]) > 100


def test_dryrun_multichip_on_cpu_ranks():
    t0 = time.monotonic()
    out = dryrun_multichip(4, device="cpu", timeout_s=LIMIT_S)
    assert time.monotonic() - t0 < LIMIT_S
    assert out["Tcw"].shape == (4, 4, 4) and np.isfinite(out["Tcw"]).all()
    assert out["gba_keyframes"] == 64 and out["n_guarded"] == 0
    assert out["launches"] == 0          # the kernel launches on cards only


def test_launch_returns_every_rank_in_order():
    assert TM.launch(TM.check_group, 3, "cpu", timeout_s=LIMIT_S) == [3, 3, 3]


def test_launch_raises_within_its_limit_when_a_rank_raises():
    """Rank 2 raises before the collective the others wait in: the call
    fails fast, naming rank 2's error and every other rank's fate (gloo
    fails their collective when rank 2's connection closes; a rank still
    waiting 10 s later is killed)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        TM.launch(TM.check_group, 4, "cpu", timeout_s=LIMIT_S, args=(2,))
    assert time.monotonic() - t0 < 60
    msg = str(e.value)
    assert "rank 2:" in msg and "failed on request" in msg
    assert all(f"rank {r}: " in msg for r in (0, 1, 3))


def test_launch_and_mesh_refuse_what_is_not_there():
    n_cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="launch: "):
        TM.launch(TM.check_group, n_cards + 1, "cuda")
    with pytest.raises(RuntimeError, match="initialized process group"):
        TM.make_mesh(2)
