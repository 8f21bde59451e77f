"""Local BA of the PyTorch port (`splslam_tpu_torch/optim/ba.py`) against
the JAX reference on identical problems: the synthetic builders of
tests/test_ba.py (mono, stereo, gross outliers, fixed anchors), the dense
Schur solve and the batched 3x3 inverse.

The problems are padded with invalid edges to one edge count, so the
jitted reference compiles once per solver schedule (padding is a no-op:
an invalid edge adds zeros and is never an inlier).

Tolerances: poses within 1e-4 and landmarks within 5e-4 (float32 sums
in another order over 10-12 LM iterations, and the reference's jit
contracts multiply-adds; landmarks sit 5-7 m from the cameras, and the
mono problems' single frozen camera leaves a flat global-scale
direction along which they move most); inlier masks and the three guard
counters exact. The mono problem with gross outliers is the exception:
its scale gauge is so flat that the reduced camera system turns
indefinite, both solvers propose non-finite camera steps, and whether
one is accepted (counted in n_guarded) and where along the gauge the
solve ends flip with summation order (tests/test_ba.py:128-133 saw the
reference alone slide 0.015 -> 0.15). There the gauge-invariant outputs
are compared: inlier mask exact, total chi2 within 1e-3, no state
revert, and the gauge-aligned camera centres.
`solve_dense` within a relative 1e-4 of the reference (the scaled
system's sums run in another order), and exactly where its pivot floor
decides.

`ba_solve_pcg` (global BA) on tests/test_ba.py's 8-camera problem, mono
and stereo, against the reference with the same tolerances, and against
the port's own dense `ba_solve` (both reach the optimum). The
fixed-order segment sum of the solvers (`ops/segsum.py`) against
`index_add_`.

Line edges: tests/test_ba.py's stereo problem plus 24 map lines, each a
pair of endpoint slots observed by every camera as a pair of 1-dof edges
(three offset by 40 px across the line in one view). The edge terms and
the joint pair gate match at a fixed state within 1e-5; `ba_solve` and
`ba_solve_arbitrated` (point-BA and line-BA, per-camera pose pick, joint
pass) with 64 lines match with the tolerances above, line endpoints
modulo their unobserved slide along the line."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_ba as JBA
from splslam_tpu.optim import ba as JB
from splslam_tpu_torch import convert
from splslam_tpu_torch.geometry.camera import Camera as TCam
from splslam_tpu_torch.ops import segsum as SS
from splslam_tpu_torch.optim import ba as TB

TCAM = TCam.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0,
                   width=640, height=480)
ATOL = 1e-4
XYZ_ATOL = 5e-4
_jit_solve_dense = jax.jit(JB.solve_dense, static_argnums=2)


def _padded(prob, e_pad):
    """Append invalid edges up to `e_pad` rows (numpy leaves)."""
    p = jax.device_get(prob)
    k = e_pad - p.e_cam.shape[0]
    pad = dict(e_cam=0, e_lm=0, e_uv=0.0, e_ur=-1.0, e_inv_sigma2=1.0, e_ok=False)
    return p._replace(**{
        f: np.concatenate([np.asarray(getattr(p, f)),
                           np.full((k,) + np.asarray(getattr(p, f)).shape[1:], v,
                                   np.asarray(getattr(p, f)).dtype)])
        for f, v in pad.items()})


def _problem(kind, stereo=False):
    if kind == "outliers":
        cam, prob, Tg, Xg = JBA._make_problem(noise=0.2, stereo=stereo)
        rng = np.random.default_rng(3)
        E = prob.e_uv.shape[0]
        bad = rng.choice(E, E // 10, replace=False)
        uv = np.array(prob.e_uv)
        uv[bad] += rng.uniform(30, 80, (len(bad), 2)) * rng.choice([-1, 1], (len(bad), 2))
        prob = prob._replace(e_uv=jnp.asarray(uv))
    else:
        cam, prob, Tg, Xg = JBA._make_problem(stereo=stereo)
    C, L = prob.Tcw.shape[0], prob.xyz.shape[0]
    return cam, _padded(prob, C * L), Tg, Xg


def _solve_both(cam, p_np, **kw):
    jr = jax.device_get(JB.ba_solve(cam, jax.tree.map(jnp.asarray, p_np), **kw))
    tr = TB.ba_solve(TCAM, convert.ba_problem_from_numpy(p_np, "cpu"), **kw)
    return jr, convert.ba_result_to_numpy(tr)


def _assert_same(jr, tr):
    np.testing.assert_allclose(tr.Tcw, jr.Tcw, atol=ATOL)
    np.testing.assert_allclose(tr.xyz, jr.xyz, atol=XYZ_ATOL)
    np.testing.assert_array_equal(tr.e_inlier, jr.e_inlier)
    for f in ("n_guarded", "n_state_revert", "n_lm_singular"):
        assert int(getattr(tr, f)) == int(getattr(jr, f)), f
    np.testing.assert_allclose(float(tr.total_chi2), float(jr.total_chi2), rtol=1e-3)


@pytest.mark.parametrize("kind,stereo", [("plain", False), ("plain", True),
                                         ("outliers", True)])
def test_ba_solve_matches_jax(kind, stereo):
    cam, p, Tg, Xg = _problem(kind, stereo)
    jr, tr = _solve_both(cam, p, rounds=2, iters=5, n_free=p.Tcw.shape[0])
    _assert_same(jr, tr)
    assert np.median(np.linalg.norm(tr.xyz - Xg, axis=-1)) < 0.02
    for c in range(1, Tg.shape[0]):
        assert np.linalg.norm(tr.Tcw[c][:3, 3] - Tg[c][:3, 3]) < 0.01
    if kind == "outliers":
        assert not tr.e_inlier[~np.asarray(p.e_ok)].any()
        assert tr.e_inlier.sum() < 0.95 * np.asarray(p.e_ok).sum()


def _centres(Tcw, Tg):
    c = lambda T: -T[:3, :3].T @ T[:3, 3]
    return np.stack([c(Tcw[i]) - c(Tg[0]) for i in range(1, Tg.shape[0])])


def test_ba_mono_outliers_gauge_invariants_match_jax():
    cam, p, Tg, _ = _problem("outliers")
    jr, tr = _solve_both(cam, p, rounds=2, iters=5, n_free=p.Tcw.shape[0])
    np.testing.assert_array_equal(tr.e_inlier, jr.e_inlier)
    np.testing.assert_allclose(float(tr.total_chi2), float(jr.total_chi2), rtol=1e-3)
    assert int(tr.n_state_revert) == int(jr.n_state_revert) == 0
    gt = _centres(Tg, Tg)
    for r in (tr, jr):   # aligned for the free global scale, as tests/test_ba.py
        est = _centres(r.Tcw, Tg)
        s = float(np.sum(gt * est) / np.sum(est * est))
        assert 0.8 < s < 1.2 and np.linalg.norm(s * est - gt, axis=-1).max() < 0.03


def test_ba_fixed_cameras_anchor_matches_jax():
    cam, p, _, _ = _problem("mono")
    n_free = 4
    jr, tr = _solve_both(cam, p, rounds=2, iters=5, n_free=n_free)
    _assert_same(jr, tr)
    np.testing.assert_array_equal(tr.Tcw[n_free:], p.Tcw[n_free:])
    np.testing.assert_array_equal(tr.Tcw[0], p.Tcw[0])


def test_ba_edge_terms_match_jax():
    """Residuals, Jacobians and chi2 of mono and stereo edges at one state."""
    cam, p, _, _ = _problem("stereo")
    jt = JB._edge_terms(jnp.asarray(p.Tcw), jnp.asarray(p.xyz), cam,
                        jax.tree.map(jnp.asarray, p))
    tp = convert.ba_problem_from_numpy(p, "cpu")
    tt = TB._edge_terms(tp.Tcw, tp.xyz, TCAM, tp)
    for a, b, name in zip(tt, jt, ("r", "J_c", "J_p", "chi2", "z_ok")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3,
                                   err_msg=name)


def _spd(seed, n=48):
    r = np.random.default_rng(seed)
    B = r.normal(size=(n, n)).astype(np.float32)
    scale = np.exp(r.uniform(-3, 3, n)).astype(np.float32)
    A = (B @ B.T + n * np.eye(n)) * scale[:, None] * scale[None, :]
    return A.astype(np.float32), r.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_dense_matches_jax(seed):
    A, b = _spd(seed)
    ref = np.asarray(_jit_solve_dense(jnp.asarray(A), jnp.asarray(b), 48))
    got = TB.solve_dense(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(A.astype(np.float64) @ got, b, rtol=1e-2,
                               atol=1e-3 * np.abs(b).max())


def test_solve_dense_pivot_floor_matches_jax():
    """An indefinite 2x2 block ([[1,2],[2,1]] after scaling: pivot -3 is
    exact) and an empty row: the relative floor decides both pivots; the
    solve stays finite and equals the reference's."""
    A, b = _spd(2)
    A[40:, :] = 0.0
    A[:, 40:] = 0.0
    A[44:46, 44:46] = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32) * 4.0
    A[46, 46] = 1.0
    b[47] = 0.0
    ref = np.asarray(_jit_solve_dense(jnp.asarray(A), jnp.asarray(b), 48))
    got = TB.solve_dense(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.isfinite(got).all() and np.abs(got[44:46]).min() > 1e4
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref[:40]).max())


def test_inv3_matches_jax():
    r = np.random.default_rng(5)
    M = r.normal(size=(64, 3, 3)).astype(np.float32)
    M[0] = 0.0                       # det below the 1e-20 floor
    M[1] = np.diag([1e-8, 1e-8, 1e-8]).astype(np.float32)
    got = TB._inv3(torch.from_numpy(M)).numpy()
    ref = np.asarray(JB._inv3(jnp.asarray(M)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2:] @ M[2:], np.broadcast_to(np.eye(3), (62, 3, 3)),
                               atol=1e-3)


def test_convert_round_trip_ba():
    cam, p, _, _ = _problem("mono")
    q = convert.ba_problem_to_numpy(convert.ba_problem_from_numpy(p, "cpu"))
    for f in JB.BAProblem._fields:
        a, b = getattr(q, f), getattr(p, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == np.asarray(b).dtype, f


@pytest.fixture
def one_thread():
    """Many small ops: beside other test processes torch's OpenMP threads
    spin at every barrier while the cores are taken; one thread has none."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stereo", [False, True])
def test_ba_solve_pcg_matches_jax(stereo, one_thread):
    """tests/test_ba.py::test_pcg_gba_matches_dense's problem and schedule."""
    cam, prob, Tg, Xg = JBA._make_problem(n_cams=8, n_pts=200, stereo=stereo)
    p = jax.device_get(prob)
    kw = dict(rounds=2, gn_iters=4, cg_iters=30)
    jr = jax.device_get(JB.ba_solve_pcg(cam, prob, **kw))
    tr = convert.ba_result_to_numpy(
        TB.ba_solve_pcg(TCAM, convert.ba_problem_from_numpy(p, "cpu"), **kw))
    # measured: poses 2.3e-6 / 1.4e-6, landmarks 6.3e-5 / 1.3e-5 (mono / stereo)
    _assert_same(jr, tr)
    for c in range(1, Tg.shape[0]):
        assert np.linalg.norm(tr.Tcw[c][:3, 3] - Tg[c][:3, 3]) < 0.01
    assert np.median(np.linalg.norm(tr.xyz - Xg, axis=-1)) < 0.02
    assert tr.e_inlier.mean() > 0.95
    np.testing.assert_array_equal(tr.Tcw[0], p.Tcw[0])      # the frozen camera


def test_ba_solve_pcg_reaches_the_dense_optimum(one_thread):
    """The matrix-free solver and the dense-Schur local solver agree where
    both apply (stereo: no free scale to slide along)."""
    cam, prob, Tg, Xg = JBA._make_problem(n_cams=8, n_pts=200, stereo=True)
    tp = convert.ba_problem_from_numpy(jax.device_get(prob), "cpu")
    pcg = TB.ba_solve_pcg(TCAM, tp, rounds=2, gn_iters=4, cg_iters=30)
    dense = TB.ba_solve(TCAM, tp, rounds=2, iters=6, n_free=8)
    # two schedules with different damping, each within 0.01 of the truth
    # (tests/test_ba.py's gate): measured 3.5e-3 between them
    np.testing.assert_allclose(pcg.Tcw.numpy(), dense.Tcw.numpy(), atol=1e-2)
    d = (pcg.xyz - dense.xyz).norm(dim=-1)
    # measured: median 6.6e-3, max 2.5e-2 (depth is the soft direction)
    assert float(d.median()) < 2e-2 and float(d.max()) < 5e-2, (d.median(), d.max())
    assert float((pcg.e_inlier == dense.e_inlier).float().mean()) > 0.99
    assert int(pcg.n_guarded) == int(pcg.n_state_revert) == 0


def test_ba_solve_pcg_drops_out_of_range_edges(one_thread):
    """An edge whose landmark or camera index lies past the tables adds
    nothing to the sums (the reference's `mode="drop"`)."""
    cam, prob, _, _ = JBA._make_problem(n_cams=4, n_pts=40, stereo=True)
    p = jax.device_get(prob)
    far = p._replace(
        e_cam=np.concatenate([p.e_cam, [99, 1]]).astype(np.int32),
        e_lm=np.concatenate([p.e_lm, [3, 4000]]).astype(np.int32),
        e_uv=np.concatenate([p.e_uv, np.zeros((2, 2), np.float32)]),
        e_ur=np.concatenate([p.e_ur, [-1.0, -1.0]]).astype(np.float32),
        e_inv_sigma2=np.concatenate([p.e_inv_sigma2, [1.0, 1.0]]).astype(np.float32),
        e_ok=np.concatenate([p.e_ok, [False, False]]))
    kw = dict(rounds=1, gn_iters=2, cg_iters=10)
    a = TB.ba_solve_pcg(TCAM, convert.ba_problem_from_numpy(p, "cpu"), **kw)
    b = TB.ba_solve_pcg(TCAM, convert.ba_problem_from_numpy(far, "cpu"), **kw)
    np.testing.assert_array_equal(a.Tcw.numpy(), b.Tcw.numpy())
    np.testing.assert_array_equal(a.xyz.numpy(), b.xyz.numpy())


def test_sum_cells_is_an_ordered_index_add():
    """Cells with one row, many rows and none; rows sent to the spare cell
    are dropped; the result does not depend on how the rows are spread."""
    g = torch.Generator().manual_seed(0)
    E, n = 6000, 257
    cell = torch.randint(0, n + 1, (E,), generator=g)
    cell[:60] = 7                                 # a cell with 60+ rows
    cell[cell == 11] = 12                         # an empty cell
    rows = torch.randn((E, 5), generator=g)
    oc = SS.Segments(cell, n, max_rows=128)
    got = SS.segment_sum(oc, rows)
    ref = torch.zeros((n + 1, 5), dtype=torch.float64).index_add_(
        0, cell, rows.double())[:n]
    # float32 pairwise sums against a float64 sum: measured 1.9e-6
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    assert not got[11].any()
    # a permutation that keeps each cell's rows in order gives equal bits
    perm = torch.argsort(cell % 7, stable=True)
    again = SS.segment_sum(SS.Segments(cell[perm], n, max_rows=128), rows[perm])
    assert torch.equal(again, got)


def _line_problem(n_lines=24, n_bad=3):
    """_problem("plain", stereo=True) + line-endpoint edges (numpy)."""
    from splslam_tpu.optim.pose_gn import line_coefficients

    cam, p, Tg, Xg = _problem("plain", stereo=True)
    rng = np.random.default_rng(5)
    C, L = p.Tcw.shape[0], p.xyz.shape[0]
    A = rng.uniform([-1.5, -1, -0.8], [1.5, 1, 0.8], (n_lines, 3)).astype(np.float32)
    B = (A + rng.normal(0, 0.6, (n_lines, 3))).astype(np.float32)
    ends = np.stack([A, B], 1).reshape(-1, 3)               # slot L + 2q (+1)
    f = float(cam.fx)
    cols = {k: [] for k in ("cam", "lm", "coef", "pair")}
    for c in range(C):
        pc = ends @ Tg[c][:3, :3].T + Tg[c][:3, 3]
        uv = f * pc[:, :2] / pc[:, 2:] + np.array([float(cam.cx), float(cam.cy)])
        uv = uv + rng.normal(0, 0.3, uv.shape)
        seg = uv.reshape(n_lines, 4)
        if c == 2:          # gross outliers: 40 px across the line
            d = seg[:n_bad, 2:] - seg[:n_bad, :2]
            nrm = np.stack([-d[:, 1], d[:, 0]], 1) / np.linalg.norm(d, axis=1, keepdims=True)
            seg[:n_bad] += 40.0 * np.concatenate([nrm, nrm], 1)
        coef = np.asarray(line_coefficients(jnp.asarray(seg.astype(np.float32))))
        for q in range(n_lines):
            e0 = p.e_cam.shape[0] + len(cols["cam"])
            for k in range(2):
                cols["cam"].append(c)
                cols["lm"].append(L + 2 * q + k)
                cols["coef"].append(coef[q])
                cols["pair"].append(e0 + 1 - k)
    El = len(cols["cam"])
    Ep = p.e_cam.shape[0]
    ends0 = ends + rng.normal(0, 0.03, ends.shape).astype(np.float32)
    p = p._replace(
        xyz=np.concatenate([p.xyz, ends0]).astype(np.float32),
        lm_ok=np.concatenate([p.lm_ok, np.ones(2 * n_lines, bool)]),
        e_cam=np.concatenate([p.e_cam, cols["cam"]]).astype(np.int32),
        e_lm=np.concatenate([p.e_lm, cols["lm"]]).astype(np.int32),
        e_uv=np.concatenate([p.e_uv, np.zeros((El, 2), np.float32)]),
        e_ur=np.concatenate([p.e_ur, np.full(El, -1.0, np.float32)]),
        e_inv_sigma2=np.concatenate([p.e_inv_sigma2, np.full(El, 0.25, np.float32)]),
        e_ok=np.concatenate([p.e_ok, np.ones(El, bool)]),
        e_coef=np.concatenate([np.zeros((Ep, 3), np.float32),
                               np.asarray(cols["coef"], np.float32)]),
        e_line=np.concatenate([np.zeros(Ep, bool), np.ones(El, bool)]),
        e_pair=np.concatenate([np.full(Ep, -1, np.int32),
                               np.asarray(cols["pair"], np.int32)]),
    )
    return cam, p, Tg, n_bad


def test_ba_line_edge_terms_match_jax():
    """Residuals, Jacobians, chi2 and the joint pair classification of a
    problem with line edges, at one state: exact but for float noise."""
    cam, p, _, _ = _line_problem()
    pj = jax.tree.map(jnp.asarray, p)
    pt = convert.ba_problem_from_numpy(p, "cpu")
    a = JB._edge_terms(pj.Tcw, pj.xyz, cam, pj)
    b = TB._edge_terms(pt.Tcw, pt.xyz, TCAM, pt)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy().astype(np.float64),
                                   np.asarray(x).astype(np.float64),
                                   rtol=1e-5, atol=1e-5)
    jg, jh, jj = JB._gates(pj)
    tg, th, tj = TB._gates(pt)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    valid = pt.e_ok & b[4]
    np.testing.assert_allclose(tj(b[3], valid).numpy(),
                               np.asarray(jj(a[3], jnp.asarray(valid.numpy()))),
                               rtol=1e-5)


@pytest.mark.parametrize("solver", ["ba_solve", "ba_solve_arbitrated"])
def test_ba_line_edges_match_jax(solver):
    """With the tolerances above. A 1-dof line edge leaves each endpoint
    free to slide along its line (an exact null direction of its landmark
    block), so endpoints are compared off the reference's line (within
    XYZ_ATOL) and not along it: that slide is unobserved (float noise
    moved one endpoint 0.34 along its line). The problem has 64 lines: the
    arbitration's line-only pass constrains the cameras by lines alone,
    and with 24 lines that pass is so flat that the two packages end it
    up to 3e-2 apart (their joint passes then disagree by 5e-3)."""
    n_lines = 64
    cam, p, Tg, n_bad = _line_problem(n_lines=n_lines)
    C = p.Tcw.shape[0]
    kw = dict(rounds=2, iters=5, n_free=C)
    jr = jax.device_get(getattr(JB, solver)(cam, jax.tree.map(jnp.asarray, p), **kw))
    tr = convert.ba_result_to_numpy(
        getattr(TB, solver)(TCAM, convert.ba_problem_from_numpy(p, "cpu"), **kw))
    L = p.xyz.shape[0] - 2 * n_lines
    _assert_same(jr._replace(xyz=jr.xyz[:L]), tr._replace(xyz=tr.xyz[:L]))
    je, te = jr.xyz[L:].reshape(-1, 2, 3), tr.xyz[L:].reshape(-1, 2, 3)
    d = je[:, 1] - je[:, 0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    off = te - je
    along = np.sum(off * d[:, None], -1)
    np.testing.assert_allclose(off - along[..., None] * d[:, None], 0, atol=XYZ_ATOL)
    assert int(tr.n_state_revert) == 0
    # the joint pair gate rejects the lines offset in view 2, there only
    line = np.asarray(p.e_line)
    q = (np.asarray(p.e_lm)[line] - L) // 2
    bad = (q < n_bad) & (np.asarray(p.e_cam)[line] == 2)
    assert not tr.e_inlier[line][bad].any()
    assert tr.e_inlier[line][~bad].mean() > 0.9
    for c in range(1, C):
        assert np.linalg.norm(tr.Tcw[c][:3, 3] - Tg[c][:3, 3]) < 0.01


def test_ba_pcg_line_edges_match_jax(one_thread):
    """`ba_solve_pcg` on the 64-line problem above: point and line edges in
    one unsorted table, line rows robustified at 3.841 and re-classified
    by their pair's joint chi2. Poses, points and the inlier mask with
    `_assert_same`'s tolerances; endpoints off the reference's line
    within XYZ_ATOL (along it they are unobserved)."""
    n_lines = 64
    cam, p, Tg, n_bad = _line_problem(n_lines=n_lines)
    kw = dict(rounds=2, gn_iters=4, cg_iters=30)
    jr = jax.device_get(JB.ba_solve_pcg(cam, jax.tree.map(jnp.asarray, p), **kw))
    tr = convert.ba_result_to_numpy(
        TB.ba_solve_pcg(TCAM, convert.ba_problem_from_numpy(p, "cpu"), **kw))
    L = p.xyz.shape[0] - 2 * n_lines
    _assert_same(jr._replace(xyz=jr.xyz[:L]), tr._replace(xyz=tr.xyz[:L]))
    je, te = jr.xyz[L:].reshape(-1, 2, 3), tr.xyz[L:].reshape(-1, 2, 3)
    d = je[:, 1] - je[:, 0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    off = te - je
    along = np.sum(off * d[:, None], -1)
    np.testing.assert_allclose(off - along[..., None] * d[:, None], 0, atol=XYZ_ATOL)
    assert int(tr.n_state_revert) == 0
    # the joint pair gate rejects the lines offset in view 2, there only
    line = np.asarray(p.e_line)
    q = (np.asarray(p.e_lm)[line] - L) // 2
    bad = (q < n_bad) & (np.asarray(p.e_cam)[line] == 2)
    assert not tr.e_inlier[line][bad].any()
    assert tr.e_inlier[line][~bad].mean() > 0.9
    for c in range(1, p.Tcw.shape[0]):
        assert np.linalg.norm(tr.Tcw[c][:3, 3] - Tg[c][:3, 3]) < 0.01
