"""The fixed-order segment sum of the port's solvers (`ops/segsum.py`).

- `segment_sum` on the CPU (its plain version) bit for bit against a numpy
  float32 loop that adds each cell's rows in the specified order (the
  pairwise tree over the rows' ranks in a stable sort by cell): empty
  cells, dropped rows (the sentinel index n_cells, and indices below 0 or
  past it), one cell that holds every row, a `max_rows` bound that is a
  power of two, one and many columns.
- The kernel's association (`csrc/segment_sum.cu`: B-aligned chunks
  summed serially by a stack, then the lanes' tree) emulated in numpy for
  every lane count it takes, against the same loop; and its two passes
  (tiles of 256 ranks, then each cell over its tiles) on the tile arrays
  `Segments` prepares, against the plain version.
- `ba_solve` and `ba_solve_arbitrated` give the bits they gave with the
  cell sums they had before the module (a copy of them below).
- With `Tensor.index_add_` made to fail on a floating source,
  `ba_solve_pcg` (with and without line edges), one `_gn_step_sharded`
  (world 1, gloo, on the CPU) and `pose_graph_sim3` still run: none of
  their sums is a float scatter-add any more.

Float scatter-adds that stay, because their sums are exact in any order
(`test_every_scatter_add_of_the_port_is_listed` finds each by its
function and holds this list to the source):

- `bow/vocabulary.py::_tfidf`: every addend of one word's slot is that
  word's idf weight, and the running sums of n equal addends are the same
  in any order; the sentinel slot takes 0.0s.
- `bow/vocabulary.py::densify_bow_row`: a sparse row's word ids are unique
  below the sentinel W, so each word slot takes one value; the sentinel
  slots take 0.0s.
- `parallel/gba_sharded.py::joint_chi2_sharded`: each line pair's slot
  takes the pair's two chi2 (0 + a + b: a + b commutes exactly, on a rank
  and over the mesh); every other row adds 0.0.
- The integer counters (`slam/map.py`, `slam/mapping_ops.py`,
  `slam/loop_closing.py`, `ops/match.py`): integer sums are exact.
"""

import ast
import contextlib
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_ba as JBA
from splslam_tpu_torch import convert
from splslam_tpu_torch.geometry import se3
from splslam_tpu_torch.geometry.camera import Camera as TCam
from splslam_tpu_torch.ops import segsum as SS
from splslam_tpu_torch.optim import ba as TB
from splslam_tpu_torch.optim import sim3 as TS3
from splslam_tpu_torch.parallel import gba_sharded as TGS
from splslam_tpu_torch.parallel.mesh import Mesh

TCAM = TCam.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0,
                   width=640, height=480)
PORT = Path(__file__).resolve().parents[1] / "splslam_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_np(vals: np.ndarray, depth: int) -> np.ndarray:
    """The specified order on one cell's rows [n, W] (float32, in table
    order): at level d = 1, 2, 4, ... < 2**depth, the partial sum at rank
    r + d is added into the one at rank r for r a multiple of 2d, and a
    rank without a partner adds +0.0, as the plain version does."""
    v = [row.astype(np.float32) for row in vals]
    n, d = len(v), 1
    if n == 0:
        return np.zeros(vals.shape[1], np.float32)
    for _ in range(depth):
        for r in range(0, n, 2 * d):
            v[r] = (v[r] + (v[r + d] if r + d < n else np.float32(0.0))
                    ).astype(np.float32)
        d *= 2
    return v[0]


def _reference_np(cell: np.ndarray, rows: np.ndarray, n_cells: int,
                  max_rows: int | None) -> np.ndarray:
    counts = np.bincount(cell[(cell >= 0) & (cell < n_cells)], minlength=n_cells)
    longest = max(int(counts.max(initial=0)), max_rows or 0)
    depth = math.ceil(math.log2(longest)) if longest > 1 else 0
    return np.stack([_tree_np(rows[cell == c], depth) for c in range(n_cells)])


def _case(name):
    """(cell [E] int64, rows [E, W] f32, n_cells, max_rows) from a seed."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "empty_cells_and_sentinels":
        n, E, W = 40, 700, 6
        cell = rng.integers(-3, n + 4, E)          # below 0 and past n: dropped
        cell[cell == 5] = 6                        # cell 5 empty
        cell[:50] = n                              # the sentinel index n
    elif name == "one_cell_holds_every_row":
        n, E, W = 9, 1000, 3
        cell = np.full(E, 4)
    elif name == "max_rows_power_of_two":
        n, E, W = 5, 64 * 5, 9
        cell = np.repeat(np.arange(n), 64)[rng.permutation(E)]
        return cell, rng.normal(size=(E, W)).astype(np.float32), n, 64
    elif name == "one_column":
        n, E, W = 300, 2000, 1
        cell = rng.integers(0, n, E)
    elif name == "wide_rows":
        n, E, W = 16, 400, 54
        cell = rng.integers(0, n, E)
    else:                                          # no rows at all
        n, E, W = 7, 0, 4
        cell = np.zeros(0, np.int64)
    # magnitudes over many decades, so the order of the sums shows
    rows = (rng.normal(size=(E, W)) * 10.0 ** rng.integers(-3, 4, (E, 1)))
    return cell.astype(np.int64), rows.astype(np.float32), n, None


CASES = ["empty_cells_and_sentinels", "one_cell_holds_every_row",
         "max_rows_power_of_two", "one_column", "wide_rows", "no_rows"]


@pytest.mark.parametrize("name", CASES)
def test_segment_sum_is_the_specified_order(name):
    cell, rows, n, max_rows = _case(name)
    seg = SS.Segments(torch.from_numpy(cell), n, max_rows=max_rows)
    got = SS.segment_sum(seg, torch.from_numpy(rows)).numpy()
    ref = _reference_np(cell, rows, n, max_rows)
    assert got.shape == (n, rows.shape[1]) and got.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    # against a float64 sum of the kept rows: only rounding apart
    ref64 = np.zeros((n + 1, rows.shape[1]))
    np.add.at(ref64, np.where((cell >= 0) & (cell < n), cell, n), rows)
    scale = np.abs(rows).max(initial=1.0)
    np.testing.assert_allclose(got, ref64[:n], atol=1e-5 * scale)


def _kernel_pass_np(vals: np.ndarray, group: int) -> np.ndarray:
    """One pass of csrc/segment_sum.cu on one cell's rows [n, W]: lane j
    of `group` sums the ranks [jB, (j+1)B) with a stack (element k merges
    with the top once for each trailing 1 bit of k; the stack folds from
    its top), then lane j takes lane j + d's sum at level d where lane j
    is a multiple of 2d and lane j + d's chunk holds a rank."""
    n = len(vals)
    B = 1
    while B * group < n:
        B *= 2
    part = []
    for j in range(group):
        stack = []
        for k in range(max(0, min(B, n - j * B))):
            v = vals[j * B + k].astype(np.float32)
            b = k
            while b & 1:
                v = (stack.pop() + v).astype(np.float32)
                b >>= 1
            stack.append(v)
        acc = stack.pop() if stack else np.zeros(vals.shape[1], np.float32)
        while stack:
            acc = (stack.pop() + acc).astype(np.float32)
        part.append(acc)
    d = 1
    while d < group:
        for j in range(0, group, 2 * d):
            if (j + d) * B < n:
                part[j] = (part[j] + part[j + d]).astype(np.float32)
        d *= 2
    return part[0]


def _two_passes_np(seg, rows: np.ndarray) -> np.ndarray:
    """The wrapper's two launches on CUDA, from `seg`'s own tile arrays:
    each tile's rows (in sorted order) in 32 lanes, then each cell's tile
    sums in `seg.group` lanes."""
    order = seg.order.numpy()
    ts, ct = seg.tile_start.numpy(), seg.cell_tiles.numpy()
    tiles = np.stack([_kernel_pass_np(rows[order[ts[t]:ts[t + 1]]], SS.TILE_LANES)
                      for t in range(seg.n_tiles)])
    return np.stack([_kernel_pass_np(tiles[ct[c]:ct[c + 1]], seg.group)
                     for c in range(seg.n_cells)])


@pytest.mark.parametrize("group", [32, 256, 1024])
def test_kernel_association_is_the_specified_order(group):
    rng = np.random.default_rng(group)
    for n in [0, 1, 2, 3, 31, 33, 100, group - 1, group, group + 1, 3 * group + 5,
              5000]:
        vals = (rng.normal(size=(n, 2))
                * 10.0 ** rng.integers(-4, 5, (n, 1))).astype(np.float32)
        depth = math.ceil(math.log2(n)) if n > 1 else 0
        # equal as values: the tree may add +0.0 where the kernel does not
        np.testing.assert_array_equal(_kernel_pass_np(vals, group),
                                      _tree_np(vals, depth), err_msg=f"n={n}")


@pytest.mark.parametrize("name", ["one_cell_holds_every_row", "skewed",
                                  "empty_cells_and_sentinels"])
def test_kernel_tiles_are_the_specified_order(name):
    """The tile arrays `Segments` prepares for the kernel's two passes
    cover every kept row once, in order, and the two passes give the
    plain version's sums: one cell of 5,000 rows (20 tiles) beside 300
    small ones, as a global BA's landmark 0 takes every unobserved slot."""
    if name == "skewed":
        rng = np.random.default_rng(9)
        cell = np.concatenate([np.zeros(5000, np.int64), rng.integers(1, 301, 900)])
        cell = cell[rng.permutation(cell.shape[0])]
        rows = rng.normal(size=(cell.shape[0], 3)).astype(np.float32)
        n = 301
    else:
        cell, rows, n, _ = _case(name)
    seg = SS.Segments(torch.from_numpy(cell), n)
    ts = seg.tile_start.numpy()
    assert seg.tile_start.shape[0] == seg.n_tiles + 1
    assert np.all(np.diff(ts) >= 0) and np.all(np.diff(ts) <= SS.TILE)
    assert ts[0] == 0 and ts[-1] == int(seg.start[-1])
    np.testing.assert_array_equal(_two_passes_np(seg, rows),
                                  SS.segment_sum(seg, torch.from_numpy(rows)).numpy())


def test_lane_count_follows_the_rows_a_cell():
    """About 8 rows a lane at the mean, 32 to 1024 lanes a cell; the
    second pass sums tiles, so 32 lanes serve cells of up to 64k rows."""
    assert SS._lanes(64000, 20000) == 32
    assert SS._lanes(2000, 1) == 256
    assert SS._lanes(10 ** 7, 1) == 1024
    one = torch.zeros(64000, dtype=torch.long)
    seg = SS.Segments(one, 30)
    assert (seg.n_tiles, seg.group) == (280, 32)
    assert SS.Segments(torch.zeros(10 ** 6, dtype=torch.long), 1).group == 512
    with pytest.raises(ValueError):
        SS.segment_sum(seg, torch.zeros((64000, 2), dtype=torch.float64))


# ---- ba_solve: the bits of the cell sums it had before the module ----
def _old_ordered_cells(cell, n_cells, max_rows):
    E = cell.shape[0]
    order = torch.argsort(cell, stable=True)
    sc = cell[order]
    pos = torch.arange(E)
    rank = pos - torch.searchsorted(sc, sc)
    steps, d = [], 1
    while d < max_rows:
        nxt = torch.clamp(pos + d, max=E - 1)
        take = (rank % (2 * d) == 0) & (pos + d < E) & (sc[nxt] == sc)
        steps.append((take[:, None], d))
        d *= 2
    return order, torch.where(rank == 0, sc, n_cells), steps, n_cells


def _old_sum_cells(oc, rows):
    order, head, steps, n_cells = oc
    ps = rows[order]
    for take, d in steps:
        ps = ps + torch.where(take, torch.roll(ps, -d, 0), 0.0)
    acc = torch.zeros((n_cells + 1, rows.shape[1]))
    acc[head] = ps
    return acc[:n_cells]


def _old_segments(cell, n_cells, max_rows=None):
    return _old_ordered_cells(cell.long(), n_cells,
                              cell.shape[0] if max_rows is None else max_rows)


def _problem(kind):
    if kind == "lines":
        cam, prob, Tg, _ = JBA._make_problem(n_cams=5, n_pts=80, noise=0.1,
                                             stereo=True)
        prob, _ = JBA._add_line_edges_synthetic(cam, prob, Tg)
    else:
        prob = JBA._make_problem(n_cams=6, n_pts=100, stereo=kind == "stereo")[1]
    return convert.ba_problem_from_numpy(jax.device_get(prob), "cpu")


@pytest.mark.parametrize("kind,solver", [("mono", "ba_solve"),
                                         ("stereo", "ba_solve"),
                                         ("lines", "ba_solve_arbitrated")])
def test_ba_solve_bits_unchanged(kind, solver, monkeypatch):
    p = _problem(kind)
    new = getattr(TB, solver)(TCAM, p)
    monkeypatch.setattr(TB, "Segments", _old_segments)
    monkeypatch.setattr(TB, "segment_sum", _old_sum_cells)
    old = getattr(TB, solver)(TCAM, p)
    for name, a, b in zip(new._fields, new, old):
        assert a.numpy().tobytes() == b.numpy().tobytes(), name


# ---- no float scatter-add left in the three global solvers ----
@pytest.fixture
def no_float_index_add(monkeypatch):
    plain = torch.Tensor.index_add_

    def refuse(self, dim, index, source, *a, **kw):
        if source.is_floating_point():
            raise AssertionError("float index_add_ on a solver path")
        return plain(self, dim, index, source, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    with pytest.raises(AssertionError):        # the patch is live
        torch.zeros(2).index_add_(0, torch.tensor([0, 0]), torch.ones(2))


@contextlib.contextmanager
def _gloo_world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        yield Mesh(None, 0, 1, torch.device("cpu"))
    finally:
        dist.destroy_process_group()


def _pose_graph():
    """A ring of 12 keyframes with 4 chords, measurements perturbed."""
    rng = np.random.default_rng(3)
    K = 12
    T = se3.se3_exp(torch.from_numpy(rng.normal(0, 0.1, (K, 6)).astype(np.float32)))
    ii = list(range(K - 1)) + [K - 1, 0, 2, 5]
    jj = list(range(1, K)) + [0, 6, 9, 11]
    M = torch.stack([T[a] @ torch.linalg.inv(T[b]) for a, b in zip(ii, jj)])
    M = M @ se3.se3_exp(torch.from_numpy(
        rng.normal(0, 0.02, (len(ii), 6)).astype(np.float32)))
    edges = TS3.PoseGraphEdges(
        torch.tensor(ii, dtype=torch.int32), torch.tensor(jj, dtype=torch.int32),
        torch.ones(len(ii)), M[:, :3, :3].contiguous(), M[:, :3, 3].contiguous(),
        torch.ones(len(ii)))
    return (torch.ones(K), T[:, :3, :3].contiguous(), T[:, :3, 3].contiguous(),
            torch.arange(K) != 0, edges)


@pytest.mark.parametrize("solver", ["ba_solve_pcg", "ba_solve_pcg_lines",
                                    "gn_step_sharded", "pose_graph_sim3"])
def test_global_solvers_make_no_float_scatter_add(solver, no_float_index_add,
                                                  tmp_path):
    if solver == "pose_graph_sim3":
        s, R, t, ng = TS3.pose_graph_sim3(*_pose_graph(), iters=15)
        assert int(ng) == 0 and torch.isfinite(t).all()
        return
    p = _problem("lines" if solver.endswith("lines") else "stereo")
    if solver.startswith("ba_solve_pcg"):
        res = TB.ba_solve_pcg(TCAM, p, rounds=1, gn_iters=2, cg_iters=10)
        assert int(res.n_guarded) == 0 and torch.isfinite(res.xyz).all()
        return
    with _gloo_world1(tmp_path) as mesh:
        cells = TGS._shard_cells(p, p.Tcw.shape[0], p.xyz.shape[0])
        T, X, ng = TGS._gn_step_sharded(TCAM, p, p.Tcw, p.xyz, p.e_ok, cg_iters=10,
                                        damping=1e-3, mesh=mesh, cells=cells)
    assert int(ng) == 0 and not torch.equal(X, p.xyz)


# ---- every scatter-add of the port is a listed one ----
SCATTER_CALLS = {"index_add_", "index_add", "scatter_add_", "scatter_add",
                 "bincount", "put_"}
ACCUMULATE_CALLS = {"index_put_", "index_put"}   # with accumulate=True
INTEGER = "integer counts: exact"
LISTED = {   # (file, innermost function) -> why its sum is exact in any order
    ("bow/vocabulary.py", "_tfidf"): "equal idf addends a slot",
    ("bow/vocabulary.py", "densify_bow_row"): "unique word ids a row",
    ("bow/vocabulary.py", "train"): "numpy on the host: serial",
    ("parallel/gba_sharded.py", "joint_chi2_sharded"): "two addends a pair",
    ("ops/match.py", "rotation_consistency"): INTEGER,
    ("slam/loop_closing.py", "loop_search_and_fuse"): INTEGER,
    ("slam/loop_closing.py", "run_global_ba"): INTEGER,
    ("slam/map.py", "insert_keyframe"): INTEGER,
    ("slam/map.py", "update_point_stats"): INTEGER,
    ("slam/map.py", "update_point_stats2"): INTEGER,
    ("slam/map.py", "update_line_stats"): INTEGER,
    ("slam/mapping_ops.py", "fuse_neighbors"): INTEGER,
    ("slam/mapping_ops.py", "fuse_neighbor_lines"): INTEGER,
    ("slam/mapping_ops.py", "_redundancy"): INTEGER,
    ("slam/mapping_ops.py", "cull_keyframes"): INTEGER,
    ("slam/mapping_ops.py", "apply_ba_result"): INTEGER,
}


class _Sites(ast.NodeVisitor):
    def __init__(self, rel):
        self.rel, self.stack, self.found = rel, [], set()

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute) and (
                f.attr in SCATTER_CALLS or (f.attr in ACCUMULATE_CALLS and any(
                    k.arg == "accumulate" for k in node.keywords))):
            self.found.add((self.rel, self.stack[-1] if self.stack else "<module>"))
        self.generic_visit(node)


def test_every_scatter_add_of_the_port_is_listed():
    """Each scatter-add of the port (by the innermost function that makes
    it) is listed above with why its sum is exact in any order: a new one
    is listed, or goes through `ops/segsum.py`. The global solvers make
    none."""
    sites = set()
    for path in sorted(PORT.rglob("*.py")):
        v = _Sites(path.relative_to(PORT).as_posix())
        v.visit(ast.parse(path.read_text()))
        sites |= v.found
    assert sites == set(LISTED)
