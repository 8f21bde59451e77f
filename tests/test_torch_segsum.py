"""The fixed-order segment sum of the port's solvers (`ops/segsum.py`).

- `segment_sum` on the CPU (its plain version) bit for bit against a numpy
  float32 loop that adds each cell's rows in the specified order (the
  pairwise tree over the rows' ranks in a stable sort by cell): empty
  cells, dropped rows (the sentinel index n_cells, and indices below 0 or
  past it), one cell that holds every row, a `max_rows` bound that is a
  power of two, one and many columns.
- The kernel's schedule (`csrc/segment_sum.cu`: chunks of 32 ranks, a
  warp for the chunks that start in each window of 32 sorted rows, the
  tree's levels over pieces of whole chunks, a long cell's chunk sums
  added 64 at a time up the tree) emulated in numpy on the tables `Segments` builds, against the
  plain version and the loop: at chunk edges, sparse and skewed tables,
  sentinels, no kept row, and every width the solvers sum; the tables
  built on the meta device (no host read) at sizes from E and n_cells.
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


def _tree_rows_np(buf: np.ndarray) -> np.ndarray:
    """The tree over the rows of `buf` [m, W] (float32), into row 0."""
    buf = buf.copy()
    d = 1
    while d < buf.shape[0]:
        r = np.arange(0, buf.shape[0] - d, 2 * d)
        buf[r] = buf[r] + buf[r + d]
        d *= 2
    return buf[0]


def _climb_np(parts: np.ndarray) -> np.ndarray:
    """The upper levels of one cell's tree over its chunk sums [n, W]
    (rank order): each aligned group of 64 sums added as the kernel adds
    it (each half of 32 by the tree, then the halves), then each group of
    64 group sums, up to one."""
    while parts.shape[0] > 1:
        sums = []
        for g in range(0, parts.shape[0], 64):
            halves = [_tree_rows_np(parts[h:min(h + 32, g + 64)])
                      for h in range(g, min(g + 64, parts.shape[0]), 32)]
            sums.append(halves[0] if len(halves) == 1 else halves[0] + halves[1])
        parts = np.stack(sums)
    return parts[0]


def _kernel_np(seg, rows: np.ndarray) -> np.ndarray:
    """csrc/segment_sum.cu's schedule in numpy float32, on `seg`'s own
    row records: warp task w takes the chunks that start in sorted rows
    [32w, 32w + 32), in pieces of whole chunks of at most 32 rows; the
    tree's levels run over each piece's rows, a row at rank q of a chunk
    of m rows taking row q + d where q is a multiple of 2d and q + d < m;
    a one-chunk cell is its chunk's sum, a longer one its chunk sums
    added 64 at a time up the tree. Checks the tables on the way."""
    order, rec = seg.order32.numpy(), seg.records.numpy()
    start = seg.start.numpy()
    # the chunks, from the cell starts alone, against the row records
    per_cell = -(-np.diff(start) // 32)
    cell_chunk = np.concatenate([[0], np.cumsum(per_cell)])
    heads = np.nonzero(rec[:, 1] >= 0)[0]
    chunk_cell = rec[heads, 0]
    length = rec[heads, 3] & 63
    np.testing.assert_array_equal(rec[heads, 1], np.arange(heads.shape[0]))
    np.testing.assert_array_equal(rec[heads, 2], cell_chunk[chunk_cell])
    np.testing.assert_array_equal(rec[heads, 3] >> 6, per_cell[chunk_cell])
    cs_all = np.append(heads, start[-1])
    np.testing.assert_array_equal(np.diff(cs_all), length)   # chunks tile the kept rows
    assert heads.shape[0] == cell_chunk[-1] <= seg.n_chunks
    assert np.all(length >= 1) and np.all(length <= 32)
    assert np.all((heads - start[chunk_cell]) % 32 == 0)
    W = rows.shape[1]
    out = np.full((seg.n_cells, W), np.nan, np.float32)
    parts = np.full((seg.n_chunks, W), np.nan, np.float32)
    for w in range(seg.n_tasks):
        a, b = np.searchsorted(heads, [32 * w, 32 * w + 32])
        cs = cs_all[a:b + 1]
        ja = 0
        while ja < b - a:
            p0, jb = cs[ja], ja + 1
            while jb < b - a and cs[jb + 1] - p0 <= 32:
                jb += 1
            nr = cs[jb] - p0
            assert 0 < nr <= 32
            buf = rows[order[p0:p0 + nr]].astype(np.float32)
            firsts = cs[ja:jb] - p0
            j = np.searchsorted(firsts, np.arange(nr), side="right") - 1
            q = np.arange(nr) - firsts[j]
            m = np.append(firsts[1:], nr)[j] - firsts[j]
            d = 1
            while d < m.max():
                left = np.nonzero((q % (2 * d) == 0) & (q + d < m))[0]
                buf[left] = buf[left] + buf[left + d]
                d *= 2
            for j in range(ja, jb):
                c = chunk_cell[a + j]
                if cell_chunk[c + 1] - cell_chunk[c] > 1:
                    parts[a + j] = buf[cs[j] - p0]
                else:
                    out[c] = buf[cs[j] - p0]
            ja = jb
    for c in range(seg.n_cells):
        f, n = cell_chunk[c], cell_chunk[c + 1] - cell_chunk[c]
        if n == 0:
            out[c] = 0.0
        elif n > 1:
            out[c] = _climb_np(parts[f:f + n])
    return out


def _schedule_case(name, W):
    """(cell [E] int64, rows [E, W] f32, n_cells) from a seed."""
    rng = np.random.default_rng(list(SCHEDULE_CASES).index(name) + 100 * W)
    if name == "chunk_edges":
        # cells shorter than a chunk, of one chunk, one past one, of many;
        # short cells share a warp's window
        sizes = [1, 2, 31, 32, 33, 0, 63, 64, 65, 3, 700, 1, 1, 5, 96, 129, 0, 17]
        cell = np.repeat(np.arange(len(sizes)), sizes)
        n = len(sizes)
    elif name == "sparse_wide_cells":       # local BA: most cells empty or of one row
        n = 4096
        cell = rng.integers(0, n + 1, 2200)
    elif name == "all_cells_empty":
        n = 50
        cell = np.concatenate([np.full(300, n), rng.integers(-9, 0, 100),
                               rng.integers(n + 1, 3 * n, 100)])
    elif name == "sentinels":
        n = 200
        cell = rng.integers(-3, n + 4, 3000)
        cell[::5] = n
    elif name == "skewed":                  # a global BA's landmark 0
        n = 301
        cell = np.concatenate([np.zeros(50000, np.int64), rng.integers(1, n, 900)])
    else:                                   # no rows at all
        n = 7
        cell = np.zeros(0, np.int64)
    cell = cell[rng.permutation(cell.shape[0])]
    rows = (rng.normal(size=(cell.shape[0], W))
            * 10.0 ** rng.integers(-3, 4, (cell.shape[0], 1)))
    return cell.astype(np.int64), rows.astype(np.float32), n


SCHEDULE_CASES = {"chunk_edges": 54, "sparse_wide_cells": 54, "all_cells_empty": 2,
                  "sentinels": 49, "skewed": 3, "no_rows": 6}


def _check_schedule(cell, rows, n):
    seg = SS.Segments(torch.from_numpy(cell), n)
    got = _kernel_np(seg, rows)
    plain = SS.segment_sum(seg, torch.from_numpy(rows)).numpy()
    # equal as values: the plain tree may add +0.0 where the kernel does not
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _reference_np(cell, rows, n, None))


@pytest.mark.parametrize("name", list(SCHEDULE_CASES))
def test_kernel_schedule_is_the_specified_order(name):
    """The kernel's schedule (chunk windows, pieces, levels, the last
    warp's combine) on the tables `Segments` builds gives the plain tree's
    sums: chunk edges, short cells sharing a warp, sparse wide cells, no
    kept row, sentinels, one cell of 50,000 rows beside 300 small ones."""
    _check_schedule(*_schedule_case(name, SCHEDULE_CASES[name]))


@pytest.mark.parametrize("width", [2, 3, 6, 42, 49, 54])
def test_kernel_schedule_at_the_solvers_widths(width):
    """The same at every width the solvers sum, with a 5,000-row cell
    (157 chunks: groups of 64, 64 and 29, then one group of three) beside
    the chunk edges."""
    cell, rows, n = _schedule_case("chunk_edges", width)
    big = np.full(5000, n)
    rng = np.random.default_rng(width)
    cell = np.concatenate([cell, big])[::-1].copy()
    rows = np.concatenate([rows, rng.normal(size=(5000, width)).astype(np.float32)])
    _check_schedule(cell, rows, n + 1)


def test_segments_tables_are_sized_without_a_host_read():
    """`Segments` builds its row records and scratch on the meta device, which holds no values (a host read there raises), at sizes
    from E and n_cells alone; the scratch grows for a table wider than 64
    columns only in the wrapper."""
    for E, n in [(64000, 32), (64000, 16384), (20000, 36864), (2400, 4096), (0, 7),
                 (100, 0)]:
        seg = SS.Segments(torch.zeros(E, dtype=torch.long, device="meta"), n)
        n_chunks = min(E, E // SS.CHUNK + n)
        n_tasks = -(-E // SS.CHUNK)
        assert (seg.n_chunks, seg.n_tasks) == (n_chunks, n_tasks)
        assert seg.records.shape == (E, 4)
        assert seg.partials.shape == (n_chunks * SS.SCRATCH_COLS,)
        assert seg.tickets.shape == (n_chunks,)
        for t in (seg.records, seg.tickets):
            assert t.dtype == torch.int32
    with pytest.raises(ValueError):
        SS.segment_sum(SS.Segments(torch.zeros(10, dtype=torch.long), 3),
                       torch.zeros((10, 2), dtype=torch.float64))


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
