"""Fixed-order segment sums: per-cell sums of the rows of a float32 table,
each cell's rows added in one specified order, the same on every run and
every device. The hand-written Hopper kernel `csrc/segment_sum.cu`, its
plain PyTorch version, and the wrapper that picks between them by device.

The port's solvers sum Hessian blocks and gradients of the edges that
share a camera, a landmark or a keyframe pair. `Tensor.index_add_` does
this serially on the CPU, but on CUDA it adds the rows that land in one
slot by atomics in launch order, so a solve gives other floats on every
run (the JAX package's `.at[idx].add` is serial on the CPU where its
tests run it). The order here:

- the rows are sorted by cell once (`Segments`, stable, so a cell keeps
  the table's row order) and numbered by rank 0..n-1 within their cell;
- each cell's rows are summed by the pairwise tree that at level
  d = 1, 2, 4, ... adds the partial sum at rank r + d into the one at
  rank r, for r a multiple of 2d and r + d < n;
- rows whose cell lies outside [0, n_cells) are dropped, as the JAX
  package's `mode="drop"` drops them.

`Segments` is built once per solve, outside the solver's loops (the edge
table does not change inside a solve; weights and masks do), and every
sum in the loops is then `segment_sum(seg, rows)`: two launches of the
kernel for a CUDA tensor (tiles of 256 ranks, then each cell over its
tiles: the same tree), the plain version for a CPU tensor; there is no
fallback from one to the other. `segment_sum.launches` counts kernel
launches.

Float scatter-adds of the port that stay `index_add_`, because their sums
are exact in any order, are listed in `tests/test_torch_segsum.py`.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from splslam_tpu_torch.ops.nvcc import NVCC_FLAGS, build_library

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "segment_sum.cu"
MIN_GROUP, MAX_GROUP = 32, 1024   # lanes a cell (csrc/segment_sum.cu)
TILE = 256    # rows of a tile, the kernel's first pass (a power of two)
TILE_LANES = 32   # lanes a tile: 8 rows a lane


def _lanes(rows: int, cells: int) -> int:
    """The kernel's lanes a cell: about 8 rows a lane at the mean."""
    mean = rows / max(cells, 1)
    return min(MAX_GROUP, max(MIN_GROUP, 1 << max(0, math.ceil(
        math.log2(max(mean / 8.0, 1.0))))))


class Segments:
    """The rows of a table grouped by cell, prepared once for many
    `segment_sum` calls over tables of the same rows: `cell` [E] holds
    each row's cell index (indices outside [0, n_cells) are dropped).

    order:   [E] int64, a stable sort of the rows by cell (and its int32
             copy for the kernel);
    start:   [n_cells + 1] int32, the first sorted row of each cell
             (start[n_cells]: the first dropped row);
    tiles:   the kernel's first pass: `tile_start` [n_tiles + 1] int32,
             the first sorted row of each tile (the ranks [jT, (j+1)T) of
             one cell, T = TILE; tiles past the last are empty), and
             `cell_tiles` [n_cells + 1] int32, each cell's first tile.
             n_tiles = E // T + n_cells bounds the tiles of any table of E
             rows, so nothing is read back to the host;
    max_rows: a bound on the rows of one cell that deepens the plain
             version's tree (the kernel needs none); a deeper tree only
             adds +0.0 to lone partial sums."""

    def __init__(self, cell: torch.Tensor, n_cells: int,
                 max_rows: int | None = None):
        cell = cell.long()
        inside = (cell >= 0) & (cell < n_cells)
        self.cell = torch.where(inside, cell, n_cells)
        self.n_cells = n_cells
        self.rows = cell.shape[0]
        self.order = torch.argsort(self.cell, stable=True)
        self.sorted = self.cell[self.order]
        self.start = torch.searchsorted(
            self.sorted, torch.arange(n_cells + 1, device=cell.device)
        ).to(torch.int32)
        self.max_rows = max_rows
        self.order32 = self.order.to(torch.int32)
        start = self.start.long()
        ntile = (start[1:] - start[:-1] + TILE - 1) // TILE
        cell_tiles = torch.zeros(n_cells + 1, dtype=torch.long, device=cell.device)
        cell_tiles[1:] = torch.cumsum(ntile, 0)
        self.n_tiles = self.rows // TILE + n_cells
        t = torch.arange(self.n_tiles + 1, device=cell.device)
        c = torch.searchsorted(cell_tiles, t, right=True) - 1   # n_cells: past the last
        first = start[c] + (t - cell_tiles[c]) * TILE
        self.tile_start = torch.where(c < n_cells, first, start[-1]).to(torch.int32)
        self.cell_tiles = cell_tiles.to(torch.int32)
        self.group = _lanes(self.n_tiles, n_cells)
        self._tree = None

    def tree(self):
        """(levels, head cells, kept rows): the plain version's pairwise
        tree over the kept rows, as compactions. Level k keeps the partial
        sums at the ranks that are multiples of 2^k: (left [m] positions
        of those at even ranks, right [m] the next position, pair [m, 1]
        whether it is the same cell's next rank). Deep enough for
        `max_rows` and for the longest cell (read back from the device:
        the plain version runs on the card only beside the kernel, to
        check it)."""
        if self._tree is None:
            kept = int(self.start[-1])
            cell = self.sorted[:kept]
            rank = torch.arange(kept, device=cell.device) \
                - torch.searchsorted(cell, cell)
            bound = self.max_rows or 0
            if kept:
                bound = max(bound, int((self.start[1:] - self.start[:-1]).max()))
            levels, d = [], 1
            while d < bound:
                left = torch.nonzero(rank % 2 == 0)[:, 0]
                right = torch.clamp(left + 1, max=max(cell.shape[0] - 1, 0))
                pair = (left + 1 < cell.shape[0]) & (cell[right] == cell[left])
                levels.append((left, right, pair[:, None]))
                cell, rank = cell[left], rank[left] // 2
                d *= 2
            self._tree = (tuple(levels), cell, kept)
        return self._tree


def segment_sum_reference(seg: Segments, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [n_cells, W] sums of `rows`
    [E, W] over the rows of each cell, in the order of the module
    docstring. At each level every surviving partial sum at an even rank
    takes its cell's next one, or +0.0 where its rank has no partner, and
    the odd ranks drop out, so the work halves a level."""
    _check(seg, rows)
    levels, head, kept = seg.tree()
    ps = rows[seg.order[:kept]]
    for left, right, pair in levels:
        ps = ps[left] + torch.where(pair, ps[right], 0.0)
    out = torch.zeros((seg.n_cells, rows.shape[1]), device=rows.device)
    out[head] = ps        # one partial sum a cell is left, at its rank 0
    return out


def _check(seg: Segments, rows: torch.Tensor):
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.float32 \
            or rows.dim() != 2 or rows.shape[0] != seg.rows:
        raise ValueError(f"rows must be a float32 [{seg.rows}, W] tensor")
    if rows.device != seg.order.device:
        raise ValueError(f"rows on {rows.device}, the segments on "
                         f"{seg.order.device}")


class _Library:
    def __init__(self, lib: ctypes.CDLL, path: Path, log: str):
        self.lib = lib
        self.path = path
        self.log = log


_LIB: _Library | None = None


def build() -> _Library:
    """Build (if needed) and load the kernel library; cached per process.
    A failed build raises with nvcc's stderr."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib, so, log = build_library(_SOURCE, NVCC_FLAGS)
    lib.segment_sum_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.segment_sum_launch.restype = ctypes.c_int
    lib.segment_sum_error_string.argtypes = [ctypes.c_int]
    lib.segment_sum_error_string.restype = ctypes.c_char_p
    _LIB = _Library(lib, so, log)
    return _LIB


def _launch(seg: Segments, rows: torch.Tensor) -> torch.Tensor:
    """Two launches: the tiles' sums, then each cell's over its tiles."""
    if rows.shape[1] == 0 or not rows.is_contiguous():
        raise ValueError("segment_sum needs a contiguous table of >= 1 column")
    lib = build()
    dev = rows.device
    W = rows.shape[1]
    with torch.cuda.device(dev):
        out = torch.empty((seg.n_cells, W), dtype=torch.float32, device=dev)
        if seg.n_cells == 0:
            return out
        tiles = torch.empty((seg.n_tiles, W), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for src, order, start, n, group, dst in (
                (rows, seg.order32.data_ptr(), seg.tile_start, seg.n_tiles,
                 TILE_LANES, tiles),
                (tiles, None, seg.cell_tiles, seg.n_cells, seg.group, out)):
            code = lib.lib.segment_sum_launch(
                src.data_ptr(), W, order, start.data_ptr(), n, group,
                dst.data_ptr(), stream)
            if code != 0:
                msg = lib.lib.segment_sum_error_string(code).decode()
                raise RuntimeError(f"segment_sum launch failed: CUDA error "
                                   f"{code} ({msg})")
            segment_sum.launches += 1
    return out


def segment_sum(seg: Segments, rows: torch.Tensor) -> torch.Tensor:
    """[n_cells, W] sums of `rows` f32 [E, W] over the rows of each cell
    of `seg`, in its fixed order. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    _check(seg, rows)
    if rows.device.type == "cuda":
        return _launch(seg, rows)
    if rows.device.type == "cpu":
        return segment_sum_reference(seg, rows)
    raise ValueError(f"segment_sum: unsupported device {rows.device}")


segment_sum.launches = 0
