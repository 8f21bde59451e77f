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
sum in the loops is then `segment_sum(seg, rows)`: one launch of the
kernel for a CUDA tensor, the plain version for a CPU tensor; there is
no fallback from one to the other. `segment_sum.launches` counts kernel
launches. The kernel cuts each cell's ranks into chunks of 32 (aligned
subtrees of the tree), lets a warp sum the chunks that start in a window
of 32 sorted rows, and adds a long cell's chunk sums 64 at a time by the
tree's upper levels, each group by the warp that finishes its last
member (`Segments` holds the row records, the scratch for the sums and
the tickets; the kernel's source says how it runs).

Float scatter-adds of the port that stay `index_add_`, because their sums
are exact in any order, are listed in `tests/test_torch_segsum.py`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from splslam_tpu_torch.ops.nvcc import NVCC_FLAGS, build_library

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "segment_sum.cu"
CHUNK = 32          # ranks a chunk (an aligned subtree), and sorted rows a
                    # warp task's window (csrc/segment_sum.cu kChunk)
SCRATCH_COLS = 64   # columns the chunk-sum scratch holds a chunk at first


class Segments:
    """The rows of a table grouped by cell, prepared once for many
    `segment_sum` calls over tables of the same rows: `cell` [E] holds
    each row's cell index (indices outside [0, n_cells) are dropped).

    order:   [E] int64, a stable sort of the rows by cell (and its int32
             copy for the kernel);
    start:   [n_cells + 1] int32, the first sorted row of each cell
             (start[n_cells]: the first dropped row);
    the kernel's tables, each sized from E and n_cells alone, so that
    nothing is read back to the host:
    records: [E, 4] int32, the kernel's row table. A chunk is the ranks
             [32j, 32j + 32) of one cell; the kept rows, sorted, are the
             chunks one after another, numbered in that order. A sorted
             row where a chunk starts holds (cell, chunk number, the
             cell's first chunk, the cell's chunk count x 64 + the
             chunk's rows); any other row (-, -1, -, -). Warp task w
             takes the chunks that start in sorted rows [32w, 32w + 32):
             n_tasks = ceil(E / 32). n_chunks = min(E, E // 32 + n_cells)
             bounds the chunks of any table of E rows;
    partials: f32 scratch for the sums of long cells' chunks and of their
             groups of 64, [n_chunks x 64] floats (a wider table makes the
             wrapper allocate it once more); tickets: [n_chunks] int32,
             zero between launches: a group's sums done so far in a launch
             (a group's ticket sits at its first chunk plus its level);
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
        dev = cell.device
        start = self.start.long()
        zero = torch.zeros(1, dtype=torch.long, device=dev)
        size = torch.cat([start[1:] - start[:-1], zero])     # 0 past the last
        per_cell = (size + CHUNK - 1) // CHUNK
        first = torch.cat([zero, torch.cumsum(per_cell, 0)[:-1]])
        sc = self.sorted                                     # n_cells: dropped
        rank = torch.arange(self.rows, device=dev) - start[sc]
        head = (sc < n_cells) & (rank % CHUNK == 0)
        self.records = torch.stack([
            sc, torch.where(head, first[sc] + rank // CHUNK, -1), first[sc],
            per_cell[sc] * 64 + torch.clamp(size[sc] - rank, max=CHUNK)],
            dim=1).to(torch.int32)
        self.n_chunks = min(self.rows, self.rows // CHUNK + n_cells)
        self.n_tasks = -(-self.rows // CHUNK)
        self.partials = torch.empty(self.n_chunks * SCRATCH_COLS, device=dev)
        self.tickets = torch.zeros(self.n_chunks, dtype=torch.int32, device=dev)
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
    ptr, n = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum_launch.argtypes = [ptr, n, n, ptr, ptr, ptr, n, n,
                                       ptr, ptr, ptr, ptr]
    lib.segment_sum_launch.restype = ctypes.c_int
    lib.segment_sum_error_string.argtypes = [ctypes.c_int]
    lib.segment_sum_error_string.restype = ctypes.c_char_p
    _LIB = _Library(lib, so, log)
    return _LIB


def _launch(seg: Segments, rows: torch.Tensor) -> torch.Tensor:
    """One launch: every chunk, every long cell's groups and the empty
    cells' zeros."""
    W = rows.shape[1]
    if W == 0 or not rows.is_contiguous():
        raise ValueError("segment_sum needs a contiguous table of >= 1 column")
    if seg.n_cells * W >= 2 ** 31:
        raise ValueError("segment_sum: n_cells x W must stay below 2^31")
    lib = build()
    dev = rows.device
    with torch.cuda.device(dev):
        out = torch.empty((seg.n_cells, W), dtype=torch.float32, device=dev)
        if seg.n_cells == 0:
            return out
        if seg.partials.numel() < seg.n_chunks * W:
            seg.partials = torch.empty(seg.n_chunks * W, device=dev)
        code = lib.lib.segment_sum_launch(
            rows.data_ptr(), W, seg.rows, seg.order32.data_ptr(),
            seg.records.data_ptr(), seg.start.data_ptr(), seg.n_tasks, seg.n_cells,
            seg.partials.data_ptr(), seg.tickets.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
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
