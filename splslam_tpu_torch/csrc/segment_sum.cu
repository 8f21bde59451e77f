// segment_sum: per-cell sums of the rows of a float32 table, each cell's
// rows added in one fixed order, so that the same input gives the same
// bits on every run.
//
// Replaces no TPU kernel. The JAX package sums its bundle-adjustment and
// pose-graph blocks with XLA scatter-adds (`.at[idx].add`,
// splslam_tpu/optim/ba.py:715-718 and :398, splslam_tpu/optim/sim3.py:
// 290-295), which run serially on the CPU. Their PyTorch counterpart,
// `Tensor.index_add_`, adds the rows that share a slot by atomics on
// CUDA, in whatever order the launch happens to run, so a solve moved by
// float noise from one run to the next. This kernel sums in the order of
// the plain version in ops/segsum.py, on every device.
//
// The order: the rows of a cell, taken in a stable sort of the table by
// cell (table order within a cell), numbered by rank 0..n-1, are summed
// by the pairwise tree that at level d = 1, 2, 4, ... adds the partial
// sum at rank r + d into the one at rank r for every r that is a multiple
// of 2d and every r + d < n. Rows whose cell lies outside [0, n_cells)
// are dropped (they sort past the last cell's rows). Every addition here
// is one the tree makes, on the same operands (float addition commutes),
// so the results are the plain version's; only the sign of a zero sum may
// differ, where the plain version adds +0.0 to a lone partial sum.
//
// What bounds it on an H100: it reads each kept row once (E x W x 4
// bytes), its order entry (E x 4) and the chunk tables, and writes
// n_cells x W x 4 bytes; it adds E x W floats. At the solvers' shapes
// (1-13 MB, 0.4-3.7 us at 3.35 TB/s against nothing at 67 TFLOP/s) it is
// bound by the bytes, and at the smaller ones by a launch and a few
// dependent memory round trips. The solvers' tables are either dense (a
// CG product's 64,000 rows into 32 cameras; a global BA's landmark 0
// takes ~50,000 unobserved slots) or sparse (local BA's 20,000 rows into
// 36,864 cells, most empty or of one row).
//
// The schedule, one launch a sum, work by rows:
// - A chunk is the ranks [32j, 32j + 32) of one cell: an aligned subtree
//   of its tree. The kept rows, sorted, are the chunks one after another,
//   numbered in that order (a cell's consecutive). The row table
//   (ops/segsum.py `Segments`) marks each chunk's first row with its
//   cell, number, length and the cell's first chunk and chunk count.
// - A warp task is a window of 32 sorted rows: the warp sums the (at most
//   32) chunks that start in it, so several short cells share a warp, and
//   the warps scale with the rows. It loads the window's 32 row records
//   and 64 order entries at once (no table lookup before them), and
//   stages the chunks' rows in shared memory in
//   pieces of at most 32 rows (whole chunks), by cp.async (16, 8 or 4
//   bytes a lane, as W's divisors allow): for a wide table consecutive
//   lanes read consecutive columns of a row, for a narrow one a warp
//   reads 32 / W rows (or more, with wider copies) at once.
//   Then each lane adds one column of one chunk by the tree, in
//   registers (unrolled for the chunk's length rounded up to a power of
//   two, an addition only where the tree has one): no barrier, no
//   shared-memory round trip between levels.
// - A cell of one chunk is written out at once. A longer cell's chunk
//   sums go to scratch, and the tree's upper levels are added 64 at a
//   time: each aligned group of 64 chunk sums (of 64 group sums, ...) is
//   an aligned subtree, and the warp that draws the group's last ticket
//   (lane 0's acq_rel atomicAdd after a __syncwarp) adds its sums, each
//   half of 32 by a lane a column in registers, then the halves, and
//   writes the group's sum in the slot of its first member, or the
//   cell's row at the top. The groups of one
//   level are added by different warps at once, so a cell of 50,000 rows
//   (1,563 chunks) is two such levels deep, not a serial walk, and a CG
//   product's camera (~2,000 rows, 63 chunks) one. Atomics
//   pick which warp adds a group, never an order of additions; the last
//   arrival resets the ticket for the next launch.
// - Blocks past the tasks write the empty cells' zeros, coalesced.
// Columns go in slabs of at most 64. No tensor cores: a product would
// change the order of additions.
//
// Bound through a plain C interface (ctypes); it launches on the caller's
// stream and allocates nothing: the chunk tables, the scratch and the
// tickets (zero between launches) belong to the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                    // warps a block
constexpr int kChunk = 32;                   // ranks a chunk (segsum.py CHUNK)
constexpr int kGroup = 64;                   // sums a group adds: two halves
constexpr int kSlab = 64;                    // columns staged at once
constexpr int kBuf = kChunk * kSlab;         // floats a warp stages
constexpr int kZeroPer = 8;                  // outputs a zero-writing thread

// `vec` floats (1, 2 or 4, aligned to their size) from global memory to
// shared memory, without registers.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  else if (vec == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Takes a ticket of `arrivals` at p (atomicAdd with release at GPU scope:
// the warp's writes, ordered before it by a __syncwarp); true for the
// last, which then acquires the other arrivals' writes.
__device__ __forceinline__ bool ticket_last(int* p, int arrivals) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(p) : "memory");
  return old == arrivals - 1;
}

// One column of an aligned subtree: the m <= R values p[0], p[step], ...
// added by the tree, where the tree adds (never +0.0).
template <int R, bool kScratch>
__device__ __forceinline__ float column_tree(const float* p, size_t step, int m) {
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    v[r] = r < m ? (kScratch ? __ldcg(p + r * step) : p[r * step]) : 0.0f;
#pragma unroll
  for (int d = 1; d < R; d <<= 1) {
#pragma unroll
    for (int r = 0; r + d < R; r += 2 * d)
      if (r + d < m) v[r] = v[r] + v[r + d];
  }
  return v[0];
}

// The same for 1 <= m <= 32; kScratch: values written in this launch by
// other SMs, read past L1.
template <bool kScratch>
__device__ __forceinline__ float column_sum(const float* p, size_t step, int m) {
  if (m == 1) return kScratch ? __ldcg(p) : p[0];
  if (m <= 2) return column_tree<2, kScratch>(p, step, m);
  if (m <= 4) return column_tree<4, kScratch>(p, step, m);
  if (m <= 8) return column_tree<8, kScratch>(p, step, m);
  if (m <= 16) return column_tree<16, kScratch>(p, step, m);
  return column_tree<32, kScratch>(p, step, m);
}

// Lanes over (slot, item) for slots of n items (columns, or vectors of
// columns): 32 / n slots a pass where n < 32; else one slot, items lane
// and lane + 32.
struct Lanes {
  int per, slot, item;
};

__device__ __forceinline__ Lanes lanes_for(int n, int lane) {
  if (n >= 32) return {1, 0, lane};
  const int per = 32 / n, slot = lane / n;
  return {per, slot < per ? slot : kChunk, lane - slot * n};  // kChunk: idle
}

// Chunk j of a cell of `count` chunks (the first `first`) has its sum in
// partials[(first + j) * width ...]: climb the tree's upper levels while
// this warp is the last arrival of its group.
__device__ void climb(int cell, int first, int count, int j, int width,
                      float* partials, int* tickets, float* __restrict__ out,
                      float* buf, int lane) {
  int n = count, idx = j, span = 1;
  for (int level = 0;; ++level) {
    const int g = idx / kGroup;
    const int m = min(kGroup, n - g * kGroup);
    const int slot = first + g * kGroup * span;  // the group's first member
    if (m > 1) {
      __syncwarp();
      int last = 0;
      if (lane == 0) last = ticket_last(tickets + slot + level, m);
      if (!__shfl_sync(kFull, last, 0)) return;
      __syncwarp();
      float* dst = n <= kGroup ? out + (size_t)cell * width
                               : partials + (size_t)slot * width;
      // the tree over up to 64 members: each half of 32 a (half, column)
      // a lane, then the top level adds the halves
      const size_t step = (size_t)span * width;
      const int halves = m > 32 ? 2 : 1;
      for (int c0 = 0; c0 < width; c0 += kSlab) {
        const int ws = min(kSlab, width - c0);
        const float* p = partials + (size_t)slot * width + c0;
        for (int i = lane; i < halves * ws; i += 32) {
          const int h = i / ws, c = i - h * ws;
          buf[i] = column_sum<true>(p + h * 32 * step + c, step, min(32, m - 32 * h));
        }
        __syncwarp();
        for (int c = lane; c < ws; c += 32)
          dst[c0 + c] = halves == 2 ? buf[c] + buf[ws + c] : buf[c];
        __syncwarp();
      }
      if (lane == 0) tickets[slot + level] = 0;
    }
    if (n <= kGroup) return;
    n = (n + kGroup - 1) / kGroup;
    idx = g;
    span *= kGroup;
  }
}

__global__ void __launch_bounds__(kWarps * 32, 4)
segment_sum_kernel(const float* __restrict__ rows, int width, int n_rows,
                   const int* __restrict__ order,
                   const int4* __restrict__ records,
                   const int* __restrict__ start, int n_tasks,
                   int n_cells, int task_blocks, float* partials,
                   int* tickets, float* __restrict__ out) {
  if ((int)blockIdx.x >= task_blocks) {          // the empty cells' zeros
    const int total = n_cells * width;
    int i = ((int)blockIdx.x - task_blocks) * blockDim.x * kZeroPer + threadIdx.x;
    for (int u = 0; u < kZeroPer && i < total; ++u, i += blockDim.x) {
      const int c = i / width;
      if (start[c + 1] == start[c]) out[i] = 0.0f;
    }
    return;
  }
  __shared__ __align__(16) float buf_all[kWarps][kBuf];
  __shared__ int cs_all[kWarps][kChunk + 1];     // chunk starts (sorted rows)
  __shared__ int4 cr_all[kWarps][kChunk];        // chunk records
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= n_tasks) return;
  float* buf = buf_all[warp];
  int* cs = cs_all[warp];
  int4* cr = cr_all[warp];
  // the window's row records and order entries: the chunks that start in
  // the window lie in [base, base + 64)
  const int base = task * kChunk;
  const int4 rec = base + lane < n_rows ? records[base + lane] : make_int4(0, -1, 0, 0);
  int o0 = base + lane, o1 = base + 32 + lane;
  if (order) {
    o0 = o0 < n_rows ? order[o0] : 0;
    o1 = o1 < n_rows ? order[o1] : 0;
  }
  const unsigned heads = __ballot_sync(kFull, rec.y >= 0);
  if (heads == 0) return;
  const int nch = __popc(heads);
  if (rec.y >= 0) {                              // the j-th chunk's first row
    const int j = __popc(heads & ((1u << lane) - 1));
    cs[j] = base + lane;
    cr[j] = rec;
    if (j == nch - 1) cs[nch] = base + lane + (rec.w & 63);
  }
  __syncwarp();
  // lane j: chunk j's cell, number, and its cell's first chunk and count
  int cell = 0, chunk = 0, first = 0, count = 0;
  if (lane < nch) {
    const int4 c = cr[lane];
    cell = c.x;
    chunk = c.y;
    first = c.z;
    count = (int)((unsigned)c.w >> 6);
  }
  const unsigned multi = __ballot_sync(kFull, count > 1);
  __syncwarp();
  // copies of 16 or 8 bytes where every row's slab starts so aligned
  const uintptr_t at = (uintptr_t)rows;
  const int vec = width % 4 == 0 && at % 16 == 0 ? 4
                  : width % 2 == 0 && at % 8 == 0 ? 2 : 1;

  for (int ja = 0; ja < nch;) {
    // a piece: whole chunks [ja, jb), at most 32 rows from p0
    const int p0 = cs[ja];
    int jb = ja + 1;
    while (jb < nch && cs[jb + 1] - p0 <= kChunk) ++jb;
    const int nr = cs[jb] - p0;
    const int pos = p0 - base + lane;            // < 64: lane's row's entry
    const int lo = __shfl_sync(kFull, o0, pos & 31);
    const int hi = __shfl_sync(kFull, o1, pos & 31);
    const int src = pos < 32 ? lo : hi;
    for (int c0 = 0; c0 < width; c0 += kSlab) {
      const int ws = min(kSlab, width - c0);
      const Lanes V = lanes_for(ws / vec, lane);
      for (int r0 = 0; r0 < nr; r0 += V.per) {
        const int r = r0 + V.slot;
        const int row = __shfl_sync(kFull, src, min(r, 31));
        if (r < nr)
          for (int c = V.item * vec; c < ws; c += 32 * vec)
            copy_async(buf + r * ws + c, rows + (size_t)row * width + c0 + c, vec);
      }
      copy_wait();
      __syncwarp();
      // each chunk's sum, a column a lane: to the output, or to scratch
      // where the cell has more chunks
      const Lanes L = lanes_for(ws, lane);
      for (int j = ja + L.slot; j < jb; j += L.per) {
        const int h = cs[j] - p0, m = cs[j + 1] - cs[j];
        float* dst = (multi >> j) & 1 ? partials + (size_t)cr[j].y * width
                                      : out + (size_t)cr[j].x * width;
        for (int c = L.item; c < ws; c += 32)
          dst[c0 + c] = column_sum<false>(buf + h * ws + c, ws, m);
      }
      __syncwarp();
    }
    ja = jb;
  }

  for (unsigned left = multi; left;) {
    const int j = __ffs(left) - 1;
    left &= left - 1;
    const int c = __shfl_sync(kFull, cell, j);
    const int t = __shfl_sync(kFull, chunk, j);
    const int f = __shfl_sync(kFull, first, j);
    const int n = __shfl_sync(kFull, count, j);
    climb(c, f, n, t - f, width, partials, tickets, out, buf, lane);
  }
}

}  // namespace

// rows: f32 [n_rows, width] (contiguous); order: int32 [n_rows], the
// rows sorted by cell (stable), or null for rows already in that order;
// records: int32 [n_rows, 4], a sorted row's (cell, chunk number, the
// cell's first chunk, the cell's chunk count x 64 + the chunk's rows)
// where a chunk starts there, else (-, -1, -, -); start: int32 [n_cells +
// 1], each cell's first sorted row; n_tasks: ceil(n_rows / 32); partials:
// f32 [n_chunks * width] scratch; tickets: int32 [n_chunks], zero; out:
// f32 [n_cells, width]. Enqueues one launch on `stream`; returns
// cudaGetLastError().
extern "C" int segment_sum_launch(const void* rows, int width, int n_rows,
                                  const void* order, const void* records,
                                  const void* start, int n_tasks,
                                  int n_cells, void* partials, void* tickets,
                                  void* out, void* stream) {
  const long long total = (long long)n_cells * width;
  if (width < 1 || n_rows < 0 || n_cells < 0 || n_tasks < 0 ||
      total >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (n_cells == 0) return 0;
  const int threads = kWarps * 32;
  const int task_blocks = (n_tasks + kWarps - 1) / kWarps;
  const int zero_blocks = (int)((total + threads * kZeroPer - 1) / (threads * kZeroPer));
  segment_sum_kernel<<<task_blocks + zero_blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)rows, width, n_rows, (const int*)order,
      (const int4*)records, (const int*)start, n_tasks, n_cells, task_blocks, (float*)partials, (int*)tickets,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
