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
// are dropped (they sort past start[n_cells]).
//
// The wrapper launches it twice a sum, so that no lane walks a long
// cell alone: first over tiles, each the ranks [jT, (j+1)T) of one cell
// (T = 256 rows, a B-aligned subtree of the tree), writing one partial
// sum a tile; then over the cells, whose rows are their tiles' sums in
// rank order (`order` null: the identity), which the tree's upper levels
// combine. The order of the additions is the tree's either way.
//
// A group of G lanes (G a power of two, 32..1024) serves one cell; a
// block of max(G, 256) threads serves 256 / G cells, or one. With B the
// least power of two such that G * B >= n, lane j sums the ranks
// [jB, (j+1)B): a B-aligned subtree of the tree, computed serially with
// a stack of partial sums (the binary-counter form of the same tree:
// element k merges with the stack's top once for each trailing 1 bit of
// k, and the stack folds from its top at the end). The G lane sums then
// combine in shared memory by the tree's upper levels, partner lane
// j + d taken only where its chunk holds a rank. Every addition is one
// the plain version makes, on the same operands (float addition
// commutes), so the results are equal; only the sign of a zero sum may
// differ, where the plain version adds +0.0 to a lone partial. One
// launch computes every column: lanes loop over the W columns.
//
// What bounds it on an H100: it reads each row once (E x W x 4 bytes),
// the sorted order (E x 4) and the cell starts, and writes n_cells x W x
// 4 bytes; it adds E x W floats. The CG products of the global BA at
// 64,000 rows and W = 6 move about 1.8 MB, 0.55 us at 3.35 TB/s, against
// 0.4 M additions, nothing at 67 TFLOP/s: bound by the bytes. At such
// sizes a launch costs more than the bound; a sum is two launches and a
// walk of the table, one read a row a column, gathered through `order`
// (the rows are scattered, so a warp's reads are not coalesced). The
// tiles keep the walk short: a lane adds at most 8 rows of a tile, where
// one lane of a single pass would add a long cell's rows alone (a global
// BA sends every unobserved slot to landmark 0: some 50,000 rows).
//
// Bound through a plain C interface (ctypes); it launches on the caller's
// stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinBlock = 256;
constexpr int kMaxStack = 32;   // log2 of the longest chunk, plus one

__global__ void segment_sum_kernel(const float* __restrict__ rows, int width,
                                   const int* __restrict__ order,
                                   const int* __restrict__ start, int n_cells,
                                   int group, float* __restrict__ out) {
  extern __shared__ float part[];
  const int t = threadIdx.x;
  const int lane = t & (group - 1);
  const int cell = blockIdx.x * (blockDim.x / group) + t / group;
  int lo = 0, n = 0;
  if (cell < n_cells) {
    lo = start[cell];
    n = start[cell + 1] - lo;
  }
  long long chunk = 1;  // B
  while (chunk * group < n) chunk <<= 1;
  const long long c0 = lane * chunk;
  const int m = (int)(c0 < n ? (n - c0 < chunk ? n - c0 : chunk) : 0);
  const long long base = lo + c0;
  for (int col = 0; col < width; ++col) {
    float stack[kMaxStack];
    int top = 0;
    for (int k = 0; k < m; ++k) {
      const int row = order ? order[base + k] : (int)(base + k);
      float v = rows[(size_t)row * width + col];
      for (int b = k; b & 1; b >>= 1) v = stack[--top] + v;
      stack[top++] = v;
    }
    float acc = 0.0f;
    if (top > 0) {
      acc = stack[--top];
      while (top > 0) acc = stack[--top] + acc;
    }
    part[t] = acc;
    __syncthreads();
    for (int d = 1; d < group; d <<= 1) {
      if ((lane & (2 * d - 1)) == 0 && c0 + d * chunk < n)
        part[t] = part[t] + part[t + d];
      __syncthreads();
    }
    if (lane == 0 && cell < n_cells) out[(size_t)cell * width + col] = part[t];
    __syncthreads();
  }
}

}  // namespace

// rows: f32 [E, width] (contiguous); order: int32 [E], the rows sorted
// by cell (stable), or null for rows already in that order; start: int32
// [n_cells + 1], the first sorted row of each cell, start[n_cells] the
// first dropped one; out: f32 [n_cells, width]. group: lanes a cell, a
// power of two in [32, 1024]. Enqueues on `stream`; returns
// cudaGetLastError().
extern "C" int segment_sum_launch(const void* rows, int width,
                                  const void* order, const void* start,
                                  int n_cells, int group, void* out,
                                  void* stream) {
  if (width < 1 || n_cells < 0 || group < 32 || group > 1024 ||
      (group & (group - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_cells == 0) return 0;
  const int block = group > kMinBlock ? group : kMinBlock;
  const int per_block = block / group;
  const int grid = (n_cells + per_block - 1) / per_block;
  segment_sum_kernel<<<grid, block, block * sizeof(float),
                       (cudaStream_t)stream>>>(
      (const float*)rows, width, (const int*)order, (const int*)start,
      n_cells, group, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
