// orb_describe: ORB orientation + steered-BRIEF descriptors for every
// keypoint slot of one or two images, read straight from their unblurred
// float32 pyramid levels.
//
// Replaces the TPU kernel splslam_tpu/ops/orb_pallas.py::extract_patches
// (a Pallas DMA + roll patch extractor over the packed blurred pyramid)
// together with the XLA stage that consumes its patches,
// describe_from_patches, and the stages of splslam_tpu/ops/orb.py::
// extract_orb that only feed them: the 7x7 blur of every level, the
// packing of the levels into one bf16 buffer and the patch-corner
// arithmetic. The results are those of the plain version in
// ops/orb_kernel.py (blur, pack, clamp the corner, gather, moments, bin,
// tests), for every slot, valid or not.
//
// One block of 128 threads serves one slot; the grid covers the B x N
// slots of B images in one launch. Per slot:
//   1. the slot's level (from the per-level budgets) and its patch corner
//      in the packed buffer the reference builds, clamped as it clamps;
//   2. the patch's 40 packed rows map to segments: a run of rows of one
//      level, or the 8 zero rows under the last level. A patch of a slot
//      at y < 19 on a level > 0 starts in the previous level, and one on
//      the bottom border ends one row into the next; each segment blurs
//      with its own +-3-row halo from its own level. Columns at or past
//      the level's width read 0, as the packing's zero padding does;
//   3. per segment, the blur input window (rows + 6) x 46 f32 comes into
//      shared memory with 4-byte cp.async copies, zero-filled outside the
//      level (the blur's zero padding). Then the vertical pass, then the
//      horizontal pass, taps summed in order from 0 with every multiply
//      and add written as __fmul_rn / __fadd_rn (nvcc would otherwise
//      contract them into FMAs, and one ulp flips a bf16 pixel), rounded
//      to bf16 (RNE, as .to(torch.bfloat16)) into the 40x40 bf16 patch.
//      In each pass a thread takes a run of 10 outputs along a column or
//      a row: it reads the run's 16 inputs from shared memory into
//      registers once, instead of 7 reads an output;
//   4. intensity-centroid moments over the r=15 circle in f32, summed by
//      the thread that writes each patch pixel, reduced to lane 0 of each
//      warp, then summed in one fixed order by every thread, so all
//      threads see one rounding and pick one bin;
//   5. angle = atan2f(m01, m10); bin = rint(angle * 30/2pi) mod 30;
//   6. the 256 tests I(p1) < I(p2) on pixels re-centred as the reference
//      does, clamp(rint(p) - 128, -128, 127); pair offsets come from a
//      30x256 table of pre-rotated patch offsets in device memory (two
//      uint16 in one word), read through the read-only path (__ldg: 30 KB
//      that stays in L1), so a warp's 32 lanes read 32 consecutive words;
//      bits packed with __ballot_sync, warp w writing words 2w and 2w+1.
//
// What bounds it on an H100: the inputs are 2 x 1,444,097 f32 pixels at
// KITTI 1241x376 with 8 levels, 11.6 MB, 3.45 us at 3.35 TB/s; the blur
// of 2 x 2000 patches is about 48 k float32 multiplies and adds each,
// 0.19 GFLOP, 2.9 us at 67 TFLOP/s. So the bound is the bytes, about
// 3.5 us a stereo frame. It runs at about 13% of that (0.027 ms on an
// H100 80GB HBM3 at 700 W; scripts/orb_kernel_stages.py times copies
// of this file cut after each stage): ~4 us of launch, ~7 us of window
// copies (each slot copies its own 46x46 window, three times the
// levels' bytes in all, as windows overlap), ~14 us of blur passes,
// which run as separate float32 multiplies and adds (no FMA, for
// exactness: 14 instructions an output), and ~2.5 us of moments and
// tests. ~20 KB of shared memory a block leaves 11 slots resident on
// an SM.
//
// Design choices:
// - cp.async, not TMA: a tensor map needs 16-byte-multiple row strides,
//   and a level of width 1241 (4964 B a row) has none; TMA would need the
//   padded copy this kernel exists to avoid. 4-byte copies take any
//   alignment, and the zero fill outside the level is a plain store.
// - Row strides are odd in 4-byte words (47 for the f32 window and the
//   vertical result, 21 words = 42 bf16 for the patch), so the 32 lanes
//   of a warp, which take 32 consecutive columns in the vertical pass and
//   32 consecutive rows in the horizontal one, hit 32 distinct banks.
// - The patch is held in bf16, the type the descriptor reads. Its
//   p[offset] reads follow 256 random Gaussian pairs under 30 rotations;
//   no fixed layout spreads all 30 bins' lanes over distinct banks, and
//   the 16 reads a slot makes are a few hundred cycles against the blur's
//   thousands, so they keep the row layout.
// - No tensor cores: per slot the work is a 7-tap separable stencil, two
//   dot products of 1,600 and 256 compares, which is no matrix product.
//   wgmma would need the pair tests written as the TPU's one-hot table
//   matmul, 30x the arithmetic.
//
// Bound through a plain C interface (ctypes); it launches on the caller's
// stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 40;             // patch side, px
constexpr int kCenter = 19;            // patch centre (= FAST border)
constexpr int kRadius = 15;            // IC-angle circle radius
constexpr int kBins = 30;              // pattern rotation bins
constexpr int kPairs = 256;            // descriptor bits
constexpr int kWords = kPairs / 32;    // 8 packed words
constexpr int kTaps = 7;               // blur taps
constexpr int kHalo = kTaps / 2;       // 3
constexpr int kWin = kPatch + 2 * kHalo;  // 46: blur window side
constexpr int kStride = kWin + 1;      // 47: odd f32 row stride of win, vert
constexpr int kPStride = kPatch + 2;   // 42: bf16 patch row stride (21 words)
constexpr int kRun = 10;               // outputs a thread takes in a pass
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxImages = 2;
constexpr int kMaxLevels = 16;
constexpr int kPadRows = 8;            // zero rows under the packed levels
constexpr float kBinScale = (float)(30.0 / (2.0 * 3.14159265358979323846));

// Passed by value: the level pointers of every image and the geometry of
// the packed buffer the reference would build.
struct Pyramid {
  const float* level[kMaxImages][kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  int row_off[kMaxLevels + 1];  // first packed row of each level; [L] = sum H
  int slot_end[kMaxLevels];     // one past each level's last slot
  float taps[kTaps];
  int n_levels;
  int packed_rows;              // sum H + 8
  int packed_cols;              // level 0's width padded to 128
  int n;                        // slots per image
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A pair table offset (row * 40 + col) in the patch's padded rows.
__device__ __forceinline__ unsigned at(unsigned o) {
  return o + (kPStride - kPatch) * (o / kPatch);
}

__device__ __forceinline__ float recentre(float v) {
  return fminf(fmaxf(rintf(v) - 128.0f, -128.0f), 127.0f);
}

__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(const Pyramid pyr, const float* __restrict__ xy,
                    const uint32_t* __restrict__ pairs,
                    float* __restrict__ angle, int* __restrict__ desc) {
  __shared__ float win[kWin * kStride];     // blur input window of a segment
  __shared__ float vert[kPatch * kStride];  // after the vertical pass
  __shared__ __align__(4) __nv_bfloat16 patch[kPatch * kPStride];
  __shared__ float red[2][kWarps];          // per-warp moment sums

  const int tid = threadIdx.x;
  const int img = blockIdx.x / pyr.n;
  const int k = blockIdx.x - img * pyr.n;

  // 1. The slot's level and its patch corner in the packed buffer.
  int lv = 0;
  while (k >= pyr.slot_end[lv]) ++lv;
  const int acc = pyr.row_off[pyr.n_levels];
  const int xi = __float2int_rz(xy[2 * (size_t)blockIdx.x]);
  const int yi = __float2int_rz(xy[2 * (size_t)blockIdx.x + 1]);
  int cy = min(max(yi - kCenter + pyr.row_off[lv], 0), acc - kPatch);
  cy = min(max(cy, 0), pyr.packed_rows - kPatch);
  const int cx = min(max(xi - kCenter, 0), pyr.packed_cols - kPatch);

  // 2-4. Blur the patch segment by segment; the horizontal pass also
  // takes this thread's share of the moments.
  float m10 = 0.0f, m01 = 0.0f;
  int i = 0;  // next patch row
  while (i < kPatch) {
    const int r = cy + i;  // packed row
    if (r >= acc) {        // the zero rows under the last level
      for (int j = tid; j < (kPatch - i) * kPStride; j += kThreads)
        patch[i * kPStride + j] = __float2bfloat16_rn(0.0f);
      break;
    }
    int sl = 0;
    while (r >= pyr.row_off[sl + 1]) ++sl;
    const int H = pyr.height[sl];
    const int W = pyr.width[sl];
    const int y0 = r - pyr.row_off[sl];       // the segment's first level row
    const int rows = min(kPatch - i, H - y0);  // patch rows this level holds
    const int wrows = rows + 2 * kHalo;

    // Window: level rows y0-3 .. y0+rows+2, columns cx-3 .. cx+42; two
    // threads a column, each every other row.
    if (tid < 2 * kWin) {
      const int wc = tid % kWin;
      const int x = cx - kHalo + wc;
      const bool col_in = x >= 0 && x < W;
      int wr = tid / kWin;
      int y = y0 - kHalo + wr;
      const float* src = pyr.level[img][sl] + (ptrdiff_t)y * W + x;
      float* dst = win + wr * kStride + wc;
      for (; wr < wrows; wr += 2, y += 2, src += 2 * W, dst += 2 * kStride) {
        if (col_in && y >= 0 && y < H)
          cp_async4(dst, src);
        else
          *dst = 0.0f;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // Vertical pass: a thread takes kRun rows of one window column.
    const int runs = (rows + kRun - 1) / kRun;
    for (int item = tid; item < runs * kWin; item += kThreads) {
      const int run = item / kWin;
      const int c = item - run * kWin;
      const int r0 = run * kRun;
      float v[kRun + kTaps - 1];
#pragma unroll
      for (int u = 0; u < kRun + kTaps - 1; ++u)
        v[u] = r0 + u < wrows ? win[(r0 + u) * kStride + c] : 0.0f;
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < kTaps; ++t)
          s = __fadd_rn(s, __fmul_rn(pyr.taps[t], v[u + t]));
        if (r0 + u < rows) vert[(r0 + u) * kStride + c] = s;
      }
    }
    __syncthreads();

    // Horizontal pass: a thread takes kRun columns of one patch row.
    for (int item = tid; item < rows * (kPatch / kRun); item += kThreads) {
      const int run = item / rows;
      const int pr = item - run * rows;
      const int c0 = run * kRun;
      const float* w = vert + pr * kStride + c0;
      float v[kRun + kTaps - 1];
#pragma unroll
      for (int u = 0; u < kRun + kTaps - 1; ++u) v[u] = w[u];
      const int dy = i + pr - kCenter;
      __nv_bfloat16* out = patch + (i + pr) * kPStride + c0;
#pragma unroll
      for (int u = 0; u < kRun; u += 2) {
        __nv_bfloat16 b[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = 0.0f;
#pragma unroll
          for (int t = 0; t < kTaps; ++t)
            s = __fadd_rn(s, __fmul_rn(pyr.taps[t], v[u + e + t]));
          b[e] = __float2bfloat16_rn(cx + c0 + u + e < W ? s : 0.0f);
          const int dx = c0 + u + e - kCenter;
          if (dx * dx + dy * dy <= kRadius * kRadius) {
            const float f = __bfloat162float(b[e]);
            m10 += (float)dx * f;
            m01 += (float)dy * f;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(out + u) = __halves2bfloat162(b[0], b[1]);
      }
    }
    i += rows;
    __syncthreads();  // win and vert are refilled by the next segment
  }
  __syncthreads();

  // Moments: warp sums to lane 0, then the 4 warps in one fixed order.
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_down_sync(0xffffffffu, m10, off);
    m01 += __shfl_down_sync(0xffffffffu, m01, off);
  }
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (lane == 0) {
    red[0][warp] = m10;
    red[1][warp] = m01;
  }
  __syncthreads();
  m10 = red[0][0];
  m01 = red[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    m10 += red[0][w];
    m01 += red[1][w];
  }

  // 5. Angle and bin.
  const float ang = atan2f(m01, m10);
  int bin = (int)rintf(ang * kBinScale) % kBins;
  if (bin < 0) bin += kBins;
  if (tid == 0) angle[blockIdx.x] = ang;

  // 6. The 256 tests; warp w packs words 2w and 2w+1.
  const uint32_t* row = pairs + bin * kPairs;
#pragma unroll
  for (int h = 0; h < kWords / kWarps; ++h) {
    const int word = warp * (kWords / kWarps) + h;
    const uint32_t o = __ldg(row + word * 32 + lane);
    const float v1 = recentre(__bfloat162float(patch[at(o & 0xffffu)]));
    const float v2 = recentre(__bfloat162float(patch[at(o >> 16)]));
    const unsigned bits = __ballot_sync(0xffffffffu, v1 < v2);
    if (lane == 0) desc[(size_t)blockIdx.x * kWords + word] = (int)bits;
  }
}

}  // namespace

// level_ptrs: uint64 [n_images * n_levels] device pointers of the f32
// levels, image-major; dims: int32 [n_levels * 2] (H, W per level);
// budgets: int32 [n_levels] slots per level, summing to n; taps: f32 [7];
// xy: f32 [n_images, n, 2]; pairs: uint32 [30 * 256]; angle: f32
// [n_images, n]; desc: int32 [n_images, n, 8]. Host arrays are read
// before the call returns. Enqueues on `stream`; returns
// cudaGetLastError().
extern "C" int orb_describe_launch(const void* level_ptrs, const void* dims,
                                   const void* budgets, int n_levels,
                                   const void* taps, int n_images, int n,
                                   const void* xy, const void* pairs,
                                   void* angle, void* desc, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_images < 1 ||
      n_images > kMaxImages)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const uint64_t* ptr = (const uint64_t*)level_ptrs;
  const int* d = (const int*)dims;
  const int* b = (const int*)budgets;
  Pyramid p = {};
  int acc = 0, slots = 0;
  for (int l = 0; l < n_levels; ++l) {
    for (int im = 0; im < n_images; ++im)
      p.level[im][l] = (const float*)ptr[im * n_levels + l];
    p.height[l] = d[2 * l];
    p.width[l] = d[2 * l + 1];
    p.row_off[l] = acc;
    acc += p.height[l];
    slots += b[l];
    p.slot_end[l] = slots;
  }
  p.row_off[n_levels] = acc;
  if (slots != n || acc + kPadRows < kPatch) return (int)cudaErrorInvalidValue;
  for (int t = 0; t < kTaps; ++t) p.taps[t] = ((const float*)taps)[t];
  p.n_levels = n_levels;
  p.packed_rows = acc + kPadRows;
  p.packed_cols = (p.width[0] + 127) / 128 * 128;
  p.n = n;
  orb_describe_kernel<<<n_images * n, kThreads, 0, (cudaStream_t)stream>>>(
      p, (const float*)xy, (const uint32_t*)pairs, (float*)angle, (int*)desc);
  return (int)cudaGetLastError();
}

// Resident blocks (slots) per SM at the launch configuration, or -1.
extern "C" int orb_describe_occupancy(void) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, orb_describe_kernel, kThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

extern "C" const char* orb_describe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
