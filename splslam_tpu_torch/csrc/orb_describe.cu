// orb_describe: fused ORB orientation + steered-BRIEF descriptor kernel.
//
// Replaces the TPU kernel splslam_tpu/ops/orb_pallas.py::extract_patches
// (a Pallas DMA + roll patch extractor) together with the XLA stage that
// consumes its output, describe_from_patches. One warp handles one
// keypoint, end to end:
//   1. stage the 40x40 bf16 patch of the packed blurred pyramid in shared
//      memory (as f32);
//   2. reduce the intensity-centroid moments m10 = sum dx*p, m01 = sum dy*p
//      over the r=15 circle around the patch centre C=19, in f32;
//   3. angle = atan2f(m01, m10); bin = rint(angle * 30/2pi) mod 30;
//   4. evaluate the 256 tests I(p1) < I(p2) on pixels re-centred as the
//      reference does: clamp(rint(p) - 128, -128, 127);
//   5. read the pair offsets for the keypoint's bin from a 30x256 table of
//      pre-rotated patch offsets in __constant__ memory (built on the host
//      with the reference's rounding, uploaded once);
//   6. pack the bits with __ballot_sync: lane j of word w tests pair 32w+j.
//
// What bounds it on an H100: per frame about 2000 keypoints x 3.2 KB of
// gathered patch bytes (6.4 MB, mostly L2 hits) plus 256 compares and a
// 2x800-term reduction per keypoint -- a latency- and gather-bound kernel,
// far from any FLOP limit. The design keeps the whole per-keypoint chain in
// one warp and in shared memory, so no patch ever goes back to device
// memory (the TPU path wrote every patch out and read it again for two
// matmuls). Open cost: the 32 lanes of a warp read 32 different table
// entries, which constant memory serves one address at a time; moving the
// table to shared or read-only global memory is a tuning step for later.
//
// Bound through a plain C interface (ctypes); it launches on the caller's
// stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 40;             // patch side, px
constexpr int kPix = kPatch * kPatch;  // 1600
constexpr int kCenter = 19;            // patch centre (= FAST border)
constexpr int kRadius = 15;            // IC-angle circle radius
constexpr int kBins = 30;              // pattern rotation bins
constexpr int kPairs = 256;            // descriptor bits
constexpr int kWords = kPairs / 32;    // 8 packed words
constexpr int kWarps = 4;              // keypoints per block
constexpr float kBinScale = (float)(30.0 / (2.0 * 3.14159265358979323846));

// [bin][pair][2]: flat patch offsets (row * 40 + col) of the two samples.
__constant__ uint16_t c_pairs[kBins * kPairs * 2];

__device__ __forceinline__ float recentre(float v) {
  return fminf(fmaxf(rintf(v) - 128.0f, -128.0f), 127.0f);
}

__global__ void __launch_bounds__(kWarps * 32)
orb_describe_kernel(const __nv_bfloat16* __restrict__ packed, int rows,
                    int cols, const int* __restrict__ corner_y,
                    const int* __restrict__ corner_x, int n,
                    float* __restrict__ angle, int* __restrict__ desc) {
  __shared__ float patch[kWarps][kPix];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= n) return;  // whole warp leaves together; no block barrier below
  float* p = patch[warp];

  const int y0 = min(max(corner_y[k], 0), rows - kPatch);
  const int x0 = min(max(corner_x[k], 0), cols - kPatch);
  const __nv_bfloat16* src = packed + (size_t)y0 * cols + x0;
  for (int i = lane; i < kPix; i += 32) {
    const int r = i / kPatch;
    p[i] = __bfloat162float(src[(size_t)r * cols + (i - r * kPatch)]);
  }
  __syncwarp();

  float m10 = 0.0f, m01 = 0.0f;
  for (int i = lane; i < kPix; i += 32) {
    const int dy = i / kPatch - kCenter;
    const int dx = i % kPatch - kCenter;
    if (dx * dx + dy * dy <= kRadius * kRadius) {
      m10 += (float)dx * p[i];
      m01 += (float)dy * p[i];
    }
  }
  // Reduce to lane 0, then broadcast: every lane must see the SAME sums
  // (a butterfly would give each lane its own rounding, hence its own bin).
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_down_sync(0xffffffffu, m10, off);
    m01 += __shfl_down_sync(0xffffffffu, m01, off);
  }
  m10 = __shfl_sync(0xffffffffu, m10, 0);
  m01 = __shfl_sync(0xffffffffu, m01, 0);

  const float ang = atan2f(m01, m10);
  int bin = (int)rintf(ang * kBinScale) % kBins;
  if (bin < 0) bin += kBins;
  if (lane == 0) angle[k] = ang;

  const uint16_t* table = c_pairs + bin * kPairs * 2;
  for (int w = 0; w < kWords; ++w) {
    const int s = w * 32 + lane;
    const float v1 = recentre(p[table[2 * s]]);
    const float v2 = recentre(p[table[2 * s + 1]]);
    const unsigned word = __ballot_sync(0xffffffffu, v1 < v2);
    if (lane == 0) desc[k * kWords + w] = (int)word;
  }
}

}  // namespace

// Uploads the [30][256][2] uint16 pair table to constant memory. Blocking;
// call once per process before the first launch. Returns a cudaError_t.
extern "C" int orb_describe_upload_table(const void* pairs) {
  const cudaError_t err = cudaMemcpyToSymbol(
      c_pairs, pairs, sizeof(uint16_t) * kBins * kPairs * 2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// packed: bf16 [rows, cols]; corner_y/x: int32 [n]; angle: f32 [n];
// desc: int32 [n, 8]. Enqueues on `stream`; returns cudaGetLastError().
extern "C" int orb_describe_launch(const void* packed, int rows, int cols,
                                   const void* corner_y, const void* corner_x,
                                   int n, void* angle, void* desc,
                                   void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarps - 1) / kWarps;
  orb_describe_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)packed, rows, cols, (const int*)corner_y,
      (const int*)corner_x, n, (float*)angle, (int*)desc);
  return (int)cudaGetLastError();
}

extern "C" const char* orb_describe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
