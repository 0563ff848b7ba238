// Batch-1 per-channel int8 GEMV, split over K, for sm_90a.
//
// Replaces: `_vpu_gemv_kernel` / `vpu_gemv` (scripts/profile_gemv.py:65-98),
// the TPU probe that computes the int8 GEMV on the vector unit instead of the
// matrix unit to ask whether the production kernel's layout of the reduction
// holds it back. Its H100 question: can an M = 1 int8 GEMV fill the 132 SMs
// and reach the 3.35 TB/s at the probe's shapes?
//
//   out (1, N) = bf16( sum_k x[k] * W[k, n]  (f32)  * scale[n] ),  n < N
//
// x (1, K) bf16, W (K, ldw) int8 with ldw >= N a multiple of 16 (the
// quantizer pads to 512), scale (N,) f32, out (1, N) bf16. Each product
// x[k] * W[k, n] is exact in f32 (8 + 7 significant bits), as in the
// interpret-mode Pallas kernel, and the sums are f32.
//
// Bound: the weight bytes, K * N (read once), against 3.35 TB/s: 25.2 MB at
// (3072, 8192), 7.5 us; the 2 * K * N operations are far below the tensor
// cores' rate.
//
// Design: the TMA-ring split-K GEMV of gemv_int4_stream.cuh, INT8, in one
// form (`namespace ring` below): the bytes by TMA into a ring one producer
// thread keeps full, four consumer warps on `mma.sync` in the split-K
// kernel's INT8 steps (16 byte rows a step, the conversion-free unpack), x
// staged once in 16-byte loads, the cluster's partials added in rank order
// through distributed shared memory: one launch, no workspace. On
// `quant.gemv_plan`'s slices (K % 16 == 0; N <= 8192 never takes the
// wide-N rule) it gives `quant.int8_matmul`'s bits.
//
// The first design stays as the yardstick, `ua2_gemv_int8_splitk_twopass`:
//  * pass 1, grid (N / 128 column tiles, S splits of K): a block of 256
//    threads owns 128 columns and a chunk of K rows; a thread owns 16
//    adjacent columns (one 16-byte load a row) and every 32nd row of the
//    chunk, four rows loaded before any is used; the levels become floats
//    by a byte permute and one subtraction (`fma16`), FMAs on the CUDA
//    cores; each block writes one f32 partial per column to a (S, N_tiles
//    * 128) workspace, with no atomics;
//  * pass 2 adds the S partials of a column in split order, scales and
//    rounds to bf16 once, so every run gives the same bits.
#include "gemv_int4_stream.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 16;             // int8 columns a thread loads at once
constexpr int GROUPS = 8;            // 16-column groups of a block
constexpr int TILE = COLS * GROUPS;  // 128 columns a block
constexpr int LANES = 32;            // row lanes of a block
constexpr int THREADS = GROUPS * LANES;
constexpr int UNROLL = 4;            // rows in flight per thread

// acc[j] += x * w_j for the 16 int8 levels of one 16-byte load. A level b
// becomes a float without a conversion instruction: the byte b ^ 0x80 = b +
// 128 placed under the exponent of 2^23 reads 2^23 + b + 128, and one
// subtraction leaves b exactly (the f32 conversion unit would run at an
// eighth of the FMA rate and bound the kernel).
__device__ __forceinline__ void fma16(float (&acc)[COLS], float x, uint4 wv) {
  const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = words[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b = __int_as_float(
          (int)__byte_perm(u, 0x4B000000u, j | 0x7440)) - 8388736.0f;
      acc[4 * i + j] = fmaf(x, b, acc[4 * i + j]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
splitk_partial(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               float* __restrict__ partial, int K, int N, int ldw, int chunk,
               int stride) {
  __shared__ float red[LANES][TILE + 4];
  const int grp = threadIdx.x % GROUPS, lane = threadIdx.x / GROUPS;
  const int col = blockIdx.x * TILE + grp * COLS;
  const int k_lo = blockIdx.y * chunk;
  const int k_hi = min(K, k_lo + chunk);
  float acc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) acc[j] = 0.f;
  if (col < N) {
    const int8_t* wp = w + (size_t)col;
    int k = k_lo + lane;
    for (; k + (UNROLL - 1) * LANES < k_hi; k += UNROLL * LANES) {
      uint4 wv[UNROLL];
      float xv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        wv[u] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(k + u * LANES) * ldw));
        xv[u] = __bfloat162float(x[k + u * LANES]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) fma16(acc, xv[u], wv[u]);
    }
    for (; k < k_hi; k += LANES)
      fma16(acc, __bfloat162float(x[k]),
            __ldg(reinterpret_cast<const uint4*>(wp + (size_t)k * ldw)));
  }
#pragma unroll
  for (int j = 0; j < COLS; ++j) red[lane][grp * COLS + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < TILE) {
    float s = 0.f;
    for (int r = 0; r < LANES; ++r) s += red[r][threadIdx.x];
    partial[(size_t)blockIdx.y * stride + blockIdx.x * TILE + threadIdx.x] = s;
  }
}

__global__ void splitk_finish(const float* __restrict__ partial,
                              const float* __restrict__ scale,
                              __nv_bfloat16* __restrict__ out, int N, int splits,
                              int stride) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += partial[(size_t)i * stride + n];
  out[n] = __float2bfloat16_rn(s * scale[n]);
}

namespace st = ua2::stream;

// The ring's form, chosen by the (3072, 8192) time among eight (PERF.md):
// 64-column tiles, boxes of 64 pairs of rows (128 byte rows), a 4-stage
// ring, `quant.gemv_plan`'s slices, the conversion-free unpack
// (`ops/splitk_gemv.py` FORM).
namespace ring {
constexpr int TN = 64, BK = 64, STAGES = 4, UNPACK = st::MAGIC;
}

}  // namespace

// x (M, K) bf16, w (K, ldw) int8, scale (N,) f32, out (M, N) bf16 on the
// ring, `splits` K-slices of `span` pairs of rows (`int4_stream.stream_plan`,
// INT8).
extern "C" int ua2_gemv_int8_splitk(const void* x, const void* w, const void* scale,
                                    void* out, int M, int K, int N, int ldw, int splits,
                                    int span, void* stream) {
  return st::launch<ua2::INT8, ring::TN, ring::BK, ring::STAGES, ring::UNPACK>(
      x, w, scale, out, M, K, N, ldw, 0, splits, span, static_cast<cudaStream_t>(stream));
}

// The first design. x (1, K) bf16, w (K, ldw) int8, scale (N,) f32,
// partial (splits, ceil(N / 128) * 128) f32 scratch, out (1, N) bf16; K
// rows split into `splits` chunks of `chunk` rows (chunk % 32 == 0,
// splits * chunk >= K). Returns cudaGetLastError() (cudaErrorInvalidValue
// for a bad plan or ldw).
extern "C" int ua2_gemv_int8_splitk_twopass(const void* x, const void* w, const void* scale,
                                            void* partial, void* out, int K, int N, int ldw,
                                            int splits, int chunk, void* stream) {
  if (K <= 0 || N <= 0 || ldw < N || ldw % COLS || chunk <= 0 || chunk % LANES ||
      splits <= 0 || (long long)splits * chunk < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (N + TILE - 1) / TILE;
  const int stride = tiles * TILE;
  splitk_partial<<<dim3(tiles, splits), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(partial), K, N, ldw, chunk, stride);
  splitk_finish<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), N, splits, stride);
  return (int)cudaGetLastError();
}
