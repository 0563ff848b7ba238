// The int4 GEMV of the two TPU probes of the int4 kernels (sm_90a), one
// template with the H100's own parameters:
//
//   out (M, N) bf16 = x (M, K) bf16 @ unpack(W) (K, N) * scale (N,) f32
//
// with the sum in f32 and one rounding to bf16 after the scale.
//
//  * LAYOUT: I4 (row-interleaved bytes, row 2r low nibble, 2r+1 high: the
//    probe of `scripts/int4_native_probe.py`) or K4 (K-split, row r low,
//    r + K/2 high: `scripts/sweep_gemv_blocks.py`), K/2 byte rows either
//    row-major (K/2, ldw) or chunk-major (C, K/2, bn) (runtime `bn` > 0);
//  * COLS: byte columns a lane reads with one load (2 or 4: a block owns
//    TN = 64 or 128 output columns);
//  * UNROLL: weight rows each warp loads before it uses any (in flight);
//  * MT: activation rows a block stages and reuses (4, 8 or 16): at M rows
//    the grid has ceil(M / MT) row tiles, each reading every weight byte
//    once (the later ones through L2);
//  * UNPACK: SHIFT, the production kernels' two sign-extending shifts and
//    two int -> float conversions a byte (`gemv_common.cuh`), or MAGIC: the
//    byte's nibbles, sign bits flipped (u = level + 8, 0..15; one XOR a
//    word), placed in the mantissas of two bf16 halves of 128.0
//    (0x4300 | u = 128 + u) by one multiply-add and one LOP3, then 136.0
//    subtracted from both halves at once: exact for levels -8..7, and no
//    int -> float conversion (a quarter-rate unit) is left.
//
// Everything else is the production template's: 8 warps walk stripes of
// weight rows through pointers that step down the rows, the products are
// fused into f32 registers in the same order (low level, then high level,
// per row), and the 8 warps' partial sums meet in shared memory and are
// added in warp order. With COLS 2, UNROLL 8 and MT 4 the sums therefore
// run exactly as in `gemv_int4i.cu` (I4) and `gemv_int4.cu` (K4): both
// unpacks give the same floats, so the outputs are the production
// kernels' to the bit.
//
// Bound: weight bytes, K * N / 2 per call (3072 x 8192: 12.6 MB, 3.8 us at
// 3.35 TB/s) for M up to ~100; the M * K * N multiply-adds (2 * M per
// weight byte) stay far below the card's ~295 operations a byte.
#pragma once

#include "gemv_common.cuh"

namespace ua2 {
namespace probe {

constexpr int SHIFT = 0, MAGIC = 1;

// The two levels of byte j of `word` as floats (low nibble, high nibble).
// MAGIC expects `word` with every nibble's sign bit already flipped.
template <int UNPACK, typename T>
__device__ __forceinline__ void levels(T word, int j, float& lo, float& hi) {
  if constexpr (UNPACK == SHIFT) {
    const int b = (int)((word >> (8 * j)) & 0xffu);
    lo = (float)((int)(int8_t)(b << 4) >> 4);
    hi = (float)((int)(int8_t)b >> 4);
  } else {
    const unsigned v = ((unsigned)word >> (8 * j)) & 0xffu;
    // v * 0x1001 = v | v << 12: the low nibble in bits 0-3, the high one in
    // bits 16-19; then 0x4300 in both halves (one LOP3)
    const unsigned p = ((v * 0x1001u) & 0x000f000fu) | 0x43004300u;
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&p);
    h = __hsub2(h, __floats2bfloat162_rn(136.f, 136.f));
    const float2 f = __bfloat1622float2(h);
    lo = f.x;
    hi = f.y;
  }
}

template <int UNPACK, typename T>
__device__ __forceinline__ T flip_signs(T word) {
  if constexpr (UNPACK == MAGIC) return word ^ T(0x88888888u);
  return word;
}

__host__ inline int probe_smem(int K, int COLS, int MT) {
  return align16(MT * K * 2) + WARPS * MT * 32 * COLS * 4;
}

template <int LAYOUT, int COLS, int UNROLL, int MT, int UNPACK>
__global__ void __launch_bounds__(THREADS)
probe_gemv(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
           int M, int K, int N, int ldw, int bn) {
  static_assert(LAYOUT == I4 || LAYOUT == K4, "packed int4 rows only");
  using T = typename Word<COLS>::T;
  constexpr int TN = 32 * COLS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(MT * K * 2));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * TN, m0 = blockIdx.y * MT;
  const int rows = K / 2;
  for (int m = 0; m < MT; ++m) {
    const int row = m0 + m;
    for (int k = threadIdx.x; k < K; k += THREADS)
      xs[m * K + k] = row < M ? x[(size_t)row * K + k] : __float2bfloat16(0.f);
  }
  __syncthreads();
  // the block's tile: a slice of the row-major bytes, or of one chunk
  const int8_t* base = w + col0;
  int ld = ldw;
  if (bn > 0) {
    const int chunk = col0 / bn;
    base = w + (size_t)chunk * rows * bn + (col0 - chunk * bn);
    ld = bn;
  }
  const size_t step = (size_t)WARPS * ld;
  const int8_t* wp = base + (size_t)warp * ld + lane * COLS;
  float acc[MT][COLS] = {};
  for (int r0 = warp; r0 < rows; r0 += WARPS * UNROLL) {
    T word[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      word[u] = r0 + u * WARPS < rows
          ? __ldg(reinterpret_cast<const T*>(wp + u * step)) : T(0);
    wp += UNROLL * step;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * WARPS;
      if (r >= rows) break;
      float xa[MT], xb[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (LAYOUT == I4) {
          const float2 p = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + m * K + 2 * r));
          xa[m] = p.x;
          xb[m] = p.y;
        } else {
          xa[m] = bf(xs[m * K + r]);
          xb[m] = bf(xs[m * K + rows + r]);
        }
      }
      const T wu = flip_signs<UNPACK>(word[u]);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        float lo, hi;
        levels<UNPACK>(wu, j, lo, hi);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[m][j] = fmaf(xb[m], hi, fmaf(xa[m], lo, acc[m][j]));
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      red[(warp * MT + m) * TN + lane * COLS + j] = acc[m][j];
  __syncthreads();
  for (int t = threadIdx.x; t < MT * TN; t += THREADS) {
    const int row = m0 + t / TN, c = col0 + t % TN;
    if (row >= M || c >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) v += red[q * MT * TN + t];
    out[(size_t)row * N + c] = __float2bfloat16(v * scale[c]);
  }
}

// Host launcher; bn = 0 for row-major (K/2, ldw) bytes, else the chunk
// width of (C, K/2, bn) bytes. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for bytes the tiles cannot read.
template <int LAYOUT, int COLS, int UNROLL, int MT, int UNPACK>
inline int launch_probe(const void* x, const void* w, const void* scale, void* out,
                        int M, int K, int N, int ldw, int bn, cudaStream_t stream) {
  constexpr int TN = 32 * COLS;
  const int tiles = (N + TN - 1) / TN;
  if (K % 2 || (bn > 0 ? bn % TN != 0 : tiles * TN > ldw))
    return (int)cudaErrorInvalidValue;
  const int smem = probe_smem(K, COLS, MT);
  auto kernel = probe_gemv<LAYOUT, COLS, UNROLL, MT, UNPACK>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(tiles, (M + MT - 1) / MT), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, K, N,
      ldw, bn);
  return (int)cudaGetLastError();
}

}  // namespace probe
}  // namespace ua2
