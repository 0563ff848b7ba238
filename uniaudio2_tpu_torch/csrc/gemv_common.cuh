// Shared device code of the port's GEMV-shaped kernels (sm_90a).
//
// Every kernel of the serving path is a GEMV over quantized weights with a
// prologue (RMSNorm of the activation rows) and an epilogue (scale, RoPE,
// SwiGLU or residual). At decode (M = 1 or 2) each weight byte is read once
// per call and used for M multiply-adds, so the kernels are bound by weight
// bytes from HBM (3.35 TB/s on an H100 SXM), not by arithmetic.
//
// Two template parameters say how the weights are stored:
//  * LAYOUT: INT8 (one level a byte, K byte rows); I4 (row-interleaved
//    int4: byte [r, c] = row 2r low nibble, row 2r+1 high, K/2 byte rows);
//    K4 (K-split int4: byte [r, c] = row r low, row r + K/2 high, K/2 byte
//    rows); C4 (column-packed int4: byte [k, c] = column c low, column
//    c + N/2 high, K byte rows, so one byte feeds two output columns);
//  * GROUPED: false = one f32 scale per output column, applied to the f32
//    sum of the unscaled levels; true = one scale per `K / G` input rows
//    and output column (scale (G, N)): the level is multiplied by its f32
//    scale and rounded to bf16 BEFORE the product, as the Pallas kernels
//    round the scaled tile to x.dtype, so the sum needs no scale after.
//    Group of a byte's two levels: I4 both (2r) / group; K4 r / group and
//    G/2 + r / group; C4 both k / group, columns c and N/2 + c.
//
// Design, common to all of them:
//  * a block owns a tile of TN = 32 * COLS byte columns and MT = 4
//    activation rows; the grid is (column tiles, row tiles), so any M works
//    (prefill calls these with M = 63 or 255; every row tile reads the
//    weights again, through L2);
//  * the block stages its MT activation rows once in shared memory as bf16,
//    folding the RMSNorm there (f32 statistics, the result rounded to bf16
//    as the Pallas kernels round it to x.dtype), and, when GROUPED, its
//    (G, TN) tile of the scales as f32;
//  * each of the 8 warps walks its own stripe of weight rows; a lane reads
//    COLS adjacent bytes of a row (2 or 4 bytes, one load), so a warp reads
//    64 or 128 contiguous bytes of every row it visits, and eight rows are
//    loaded before any is used, through pointers that walk down the rows
//    (no multiply per load), to keep loads in flight: on the int8 lm_head
//    (395 MB) four rows with an index multiply read 0.39 ms, eight rows
//    with walking pointers 0.28 ms (H100 80GB HBM3, 700 W);
//  * the int4 bytes are unpacked with two sign-extending shifts, multiplied
//    in f32 with the bf16 activations and summed in f32 registers;
//  * the 8 warps' partial sums meet in shared memory and are added in a
//    fixed order (deterministic, no atomics) before the epilogue.
//
// This is the simple, correct first version: no TMA, no wgmma, no split-K
// across blocks (a narrow N therefore fills fewer SMs than the card has).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ua2 {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 4;       // activation rows per block
constexpr int UNROLL = 8;   // weight rows in flight per warp

// Weight layouts (the numbers are part of the C interface).
constexpr int INT8 = 0, I4 = 1, K4 = 2, C4 = 3;

// Accumulators (and scale tiles) per weight matrix: a C4 byte feeds two
// output columns, low nibble first.
__host__ __device__ constexpr int nacc(int layout) { return layout == C4 ? 2 : 1; }

template <int COLS> struct Word;
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned int; };

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Shared-memory bytes: staged activations + per-warp partial sums of NA
// accumulator sets + `extra` bytes for an epilogue + NA scale tiles of G
// rows (G = 0: per-channel scales, nothing staged).
__host__ inline int smem_bytes(int K, int COLS, int NA, int extra = 0, int G = 0) {
  return align16(MT * K * 2) + NA * WARPS * MT * 32 * COLS * 4 + extra +
         NA * G * 32 * COLS * 4;
}

// Raise the dynamic shared-memory cap of `kernel` when `bytes` > 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to bf16 and back: the rounding of a group-scaled weight.
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Sum of `v` over the block, the same value in every thread. `red` holds
// WARPS floats and may be reused by the next call.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s += red[i];
  return s;
}

// Stage rows [m0, m0 + MT) of x (M x K bf16) into xs (MT x K bf16). With
// `nw`, each row is RMS-normalised in f32 and scaled by nw, then rounded to
// bf16. Rows at or past M are zero.
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ nw,
                                           int M, int K, int m0, float eps,
                                           __nv_bfloat16* xs, float* red) {
  for (int m = 0; m < MT; ++m) {
    __nv_bfloat16* dst = xs + m * K;
    const int row = m0 + m;
    if (row >= M) {
      for (int k = threadIdx.x; k < K; k += THREADS) dst[k] = __float2bfloat16(0.f);
      continue;
    }
    const __nv_bfloat16* src = x + (size_t)row * K;
    if (nw == nullptr) {
      for (int k = threadIdx.x; k < K; k += THREADS) dst[k] = src[k];
      continue;
    }
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += THREADS) {
      const float v = bf(src[k]);
      ss += v * v;
    }
    const float r = rsqrtf(block_sum(ss, red) / (float)K + eps);
    for (int k = threadIdx.x; k < K; k += THREADS)
      dst[k] = __float2bfloat16(bf(src[k]) * r * bf(nw[k]));
  }
  __syncthreads();
}

// Stage the block's tile of one weight's grouped scales (G x N f32, row
// stride N) into `st`: nacc(LAYOUT) tiles of G x TN floats. Tile a, entry
// (g, t) is scale[g, first_a + t], where the first column is col0 and, for
// the high nibbles of C4, N/2 + col0. Columns past the true width read 1
// (their levels are the storage's zero padding).
template <int COLS, int LAYOUT>
__device__ __forceinline__ void stage_scales(const float* __restrict__ scale,
                                             int N, int G, int col0, float* st) {
  constexpr int TN = 32 * COLS;
  const int nh = N / 2;
  for (int a = 0; a < nacc(LAYOUT); ++a) {
    const int first = a == 0 ? col0 : nh + col0;
    const int end = LAYOUT == C4 ? (a == 0 ? nh : N) : N;
    for (int i = threadIdx.x; i < G * TN; i += THREADS) {
      const int g = i / TN, c = first + i % TN;
      st[(a * G + g) * TN + i % TN] = c < end ? scale[(size_t)g * N + c] : 1.f;
    }
  }
  __syncthreads();
}

// Partial sums of this thread: NW weight matrices (same layout, sharing the
// staged activations), MT rows, COLS byte columns starting at tile column
// `lc` (global byte column `col`). Accumulator set q * nacc + a belongs to
// matrix q, nibble a (a = 1 only for C4's high nibbles). When GROUPED, `st`
// holds NW * nacc staged scale tiles of G x TN floats, in that order.
template <int COLS, int NW, int LAYOUT, bool GROUPED>
__device__ __forceinline__ void gemv_partial(
    const __nv_bfloat16* xs, int K, const int8_t* const (&w)[NW], int ldw, int col,
    const float* st, int G, float (&acc)[NW * nacc(LAYOUT)][MT][COLS]) {
  static_assert(!(GROUPED && LAYOUT == INT8), "int8 has per-channel scales only");
  using T = typename Word<COLS>::T;
  constexpr int TN = 32 * COLS;
  constexpr int NA = nacc(LAYOUT);
  const int warp = threadIdx.x >> 5;
  const int lc = (threadIdx.x & 31) * COLS;
  const int rows = (LAYOUT == I4 || LAYOUT == K4) ? K / 2 : K;
  const int group = GROUPED ? K / G : 1;
  const size_t step = (size_t)WARPS * ldw;        // bytes between a warp's rows
  const int8_t* wp[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) wp[q] = w[q] + (size_t)warp * ldw + col;
  for (int r0 = warp; r0 < rows; r0 += WARPS * UNROLL) {
    T word[NW][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * WARPS;
#pragma unroll
      for (int q = 0; q < NW; ++q)
        word[q][u] = r < rows
            ? __ldg(reinterpret_cast<const T*>(wp[q] + u * step))
            : T(0);
    }
#pragma unroll
    for (int q = 0; q < NW; ++q) wp[q] += UNROLL * step;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * WARPS;
      if (r >= rows) break;
      // the activations of the byte's low (xa) and high (xb) level, and
      // the scale group of each
      float xa[MT], xb[MT];
      int ga = 0, gb = 0;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (LAYOUT == I4) {
          const float2 p = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + m * K + 2 * r));
          xa[m] = p.x;
          xb[m] = p.y;
        } else if constexpr (LAYOUT == K4) {
          xa[m] = bf(xs[m * K + r]);
          xb[m] = bf(xs[m * K + rows + r]);
        } else {
          xa[m] = xb[m] = bf(xs[m * K + r]);
        }
      }
      if constexpr (GROUPED) {
        ga = (LAYOUT == I4 ? 2 * r : r) / group;
        gb = LAYOUT == K4 ? G / 2 + ga : ga;
      }
#pragma unroll
      for (int q = 0; q < NW; ++q) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int b = (int)((word[q][u] >> (8 * j)) & 0xffu);
          if constexpr (LAYOUT == INT8) {
            const float wv = (float)(int8_t)b;
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[q][m][j] = fmaf(xa[m], wv, acc[q][m][j]);
          } else {
            float lo = (float)((int)(int8_t)(b << 4) >> 4);
            float hi = (float)((int)(int8_t)b >> 4);
            if constexpr (GROUPED) {
              lo = round_bf(lo * st[((q * NA) * G + ga) * TN + lc + j]);
              hi = round_bf(hi * st[((q * NA + NA - 1) * G + gb) * TN + lc + j]);
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if constexpr (LAYOUT == C4) {
                acc[q * NA][m][j] = fmaf(xa[m], lo, acc[q * NA][m][j]);
                acc[q * NA + NA - 1][m][j] = fmaf(xb[m], hi, acc[q * NA + NA - 1][m][j]);
              } else {
                acc[q][m][j] = fmaf(xb[m], hi, fmaf(xa[m], lo, acc[q][m][j]));
              }
            }
          }
        }
      }
    }
  }
}

// Park every warp's partial sums in `red` (NA x WARPS x MT x TN floats).
template <int COLS, int NA>
__device__ __forceinline__ void park_partials(const float (&acc)[NA][MT][COLS],
                                              float* red) {
  constexpr int TN = 32 * COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NA; ++q)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        red[((q * WARPS + warp) * MT + m) * TN + lane * COLS + j] = acc[q][m][j];
  __syncthreads();
}

// Sum over warps, in warp order, of accumulator set q's partial at tile
// entry t.
template <int COLS>
__device__ __forceinline__ float warp_total(const float* red, int q, int t) {
  constexpr int TN = 32 * COLS;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[(q * WARPS + w) * MT * TN + t];
  return s;
}

// The GEMV kernel: out[m, c] = sum_k xs[m, k] * W[k, c] * scale (+ res[m, c]),
// c < N, for one (column tile, row tile). For C4 a tile of TN byte columns
// gives the output columns [col0, col0 + TN) and N/2 + the same.
template <int COLS, int LAYOUT, bool GROUPED, bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, const __nv_bfloat16* __restrict__ nw,
            const __nv_bfloat16* __restrict__ res, void* __restrict__ out,
            int M, int K, int N, int ldw, int G, float eps) {
  constexpr int TN = 32 * COLS;
  constexpr int NA = nacc(LAYOUT);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(MT * K * 2));
  float* st = red + NA * WARPS * MT * TN;
  const int col0 = blockIdx.x * TN, m0 = blockIdx.y * MT;
  stage_rows(x, nw, M, K, m0, eps, xs, red);
  if (GROUPED) stage_scales<COLS, LAYOUT>(scale, N, G, col0, st);
  float acc[NA][MT][COLS] = {};
  const int8_t* const ws[1] = {w};
  gemv_partial<COLS, 1, LAYOUT, GROUPED>(xs, K, ws, ldw,
                                         col0 + (threadIdx.x & 31) * COLS, st, G, acc);
  park_partials<COLS, NA>(acc, red);
  const int nh = N / 2;
  for (int t = threadIdx.x; t < NA * MT * TN; t += THREADS) {
    const int a = t / (MT * TN), tt = t % (MT * TN);
    const int m = tt / TN, cb = col0 + tt % TN, row = m0 + m;
    if (row >= M) continue;
    int c = cb;
    if (LAYOUT == C4) {
      if (cb >= (a == 0 ? nh : N - nh)) continue;
      c = a == 0 ? cb : nh + cb;
    } else if (cb >= N) {
      continue;
    }
    float v = warp_total<COLS>(red, a, tt);
    if (!GROUPED) v *= scale[c];
    if (res != nullptr) v += bf(res[(size_t)row * N + c]);
    if (OUT_F32)
      reinterpret_cast<float*>(out)[(size_t)row * N + c] = v;
    else
      reinterpret_cast<__nv_bfloat16*>(out)[(size_t)row * N + c] = __float2bfloat16(v);
  }
}

// Host launcher of gemv_kernel (COLS = 2: 64-column tiles, the most blocks
// for the narrow decode GEMVs). G = 0 for per-channel scales. Returns
// cudaGetLastError().
template <int LAYOUT, bool GROUPED>
inline int launch_gemv(const void* x, const void* w, const void* scale,
                       const void* nw, const void* res, void* out, int M, int K,
                       int N, int ldw, int G, float eps, int out_f32,
                       cudaStream_t stream) {
  constexpr int COLS = 2, TN = 32 * COLS;
  if (GROUPED != (G > 0)) return (int)cudaErrorInvalidValue;
  const int width = LAYOUT == C4 ? N - N / 2 : N;   // byte columns in use
  const dim3 grid((width + TN - 1) / TN, (M + MT - 1) / MT);
  const int smem = smem_bytes(K, COLS, nacc(LAYOUT), 0, G);
  auto args = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(nw),
        static_cast<const __nv_bfloat16*>(res), out, M, K, N, ldw, G, eps);
    return (int)cudaGetLastError();
  };
  return out_f32 ? args(gemv_kernel<COLS, LAYOUT, GROUPED, true>)
                 : args(gemv_kernel<COLS, LAYOUT, GROUPED, false>);
}

}  // namespace ua2
