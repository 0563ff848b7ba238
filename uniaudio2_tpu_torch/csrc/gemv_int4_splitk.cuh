// Split-K int4 GEMV for the decode rows of the row-interleaved (I4) and
// K-split (K4) layouts, for sm_90a, on the tensor cores. Included by
// gemv_int4i.cu, gemv_int4g.cu and gemv_int4.cu only.
//
//   out (M, N) = [rmsnorm(x)] (M, K) @ unpack(W) (K, N) * scale [+ res]
//
// Bound: weight bytes. At decode (M <= 16) a call reads K*N/2 bytes once
// (3072 -> 2048: 3.1 MB, 0.94 us at 3.35 TB/s) for 2*M operations a byte.
// The tiled template of gemv_common.cuh gives such a call one block per 64
// columns (32 blocks at N = 2048 for 132 SMs), each walking all K/2 byte
// rows in ~24 dependent rounds of loads, and spends a shift pair, an
// int -> float conversion and M FMAs on every level.
//
// Design:
//  * the grid is (column tiles of TN = 64, S K-slices, tiles of 16
//    activation rows), launched as clusters of the S slices of one tile
//    (cudaLaunchKernelEx, S <= 8). The host (`quant.gemv_plan`) picks S and
//    the slice length `span` from the shape and the SM count; a grouped
//    slice holds whole groups;
//  * products on the tensor cores: mma.sync m16n8k16 (bf16 in, f32 sums)
//    with the up to 16 activation rows as A, so a call of M <= 16 rows
//    reads each weight byte once and spends no more work at M = 16 than at
//    M = 1. A warp step takes 8 byte rows (k = 16) of the block's 64
//    columns: a lane loads 8 bytes (8 columns) of rows t and t + 4
//    (t = lane % 4), so four lanes cover the step's rows of one 8-column
//    group and a warp reads 4 x 64 contiguous bytes a load;
//  * unpack without conversions: XOR 0x88888888 makes the nibbles offset
//    (n + 8); a byte permute pairs a byte of row t with the same column's
//    byte of row t + 4, and one LOP3 puts two nibbles (the same column,
//    rows t and t + 4) under the bf16 exponent of 128, one bf16x2 FMA
//    subtracts 136: the exact levels as one B register. The A fragment
//    pairs the activations in the same order, so each MMA adds x * level
//    over k in another order than the sequential sum. Grouped: the two
//    nibbles are unpacked to f32 (under 2^23), multiplied by their f32
//    scales and rounded to bf16 as the Pallas kernel rounds the scaled
//    tile;
//  * 8 steps of loads in flight per warp, the next 8 issued before the
//    current ones are used (registers, double-buffered: a slice of up to
//    256 byte rows is one batch); the first batch before the prologue, which
//    sums every row's squares over all of K in one fixed order (the same
//    bits in every block of a cluster) and stages the slice's activations,
//    normalised and rounded to bf16, and the slice's scale groups;
//  * the four warps' tiles are added in warp order, then the cluster's
//    through distributed shared memory: rank r adds every S-th output of
//    the tile over ranks 0..S-1 in rank order and applies the scale, the
//    residual and the cast. One launch, no workspace, no atomics, the same
//    bits on every run.
#pragma once

#include <cooperative_groups.h>

#include "gemv_common.cuh"

namespace ua2 {
namespace splitk {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TN = 64;                    // output columns of a block
constexpr int STEP = 8;                   // byte rows of a warp step (k = 16)
constexpr int R = 8;                      // steps of loads in flight a warp
constexpr int MROWS = 16;                 // activation rows of a block
constexpr int RS = TN + 1;                // row stride of the warp partials
constexpr int MAX_SPLITS = 8;
constexpr int EP = MROWS * TN / THREADS;  // outputs a thread may finish
constexpr unsigned OFFSET = 0x88888888u;  // two's complement -> n + 8
constexpr unsigned MAGIC = 0x4B000000u;   // f32 2^23
constexpr unsigned MAGIC2 = 0x43004300u;  // bf16x2 (128, 128)

// (a & b) | c in one LOP3, every operand a register.
__device__ __forceinline__ unsigned and_or(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The offset nibbles at bits 0-3 (low half) and 16-19 (high half) of q as
// the bf16x2 of their levels, exact: 128 + (n + 8) - 136.
__device__ __forceinline__ unsigned levels2(unsigned q) {
  const unsigned v = and_or(q, 0x000F000Fu, MAGIC2);
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));   // x 1 - 136
  return d;
}

// 16^p n of the offset nibble p (0..3) of q, exact, in f32.
__device__ __forceinline__ float level(unsigned q, int p) {
  const float f = __uint_as_float(and_or(q, 0xFu << (4 * p), MAGIC));
  return f - (8388608.f + 8.f * (float)(1 << (4 * p)));
}

// (lo, hi) rounded to bf16 (round to nearest even), packed lo first.
__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += A (16 x 16 bf16) * B (16 x 8 bf16), f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Scale groups a slice of `span` byte rows may touch (bound for smem).
__host__ __device__ inline int slice_groups(int layout, int K, int G, int span) {
  if (G == 0) return 0;
  const int gs = K / G;                        // input rows a group
  const int rows = layout == I4 ? 2 * span : span;
  const int most = layout == I4 ? G : G / 2;
  const int n = rows / gs + 2;
  return n < most ? n : most;
}

// Words between two activation rows of the staged slice: whole steps,
// then padded to 4 past a multiple of 32 banks so that the 8 rows of an A
// fragment load fall in distinct banks.
__host__ __device__ inline int staged_rows(int span) { return (span + 31) / 32 * 32 + 4; }

// Activation rows staged from row m0 on: 8 (A rows 0-7) or 16.
__host__ __device__ inline int staged_m(int M, int m0) { return M - m0 > 8 ? 16 : 8; }

// Dynamic shared memory: the block's partial tile, then a region that
// holds the staged activations and scale tiles during the main loop and
// the warps' partial tiles after it.
__host__ inline int smem_bytes(int layout, int K, int G, int M, int span) {
  const int part = MROWS * TN * 4;
  const int stage = align16(staged_m(M, 0) * staged_rows(span) * 4) +
                    2 * slice_groups(layout, K, G, span) * TN * 4;
  const int red = NWARPS * MROWS * RS * 4;
  return part + (stage > red ? stage : red);
}

template <int LAYOUT, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
gemv_splitk_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const __nv_bfloat16* __restrict__ nw,
                   const __nv_bfloat16* __restrict__ res, void* __restrict__ out,
                   int M, int K, int N, int ldw, int G, float eps, int out_f32,
                   int span) {
  static_assert(LAYOUT == I4 || LAYOUT == K4, "row-packed int4 layouts only");
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int rows = K / 2;
  const int r0 = blockIdx.y * span;
  const int n_rows = max(min(rows, r0 + span) - r0, 0);
  const int xw = staged_rows(span);
  const int col0 = blockIdx.x * TN, m0 = blockIdx.z * MROWS;
  const int mt = min(MROWS, M - m0);                 // live activation rows
  const int mr = staged_m(M, m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, gq = lane >> 2;            // MMA thread / group ids

  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);                       // MROWS x TN
  unsigned char* region = smem + MROWS * TN * 4;
  unsigned* xs = reinterpret_cast<unsigned*>(region);                 // mr x xw
  float* st = reinterpret_cast<float*>(region + align16(mr * xw * 4));
  float* red = reinterpret_cast<float*>(region);                      // after the loop

  // 1. the first batch of weight loads: step s of this warp is slice rows
  // [8 s, 8 s + 8); a lane loads rows 8 s + t and 8 s + t + 4, columns
  // [8 gq, 8 gq + 8) of the tile
  const int steps = (n_rows + STEP - 1) / STEP;
  const int my_steps = steps > warp ? (steps - warp + NWARPS - 1) / NWARPS : 0;
  const int8_t* wp = w + (size_t)(r0 + t) * ldw + col0 + 8 * gq;
  uint2 cur[R][2], nxt[R][2] = {};
  auto load = [&](uint2 (&buf)[R][2], int batch) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = STEP * (warp + NWARPS * (batch * R + u));
      const uint2 zero = make_uint2(0u, 0u);
      const bool in = batch * R + u < my_steps;
      buf[u][0] = in && i + t < n_rows
          ? __ldg(reinterpret_cast<const uint2*>(wp + (size_t)i * ldw)) : zero;
      buf[u][1] = in && i + t + 4 < n_rows
          ? __ldg(reinterpret_cast<const uint2*>(wp + (size_t)(i + 4) * ldw)) : zero;
    }
  };
  load(cur, 0);

  // 2. the slice's activations: byte row i's (low, high) pair, row m at
  // xs[m * xw + i]; rows past the slice and past M are zero
  float rstd[MROWS];
#pragma unroll
  for (int m = 0; m < MROWS; ++m) rstd[m] = 1.f;
  if (nw != nullptr) {
    float ss[MROWS];
#pragma unroll
    for (int m = 0; m < MROWS; ++m) {
      ss[m] = 0.f;
      if (m < mt) {
        const __nv_bfloat16* src = x + (size_t)(m0 + m) * K;
        for (int k = tid; k < K; k += THREADS) {
          const float v = bf(src[k]);
          ss[m] += v * v;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss[m] += __shfl_xor_sync(0xffffffffu, ss[m], o);
    }
    float* sred = reinterpret_cast<float*>(region);   // NWARPS x MROWS
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < MROWS; ++m) sred[warp * MROWS + m] = ss[m];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MROWS; ++m) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NWARPS; ++q) s += sred[q * MROWS + m];
      rstd[m] = rsqrtf(s / (float)K + eps);
    }
    __syncthreads();                 // sred is xs
  }
  for (int i = tid; i < xw; i += THREADS) {
    const int r = r0 + i;
    const int ka = LAYOUT == I4 ? 2 * r : r, kb = LAYOUT == I4 ? 2 * r + 1 : rows + r;
#pragma unroll
    for (int m = 0; m < MROWS; ++m) {
      if (m >= mr) break;
      __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (m < mt && i < n_rows) {
        const __nv_bfloat16* src = x + (size_t)(m0 + m) * K;
        if (nw == nullptr) {
          v.x = src[ka];
          v.y = src[kb];
        } else {
          v.x = __float2bfloat16(bf(src[ka]) * rstd[m] * bf(nw[ka]));
          v.y = __float2bfloat16(bf(src[kb]) * rstd[m] * bf(nw[kb]));
        }
      }
      xs[m * xw + i] = *reinterpret_cast<const unsigned*>(&v);
    }
  }

  // 3. grouped: the slice's scale tiles. Entry (gi, c) of the low tile is
  // the scale of the byte's low level in tile column c times 16^-q, q the
  // place of that nibble in the unpack below (2 (c % 2)); the high tile
  // likewise (q = 2 (c % 2) + 1). Local group of byte row r: I4
  // 2r / gs - g0, K4 r / gs - g0 in both halves (the high half's groups
  // start at G/2).
  int g0 = 0, gs = 1;
  const int ng = GROUPED ? slice_groups(LAYOUT, K, G, span) : 0;
  if (GROUPED) {
    gs = K / G;
    g0 = (LAYOUT == I4 ? 2 * r0 : r0) / gs;
    const int hi0 = LAYOUT == I4 ? g0 : G / 2 + g0;
    const int top = LAYOUT == I4 ? G : G / 2;
    for (int e = tid; e < ng * TN; e += THREADS) {
      const int gi = e / TN, c = e % TN;
      const bool in = col0 + c < N && g0 + gi < top;
      const float lo = in ? scale[(size_t)(g0 + gi) * N + col0 + c] : 0.f;
      const float hi = in ? scale[(size_t)(hi0 + gi) * N + col0 + c] : 0.f;
      st[e] = c % 2 ? lo * (1.f / 256.f) : lo;
      st[ng * TN + e] = c % 2 ? hi * (1.f / 4096.f) : hi * (1.f / 16.f);
    }
  }
  __syncthreads();

  // 4. the slice on the tensor cores, R steps at a time, the next R in
  // flight. MMA j takes tile columns 8 n + j (n = 0..7, the B fragment's
  // column); its logical k pairs are (low levels of rows t, t + 4) and
  // (high levels of rows t, t + 4), and the A fragment pairs x alike.
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  const int batches = (my_steps + R - 1) / R;
  for (int b = 0; b < batches; ++b) {
    if (b + 1 < batches) load(nxt, b + 1);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (b * R + u >= my_steps) break;
      const int i = STEP * (warp + NWARPS * (b * R + u));
      unsigned a[4];
      {
        const unsigned p0 = xs[gq * xw + i + t], p4 = xs[gq * xw + i + t + 4];
        a[0] = __byte_perm(p0, p4, 0x5410);      // low levels' x, rows t, t + 4
        a[2] = __byte_perm(p0, p4, 0x7632);      // high levels' x
        a[1] = a[3] = 0u;
        if (mr > 8) {
          const unsigned q0 = xs[(gq + 8) * xw + i + t];
          const unsigned q4 = xs[(gq + 8) * xw + i + t + 4];
          a[1] = __byte_perm(q0, q4, 0x5410);
          a[3] = __byte_perm(q0, q4, 0x7632);
        }
      }
      float4 sla[2], sha[2], slb[2], shb[2];    // this lane's 8 columns' scales
      if (GROUPED) {
        const int rt = r0 + i + t;
        const int ga = min((LAYOUT == I4 ? 2 * rt : rt) / gs - g0, ng - 1);
        const int gb = min((LAYOUT == I4 ? 2 * (rt + 4) : rt + 4) / gs - g0, ng - 1);
        const float4* s4 = reinterpret_cast<const float4*>(st);
        const int c4 = 2 * gq;                   // float4 index of column 8 gq
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sla[h] = s4[(ga * TN) / 4 + c4 + h];
          slb[h] = s4[(gb * TN) / 4 + c4 + h];
          sha[h] = s4[((ng + ga) * TN) / 4 + c4 + h];
          shb[h] = s4[((ng + gb) * TN) / 4 + c4 + h];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {              // word h: columns 4h..4h+3
        const unsigned wa = (h ? cur[u][0].y : cur[u][0].x) ^ OFFSET;
        const unsigned wb = (h ? cur[u][1].y : cur[u][1].x) ^ OFFSET;
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {         // columns 4h + 2pr, + 1
          // bytes: row t's two columns, then row t + 4's
          const unsigned q = __byte_perm(wa, wb, pr ? 0x7632 : 0x5410);
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int j = 4 * h + 2 * pr + cc;
            unsigned b0, b1;
            if (GROUPED) {
              const int jc = 2 * pr + cc;        // column within word h
              const float la = jc == 0 ? sla[h].x : jc == 1 ? sla[h].y : jc == 2 ? sla[h].z : sla[h].w;
              const float lb = jc == 0 ? slb[h].x : jc == 1 ? slb[h].y : jc == 2 ? slb[h].z : slb[h].w;
              const float ha = jc == 0 ? sha[h].x : jc == 1 ? sha[h].y : jc == 2 ? sha[h].z : sha[h].w;
              const float hb = jc == 0 ? shb[h].x : jc == 1 ? shb[h].y : jc == 2 ? shb[h].z : shb[h].w;
              const unsigned q16 = q >> 16;
              b0 = pack_bf2(level(q, 2 * cc) * la, level(q16, 2 * cc) * lb);
              b1 = pack_bf2(level(q, 2 * cc + 1) * ha, level(q16, 2 * cc + 1) * hb);
            } else {
              b0 = levels2(q >> (8 * cc));
              b1 = levels2(q >> (8 * cc + 4));
            }
            mma(acc[j], a, b0, b1);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      cur[u][0] = nxt[u][0];
      cur[u][1] = nxt[u][1];
    }
  }

  // the epilogue's operands (outputs rank, rank + S, ... of the tile),
  // loaded now so that their latency hides behind the reductions
  float ep_scale[EP], ep_res[EP];
#pragma unroll
  for (int k = 0; k < EP; ++k) {
    const int e = rank + S * (tid + k * THREADS);
    const int row = m0 + e / TN, c = col0 + e % TN;
    const bool in = e < mt * TN && c < N;
    ep_scale[k] = !GROUPED && in ? __ldg(scale + c) : 1.f;
    ep_res[k] = res != nullptr && in ? bf(res[(size_t)row * N + c]) : 0.f;
  }

  // 5. the block's partial tile: the warps' tiles added in warp order.
  // acc[j] holds rows gq, gq + 8 and tile columns 16 t + j, 16 t + 8 + j.
  __syncthreads();                   // the region now holds `red`
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* dst = red + (warp * MROWS + gq) * RS + 16 * t + j;
    dst[0] = acc[j][0];
    dst[8] = acc[j][1];
    dst[8 * RS] = acc[j][2];
    dst[8 * RS + 8] = acc[j][3];
  }
  __syncthreads();
  for (int e = tid; e < mt * TN; e += THREADS) {
    const int m = e / TN, c = e % TN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NWARPS; ++q) s += red[(q * MROWS + m) * RS + c];
    part[e] = s;
  }

  // 6. across the cluster: rank r finishes outputs r, r + S, ... of the
  // tile, adding the ranks' partials in rank order
  cluster.sync();
#pragma unroll
  for (int k = 0; k < EP; ++k) {
    const int e = rank + S * (tid + k * THREADS);
    const int row = m0 + e / TN, c = col0 + e % TN;
    if (e >= mt * TN || c >= N) continue;
    float pv[MAX_SPLITS];           // every rank's partial read at once
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      pv[q] = q < S ? cluster.map_shared_rank(part, q)[e] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < S) v += pv[q];
    if (!GROUPED) v *= ep_scale[k];
    if (res != nullptr) v += ep_res[k];
    if (out_f32)
      reinterpret_cast<float*>(out)[(size_t)row * N + c] = v;
    else
      reinterpret_cast<__nv_bfloat16*>(out)[(size_t)row * N + c] = __float2bfloat16(v);
  }
  cluster.sync();                    // no block leaves while others read it
}

// Host launcher: `splits` K-slices of `span` byte rows each (the last may
// be shorter, none empty) and `mt` = MROWS activation rows a block; G = 0
// for per-channel scales. Returns cudaGetLastError() or
// cudaErrorInvalidValue for a plan or an operand the kernel does not take.
template <int LAYOUT, bool GROUPED>
inline int launch(const void* x, const void* w, const void* scale, const void* nw,
                  const void* res, void* out, int M, int K, int N, int ldw, int G,
                  float eps, int out_f32, int splits, int mt, int span,
                  cudaStream_t stream) {
  const int rows = K / 2;
  const bool plan_ok = splits >= 1 && splits <= MAX_SPLITS && span >= 1 && mt == MROWS &&
                       (long long)splits * span >= rows &&
                       (long long)(splits - 1) * span < rows;
  const bool ok = plan_ok && K % 2 == 0 && ldw % TN == 0 && ldw >= N &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0 && GROUPED == (G > 0) &&
                  (!GROUPED || (K % G == 0 && (LAYOUT == I4 ? (K / G) % 2 == 0
                                                            : G % 2 == 0)));
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = gemv_splitk_kernel<LAYOUT, GROUPED>;
  const int smem = smem_bytes(LAYOUT, K, G, M, span);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + TN - 1) / TN, splits, (M + MROWS - 1) / MROWS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                         static_cast<const int8_t*>(w), static_cast<const float*>(scale),
                         static_cast<const __nv_bfloat16*>(nw),
                         static_cast<const __nv_bfloat16*>(res), out, M, K, N, ldw, G,
                         eps, out_f32, span);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace splitk
}  // namespace ua2
