// Split-K GEMV for the decode rows, for sm_90a, on the tensor cores: the
// row-interleaved (I4) and K-split (K4) int4 layouts of rows 1, 5 and 6,
// and the two passes of the fused SwiGLU (row 2), which add the int8
// (INT8) and column-packed int4 (C4) layouts, and the fused QKV step
// (row 3). Included by gemv_int4i.cu, gemv_int4g.cu, gemv_int4.cu,
// fused_swiglu.cu and qkv_rope.cu only.
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
//  * the layouts of one level a byte row (INT8, and C4, whose byte holds
//    output columns c and N/2 + c) take steps of 16 byte rows (k = 16): a
//    lane loads rows t, t + 4, t + 8 and t + 12, and the host's rows are
//    "pairs" (row 16 s + j with row 16 s + j + 8, j < 8), K/2 of them, so
//    that staging, A fragments and plans are those of the int4 layouts.
//    C4 runs two products a column: the low nibbles (column c) and the
//    high ones (column N/2 + c), 128 outputs a block;
//  * unpack without conversions: XOR 0x88888888 makes the nibbles offset
//    (n + 8); a byte permute pairs a byte of row t with the same column's
//    byte of row t + 4, and one LOP3 puts two nibbles (the same column,
//    rows t and t + 4) under the bf16 exponent of 128, one bf16x2 FMA
//    subtracts 136: the exact levels as one B register. The A fragment
//    pairs the activations in the same order, so each MMA adds x * level
//    over k in another order than the sequential sum. Grouped: the two
//    nibbles are unpacked to f32 (under 2^23), multiplied by their f32
//    scales and rounded to bf16 as the Pallas kernel rounds the scaled
//    tile. INT8: a level needs 8 bits, more than bf16's 7 under one
//    exponent, so a byte permute puts (b ^ 0x80) = level + 128 under the
//    f32 exponent of 2^23, one FADD subtracts 2^23 + 128 and one cvt packs
//    two levels as bf16x2 (exact: |level| <= 127);
//  * 8 steps of loads in flight per warp (4 for INT8 / C4, which load
//    twice the rows a step), the next batch loading before the current one
//    is used (registers, double-buffered); the first batch before the
//    prologue, which sums every row's squares over all of K in one fixed
//    order (the same bits in every block of a cluster) and stages the
//    slice's activations, normalised and rounded to bf16, and the slice's
//    scale groups;
//  * the four warps' tiles are added in warp order, then the cluster's
//    through distributed shared memory: rank r adds every S-th output of
//    the tile over ranks 0..S-1 in rank order and applies the scale, the
//    residual and the cast. One launch, no workspace, no atomics, the same
//    bits on every run.
// The fused SwiGLU runs this kernel twice (`ua2_fused_swiglu`), each pass
// its own instance (MODE), so that a trace tells them from the GEMVs: pass
// 1 (UP) over 2 I / 64 column tiles, the first I / 64 reading W1 (`w`,
// `scale`) and the rest W2 (`w2`, `scale2`), writing a and b in f32; pass
// 2 (SWIGLU) over W3, launched after pass 1 has completed, staging
// bf16(silu(a) * b) of its slice from those f32 sums where the norm mode
// stages bf16(norm(x)).
// The fused QKV step (`ua2_qkv_rope`, row 3) is a fourth instance (QKV):
// the norm prologue and the products of a GEMV over W (N = (H + 2 G) hd
// columns, q's heads, then k's, then v's), with another column map and
// epilogue. RoPE pairs output column j of a head with j + hd/2, so a tile's
// 64 byte columns are two runs of 32, columns hd h + 32 p + [0, 32) and
// the same plus hd/2 (tile x: head h = x / (hd / 64), p = x % (hd / 64);
// at hd 64 the identity, one tile a head): tile column c < 32 and c + 32
// are a pair, and a lane's 8 columns lie in one run (two 32-byte runs a
// row, whole sectors). Rank r of the cluster finishes pairs r, r + S, ...
// of the tile: both columns' partials added over the ranks in rank order,
// the per-channel scale, then o = y cos + rot sin in f32 (rot = -y[j + hd/2]
// | y[j - hd/2]; v not rotated), one cast to bf16, and the store into q, k
// or v by the head's stream.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "gemv_common.cuh"

namespace ua2 {
namespace splitk {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TN = 64;                    // byte columns of a block
constexpr int STEP = 8;                   // (pair) rows of a warp step (k = 16)
constexpr int R = 8;                      // steps of loads in flight a warp
constexpr int MROWS = 16;                 // activation rows of a block
constexpr int RS = TN + 1;                // row stride of the warp partials
constexpr int MAX_SPLITS = 8;
constexpr unsigned OFFSET = 0x88888888u;  // two's complement -> n + 8
constexpr unsigned MAGIC = 0x4B000000u;   // f32 2^23
constexpr unsigned MAGIC2 = 0x43004300u;  // bf16x2 (128, 128)
// Modes of the kernel: a GEMV (rows 1, 5 and 6), the fused SwiGLU's pass 1
// over W1 | W2, its pass 2 staging h, the fused QKV step
constexpr int GEMV = 0, UP = 1, SWIGLU = 2, QKV = 3;

// One level a byte row, in steps of 16 rows: INT8 and C4.
__host__ __device__ constexpr bool wide(int layout) { return layout == INT8 || layout == C4; }

// The operands of one launch. The output is (M, N): columns [0, n1) from
// `w` / `scale`, [n1, N) from `w2` / `scale2` (a second weight of the same
// shape and storage, pass 1 of the fused SwiGLU; n1 = N and w2 = NULL
// otherwise). `ab` (SWIGLU): the (M, 2K) f32 sums a | b of pass 1.
struct Args {
  const __nv_bfloat16* x;
  const float* ab;
  const int8_t* w;
  const float* scale;
  const int8_t* w2;
  const float* scale2;
  const __nv_bfloat16* nw;
  const __nv_bfloat16* res;
  void* out;
  int M, K, N, n1, ldw, G, out_f32, span;
  float eps;
};

// The QKV mode's operands, a type of its own so that the other modes'
// kernel parameters stay as they were: with these fields added to Args,
// rows 1, 5 and 6's GEMV instances read up to 1.9x slower at 16 rows on the
// H100, the same code otherwise (`probes/splitk_ab.py`). `out` is q
// (M, H hd), `out_k` and `out_v` are k and v (M, G hd), bf16; `cos_r` and
// `sin_r` the (hd,) f32 rope rows shared by the rows.
struct QkvArgs : Args {
  const float* cos_r;
  const float* sin_r;
  void* out_k;
  void* out_v;
  int n_head, n_groups, hd;
};

template <int MODE>
using KernelArgs = std::conditional_t<MODE == QKV, QkvArgs, Args>;

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

// The int8 level of byte j of q (q already XORed with 0x80808080: the byte
// is level + 128), exact, in f32: 2^23 + (level + 128) - (2^23 + 128).
__device__ __forceinline__ float level8(unsigned q, int j) {
  return __uint_as_float(__byte_perm(q, MAGIC, 0x7440 | j)) - 8388736.f;
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

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Each of the first R rows' sum of squares into ss[m], in the order
// k = tid, tid + THREADS, ... (the same in every block); the R rows side by
// side, so that a step's loads of every row are in flight at once. Rows past
// the mt live ones read row mt - 1 (their sums are not used).
template <int R>
__device__ __forceinline__ void row_squares(const __nv_bfloat16* src, int K, int mt,
                                            float (&ss)[MROWS]) {
  const __nv_bfloat16* row[R];
#pragma unroll
  for (int m = 0; m < R; ++m) row[m] = src + (size_t)min(m, mt - 1) * K;
#pragma unroll 4
  for (int k = threadIdx.x; k < K; k += THREADS) {
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float v = bf(row[m][k]);
      ss[m] += v * v;
    }
  }
}

// Scale groups a slice of `span` (pair) rows may touch (bound for smem).
__host__ __device__ inline int slice_groups(int layout, int K, int G, int span) {
  if (G == 0) return 0;
  const int gs = K / G;                        // input rows a group
  const int rows = layout == K4 ? span : 2 * span;
  const int most = layout == K4 ? G / 2 : G;
  const int n = rows / gs + 2;
  return n < most ? n : most;
}

// Words between two activation rows of the staged slice: whole steps,
// then padded to 4 past a multiple of 32 banks so that the 8 rows of an A
// fragment load fall in distinct banks.
__host__ __device__ inline int staged_rows(int span) { return (span + 31) / 32 * 32 + 4; }

// Activation rows staged from row m0 on: 8 (A rows 0-7) or 16.
__host__ __device__ inline int staged_m(int M, int m0) { return M - m0 > 8 ? 16 : 8; }

// Dynamic shared memory: the block's partial tile (two for C4), then a
// region that holds the staged activations and scale tiles during the main
// loop and the warps' partial tiles after it.
__host__ inline int smem_bytes(int layout, int K, int G, int M, int span) {
  const int na = layout == C4 ? 2 : 1;
  const int part = na * MROWS * TN * 4;
  const int stage = align16(staged_m(M, 0) * staged_rows(span) * 4) +
                    2 * slice_groups(layout, K, G, span) * TN * 4;
  const int red = na * NWARPS * MROWS * RS * 4;
  return part + (stage > red ? stage : red);
}

template <int LAYOUT, bool GROUPED, int MODE>
__global__ void __launch_bounds__(THREADS) gemv_splitk_kernel(const KernelArgs<MODE> p) {
  static_assert(LAYOUT == I4 || LAYOUT == K4 || LAYOUT == INT8 || LAYOUT == C4,
                "a layout of gemv_common.cuh");
  static_assert(!(GROUPED && LAYOUT == INT8), "int8 has per-channel scales only");
  static_assert(MODE != QKV || LAYOUT != C4, "the QKV weight is row-packed or int8");
  constexpr bool WIDE = wide(LAYOUT);
  constexpr int LD = WIDE ? 4 : 2;        // loads of a lane a step
  constexpr int RB = R * 2 / LD;          // steps in flight: the same bytes
  constexpr int NA = LAYOUT == C4 ? 2 : 1;
  constexpr int TO = NA * TN;             // outputs of a tile row
  constexpr int EP = MROWS * TO / THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int M = p.M, K = p.K, N = p.N, ldw = p.ldw, G = p.G;
  const int rows = K / 2;                            // byte rows, or pairs
  const int r0 = blockIdx.y * p.span;
  const int n_rows = max(min(rows, r0 + p.span) - r0, 0);
  const int xw = staged_rows(p.span);
  const int col0 = blockIdx.x * TN, m0 = blockIdx.z * MROWS;
  const int mt = min(MROWS, M - m0);                 // live activation rows
  const int mr = staged_m(M, m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, gq = lane >> 2;            // MMA thread / group ids
  // the tile's weight: W2 past column n1 (its columns from 0 again)
  const bool second = MODE == UP && col0 >= p.n1;
  const int8_t* const w = second ? p.w2 : p.w;
  const float* const scale = second ? p.scale2 : p.scale;
  const int wc0 = second ? col0 - p.n1 : col0;       // the tile's first column in W
  const int wn = MODE != UP ? N : second ? N - p.n1 : p.n1;   // W's width
  const int nh = N / 2;                              // C4: the high nibbles' columns
  // QKV: the tiles a head, the tile's head, its first column and the
  // offset of its second run
  int tph = 1, hd = 0;
  if constexpr (MODE == QKV) tph = p.hd / 64, hd = p.hd;
  const int head = blockIdx.x / tph;
  const int qa = MODE == QKV ? hd * head + 32 * (blockIdx.x % tph) : 0;
  const int run2 = MODE == QKV ? hd / 2 - 32 : 0;
  // W's column of tile column c (QKV: the two runs of 32)
  auto wcol = [&](int c) {
    return MODE == QKV ? qa + c + (c >= 32 ? run2 : 0) : wc0 + c;
  };

  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);                       // MROWS x TO
  unsigned char* region = smem + MROWS * TO * 4;
  unsigned* xs = reinterpret_cast<unsigned*>(region);                 // mr x xw
  float* st = reinterpret_cast<float*>(region + align16(mr * xw * 4));
  float* red = reinterpret_cast<float*>(region);                      // after the loop

  // 1. the first batch of weight loads: step s of this warp is slice (pair)
  // rows [8 s, 8 s + 8); a lane loads byte rows 8 s + t and 8 s + t + 4
  // (WIDE: rows 16 s + t + 4 l, l < 4), columns [8 gq, 8 gq + 8) of the tile
  const int steps = (n_rows + STEP - 1) / STEP;
  const int my_steps = steps > warp ? (steps - warp + NWARPS - 1) / NWARPS : 0;
  const int8_t* wp = w + (size_t)((WIDE ? 2 * r0 : r0) + t) * ldw + wcol(8 * gq);
  uint2 cur[RB][LD], nxt[RB][LD] = {};
  auto load = [&](uint2 (&buf)[RB][LD], int batch) {
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int i = STEP * (warp + NWARPS * (batch * RB + u));
      const bool in = batch * RB + u < my_steps;
#pragma unroll
      for (int l = 0; l < LD; ++l) {
        const bool live = in && i + t + 4 * (l & 1) < n_rows;
        buf[u][l] = live ? __ldg(reinterpret_cast<const uint2*>(
                               wp + (size_t)((WIDE ? 2 * i : i) + 4 * l) * ldw))
                         : make_uint2(0u, 0u);
      }
    }
  };
  load(cur, 0);

  // 2. the slice's activations: (pair) row i's (low, high) pair of k, row m
  // at xs[m * xw + i]; rows past the slice and past M are zero. SWIGLU:
  // bf16(silu(a) * b) of pass 1's f32 sums
  float rstd[MROWS];
#pragma unroll
  for (int m = 0; m < MROWS; ++m) rstd[m] = 1.f;
  if (MODE != SWIGLU && p.nw != nullptr) {
    float ss[MROWS];
#pragma unroll
    for (int m = 0; m < MROWS; ++m) ss[m] = 0.f;
    const __nv_bfloat16* src = p.x + (size_t)m0 * K;
    if (mt == 1)
      row_squares<1>(src, K, mt, ss);
    else if (mt == 2)
      row_squares<2>(src, K, mt, ss);
    else if (mt <= 8)
      row_squares<8>(src, K, mt, ss);
    else
      row_squares<MROWS>(src, K, mt, ss);
#pragma unroll
    for (int m = 0; m < MROWS; ++m) {
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
      rstd[m] = rsqrtf(s / (float)K + p.eps);
    }
    __syncthreads();                 // sred is xs
  }
  for (int i = tid; i < xw; i += THREADS) {
    const int r = r0 + i;
    const int ka = LAYOUT == I4 ? 2 * r : LAYOUT == K4 ? r : 16 * (r >> 3) + (r & 7);
    const int kb = LAYOUT == I4 ? 2 * r + 1 : LAYOUT == K4 ? rows + r : ka + 8;
#pragma unroll
    for (int m = 0; m < MROWS; ++m) {
      if (m >= mr) break;
      __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (m < mt && i < n_rows) {
        if constexpr (MODE == SWIGLU) {
          const float* a = p.ab + (size_t)(m0 + m) * 2 * K;
          const float* b = a + K;
          const float aa = a[ka], ab = a[kb];
          v = __floats2bfloat162_rn(aa / (1.f + expf(-aa)) * b[ka],
                                    ab / (1.f + expf(-ab)) * b[kb]);
        } else {
          const __nv_bfloat16* src = p.x + (size_t)(m0 + m) * K;
          if (p.nw == nullptr) {
            v.x = src[ka];
            v.y = src[kb];
          } else {
            v.x = __float2bfloat16(bf(src[ka]) * rstd[m] * bf(p.nw[ka]));
            v.y = __float2bfloat16(bf(src[kb]) * rstd[m] * bf(p.nw[kb]));
          }
        }
      }
      xs[m * xw + i] = *reinterpret_cast<const unsigned*>(&v);
    }
  }

  // 3. grouped: the slice's scale tiles. Entry (gi, c) of the low tile is
  // the scale of the byte's low level in tile column c times 16^-q, q the
  // place of that nibble in the unpack below (2 (c % 2)); the high tile
  // likewise (q = 2 (c % 2) + 1). Local group of (pair) row r: I4
  // 2r / gs - g0, K4 r / gs - g0 in both halves (the high half's groups
  // start at G/2), C4 (16 (r / 8)) / gs - g0 for all four rows of a lane's
  // step (the host takes groups of whole steps), its high tile from the
  // high nibbles' columns N/2 + c.
  int g0 = 0, gs = 1;
  const int ng = GROUPED ? slice_groups(LAYOUT, K, G, p.span) : 0;
  if (GROUPED) {
    gs = K / G;
    g0 = (LAYOUT == K4 ? r0 : 2 * r0) / gs;
    const int hi0 = LAYOUT == K4 ? G / 2 + g0 : g0;
    const int top = LAYOUT == K4 ? G / 2 : G;
    for (int e = tid; e < ng * TN; e += THREADS) {
      const int gi = e / TN, c = e % TN;
      const bool gin = g0 + gi < top;
      float lo, hi;
      if (LAYOUT == C4) {
        lo = gin && col0 + c < nh ? scale[(size_t)(g0 + gi) * N + col0 + c] : 0.f;
        hi = gin && col0 + c < N - nh ? scale[(size_t)(g0 + gi) * N + nh + col0 + c] : 0.f;
      } else {
        const int wc = wcol(c);
        const bool in = gin && wc < wn;
        lo = in ? scale[(size_t)(g0 + gi) * wn + wc] : 0.f;
        hi = in ? scale[(size_t)(hi0 + gi) * wn + wc] : 0.f;
      }
      st[e] = c % 2 ? lo * (1.f / 256.f) : lo;
      st[ng * TN + e] = c % 2 ? hi * (1.f / 4096.f) : hi * (1.f / 16.f);
    }
  }
  __syncthreads();

  // 4. the slice on the tensor cores, RB steps at a time, the next RB in
  // flight. MMA j takes tile columns 8 n + j (n = 0..7, the B fragment's
  // column); its logical k pairs are (low levels of rows t, t + 4) and
  // (high levels of rows t, t + 4) (WIDE: rows t, t + 4 and rows t + 8,
  // t + 12), and the A fragment pairs x alike.
  float acc[NA][8][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][j][q] = 0.f;
  const int batches = (my_steps + RB - 1) / RB;
  for (int b = 0; b < batches; ++b) {
    if (b + 1 < batches) load(nxt, b + 1);
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      if (b * RB + u >= my_steps) break;
      const int i = STEP * (warp + NWARPS * (b * RB + u));
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
        const int c4 = 2 * gq;                   // float4 index of column 8 gq
        const float4* s4 = reinterpret_cast<const float4*>(st);
        if (LAYOUT == C4) {
          const int gc = min((2 * (r0 + i)) / gs - g0, ng - 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sla[h] = slb[h] = s4[(gc * TN) / 4 + c4 + h];
            sha[h] = shb[h] = s4[((ng + gc) * TN) / 4 + c4 + h];
          }
        } else {
          const int ga = min((LAYOUT == I4 ? 2 * rt : rt) / gs - g0, ng - 1);
          const int gb = min((LAYOUT == I4 ? 2 * (rt + 4) : rt + 4) / gs - g0, ng - 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sla[h] = s4[(ga * TN) / 4 + c4 + h];
            slb[h] = s4[(gb * TN) / 4 + c4 + h];
            sha[h] = s4[((ng + ga) * TN) / 4 + c4 + h];
            shb[h] = s4[((ng + gb) * TN) / 4 + c4 + h];
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {              // word h: columns 4h..4h+3
        if constexpr (LAYOUT == INT8) {
          unsigned q[4];
#pragma unroll
          for (int l = 0; l < 4; ++l) q[l] = (h ? cur[u][l].y : cur[u][l].x) ^ 0x80808080u;
#pragma unroll
          for (int jc = 0; jc < 4; ++jc)
            mma(acc[0][4 * h + jc], a, pack_bf2(level8(q[0], jc), level8(q[1], jc)),
                pack_bf2(level8(q[2], jc), level8(q[3], jc)));
        } else {
          const unsigned wa = (h ? cur[u][0].y : cur[u][0].x) ^ OFFSET;
          const unsigned wb = (h ? cur[u][1].y : cur[u][1].x) ^ OFFSET;
          unsigned wc = 0u, wd = 0u;
          if constexpr (LAYOUT == C4) {
            wc = (h ? cur[u][2].y : cur[u][2].x) ^ OFFSET;
            wd = (h ? cur[u][3].y : cur[u][3].x) ^ OFFSET;
          }
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {       // columns 4h + 2pr, + 1
            // bytes: row t's two columns, then row t + 4's (C4: qb rows
            // t + 8 and t + 12)
            const unsigned q = __byte_perm(wa, wb, pr ? 0x7632 : 0x5410);
            const unsigned qb = __byte_perm(wc, wd, pr ? 0x7632 : 0x5410);
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int j = 4 * h + 2 * pr + cc;
              const int jc = 2 * pr + cc;        // column within word h
              if constexpr (LAYOUT == C4) {
                if constexpr (GROUPED) {
                  const float sl = lane_of(sla[h], jc), sh = lane_of(sha[h], jc);
                  mma(acc[0][j], a,
                      pack_bf2(level(q, 2 * cc) * sl, level(q >> 16, 2 * cc) * sl),
                      pack_bf2(level(qb, 2 * cc) * sl, level(qb >> 16, 2 * cc) * sl));
                  mma(acc[1][j], a,
                      pack_bf2(level(q, 2 * cc + 1) * sh, level(q >> 16, 2 * cc + 1) * sh),
                      pack_bf2(level(qb, 2 * cc + 1) * sh, level(qb >> 16, 2 * cc + 1) * sh));
                } else {
                  mma(acc[0][j], a, levels2(q >> (8 * cc)), levels2(qb >> (8 * cc)));
                  mma(acc[1][j], a, levels2(q >> (8 * cc + 4)), levels2(qb >> (8 * cc + 4)));
                }
              } else {
                unsigned b0, b1;
                if constexpr (GROUPED) {
                  const float la = lane_of(sla[h], jc), lb = lane_of(slb[h], jc);
                  const float ha = lane_of(sha[h], jc), hb = lane_of(shb[h], jc);
                  const unsigned q16 = q >> 16;
                  b0 = pack_bf2(level(q, 2 * cc) * la, level(q16, 2 * cc) * lb);
                  b1 = pack_bf2(level(q, 2 * cc + 1) * ha, level(q16, 2 * cc + 1) * hb);
                } else {
                  b0 = levels2(q >> (8 * cc));
                  b1 = levels2(q >> (8 * cc + 4));
                }
                mma(acc[0][j], a, b0, b1);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < RB; ++u)
#pragma unroll
      for (int l = 0; l < LD; ++l) cur[u][l] = nxt[u][l];
  }

  // the epilogue's operands (outputs rank, rank + S, ... of the tile),
  // loaded now so that their latency hides behind the reductions. Entry e:
  // row e / TO; column e % TO, C4's high nibbles at TN and above
  float ep_scale[EP], ep_res[EP];
  int ep_col[EP];
  // QKV: the RoPE pairs rank, rank + S, ... of the tile instead, pair i
  // being tile columns i % 32 and i % 32 + 32 of row i / 32; entry 2 k + h
  // holds the scale, cos and sin of pair k's column h (h = 1: j + hd/2)
  constexpr int PAIRS = TN / 2;
  constexpr int EPQ = MROWS * PAIRS / THREADS;
  const int j0 = MODE == QKV ? 32 * (blockIdx.x % tph) : 0;   // in the head
  float pq_scale[2 * EPQ], pq_cos[2 * EPQ], pq_sin[2 * EPQ];
  if constexpr (MODE == QKV) {
#pragma unroll
    for (int k = 0; k < EPQ; ++k) {
      const int i = rank + S * (tid + k * THREADS);
      const bool in = i < mt * PAIRS;
      const int c = i % PAIRS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + c + h * (hd / 2);
        pq_scale[2 * k + h] = !GROUPED && in ? __ldg(scale + wcol(c + PAIRS * h)) : 1.f;
        pq_cos[2 * k + h] = in ? __ldg(p.cos_r + j) : 0.f;
        pq_sin[2 * k + h] = in ? __ldg(p.sin_r + j) : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < EP; ++k) {
      const int e = rank + S * (tid + k * THREADS);
      const int row = m0 + e / TO, jc = e % TO;
      int col = col0 + jc, scol = wc0 + jc;
      bool in = e < mt * TO && col < N;
      if (LAYOUT == C4) {
        const bool hi = jc >= TN;
        const int bcol = col0 + jc - (hi ? TN : 0);
        in = e < mt * TO && bcol < (hi ? N - nh : nh);
        col = scol = hi ? nh + bcol : bcol;
      }
      ep_col[k] = in ? col : -1;
      ep_scale[k] = !GROUPED && in ? __ldg(scale + scol) : 1.f;
      ep_res[k] = p.res != nullptr && in ? bf(p.res[(size_t)row * N + col]) : 0.f;
    }
  }

  // 5. the block's partial tile: the warps' tiles added in warp order.
  // acc[a][j] holds rows gq, gq + 8 and tile columns 16 t + j,
  // 16 t + 8 + j (C4: of the low (a = 0) or high (a = 1) nibbles)
  __syncthreads();                   // the region now holds `red`
#pragma unroll
  for (int na = 0; na < NA; ++na)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* dst = red + ((na * NWARPS + warp) * MROWS + gq) * RS + 16 * t + j;
      dst[0] = acc[na][j][0];
      dst[8] = acc[na][j][1];
      dst[8 * RS] = acc[na][j][2];
      dst[8 * RS + 8] = acc[na][j][3];
    }
  __syncthreads();
  for (int e = tid; e < mt * TO; e += THREADS) {
    const int m = e / TO, na = (e % TO) / TN, c = e % TN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NWARPS; ++q) s += red[((na * NWARPS + q) * MROWS + m) * RS + c];
    part[e] = s;
  }

  // 6. across the cluster: rank r finishes outputs r, r + S, ... of the
  // tile (QKV: pairs), adding the ranks' partials in rank order
  cluster.sync();
  if constexpr (MODE == QKV) {
    // the head's stream: q and k rotated, v not
    __nv_bfloat16* dst;
    int ld, dcol;
    bool rope = true;
    if (head < p.n_head) {
      dst = static_cast<__nv_bfloat16*>(p.out);
      ld = p.n_head * p.hd, dcol = head * p.hd;
    } else if (head < p.n_head + p.n_groups) {
      dst = static_cast<__nv_bfloat16*>(p.out_k);
      ld = p.n_groups * p.hd, dcol = (head - p.n_head) * p.hd;
    } else {
      dst = static_cast<__nv_bfloat16*>(p.out_v);
      ld = p.n_groups * p.hd, dcol = (head - p.n_head - p.n_groups) * p.hd;
      rope = false;
    }
#pragma unroll
    for (int k = 0; k < EPQ; ++k) {
      const int i = rank + S * (tid + k * THREADS);
      if (i >= mt * PAIRS) continue;
      const int m = i / PAIRS, c = i % PAIRS, e = m * TO + c;
      float pa[MAX_SPLITS], pb[MAX_SPLITS];
#pragma unroll
      for (int q = 0; q < MAX_SPLITS; ++q) {
        const float* rp = q < S ? cluster.map_shared_rank(part, q) : nullptr;
        pa[q] = q < S ? rp[e] : 0.f;
        pb[q] = q < S ? rp[e + PAIRS] : 0.f;
      }
      float ya = 0.f, yb = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_SPLITS; ++q)
        if (q < S) ya += pa[q], yb += pb[q];
      if (!GROUPED) ya *= pq_scale[2 * k], yb *= pq_scale[2 * k + 1];
      float oa = ya, ob = yb;
      if (rope) {
        oa = __fadd_rn(__fmul_rn(ya, pq_cos[2 * k]), __fmul_rn(-yb, pq_sin[2 * k]));
        ob = __fadd_rn(__fmul_rn(yb, pq_cos[2 * k + 1]), __fmul_rn(ya, pq_sin[2 * k + 1]));
      }
      __nv_bfloat16* o = dst + (size_t)(m0 + m) * ld + dcol + j0 + c;
      o[0] = __float2bfloat16(oa);
      o[hd / 2] = __float2bfloat16(ob);
    }
  } else {
#pragma unroll
    for (int k = 0; k < EP; ++k) {
      const int e = rank + S * (tid + k * THREADS);
      const int row = m0 + e / TO, col = ep_col[k];
      if (col < 0) continue;
      float pv[MAX_SPLITS];           // every rank's partial read at once
#pragma unroll
      for (int q = 0; q < MAX_SPLITS; ++q)
        pv[q] = q < S ? cluster.map_shared_rank(part, q)[e] : 0.f;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_SPLITS; ++q)
        if (q < S) v += pv[q];
      if (!GROUPED) v *= ep_scale[k];
      if (p.res != nullptr) v += ep_res[k];
      if (p.out_f32)
        reinterpret_cast<float*>(p.out)[(size_t)row * N + col] = v;
      else
        reinterpret_cast<__nv_bfloat16*>(p.out)[(size_t)row * N + col] = __float2bfloat16(v);
    }
  }
  cluster.sync();                    // no block leaves while others read it
}

// True when (splits, span) with `mt` = MROWS rows a block is a launch this
// kernel takes for a K of `rows` = K / 2 (pair) rows: `splits` K-slices of
// `span` rows each (the last may be shorter, none empty; WIDE: whole steps
// of 16 rows).
inline bool plan_ok(int layout, int K, int splits, int mt, int span) {
  const int rows = K / 2;
  return splits >= 1 && splits <= MAX_SPLITS && span >= 1 && mt == MROWS &&
         (long long)splits * span >= rows && (long long)(splits - 1) * span < rows &&
         (!wide(layout) || (K % 16 == 0 && span % STEP == 0));
}

// Host launcher of `a` with `splits` K-slices (the cluster) of `a.span`
// (pair) rows and `mt` = MROWS activation rows a block. Returns
// cudaGetLastError() or cudaErrorInvalidValue for a plan or an operand the
// kernel does not take.
template <int LAYOUT, bool GROUPED, int MODE>
inline int launch_args(const KernelArgs<MODE>& a, int splits, int mt, cudaStream_t stream) {
  const int width = LAYOUT == C4 ? a.N - a.N / 2 : a.N;   // byte columns in use
  const bool two = MODE == UP;
  const bool cols_ok = LAYOUT == C4
      ? !two && a.ldw >= width
      : (two ? a.n1 % TN == 0 && a.n1 > 0 && a.n1 < a.N && a.ldw >= a.n1 &&
                   a.ldw >= a.N - a.n1 &&
                   reinterpret_cast<uintptr_t>(a.w2) % 16 == 0
             : a.n1 == a.N && a.ldw >= a.N);
  const int gs = GROUPED ? a.K / a.G : 0;
  bool qkv_ok = true;
  if constexpr (MODE == QKV)
    qkv_ok = (a.hd == 64 || a.hd == 128) && a.n_head > 0 && a.n_groups > 0 &&
             a.N == (a.n_head + 2 * a.n_groups) * a.hd && a.cos_r != nullptr &&
             a.sin_r != nullptr && a.out_k != nullptr && a.out_v != nullptr &&
             a.nw != nullptr && a.res == nullptr && !a.out_f32;
  const bool ok = plan_ok(LAYOUT, a.K, splits, mt, a.span) && a.K % 2 == 0 && qkv_ok &&
                  a.ldw % TN == 0 && cols_ok && a.M >= 1 &&
                  reinterpret_cast<uintptr_t>(a.w) % 16 == 0 && GROUPED == (a.G > 0) &&
                  two == (a.w2 != nullptr) && (MODE == SWIGLU) == (a.ab != nullptr) &&
                  (MODE == SWIGLU || a.x != nullptr) &&
                  (MODE != SWIGLU || a.nw == nullptr) &&
                  (!GROUPED || (a.K % a.G == 0 &&
                                (LAYOUT == I4 ? gs % 2 == 0
                                 : LAYOUT == K4 ? a.G % 2 == 0
                                                : gs % 16 == 0)));
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = gemv_splitk_kernel<LAYOUT, GROUPED, MODE>;
  const int smem = smem_bytes(LAYOUT, a.K, a.G, a.M, a.span);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((width + TN - 1) / TN, splits, (a.M + MROWS - 1) / MROWS);
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
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The GEMV of rows 1, 5 and 6: one weight, x with an optional norm.
template <int LAYOUT, bool GROUPED>
inline int launch(const void* x, const void* w, const void* scale, const void* nw,
                  const void* res, void* out, int M, int K, int N, int ldw, int G,
                  float eps, int out_f32, int splits, int mt, int span,
                  cudaStream_t stream) {
  static_assert(LAYOUT == I4 || LAYOUT == K4, "row-packed int4 layouts only");
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.nw = static_cast<const __nv_bfloat16*>(nw);
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.out = out;
  a.M = M, a.K = K, a.N = N, a.n1 = N, a.ldw = ldw, a.G = G, a.out_f32 = out_f32;
  a.span = span, a.eps = eps;
  return launch_args<LAYOUT, GROUPED, GEMV>(a, splits, mt, stream);
}

}  // namespace splitk
}  // namespace ua2
